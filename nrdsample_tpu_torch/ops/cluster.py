"""Clustered traversal (counterpart of ``nrdsample_tpu/ops/cluster.py``).

Triangles are put in the order of a binned-SAH BVH build, padded with
degenerate triangles to a multiple of ``CLUSTER_SIZE`` and cut into
128-triangle clusters with AABBs. No tree is kept.

``closest_hit_clustered`` and ``any_hit_clustered`` are the plain versions of
the packet kernel (``csrc/packet_hit.cu``): per ray, every cluster box is
slab-tested, the clusters are visited nearest-first, and the scan ends when
the next cluster's entry distance is past the ray's best hit. They are what
the JAX package runs on the CPU, step for step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.ops import intersect
from nrdsample_tpu_torch.scene.bvh import build_order
from nrdsample_tpu_torch.scene.types import TriangleSoA, _to

CLUSTER_SIZE = 128  # triangles per cluster: one thread block's tile in the packet kernel
SLAB_ROWS = 16      # slab rows per cluster: the 9 component planes + padding
SUPER_SIZE = 8      # clusters per supercluster
T_MAX = intersect.T_MAX


@dataclasses.dataclass
class ClusterSet:
    bounds_min: torch.Tensor   # (C, 3)
    bounds_max: torch.Tensor   # (C, 3)
    p0_b: torch.Tensor         # (C, CLUSTER_SIZE, 3) cluster-major triangle blocks
    e1_b: torch.Tensor
    e2_b: torch.Tensor
    # (C' * SLAB_ROWS, CLUSTER_SIZE) float32, C' = C rounded up to whole
    # superclusters: per cluster 16 rows whose rows 0..8 are the component
    # planes p0x p0y p0z e1x e1y e1z e2x e2y e2z (zero rows never hit)
    slab: torch.Tensor
    super_min: torch.Tensor    # (C' / SUPER_SIZE, 3) supercluster AABBs
    super_max: torch.Tensor

    @property
    def count(self) -> int:
        return self.bounds_min.shape[0]

    def to(self, device) -> "ClusterSet":
        return _to(self, device)


def build_clusters(tris: TriangleSoA):
    """Reorder a TriangleSoA by BVH build order, pad it to a CLUSTER_SIZE
    multiple with degenerate triangles, and compute the per-cluster AABBs.
    Host numpy; returns CPU tensors (ClusterSet, padded reordered tris,
    order) where order[new] = old (the un-padded permutation, int64 numpy)."""
    p0 = tris.p0.cpu().numpy()
    e1 = tris.e1.cpu().numpy()
    e2 = tris.e2.cpu().numpy()
    p1 = p0 + e1
    p2 = p0 + e2
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    order = build_order(tmin, tmax, leaf_size=8)

    t = len(p0)
    pad = (-t) % CLUSTER_SIZE

    def reorder_pad(a):
        a = a.cpu().numpy()[order]
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
        return a

    tris_np = {f.name: reorder_pad(getattr(tris, f.name)) for f in dataclasses.fields(tris)}
    tris_p = TriangleSoA(**{k: torch.from_numpy(v) for k, v in tris_np.items()})

    tmin_o = tmin[order]
    tmax_o = tmax[order]
    if pad:
        # padded triangles get empty boxes that never intersect
        tmin_o = np.concatenate([tmin_o, np.full((pad, 3), np.inf, np.float32)])
        tmax_o = np.concatenate([tmax_o, np.full((pad, 3), -np.inf, np.float32)])
    c = (t + pad) // CLUSTER_SIZE
    cmin = tmin_o.reshape(c, CLUSTER_SIZE, 3).min(axis=1)
    cmax = tmax_o.reshape(c, CLUSTER_SIZE, 3).max(axis=1)
    p0_b = tris_np["p0"].reshape(c, CLUSTER_SIZE, 3)
    e1_b = tris_np["e1"].reshape(c, CLUSTER_SIZE, 3)
    e2_b = tris_np["e2"].reshape(c, CLUSTER_SIZE, 3)
    spad = (-c) % SUPER_SIZE
    slab = np.zeros(((c + spad) * SLAB_ROWS, CLUSTER_SIZE), np.float32)
    for p, plane in enumerate([p0_b[..., 0], p0_b[..., 1], p0_b[..., 2],
                               e1_b[..., 0], e1_b[..., 1], e1_b[..., 2],
                               e2_b[..., 0], e2_b[..., 1], e2_b[..., 2]]):
        slab[p::SLAB_ROWS][:c] = plane
    cmin_p = np.concatenate([cmin, np.full((spad, 3), np.inf, np.float32)]) if spad else cmin
    cmax_p = np.concatenate([cmax, np.full((spad, 3), -np.inf, np.float32)]) if spad else cmax
    cs_n = (c + spad) // SUPER_SIZE
    f = torch.from_numpy
    cs = ClusterSet(
        bounds_min=f(cmin), bounds_max=f(cmax),
        p0_b=f(np.ascontiguousarray(p0_b)), e1_b=f(np.ascontiguousarray(e1_b)),
        e2_b=f(np.ascontiguousarray(e2_b)), slab=f(slab),
        super_min=f(cmin_p.reshape(cs_n, SUPER_SIZE, 3).min(axis=1)),
        super_max=f(cmax_p.reshape(cs_n, SUPER_SIZE, 3).max(axis=1)),
    )
    return cs, tris_p, order


def _cluster_entry(o, d, bounds_min, bounds_max, t_max):
    """(R, C) entry distances of R rays into C boxes; T_MAX where a ray
    misses a box or enters it at or past its t_max."""
    small = torch.abs(d) < 1e-12
    inv_d = 1.0 / torch.where(small, torch.where(d >= 0, 1e-12, -1e-12), d)
    tmin = tmax_ = None
    for k in range(3):
        bmin = bounds_min[None, :, k]
        bmax = bounds_max[None, :, k]
        ok = o[:, None, k]
        ik = inv_d[:, None, k]
        t0 = (bmin - ok) * ik
        t1 = (bmax - ok) * ik
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tmin = lo if tmin is None else torch.maximum(tmin, lo)
        tmax_ = hi if tmax_ is None else torch.minimum(tmax_, hi)
    tnear = torch.clamp_min(tmin, 0.0)
    hit = (tnear <= tmax_) & (tnear < t_max[:, None])
    return torch.where(hit, tnear, T_MAX)


K_PREFIX = 4  # clusters tested before the loop checks whether all rays are done


def _scan_clusters(o, d, entry, cs: ClusterSet, t_max, any_hit: bool) -> dict:
    """Nearest-first scan: each step tests one 128-triangle cluster per ray,
    in the ray's order of entry distance, until every ray's next cluster is
    past its best hit (or, for any_hit, the ray is blocked)."""
    r, c = entry.shape
    order = torch.argsort(entry, dim=1, stable=True)
    n_hit = (entry < T_MAX).sum(dim=1)
    order_t = order.T.contiguous()                                  # (C, R)
    entry_sorted_t = torch.gather(entry, 1, order).T.contiguous()   # (C, R)
    ox, oy, oz = (a[:, None] for a in o.unbind(-1))
    dx, dy, dz = (a[:, None] for a in d.unbind(-1))
    s = {
        "t": t_max.clone(),
        "u": torch.zeros(r, dtype=torch.float32, device=o.device),
        "v": torch.zeros(r, dtype=torch.float32, device=o.device),
        "tri": torch.full((r,), -1, dtype=torch.int32, device=o.device),
        "blocked": torch.zeros(r, dtype=torch.bool, device=o.device),
    }

    def ray_done(i):
        done = (i >= n_hit) | (entry_sorted_t[min(i, c - 1)] >= s["t"])
        return done | s["blocked"] if any_hit else done

    def step(i):
        cid = order_t[min(i, c - 1)]
        active = ~ray_done(i)
        p0, e1, e2 = cs.p0_b[cid], cs.e1_b[cid], cs.e2_b[cid]       # (R, K, 3)
        t, u, v, hit = intersect.mt_intersect(ox, oy, oz, dx, dy, dz, *p0.unbind(-1),
                                              *e1.unbind(-1), *e2.unbind(-1))
        hit = hit & active[:, None] & (t < s["t"][:, None])
        t = torch.where(hit, t, T_MAX)
        arg = torch.argmin(t, dim=-1, keepdim=True)
        tmin = torch.gather(t, 1, arg)[:, 0]
        closer = tmin < s["t"]
        s["t"] = torch.where(closer, tmin, s["t"])
        s["u"] = torch.where(closer, torch.gather(u, 1, arg)[:, 0], s["u"])
        s["v"] = torch.where(closer, torch.gather(v, 1, arg)[:, 0], s["v"])
        tri_hit = (cid * CLUSTER_SIZE + arg[:, 0]).to(torch.int32)
        s["tri"] = torch.where(closer, tri_hit, s["tri"])
        s["blocked"] = s["blocked"] | hit.any(dim=-1)

    i = 0
    while i < min(K_PREFIX, c) or (i < c and not bool(ray_done(i).all())):
        step(i)
        i += 1
    return s


def _chunked(fn, origin, direction, t_max, ray_chunk: int):
    r = origin.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device).expand(r).contiguous()
    outs = [fn(origin[a:a + ray_chunk], direction[a:a + ray_chunk], t_max[a:a + ray_chunk])
            for a in range(0, r, ray_chunk)]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return torch.cat(outs)


def closest_hit_clustered(cs: ClusterSet, origin, direction, t_max=T_MAX,
                          ray_chunk: int = 1 << 16) -> dict:
    """Closest hit of (R, 3) rays: dict(t, u, v, tri), t = t_max and tri = -1
    on a miss. Rays are independent, so chunking over them (to bound the
    (R, C) matrices) changes no result."""
    def run(o, d, tm):
        s = _scan_clusters(o, d, _cluster_entry(o, d, cs.bounds_min, cs.bounds_max, tm),
                           cs, tm, False)
        return {k: s[k] for k in ("t", "u", "v", "tri")}

    return _chunked(run, origin, direction, t_max, ray_chunk)


def any_hit_clustered(cs: ClusterSet, origin, direction, t_max,
                      ray_chunk: int = 1 << 16) -> torch.Tensor:
    """(R,) bool: True where a triangle is hit strictly inside (1e-5, t_max)."""
    def run(o, d, tm):
        s = _scan_clusters(o, d, _cluster_entry(o, d, cs.bounds_min, cs.bounds_max, tm),
                           cs, tm, True)
        return s["blocked"] & (s["t"] < tm)

    return _chunked(run, origin, direction, t_max, ray_chunk)
