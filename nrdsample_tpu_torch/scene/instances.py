"""Instanced dynamic scenes (counterpart of ``nrdsample_tpu/scene/instances.py``):
the TLAS rebuild of GatherInstanceData (NRDSample.cpp:3395-3630) and the
acceleration-structure refit (3907-3944).

The instances' triangles are flattened once, at the rest pose, with their
cluster assignment frozen there; each frame ``transform_scene`` moves every
triangle by its instance's (3, 4) transform and ``refit_context`` recomputes
the cluster boxes, the cluster-major blocks, the packet kernels' slab and the
supercluster boxes on the device of the geometry, with no host round trip.
``prev_position`` gives a hit point's position in the previous frame (the
worldToWorldPrev motion matrix), from which ``render/trace_opaque`` takes the
motion vectors of moving objects.

The 3x3 products are written out as sums over j in order, each product and
sum its own elementwise op: that is the JAX package's arithmetic without
FMA, on the CPU and on the card alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.scene.types import Scene, _to

#: the refit's box of a padded triangle and a padded supercluster slot (the
#: JAX package's refit value; ``ops/cluster.build_clusters`` pads with inf)
PAD_BOUND = 3.0e37


@dataclasses.dataclass
class InstancedScene:
    """A scene at the rest pose (as ``build_context`` returned it: reordered
    and padded in cluster mode) and the instance of each of its triangles.
    The transforms are per-frame inputs, not state."""

    scene: Scene
    instance_id: torch.Tensor    # (T,) int32, 0 = the static background
    n_instances: int = 1
    # optional (I, 10) per-instance material scales (see Scene.instance_scales)
    instance_scales: torch.Tensor | None = None

    def to(self, device) -> "InstancedScene":
        return _to(self, device)


def assign_instance_ids(scene: Scene, tri_instance: np.ndarray, ctx,
                        instance_scales=None) -> InstancedScene:
    """The InstancedScene of ``scene`` and ``ctx`` (after ``build_context``):
    the host's per-triangle instance ids are permuted through the context's
    triangle order and padded with 0. ``instance_scales``: optional (I, 10)
    rows [baseColor.xyz, metalness, emission.xyz, roughness, normalUv.xy]
    (the InstanceData scale factors, RaytracingShared.hlsli:456-468)."""
    device = scene.tris.p0.device
    order = getattr(ctx, "order", None)
    tri_instance = np.asarray(tri_instance, np.int32)
    ids = tri_instance if order is None else tri_instance[np.asarray(order)]
    t_dev = scene.tris.count
    if len(ids) < t_dev:   # cluster padding
        ids = np.concatenate([ids, np.zeros(t_dev - len(ids), np.int32)])
    return InstancedScene(
        scene=scene,
        instance_id=torch.from_numpy(ids).to(device),
        n_instances=int(tri_instance.max()) + 1 if len(tri_instance) else 1,
        instance_scales=(None if instance_scales is None else torch.as_tensor(
            np.asarray(instance_scales, np.float32)).to(device)),
    )


def identity_transforms(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 3, 4) identity transforms on ``device`` (the CUDA card when None)."""
    m = torch.zeros((n, 3, 4), dtype=dtype, device=resolve(device))
    m[:, :, :3] = torch.eye(3, dtype=dtype, device=m.device)
    return m


def _mv(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3), summed over j in order."""
    return r[..., 0] * v[..., 0:1] + r[..., 1] * v[..., 1:2] + r[..., 2] * v[..., 2:3]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3), column by column through ``_mv``."""
    return torch.stack([_mv(a, b[..., k]) for k in range(3)], dim=-1)


def transform_scene(inst: InstancedScene, transforms: torch.Tensor) -> Scene:
    """The scene moved by (n_instances, 3, 4) ``transforms``: points, edges,
    and vertex normals and tangents rotated and renormalised (the orbits are
    rigid, so the inverse transpose is not needed)."""
    tr = inst.scene.tris
    m = transforms[inst.instance_id.long()]    # (T, 3, 4)
    r = m[:, :, :3]
    t = m[:, :, 3]

    def xf_normal(nrm):
        out = _mv(r, nrm)
        return out / torch.clamp_min(torch.linalg.norm(out, dim=-1, keepdim=True), 1e-20)

    new_tris = dataclasses.replace(
        tr,
        p0=_mv(r, tr.p0) + t, e1=_mv(r, tr.e1), e2=_mv(r, tr.e2),
        n0=xf_normal(tr.n0), n1=xf_normal(tr.n1), n2=xf_normal(tr.n2),
        t0=xf_normal(tr.t0), t1=xf_normal(tr.t1), t2=xf_normal(tr.t2),
    )
    return dataclasses.replace(
        inst.scene, tris=new_tris,
        tri_instance=inst.instance_id if inst.instance_scales is not None else None,
        instance_scales=inst.instance_scales,
    )


def _invert_3x4(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (N, 3, 4) affine transforms (the 3x3 through its
    adjugate; a determinant below 1e-20 in magnitude divides by 1e-20)."""
    r = m[..., :3]
    t = m[..., 3]
    c0, c1, c2 = r[..., :, 0], r[..., :, 1], r[..., :, 2]
    det = (r[..., :, 0] * geo.cross(c1, c2)).sum(dim=-1, keepdim=True)[..., None]
    inv_r = torch.stack([geo.cross(c1, c2), geo.cross(c2, c0), geo.cross(c0, c1)], dim=-2)
    inv_r = inv_r / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    inv_t = -_mv(inv_r, t)
    return torch.cat([inv_r, inv_t[..., None]], dim=-1)


def prev_position(inst: InstancedScene, m_curr: torch.Tensor, m_prev: torch.Tensor,
                  x: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """The previous frame's position of hit points ``x`` (N, 3) on triangles
    ``tri`` (N,): x_prev = M_prev M_curr^-1 x by the hit triangle's instance
    (the dynamic worldToWorldPrev of GatherInstanceData); a miss (tri < 0)
    keeps x. The (I, 3, 4) motion matrices are formed per instance, then
    gathered per point."""
    inv = _invert_3x4(m_curr)
    w2w = _mm(m_prev[..., :3], inv[..., :3])                  # (I, 3, 3)
    t_rel = m_prev[..., 3] + _mv(m_prev[..., :3], inv[..., 3])  # (I, 3)
    tri_safe = torch.clamp(tri, 0, inst.instance_id.shape[0] - 1).long()
    iid = inst.instance_id[tri_safe].long()
    x_prev = _mv(w2w[iid], x) + t_rel[iid]
    return torch.where((tri >= 0)[..., None], x_prev, x)


def refit_context(ctx, world_scene: Scene):
    """A new TraceContext for the moved geometry ``world_scene`` (the
    BLAS/TLAS refit, NRDSample.cpp:2727-2780). Dense mode has nothing to
    refit. Cluster mode keeps the clusters' membership and recomputes, on the
    geometry's device, their boxes, the cluster-major blocks, the slab the
    packet kernels read and the supercluster boxes. A padded triangle (zero
    edges at the rest pose) and a padded supercluster slot get the empty box
    [PAD_BOUND, -PAD_BOUND]. The context keeps ``order`` and ``tri_offset``
    and carries no emissive cluster set."""
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.ops.cluster import (CLUSTER_SIZE, SLAB_ROWS, SUPER_SIZE,
                                                 ClusterSet)

    tr = world_scene.tris
    if ctx.mode == "dense":
        return traversal.TraceContext(tr, "dense", order=ctx.order)
    if ctx.mode != "cluster":
        raise NotImplementedError(f"refit for mode {ctx.mode!r}")
    cs = ctx.clusters
    c = cs.count
    p0b = tr.p0.reshape(c, CLUSTER_SIZE, 3)
    e1b = tr.e1.reshape(c, CLUSTER_SIZE, 3)
    e2b = tr.e2.reshape(c, CLUSTER_SIZE, 3)
    spad = (-c) % SUPER_SIZE
    slab = torch.zeros(((c + spad) * SLAB_ROWS, CLUSTER_SIZE), dtype=tr.p0.dtype,
                       device=tr.p0.device)
    slab.view(c + spad, SLAB_ROWS, CLUSTER_SIZE)[:c, :9] = torch.stack(
        [p0b[..., 0], p0b[..., 1], p0b[..., 2], e1b[..., 0], e1b[..., 1], e1b[..., 2],
         e2b[..., 0], e2b[..., 1], e2b[..., 2]], dim=1)
    p1b = p0b + e1b
    p2b = p0b + e2b
    degenerate = ((cs.e1_b == 0.0).all(dim=-1) & (cs.e2_b == 0.0).all(dim=-1))[..., None]
    lo = torch.where(degenerate, PAD_BOUND, torch.minimum(torch.minimum(p0b, p1b), p2b))
    hi = torch.where(degenerate, -PAD_BOUND, torch.maximum(torch.maximum(p0b, p1b), p2b))
    bmin = lo.amin(dim=1)
    bmax = hi.amax(dim=1)
    bmin_p = torch.cat([bmin, bmin.new_full((spad, 3), PAD_BOUND)])
    bmax_p = torch.cat([bmax, bmax.new_full((spad, 3), -PAD_BOUND)])
    cs_n = (c + spad) // SUPER_SIZE
    new_cs = ClusterSet(
        bounds_min=bmin, bounds_max=bmax, p0_b=p0b, e1_b=e1b, e2_b=e2b, slab=slab,
        super_min=bmin_p.reshape(cs_n, SUPER_SIZE, 3).amin(dim=1),
        super_max=bmax_p.reshape(cs_n, SUPER_SIZE, 3).amax(dim=1),
    )
    return traversal.TraceContext(tr, "cluster", clusters=new_cs, order=ctx.order,
                                  tri_offset=ctx.tri_offset)
