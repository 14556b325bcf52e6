"""Trace dispatch (counterpart of ``nrdsample_tpu/ops/traversal.py``).

Scenes of at most ``DENSE_CUTOFF`` triangles are traced by brute force
("dense"); larger ones in "cluster" mode, over 128-triangle clusters in BVH
order. Each query picks its path by the device of the rays: a CUDA tensor
launches the kernel (the dense hit kernel or the packet kernel) or raises, a
CPU tensor takes the kernel's plain version. Hit results carry no gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.ops import cluster, dense_cuda, emissive_probe, intersect, packet

T_MAX = intersect.T_MAX
DENSE_CUTOFF = dense_cuda.MAX_TRIS
DENSE_EMISSIVE_MAX = emissive_probe.MAX_TRIS
MAX_CLUSTERS = packet.FLAT_WORKLIST_MAX_C


class TraceContext:
    """Acceleration data for a scene. ``mode`` is "dense" or "cluster";
    cluster mode carries the ``ClusterSet`` and the triangle permutation
    ``order`` (order[new] = old)."""

    def __init__(self, tris, mode: str, clusters=None, order=None):
        self.tris = tris
        self.mode = mode
        self.clusters = clusters
        self.order = order


def check_scene_supported(scene, mode: str) -> None:
    """Raise NotImplementedError for scenes the port does not trace yet."""
    n = scene.tris.count
    if mode == "dense" and n > DENSE_CUTOFF:
        raise NotImplementedError(
            f"{n} triangles > DENSE_CUTOFF={DENSE_CUTOFF}: the dense hit kernel takes at most "
            f"{DENSE_CUTOFF}; use cluster mode")
    if mode == "cluster" and -(-n // cluster.CLUSTER_SIZE) > MAX_CLUSTERS:
        raise NotImplementedError(
            f"{n} triangles make more than {MAX_CLUSTERS} clusters: the supercluster stage 1 "
            "and the streaming packet kernel are ported in slice 4 (exterior720)")
    n_em = scene.emissive_tris.shape[0]
    if n_em > DENSE_EMISSIVE_MAX:
        raise NotImplementedError(
            f"an emissive set of {n_em} > {DENSE_EMISSIVE_MAX}: the emissive cluster probe "
            "is ported in slice 5 (interior1440)")
    if scene.textures is not None:
        raise NotImplementedError("textured materials are ported in slice 3 (kitchen1080)")
    if scene.has_alpha_test:
        raise NotImplementedError("alpha-tested materials are ported in slice 4 (exterior720)")
    if scene.tri_instance is not None or scene.instance_scales is not None:
        raise NotImplementedError("instance material scales are ported in slice 4 (exterior720)")
    flags = scene.materials.flags[scene.tris.material.long()]
    if bool(((flags & cfgmod.FLAG_TRANSPARENT) != 0).any()):
        raise NotImplementedError(
            "transparent triangles (TraceTransparent) are ported in slice 4 (exterior720)")


def build_context(scene, mode: str | None = None, device=None):
    """Returns (TraceContext, scene') with scene' on ``device`` (the CUDA card
    when None). ``mode`` None picks "dense" up to DENSE_CUTOFF triangles and
    "cluster" above. In cluster mode scene' has its triangles reordered and
    padded (hit indices decode against it) and its emissive list remapped
    through the permutation; always use scene' with this context."""
    device = resolve(device)
    if mode is None:
        mode = "dense" if scene.tris.count <= DENSE_CUTOFF else "cluster"
    if mode not in ("dense", "cluster"):
        raise NotImplementedError(f"traversal mode {mode!r} is not ported")
    check_scene_supported(scene, mode)
    if mode == "dense":
        scene = scene.to(device)
        return TraceContext(scene.tris, "dense"), scene
    cs, tris_p, order = cluster.build_clusters(scene.tris)
    inv = np.empty(len(order), np.int32)
    inv[order] = np.arange(len(order), dtype=np.int32)
    em = scene.emissive_tris.cpu().numpy()
    em_new = np.where(em >= 0, inv[np.clip(em, 0, len(order) - 1)], -1).astype(np.int32)
    scene = dataclasses.replace(scene, tris=tris_p, emissive_tris=torch.from_numpy(em_new))
    scene = scene.to(device)
    return TraceContext(scene.tris, "cluster", clusters=cs.to(device), order=order), scene


def closest_hit(ctx: TraceContext, origin, direction, t_max=T_MAX, coherent: bool = True) -> dict:
    """Closest hit of each ray: dict(t, u, v, tri), t = t_max and tri = -1 on
    a miss. ``coherent=False`` (divergent bounce and shadow waves) re-bins the
    rays into coherent packets on the packet path."""
    tr = ctx.tris
    origin, direction = origin.detach().contiguous(), direction.detach().contiguous()
    dev = origin.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no hit path for device {origin.device}")
    if ctx.mode == "dense":
        if dev == "cuda":
            return dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, origin, direction, t_max)
        return intersect.intersect_dense(origin, direction, tr.p0, tr.e1, tr.e2, t_max)
    if dev == "cuda":
        return packet.closest_hit_packet_cuda(ctx.clusters, origin, direction, t_max,
                                              sort=not coherent)
    return cluster.closest_hit_clustered(ctx.clusters, origin, direction, t_max)


def closest_hit_alpha(ctx: TraceContext, scene, origin, direction, t_max=T_MAX,
                      coherent: bool = True) -> dict:
    """Closest hit with the alpha test; scenes of this port carry no
    alpha-tested material, so this is ``closest_hit``."""
    if getattr(scene, "has_alpha_test", False) and scene.textures is not None:
        raise NotImplementedError("alpha-tested materials are ported in slice 4 (exterior720)")
    return closest_hit(ctx, origin, direction, t_max, coherent=coherent)


def any_hit_t(ctx: TraceContext, origin, direction, t_max, coherent: bool = False):
    """Occlusion with the closest-blocker distance: (blocked (R,) bool,
    t (R,), T_MAX where unblocked)."""
    t_max_arr = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max_arr = t_max_arr.expand(origin.shape[:1]).contiguous()
    res = closest_hit(ctx, origin, direction, t_max_arr, coherent=coherent)
    blocked = (res["tri"] >= 0) & (res["t"] < t_max_arr)
    return blocked, torch.where(blocked, res["t"], T_MAX)


def any_hit(ctx: TraceContext, origin, direction, t_max, coherent: bool = False):
    """True where the segment (0, t_max) is blocked. On the packet path a
    packet stops as soon as all its rays are blocked."""
    if ctx.mode == "dense":
        return any_hit_t(ctx, origin, direction, t_max, coherent)[0]
    origin, direction = origin.detach().contiguous(), direction.detach().contiguous()
    t_max_arr = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max_arr = t_max_arr.expand(origin.shape[:1]).contiguous()
    if origin.device.type == "cuda":
        res = packet.closest_hit_packet_cuda(ctx.clusters, origin, direction, t_max_arr,
                                             sort=not coherent, any_hit=True)
        return (res["tri"] >= 0) & (res["t"] < t_max_arr)
    if origin.device.type == "cpu":
        return cluster.any_hit_clustered(ctx.clusters, origin, direction, t_max_arr)
    raise ValueError(f"no hit path for device {origin.device}")
