"""Trace dispatch (counterpart of ``nrdsample_tpu/ops/traversal.py``).

Triangle ranges of at most ``DENSE_CUTOFF`` triangles are traced by brute
force ("dense"); larger ones in "cluster" mode, over 128-triangle clusters in
BVH order. A scene with glass gets two contexts (``build_scene_contexts``):
the opaque and the transparent range of one merged scene. Each query picks
its path by the device of the rays: a CUDA tensor launches a kernel (the
dense hit kernel, or a packet kernel: the streaming one for slabs larger than
``packet.PACKET_VMEM_LIMIT``) or raises, a CPU tensor takes the kernel's
plain version. Hit results carry no gradient. ``scene/instances.refit_context``
gives the context of an instanced scene's moved geometry.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.ops import cluster, dense_cuda, intersect, packet

T_MAX = intersect.T_MAX
DENSE_CUTOFF = dense_cuda.MAX_TRIS


class TraceContext:
    """Acceleration data for one triangle range. ``mode`` is "dense" or
    "cluster"; cluster mode carries the ``ClusterSet`` and the triangle
    permutation ``order`` (order[new] = old). ``tri_offset`` is the range's
    first index in the merged scene (hit indices are returned in the merged
    scene's numbering); ``emissive`` is the emissive cluster set of
    ``render/emissive_is.build_emissive_clusters`` (None for small emitter
    sets and off the card)."""

    def __init__(self, tris, mode: str, clusters=None, order=None, tri_offset: int = 0,
                 emissive=None):
        self.tris = tris
        self.mode = mode
        self.clusters = clusters
        self.order = order
        self.tri_offset = tri_offset
        self.emissive = emissive


class SceneContexts:
    """The opaque and the transparent context over one merged scene: the
    world's two instance masks (FLAG_NON_TRANSPARENT, FLAG_TRANSPARENT).
    ``transparent`` is None for a scene without glass."""

    def __init__(self, opaque: TraceContext, transparent: TraceContext | None):
        self.opaque = opaque
        self.transparent = transparent


def check_scene_supported(scene, mode: str | None) -> None:
    """Raise NotImplementedError for a dense context over more triangles
    than the dense hit kernel takes."""
    n = scene.tris.count
    if mode == "dense" and n > DENSE_CUTOFF:
        raise NotImplementedError(
            f"{n} triangles > DENSE_CUTOFF={DENSE_CUTOFF}: the dense hit kernel takes at most "
            f"{DENSE_CUTOFF}; use cluster mode")


def _tris_context(tris, mode: str | None, device):
    """(TraceContext, tris') of a bare TriangleSoA on ``device``; in cluster
    mode tris' is reordered and padded."""
    if mode is None:
        mode = "dense" if tris.count <= DENSE_CUTOFF else "cluster"
    if mode not in ("dense", "cluster"):
        raise NotImplementedError(f"traversal mode {mode!r} is not ported")
    if mode == "dense":
        tris = tris.to(device)
        return TraceContext(tris, "dense"), tris
    cs, tris_p, order = cluster.build_clusters(tris)
    tris_p = tris_p.to(device)
    return TraceContext(tris_p, "cluster", clusters=cs.to(device), order=order), tris_p


def _permute_instances(scene, new_to_old: np.ndarray):
    """scene.tri_instance in the new triangle numbering (new_to_old[new] =
    old, -1 for a padded triangle, which gets instance 0); None stays None."""
    if scene.tri_instance is None:
        return None
    ids = scene.tri_instance.cpu().numpy()
    return torch.from_numpy(np.where(new_to_old >= 0, ids[np.clip(new_to_old, 0, None)],
                                     0).astype(np.int32))


def _padded_order(order: np.ndarray, count: int) -> np.ndarray:
    return np.concatenate([order, np.full(count - len(order), -1, np.int64)])


def _remap_emissive(scene, old_to_new: np.ndarray) -> torch.Tensor:
    em = scene.emissive_tris.cpu().numpy()
    return torch.from_numpy(
        np.where(em >= 0, old_to_new[np.clip(em, 0, len(old_to_new) - 1)], -1).astype(np.int32))


def build_context(scene, mode: str | None = None, device=None):
    """Returns (TraceContext, scene') with scene' on ``device`` (the CUDA card
    when None). ``mode`` None picks "dense" up to DENSE_CUTOFF triangles and
    "cluster" above. In cluster mode scene' has its triangles reordered and
    padded (hit indices decode against it), its emissive list remapped
    through the permutation and its ``tri_instance`` (if any) permuted with
    the triangles; always use scene' with this context. Every
    triangle is in the one context, glass included: ``build_scene_contexts``
    splits off the transparent ones."""
    from nrdsample_tpu_torch.render import emissive_is

    device = resolve(device)
    check_scene_supported(scene, mode)
    ctx, tris = _tris_context(scene.tris, mode, device)
    ctx.emissive = emissive_is.build_emissive_clusters(scene, device)
    if ctx.mode == "dense":
        return ctx, scene.to(device)
    inv = np.empty(len(ctx.order), np.int32)
    inv[ctx.order] = np.arange(len(ctx.order), dtype=np.int32)
    scene = dataclasses.replace(scene, tris=tris, emissive_tris=_remap_emissive(scene, inv),
                                tri_instance=_permute_instances(
                                    scene, _padded_order(ctx.order, tris.count)))
    return ctx, scene.to(device)


def build_scene_contexts(scene, mode: str | None = None, device=None):
    """Split the scene into its opaque and transparent triangles, build a
    context for each (``mode`` None picks dense or cluster per range) and
    return (SceneContexts, merged scene') on ``device``: scene' holds the
    opaque range (reordered, padded) then the transparent one, the emissive
    list remapped, as the JAX package's ``build_scene_contexts`` builds it.
    A scene without glass gets ``build_context``'s context and no
    transparent one."""
    from nrdsample_tpu_torch.render import emissive_is

    device = resolve(device)
    check_scene_supported(scene, mode)
    flags = scene.materials.flags.cpu().numpy()[scene.tris.material.cpu().numpy()]
    is_trans = (flags & cfgmod.FLAG_TRANSPARENT) != 0
    if not is_trans.any():
        ctx, scene2 = build_context(scene, mode, device)
        return SceneContexts(ctx, None), scene2
    ids_o, ids_t = np.nonzero(~is_trans)[0], np.nonzero(is_trans)[0]

    def gather(ids):
        idx = torch.from_numpy(ids.astype(np.int64))
        return type(scene.tris)(**{f.name: getattr(scene.tris, f.name).cpu()[idx]
                                   for f in dataclasses.fields(scene.tris)})

    ctx_o, tris_o = _tris_context(gather(ids_o), mode, device)
    ctx_t, tris_t = _tris_context(gather(ids_t), mode, device)
    offset = tris_o.count
    ctx_t.tri_offset = offset
    merged = type(tris_o)(**{f.name: torch.cat([getattr(tris_o, f.name), getattr(tris_t, f.name)])
                             for f in dataclasses.fields(tris_o)})
    # old scene index -> merged index, through both ranges' permutations
    if ctx_o.order is not None:
        ids_o = ids_o[ctx_o.order]
    if ctx_t.order is not None:
        ids_t = ids_t[ctx_t.order]
    old_to_new = np.full(scene.tris.count, -1, np.int64)
    old_to_new[ids_o] = np.arange(len(ids_o))
    old_to_new[ids_t] = offset + np.arange(len(ids_t))
    ctx_o.emissive = emissive_is.build_emissive_clusters(scene, device)
    new_to_old = np.concatenate([_padded_order(ids_o, tris_o.count),
                                 _padded_order(ids_t, tris_t.count)])
    scene2 = dataclasses.replace(scene, tris=merged, emissive_tris=_remap_emissive(scene, old_to_new),
                                 tri_instance=_permute_instances(scene, new_to_old))
    return SceneContexts(ctx_o, ctx_t), scene2.to(device)


def closest_hit(ctx: TraceContext, origin, direction, t_max=T_MAX, coherent: bool = True) -> dict:
    """Closest hit of each ray: dict(t, u, v, tri), t = t_max and tri = -1 on
    a miss, tri in the merged scene's numbering (``ctx.tri_offset``).
    ``coherent=False`` (divergent bounce and shadow waves) re-bins the rays
    into coherent packets on the packet path."""
    tr = ctx.tris
    origin, direction = origin.detach().contiguous(), direction.detach().contiguous()
    dev = origin.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no hit path for device {origin.device}")
    if ctx.mode == "dense":
        if dev == "cuda":
            res = dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, origin, direction, t_max)
        else:
            res = intersect.intersect_dense(origin, direction, tr.p0, tr.e1, tr.e2, t_max)
    elif dev == "cuda":
        res = packet.closest_hit_packet_cuda(ctx.clusters, origin, direction, t_max,
                                             sort=not coherent)
    else:
        res = cluster.closest_hit_clustered(ctx.clusters, origin, direction, t_max)
    if ctx.tri_offset:
        res = dict(res, tri=torch.where(res["tri"] >= 0, res["tri"] + ctx.tri_offset, -1))
    return res


def closest_hit_alpha(ctx: TraceContext, scene, origin, direction, t_max=T_MAX,
                      rounds: int = 4, coherent: bool = True) -> dict:
    """Closest hit with the alpha test: a hit on a FLAG_ALPHA_TEST material
    whose alpha (``textures.sample_alpha``) is below 0.5 is transparent. The
    rays that met one are traced again just past it, up to ``rounds`` times,
    through ``closest_hit`` with their t_max cut by the distance skipped (a
    round no ray needs is skipped); t is reported from the original origin.
    A scene without alpha-tested textures is ``closest_hit``."""
    if not scene.has_alpha_test or scene.textures is None:
        return closest_hit(ctx, origin, direction, t_max, coherent=coherent)
    from nrdsample_tpu_torch.scene import textures as tex_mod

    origin, direction = origin.detach(), direction.detach()
    tr = scene.tris
    t_max_arr = torch.as_tensor(t_max, dtype=torch.float32, device=origin.device)
    t_max_arr = t_max_arr.expand(origin.shape[:1]).contiguous()
    res = closest_hit(ctx, origin, direction, t_max_arr, coherent=coherent)
    offset = torch.zeros_like(res["t"])   # distance skipped so far, per ray
    with torch.no_grad():
        for _ in range(rounds):
            tri = torch.clamp_min(res["tri"], 0).long()
            mat = tr.material[tri].long()
            needs_test = (res["tri"] >= 0) & ((scene.materials.flags[mat]
                                               & cfgmod.FLAG_ALPHA_TEST) != 0)
            u, v = res["u"], res["v"]
            w = 1.0 - u - v
            uv = w[..., None] * tr.uv0[tri] + u[..., None] * tr.uv1[tri] + v[..., None] * tr.uv2[tri]
            reject = needs_test & (tex_mod.sample_alpha(scene.textures, mat, uv) < 0.5)
            new_offset = torch.where(reject, offset + res["t"] + 1e-4, offset)
            if bool(reject.any()):
                o2 = origin + direction * new_offset[..., None]
                res2 = closest_hit(ctx, o2, direction, t_max_arr - new_offset, coherent=coherent)
                res = {k: torch.where(reject, res2[k], res[k]) for k in ("t", "u", "v", "tri")}
            offset = new_offset
    return dict(res, t=torch.where(res["tri"] >= 0, res["t"] + offset, res["t"]))


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
                                             sort=not coherent, any_hit=True, need_uv=False)
        return (res["tri"] >= 0) & (res["t"] < t_max_arr)
    if origin.device.type == "cpu":
        return cluster.any_hit_clustered(ctx.clusters, origin, direction, t_max_arr)
    raise ValueError(f"no hit path for device {origin.device}")
