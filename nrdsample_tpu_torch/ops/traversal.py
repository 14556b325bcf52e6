"""Trace dispatch, dense branch (counterpart of ``nrdsample_tpu/ops/traversal.py``).

Scenes with at most ``DENSE_CUTOFF`` triangles are traced by brute force:
the dense hit kernel on the card, its plain version on the CPU, chosen by
the device of the ray tensors. Hit results carry no gradient.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.ops import dense_cuda, emissive_probe, intersect

T_MAX = intersect.T_MAX
DENSE_CUTOFF = dense_cuda.MAX_TRIS
DENSE_EMISSIVE_MAX = emissive_probe.MAX_TRIS


class TraceContext:
    """Acceleration data for a scene; ``mode`` is "dense" in this port."""

    def __init__(self, tris, mode: str):
        self.tris = tris
        self.mode = mode


def check_scene_supported(scene) -> None:
    """Raise NotImplementedError for scenes the dense slice does not trace."""
    n = scene.tris.count
    if n > DENSE_CUTOFF:
        raise NotImplementedError(
            f"{n} triangles > DENSE_CUTOFF={DENSE_CUTOFF}: cluster-mode traversal "
            "(packet kernel) is ported in slice 2 (shaderballs512)")
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
    """Returns (TraceContext, scene') with scene' on ``device`` (the scene's
    own device when None). Only dense mode exists in this port."""
    mode = mode or "dense"
    if mode != "dense":
        raise NotImplementedError(f"traversal mode {mode!r} is ported in a later slice")
    check_scene_supported(scene)
    if device is not None:
        scene = scene.to(device)
    return TraceContext(scene.tris, "dense"), scene


def closest_hit(ctx: TraceContext, origin, direction, t_max=T_MAX, coherent: bool = True) -> dict:
    """Closest hit of each ray: dict(t, u, v, tri), t = t_max and tri = -1 on
    a miss. CUDA rays launch the dense hit kernel (or raise); CPU rays take
    its plain version. ``coherent`` is accepted for the JAX signature; dense
    traversal has no ray re-binning."""
    tr = ctx.tris
    origin, direction = origin.detach().contiguous(), direction.detach().contiguous()
    if origin.device.type == "cuda":
        return dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, origin, direction, t_max)
    if origin.device.type == "cpu":
        return intersect.intersect_dense(origin, direction, tr.p0, tr.e1, tr.e2, t_max)
    raise ValueError(f"no dense hit path for device {origin.device}")


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
    """True where the segment [0, t_max] is blocked."""
    return any_hit_t(ctx, origin, direction, t_max, coherent)[0]
