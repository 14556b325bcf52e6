"""Ray cones — texture LOD + curvature-aware spread tracking (counterpart of
``nrdsample_tpu/render/raycone.py``). State is (width, spread) per ray."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def propagate(cone: dict, t: torch.Tensor) -> dict:
    """Grow the cone over a segment of length t."""
    return {"width": cone["width"] + t * cone["spread"], "spread": cone["spread"]}


def reflect(cone: dict, curvature, roughness=None) -> dict:
    """Widen the spread at a bounce by 2|curvature| and a roughness term."""
    spread = cone["spread"] + 2.0 * geo.absolute(curvature)
    if roughness is not None:
        spread = spread + roughness * roughness * 0.25
    return {"width": cone["width"], "spread": spread}



def texture_mip(cone_width, world_area, uv_area, n_dot_v, tex_res: int, max_mip=None):
    """Continuous mip level of a cone hitting a triangle: the cone's footprint
    projected on the surface (divided by |n.v|, clamped to [0.05, 1]), in
    texels through the triangle's uv-to-world density, as 0.5 * log2, at
    least 0 and at most ``max_mip``."""
    n_dot_v = geo.clip(geo.absolute(n_dot_v), 0.05, 1.0)
    texel_density = uv_area * (tex_res * tex_res) / geo.clip_min(world_area, 1e-12)
    width = cone_width / n_dot_v
    mip = 0.5 * torch.log2(geo.clip_min(width * width * texel_density, 1e-20))
    mip = geo.clip_min(mip, 0.0)
    if max_mip is not None:
        mip = geo.clip_max(mip, max_mip)
    return mip


def uv_area(uv0, uv1, uv2):
    """Triangle area in uv space, (T,) of (T, 2) corners."""
    d1 = uv1 - uv0
    d2 = uv2 - uv0
    return 0.5 * geo.absolute(d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0])
