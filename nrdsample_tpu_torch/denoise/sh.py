"""SH-mode resolve (counterpart of ``nrdsample_tpu/denoise/sh.py``): each
lobe's radiance travels with its luminance-weighted mean sampling direction,
and composition re-sharpens the denoised radiance with the cosine between
that direction and the shading normal (Composition.cs.hlsl:95-123)."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import color, geometry as geo


def pack(radiance: torch.Tensor, direction: torch.Tensor) -> dict:
    """(N, 3) radiance + (N, 3) direction -> the filterable SH planes."""
    return {"radiance": radiance, "dir": direction * color.luminance(radiance)[..., None]}


def resolve(sh: dict, normal: torch.Tensor) -> torch.Tensor:
    """radiance * max(1 + conf * (2 cos - 1), 0), with cos between the
    normalized mean direction and the normal, and conf = |mean dir| /
    luminance clamped to [0, 1]: a short (widely spread) direction falls back
    to flat irradiance. (JAX's roughness and is_spec arguments do not change
    the result and are not taken.)"""
    d = sh["dir"]
    dlen = geo.length(d)
    dn = d * geo.positive_rcp(dlen)[..., None]
    cos = geo.clip(geo.dot3(dn, normal), 0.0, 1.0)
    lum = color.luminance(sh["radiance"])
    conf = geo.clip(dlen / geo.clip_min(lum, 1e-6), 0.0, 1.0)
    scale = 1.0 + conf * (2.0 * cos - 1.0)
    return sh["radiance"] * geo.clip_min(scale, 0.0)[..., None]
