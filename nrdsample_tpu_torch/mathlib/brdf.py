"""GGX microfacet BRDF and environment terms — ml.hlsli ``BRDF::*``."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def fresnel_schlick(f0: torch.Tensor, v_dot_h: torch.Tensor) -> torch.Tensor:
    """Schlick Fresnel; f0 [..., 3], v_dot_h [...]."""
    m = geo.clip(1.0 - v_dot_h, 0.0, 1.0)
    m2 = m * m
    w = (m2 * m2 * m)[..., None]
    return f0 + (1.0 - f0) * w


def smith_g2_correlated(n_dot_v, n_dot_l, alpha):
    """Height-correlated Smith G2 divided by (4 NoV NoL)."""
    a2 = alpha * alpha
    nv = geo.clip_min(n_dot_v, 1e-6)
    nl = geo.clip_min(n_dot_l, 1e-6)
    lv = nl * torch.sqrt(a2 + (1.0 - a2) * nv * nv)
    ll = nv * torch.sqrt(a2 + (1.0 - a2) * nl * nl)
    return 0.5 * torch.reciprocal(geo.clip_min(lv + ll, 1e-9))


def base_color_to_f0_albedo(base_color: torch.Tensor, metalness: torch.Tensor):
    """Metalness workflow split: (albedo, f0)."""
    m = metalness[..., None]
    f0 = 0.04 * (1.0 - m) + base_color * m
    albedo = base_color * (1.0 - m)
    return albedo, f0


def environment_term_rtg(f0: torch.Tensor, n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Split-sum preintegrated environment BRDF (Ray Tracing Gems)."""
    m = geo.clip(roughness, 0.0, 1.0)
    m = m * m
    nv = geo.clip(n_dot_v, 0.0, 1.0)
    x = 1.0 - nv
    x2 = x * x
    x4 = x2 * x2
    bias = torch.exp2(-(7.0 * nv + 4.0 * m)) * m
    scale = 1.0 - bias - m * torch.maximum(bias, torch.minimum(torch.sqrt(m), x4 * x))
    return geo.clip(f0 * scale[..., None] + bias[..., None], 0.0, 1.0)
