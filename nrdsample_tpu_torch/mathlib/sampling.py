"""Importance sampling — ml.hlsli ``ImportanceSampling::{Cosine, VNDF}``.

Samplers take uniform [0, 1)^2 inputs and return z-up local directions."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo

TWO_PI = 6.283185307179586
PI = 3.141592653589793


def cosine_ray(rnd2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample, [..., 2] -> [..., 3]."""
    phi = rnd2[..., 0] * TWO_PI
    cos_theta = torch.sqrt(geo.clip_min(1.0 - rnd2[..., 1], 0.0))
    sin_theta = torch.sqrt(rnd2[..., 1])
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def vndf_ggx(rnd2: torch.Tensor, v_local: torch.Tensor, roughness, trim: float = 1.0) -> torch.Tensor:
    """GGX visible-normal sample (Heitz 2018) in z-up local space; returns the
    half-vector m. ``trim`` scales the sampled disk (PT_SPEC_LOBE_ENERGY)."""
    alpha = roughness * roughness
    a = torch.stack([alpha * v_local[..., 0], alpha * v_local[..., 1], v_local[..., 2]], dim=-1)
    vh = geo.normalize(a)
    lensq = vh[..., 0] * vh[..., 0] + vh[..., 1] * vh[..., 1]
    t1_perp = torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1) / (
        torch.sqrt(geo.clip_min(lensq, 1e-12))[..., None]
    )
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device)
    t1 = torch.where((lensq > 1e-12)[..., None], t1_perp, x_axis)
    t2 = geo.cross(vh, t1)
    r = torch.sqrt(geo.clip_min(rnd2[..., 0], 0.0)) * trim
    phi = TWO_PI * rnd2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(geo.clip_min(1.0 - p1 * p1, 0.0)) + s * p2
    pz = torch.sqrt(geo.clip_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * vh
    m = torch.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1], geo.clip_min(nh[..., 2], 1e-6)], dim=-1
    )
    return geo.normalize(m)


def ggx_d(n_dot_m: torch.Tensor, alpha) -> torch.Tensor:
    a2 = alpha * alpha
    c = geo.clip_min(n_dot_m, 0.0)
    denom = c * c * (a2 - 1.0) + 1.0
    return a2 / geo.clip_min(PI * denom * denom, 1e-15)


def smith_g1(n_dot_v: torch.Tensor, alpha) -> torch.Tensor:
    a2 = alpha * alpha
    c = geo.clip_min(n_dot_v, 1e-6)
    return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))


def to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Rotate a z-up local direction into the frame around world normal n."""
    t, b = geo.orthonormal_basis(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def to_local(world: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    t, b = geo.orthonormal_basis(n)
    return torch.stack([geo.dot3(world, t), geo.dot3(world, b), geo.dot3(world, n)], dim=-1)
