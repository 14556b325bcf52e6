"""Hair BCSDF and subsurface scattering (counterpart of
``nrdsample_tpu/render/hair_sss.py``): the far-field three-lobe (R, TT, TRT)
hair model with Gaussian longitudinal lobes at cuticle-shifted angles and
cosine azimuthal lobes, for FLAG_HAIR surfaces; Burley's normalized
diffusion profile and the wrap-diffuse term it gives the sun lighting of
FLAG_SKIN surfaces. Elementwise PyTorch."""

from __future__ import annotations

import math

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo

# cuticle tilt (degrees) and per-lobe shift, width and gain
HAIR_CUTICLE_TILT_DEG = 3.0
HAIR_LOBE_SHIFTS = (-1.0, 0.5, 1.5)     # R, TT, TRT in units of the tilt
HAIR_LOBE_WIDTHS = (1.0, 0.5, 2.0)      # relative Gaussian widths
HAIR_LOBE_GAINS = (1.0, 1.0, 0.8)


def _gaussian(x, stddev):
    z = x / stddev
    return torch.exp(-0.5 * (z * z)) / (stddev * math.sqrt(2.0 * math.pi))


def hair_bcsdf_eval(wi: torch.Tensor, wo: torch.Tensor, tangent: torch.Tensor,
                    base_color: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Far-field hair BCSDF (RGB) for the light direction wi and the view
    direction wo (both pointing away from the surface); tangent is the
    fibre's direction."""
    sin_ti = torch.clamp(geo.dot3(wi, tangent), -1.0, 1.0)
    sin_to = torch.clamp(geo.dot3(wo, tangent), -1.0, 1.0)
    theta_h = 0.5 * (torch.asin(sin_ti) + torch.asin(sin_to))

    # azimuth: both directions projected onto the fibre's normal plane
    wi_p = geo.normalize(wi - sin_ti[..., None] * tangent)
    wo_p = geo.normalize(wo - sin_to[..., None] * tangent)
    cos_phi = torch.clamp(geo.dot3(wi_p, wo_p), -1.0, 1.0)

    tilt = math.radians(HAIR_CUTICLE_TILT_DEG)
    beta = torch.clamp(roughness, 0.05, 1.0) * 0.3 + 0.05   # longitudinal stddev

    # R is a grey specular, TT and TRT carry the pigment once and twice
    tints = (torch.ones_like(base_color) * 0.25, base_color, base_color * base_color)
    azimuthal = (0.25 * (1.0 + cos_phi), 0.25 * (1.0 - cos_phi) + 0.05,
                 0.20 * (1.0 + cos_phi) + 0.05)
    out = torch.zeros_like(base_color)
    for shift, width, gain, tint, n_az in zip(HAIR_LOBE_SHIFTS, HAIR_LOBE_WIDTHS,
                                              HAIR_LOBE_GAINS, tints, azimuthal):
        m = _gaussian(theta_h - shift * tilt, beta * width)
        out = out + gain * (m * n_az)[..., None] * tint
    cos_theta_o = torch.sqrt(torch.clamp(1.0 - sin_to * sin_to, 1e-4, 1.0))
    return out / cos_theta_o[..., None]


def hair_sample(rnd: torch.Tensor, wo: torch.Tensor, tangent: torch.Tensor,
                roughness: torch.Tensor):
    """A scattered direction: a longitudinal Gaussian (Box-Muller) around the
    reflected inclination and a uniform azimuth about the fibre. rnd (..., 2)
    uniforms. Returns (direction, weight 1)."""
    sin_to = torch.clamp(geo.dot3(wo, tangent), -1.0, 1.0)
    theta_o = torch.asin(sin_to)
    beta = torch.clamp(roughness, 0.05, 1.0) * 0.3 + 0.05
    r1 = torch.clamp(rnd[..., 0], 1e-6, 1.0 - 1e-6)
    r2 = rnd[..., 1]
    g = torch.sqrt(-2.0 * torch.log(r1)) * torch.cos(2.0 * math.pi * r2)
    theta_i = -theta_o + math.radians(HAIR_CUTICLE_TILT_DEG) + g * beta
    theta_i = torch.clamp(theta_i, -0.49 * math.pi, 0.49 * math.pi)

    phi = 2.0 * math.pi * rnd[..., 1]
    b1, b2 = geo.orthonormal_basis(tangent)
    sin_ti, cos_ti = torch.sin(theta_i), torch.cos(theta_i)
    d = (tangent * sin_ti[..., None] + b1 * (cos_ti * torch.cos(phi))[..., None]
         + b2 * (cos_ti * torch.sin(phi))[..., None])
    return geo.normalize(d), torch.ones_like(theta_i)


def burley_profile(r: torch.Tensor, d) -> torch.Tensor:
    """Burley's normalized diffusion R(r), which integrates to 1 over the
    plane."""
    r = torch.clamp_min(r, 1e-5)
    return (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) / (8.0 * math.pi * d * r)


def sss_wrap_diffuse(n_dot_l: torch.Tensor, base_color: torch.Tensor,
                     scatter_distance=0.3) -> torch.Tensor:
    """The subsurface wrap term that replaces the hard cosine on FLAG_SKIN:
    light wraps round the terminator in proportion to the mean free path,
    tinted by the albedo squared."""
    w = torch.clamp(torch.as_tensor(scatter_distance, dtype=n_dot_l.dtype,
                                    device=n_dot_l.device), 0.0, 1.0)
    wrap = torch.clamp((n_dot_l + w) / (1.0 + w), 0.0, 1.0)
    hard = torch.clamp(n_dot_l, 0.0, 1.0)
    return hard[..., None] * torch.ones_like(base_color) + (wrap - hard)[..., None] * (
        base_color * base_color)
