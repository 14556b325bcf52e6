"""Geometry helpers — ml.hlsli ``Geometry::*`` equivalents + ray offsets.

Vector ops are written per component, not as ``sum``/``einsum`` over the
trailing axis, so the order of every add is fixed and the same on the CPU
and on the card.
"""

from __future__ import annotations

import torch


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v, eps: float = 1e-15):
    """Gradient-safe |v| (sqrt of a clamped argument)."""
    return torch.sqrt(torch.clamp_min(dot3(v, v), eps * eps))


def normalize(v, eps: float = 1e-15):
    n2 = dot3(v, v)[..., None]
    return v * torch.rsqrt(torch.clamp_min(n2, eps * eps))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def rotate_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors [..., 3] by the upper 3x3 of a (4, 4) or (3, 3) matrix."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [m[i, 0] * vx + m[i, 1] * vy + m[i, 2] * vz for i in range(3)], dim=-1
    )


def affine_transform(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) affine matrix to points [..., 3]."""
    return rotate_vector(m, p) + m[:3, 3]


def orthonormal_basis(n: torch.Tensor):
    """Right-handed TBN around unit normal n (Frisvad / Pixar revised).
    Returns (t, b) with n = t x b."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -torch.reciprocal(s + nz)
    bv = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * bv, -s * nx], dim=-1)
    b = torch.stack([bv, s + ny * ny * a, -ny], dim=-1)
    return t, b


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * dot3(v, n)[..., None] * n


def offset_ray(p: torch.Tensor, n: torch.Tensor, view_z, unproject, offset_pixels: float):
    """Self-intersection offset along the normal: pixels of world size at
    the hit's depth, clamped to 1e-5."""
    w = torch.abs(view_z) * unproject * offset_pixels
    w = torch.clamp_min(w, 1e-5)
    return p + n * w[..., None]


def smoothstep(a, b, x):
    """Hermite smoothstep that also takes decreasing edges (a > b)."""
    d = b - a
    if isinstance(d, torch.Tensor):
        tiny = torch.where(d >= 0, 1e-15, -1e-15)
        d = torch.where(torch.abs(d) < 1e-15, tiny, d)
    elif abs(d) < 1e-15:
        d = 1e-15 if d >= 0 else -1e-15
    t = torch.clamp((x - a) / d, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def pow01(x, e):
    """x^e on [0, 1], zero (with a finite gradient) at 0."""
    xc = torch.clamp(x, 0.0, 1.0)
    safe = torch.pow(torch.clamp_min(xc, 1e-9), e)
    return torch.where(xc <= 0.0, 0.0, safe)


def sqrt01(x):
    xc = torch.clamp(x, 0.0, 1.0)
    return torch.where(xc <= 0.0, 0.0, torch.sqrt(torch.clamp_min(xc, 1e-12)))


def positive_rcp(x, eps: float = 1e-15):
    return torch.reciprocal(torch.clamp_min(x, eps))
