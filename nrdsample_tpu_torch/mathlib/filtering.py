"""Sampling filters: clamp-to-edge bilinear and the 5-tap bicubic without
corners (counterpart of ``nrdsample_tpu/mathlib/filtering.py``).

``sample_bilinear`` is the plain version of the bilinear gather kernel
(``csrc/bilinear_sample.cu``): the kernel evaluates the same clamp, floor and
weight expression in the same order.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def _gather2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    h, w = img.shape[0], img.shape[1]
    return img[torch.clamp(iy, 0, h - 1), torch.clamp(ix, 0, w - 1)]


def sample_bilinear(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W) or (H, W, C) at pos [..., 2] = (x, y) in
    pixel units, clamp-to-edge. Returns [...] or [..., C]."""
    p = pos - 0.5
    i0 = torch.floor(p).to(torch.int32)
    f = p - i0
    x0, y0 = i0[..., 0], i0[..., 1]
    fx, fy = f[..., 0:1], f[..., 1:2]
    if img.dim() == 2:
        fx, fy = fx[..., 0], fy[..., 0]
    c00 = _gather2d(img, x0, y0)
    c10 = _gather2d(img, x0 + 1, y0)
    c01 = _gather2d(img, x0, y0 + 1)
    c11 = _gather2d(img, x0 + 1, y0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)


def sample_bicubic_no_corners(img: torch.Tensor, pos: torch.Tensor, sharpness: float = 0.66,
                              bilinear_fn=sample_bilinear) -> torch.Tensor:
    """5-tap bicubic with the corners dropped (BicubicFilterNoCorners,
    Shared.hlsli:349-387) of img (H, W, C) at pos (..., 2), as five bilinear
    taps through ``bilinear_fn``."""
    center = torch.floor(pos - 0.5) + 0.5
    f = geo.clip(pos - center, 0.0, 1.0)
    f2 = f * f
    f3 = f * f2
    s = sharpness
    w0 = -s * f3 + 2.0 * s * f2 - s * f
    w1 = (2.0 - s) * f3 - (3.0 - s) * f2 + 1.0
    w2 = -(2.0 - s) * f3 + (3.0 - 2.0 * s) * f2 + s * f
    w3 = s * f3 - s * f2
    wl2 = w1 + w2
    tc2 = center + w2 / geo.clip_min(wl2, 1e-15)
    tc0 = center - 1.0
    tc3 = center + 2.0

    def tap(px, py):
        return bilinear_fn(img, torch.stack([px, py], dim=-1))

    w = wl2[..., 0] * w0[..., 1]
    color = tap(tc2[..., 0], tc0[..., 1]) * w[..., None]
    total = w
    w = w0[..., 0] * wl2[..., 1]
    color = color + tap(tc0[..., 0], tc2[..., 1]) * w[..., None]
    total = total + w
    w = wl2[..., 0] * wl2[..., 1]
    color = color + tap(tc2[..., 0], tc2[..., 1]) * w[..., None]
    total = total + w
    w = w3[..., 0] * wl2[..., 1]
    color = color + tap(tc3[..., 0], tc2[..., 1]) * w[..., None]
    total = total + w
    w = wl2[..., 0] * w3[..., 1]
    color = color + tap(tc2[..., 0], tc3[..., 1]) * w[..., None]
    total = total + w
    return color / geo.clip_min(total, 1e-15)[..., None]
