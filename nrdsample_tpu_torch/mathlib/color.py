"""Color helpers — ml.hlsli ``Color::*`` equivalents, sRGB, the Uncharted 2
tonemap, the inverse tonemap of the confidence mapping, and CIELAB for the
TAA mix boost.

Products are written per component, and a division by a constant as a
multiplication by its reciprocal, so the CPU, PyTorch's CUDA ops and the
port's kernels evaluate the same float32 sequence (PyTorch's CUDA division by
a Python number multiplies by the reciprocal; its CPU division divides).
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo

LUMA = (0.2126, 0.7152, 0.0722)


def luminance(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def from_gamma(c, gamma: float = 2.2):
    return torch.pow(geo.clip(c, 0.0, 1.0), gamma)


def to_gamma(c, gamma: float = 2.2):
    return torch.pow(geo.clip(c, 0.0, 1.0), 1.0 / gamma)


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = geo.clip(c, 0.0, 1.0)
    c_safe = geo.clip_min(c, 0.0031308)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c_safe, 1.0 / 2.4) - 0.055)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    c = geo.clip(c, 0.0, 1.0)
    return torch.where(c <= 0.04045, c * (1.0 / 12.92), torch.pow((c + 0.055) * (1.0 / 1.055), 2.4))


# Uncharted 2 filmic tonemap (Color::HdrToLinear_Uncharted, used in
# ApplyTonemap Shared.hlsli:337 and DlssAfter.cs.hlsl:7-22)
_UA, _UB, _UC, _UD, _UE, _UF, _UW = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2


def _uncharted_curve(x):
    return ((x * (_UA * x + _UC * _UB) + _UD * _UE) / (x * (_UA * x + _UB) + _UD * _UF)) - _UE / _UF


#: the curve at the white point, evaluated in float32
_U_WHITE = float(_uncharted_curve(torch.tensor(_UW, dtype=torch.float32)))


def tonemap_uncharted(c: torch.Tensor, exposure_bias: float = 2.0) -> torch.Tensor:
    return _uncharted_curve(c * exposure_bias) * (1.0 / _U_WHITE)


def inverse_tonemap_lum(y):
    """Approximate inverse of the luminance tonemap curve (the confidence
    mapping of ConfidenceBlur.cs.hlsl:91-103)."""
    y = geo.clip(y, 0.0, 0.99)
    return y / geo.clip_min(1.0 - y, 1e-3)


# CIELAB (Taa.cs.hlsl XyzToLab, 44-54)
RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
           (0.2126729, 0.7151522, 0.0721750),
           (0.0193339, 0.1191920, 0.9503041))
WHITE = (0.950489, 1.0, 1.088840)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """CIELAB of linear RGB [..., 3]. The cube root is pow(x, 1/3) of the
    operand clamped positive, as the TAA kernel computes it (PyTorch has no
    cbrt); against JAX's cbrt it differs by a few float32 ULPs."""
    r, g, b = (geo.clip_min(rgb[..., k], 0.0) for k in range(3))
    f = []
    for k in range(3):
        m = RGB2XYZ[k]
        xyz = (m[0] * r + m[1] * g + m[2] * b) * (1.0 / WHITE[k])
        f.append(torch.where(xyz > 0.008856, torch.pow(geo.clip_min(xyz, 1e-9), 1.0 / 3.0),
                             7.787 * xyz + 16.0 / 116.0))
    return torch.stack([116.0 * f[1] - 16.0, 500.0 * (f[0] - f[1]), 200.0 * (f[1] - f[2])], dim=-1)
