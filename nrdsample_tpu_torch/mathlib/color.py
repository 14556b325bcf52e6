"""Color helpers — ml.hlsli ``Color::*`` equivalents."""

from __future__ import annotations

import torch

LUMA = (0.2126, 0.7152, 0.0722)


def luminance(c: torch.Tensor) -> torch.Tensor:
    return c[..., 0] * LUMA[0] + c[..., 1] * LUMA[1] + c[..., 2] * LUMA[2]


def from_gamma(c, gamma: float = 2.2):
    return torch.pow(torch.clamp(c, 0.0, 1.0), gamma)
