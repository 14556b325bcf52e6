"""Checkerboard (RESOLUTION_HALF) resolve and hit-distance reconstruction
(counterpart of ``nrdsample_tpu/denoise/checkerboard.py``).

In HALF tracing mode each pixel traces one lobe, diffuse and specular
interleaved in a checkerboard that alternates per frame; ``resolve`` fills
each lobe's untraced pixels from their horizontal neighbours, which carry
the signal."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.denoise import common
from nrdsample_tpu_torch.mathlib import geometry as geo, rng


def checkerboard_mask(h: int, w: int, frame) -> torch.Tensor:
    """(H, W) bool on the device of ``frame``: True where the diffuse lobe
    was traced this frame, the tracer's selector ``rng.checkerboard``."""
    device = torch.as_tensor(frame).device
    y = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    x = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return rng.checkerboard(x, y, frame).to(torch.bool)


def resolve(img: torch.Tensor, traced: torch.Tensor) -> torch.Tensor:
    """img (H, W[, C]), valid where ``traced`` (H, W) is True: each other
    pixel takes the mean of its left and right neighbours; at the first and
    last column the neighbour off screen is replaced by the other one."""
    left = torch.roll(img, 1, dims=1)
    right = torch.roll(img, -1, dims=1)
    left[:, 0] = right[:, 0]
    right[:, -1] = left[:, -1]
    fill = 0.5 * (left + right)
    m = traced
    while m.dim() < img.dim():
        m = m[..., None]
    return torch.where(m, img, fill)


def hitdist_reconstruct_3x3(hitdist: torch.Tensor) -> torch.Tensor:
    """AREA_3X3 reconstruction: probabilistic lobe selection leaves the
    unsampled lobe's hit distance at 0; fill each 0 with the mean of the
    valid (> 0) values of its 3x3 neighbourhood (0 stays 0 only where the
    whole neighbourhood is empty). hitdist: (H, W)."""
    valid = (hitdist > 0.0).to(hitdist.dtype)
    num = torch.zeros_like(hitdist)
    den = torch.zeros_like(hitdist)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            num = num + common.shifted(hitdist, dy, dx)
            den = den + common.shifted(valid, dy, dx)
    fill = num / geo.clip_min(den, 1.0)
    return torch.where(hitdist > 0.0, hitdist, fill)
