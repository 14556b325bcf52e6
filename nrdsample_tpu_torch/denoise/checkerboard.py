"""Hit-distance reconstruction (counterpart of
``nrdsample_tpu/denoise/checkerboard.py:hitdist_reconstruct_3x3``; the
RESOLUTION_HALF checkerboard resolve belongs to slice 3)."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.denoise import common


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
    fill = num / torch.clamp_min(den, 1.0)
    return torch.where(hitdist > 0.0, hitdist, fill)
