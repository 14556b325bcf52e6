"""REFERENCE denoiser: plain temporal accumulation, the converged-image
oracle (counterpart of ``nrdsample_tpu/denoise/reference.py``)."""

from __future__ import annotations

import dataclasses

import torch

REFERENCE_MAX_HISTORY = 1024


@dataclasses.dataclass
class ReferenceHistory:
    accum: torch.Tensor   # (N, 3) running mean
    frames: torch.Tensor  # () int32 frames accumulated

    @staticmethod
    def create(n_pixels: int, dtype=torch.float32, device=None) -> "ReferenceHistory":
        return ReferenceHistory(
            accum=torch.zeros((n_pixels, 3), dtype=dtype, device=device),
            frames=torch.tensor(0, dtype=torch.int32, device=device),
        )


def accumulate(history: ReferenceHistory, radiance: torch.Tensor, reset=False,
               max_frames: int = REFERENCE_MAX_HISTORY):
    """One accumulation step: running mean with a history clamp. ``reset``
    (bool or 0-d bool tensor) clears the history first."""
    reset = torch.as_tensor(reset, device=radiance.device)
    frames = torch.where(reset, 0, history.frames)
    accum = torch.where(reset, 0.0, history.accum)
    n = torch.clamp_max(frames + 1, max_frames).to(radiance.dtype)
    new_accum = accum + (radiance - accum) / n
    return new_accum, ReferenceHistory(accum=new_accum, frames=frames + 1)
