"""The OCCLUSION and DIRECTIONAL_OCCLUSION NRD modes (counterpart of
``nrdsample_tpu/denoise/occlusion.py``): the denoisers take [0, 1]
occlusion planes made from the normalized hit distances in place of the
radiance, and composition lights the albedo with them."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def norm_hitdist(hitdist: torch.Tensor, view_z: torch.Tensor,
                 a: float = 3.0, b: float = 0.1) -> torch.Tensor:
    """Hit distance over (A + B |viewZ|), REBLUR's normalization with its
    default A and B."""
    return hitdist / (a + b * torch.abs(view_z))


def occlusion_from_hitdist(norm_hitdist: torch.Tensor) -> torch.Tensor:
    """Normalized hit distance -> ambient occlusion in [0, 1]."""
    return torch.clamp(norm_hitdist, 0.0, 1.0)


def directional_occlusion(norm_hitdist: torch.Tensor, bounce_dir: torch.Tensor,
                          normal: torch.Tensor) -> torch.Tensor:
    """Bent-normal occlusion: the openness weighted by how well the first
    bounce's direction agrees with the normal."""
    occ = occlusion_from_hitdist(norm_hitdist)
    cos = torch.clamp(geo.dot3(bounce_dir, normal), 0.0, 1.0)
    return occ * (0.25 + 0.75 * cos)


def compose_occlusion(gb: dict, diff_occ: torch.Tensor, spec_occ: torch.Tensor,
                      shadow: torch.Tensor) -> torch.Tensor:
    """Composition of the occlusion modes: the direct light plus the
    demodulation factors lit by the denoised occlusion."""
    direct = gb["direct_lighting"] * shadow[..., None] + gb["emission"]
    return direct + gb["diff_factor"] * diff_occ[..., None] + gb["spec_factor"] * spec_occ[..., None]
