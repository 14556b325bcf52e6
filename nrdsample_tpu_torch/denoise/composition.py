"""Composition — re-modulation of the denoised signals and the direct term
(counterpart of ``nrdsample_tpu/denoise/composition.py:compose``)."""

from __future__ import annotations

import torch


def compose(gb: dict, diff_radiance: torch.Tensor, spec_radiance: torch.Tensor,
            shadow: torch.Tensor) -> torch.Tensor:
    """HDR radiance [N, 3]: direct * shadow + emission, plus the indirect
    signals re-modulated by the factors TraceOpaque divided out, times the
    PSR throughput (ones in this slice), plus the PSR emission (zeros). With
    glass the scalar shadow is tinted by the trace's chroma plane
    ``shadow_tint``."""
    shadow_rgb = shadow[..., None]
    tint = gb.get("shadow_tint")
    if tint is not None:
        shadow_rgb = shadow_rgb * tint
    direct = gb["direct_lighting"] * shadow_rgb + gb["emission"]
    diff = diff_radiance * gb["diff_factor"]
    spec = spec_radiance * gb["spec_factor"]
    return direct + (diff + spec) * gb["psr_throughput"] + gb["l_psr"]
