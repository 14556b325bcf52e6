"""REBLUR helpers used by the path tracer. Only ``spec_magic_curve`` is
ported; the REBLUR denoiser itself belongs to slice 2 (shaderballs512)."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def spec_magic_curve(roughness):
    """GetSpecMagicCurve (Shared.hlsli:305-311)."""
    f = 1.0 - torch.exp2(-200.0 * roughness * roughness)
    return f * geo.pow01(roughness, 0.5)
