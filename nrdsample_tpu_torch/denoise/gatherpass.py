"""History gathers of the denoisers, run inline in the frame (counterpart of
``nrdsample_tpu/denoise/gatherpass.py:execute_inline``; the JAX package's
staged gather program exists only for the TPU and is not ported).

A request is ``{name: (plane [H, W, C?], pos [..., 2])}`` with a mode per
name: BILINEAR goes to ``ops/reproject.sample_bilinear_auto`` and BICUBIC to
``sample_bicubic_auto`` (five bilinear taps)."""

from __future__ import annotations

from nrdsample_tpu_torch.ops import reproject as repr_mod

BILINEAR = "bilinear"
BICUBIC = "bicubic"


def execute_inline(requests: dict, modes: dict) -> dict:
    """Run every gather request; returns {name: gathered}."""
    out = {}
    for name in sorted(requests):
        plane, pos = requests[name]
        if modes[name] == BICUBIC:
            out[name] = repr_mod.sample_bicubic_auto(plane, pos)
        else:
            out[name] = repr_mod.sample_bilinear_auto(plane, pos)
    return out
