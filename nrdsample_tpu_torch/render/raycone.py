"""Ray cones — texture LOD + curvature-aware spread tracking (counterpart of
``nrdsample_tpu/render/raycone.py``). State is (width, spread) per ray."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo


def propagate(cone: dict, t: torch.Tensor) -> dict:
    """Grow the cone over a segment of length t."""
    return {"width": cone["width"] + t * cone["spread"], "spread": cone["spread"]}


def reflect(cone: dict, curvature, roughness=None) -> dict:
    """Widen the spread at a bounce by 2|curvature| and a roughness term."""
    spread = cone["spread"] + 2.0 * geo.absolute(curvature)
    if roughness is not None:
        spread = spread + roughness * roughness * 0.25
    return {"width": cone["width"], "spread": spread}

