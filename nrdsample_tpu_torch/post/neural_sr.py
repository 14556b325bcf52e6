"""Learned super-resolution for the DLSS-SR slot (counterpart of
``nrdsample_tpu/post/neural_sr.py``): the Lanczos-2 resize is the base
estimate, and a 3-layer 3x3 convolution stack (8 -> 24 -> 24 -> 3 channels),
conditioned on the G-buffer guides lifted to output resolution (normal,
roughness, hardware depth), predicts a residual correction.

The weights are the JAX package's, shipped beside this module as a byte
copy of ``neural_sr.npz``.
"""

from __future__ import annotations

import os

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.post import conv, upscale

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "neural_sr.npz")

# input channels: Lanczos-upscaled colour (3) + normal (3) + roughness (1) +
# hardware depth (1)
C_IN = 8
HIDDEN = 24
LAYERS = 3


def apply(params: dict, color: torch.Tensor, guides: dict, out_h: int, out_w: int) -> torch.Tensor:
    """Upscale (H, W, 3) render-resolution colour to (out_h, out_w, 3).

    guides: render-resolution (H, W, 3) "normal", (H, W) "roughness" and
    (H, W) "depth" (``guides.hw_depth``), Lanczos-lifted to output resolution
    and concatenated with the base estimate."""
    base = upscale.lanczos_resize(color, out_h, out_w)
    n_up = upscale.lanczos_resize(guides["normal"], out_h, out_w)
    r_up = upscale.lanczos_resize(guides["roughness"], out_h, out_w)
    d_up = upscale.lanczos_resize(guides["depth"], out_h, out_w)
    x = torch.cat([base, n_up, r_up[..., None], d_up[..., None]], dim=-1)
    residual = conv.conv_stack(x, params, (1,) * LAYERS)
    return geo.clip_min(base + residual, 0.0)


def load_weights(path: str = WEIGHTS_PATH, device=None) -> dict:
    """The shipped weights as OIHW tensors on ``device`` (the CUDA card when
    None)."""
    return conv.load_weights(path, device)
