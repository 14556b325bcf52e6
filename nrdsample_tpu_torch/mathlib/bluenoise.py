"""Spatiotemporal blue-noise sampler for the sun-shadow disc (counterpart of
``nrdsample_tpu/mathlib/bluenoise.py``).

A 128x128 void-and-cluster ranking texture (the port's own copy, in
``nrdsample_tpu_torch/data/``) read at an R2-lattice shift per dimension,
with a golden-ratio temporal rotation per frame. Bit for bit the JAX
package's samples.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BN_SIZE = 128
_PHI1 = 0.6180339887498949          # 1/phi, golden-ratio sequence
_R2 = (0.7548776662466927, 0.5698402909980532)  # plastic-constant R2 lattice

_TEXTURE_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", f"bluenoise_{BN_SIZE}.npy")
_textures: dict = {}   # device -> (128, 128) float32 texture


def _texture(device) -> torch.Tensor:
    device = torch.device(device)
    if device not in _textures:
        _textures[device] = torch.from_numpy(np.load(_TEXTURE_PATH)).to(device)
    return _textures[device]


def _sample(px, py, frame, dim: int, channel: int):
    """One blue field: the texture at an R2-shifted position plus a golden
    temporal rotation; each (dim, channel) pair gets its own field."""
    tex = _texture(px.device)
    k = dim * 2 + channel
    ox = int(_R2[0] * k * 997) % BN_SIZE
    oy = int(_R2[1] * k * 1499) % BN_SIZE
    v = tex[(py + oy) % BN_SIZE, (px + ox) % BN_SIZE]
    # fold the frame first so the float32 rotation stays exact
    f = torch.remainder(torch.as_tensor(frame, device=px.device) + k * 61, 4096).to(v.dtype)
    return torch.remainder(v + f * _PHI1, 1.0)


def blue2(pixel_idx, width: int, frame, dim: int):
    """(n, 2) blue-noise sample in [0, 1)^2 for flat pixel indices of a
    ``width``-wide image: the drop-in for ``rng.uniform2`` at shadow-disc
    dims."""
    px = pixel_idx % width
    py = torch.div(pixel_idx, width, rounding_mode="floor")
    return torch.stack([_sample(px, py, frame, dim, 0), _sample(px, py, frame, dim, 1)], dim=-1)
