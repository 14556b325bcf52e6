"""Learned denoiser for the DLSS-RR slot (counterpart of
``nrdsample_tpu/post/neural_rr.py``): a small recurrent network over the
noisy composed colour, the RR guides and the previous output reprojected by
the motion vectors. A dilated trunk (3x3 at dilations 1, 2, 4, 8; 18 -> 32
channels) and a 3x3 head to 26 channels: softmax weights over a dilated 5x5
grid of the noisy input, and a temporal blend logit.

Selected with ``RenderConfig(denoiser=Denoiser.NEURAL)``, it replaces the
NRD denoisers. The reprojection goes through ``denoise/common.reproject``,
so on the card it runs the bilinear gather kernel. The weights are the JAX
package's, shipped beside this module as a byte copy of ``neural_rr.npz``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from nrdsample_tpu_torch.denoise import common
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.post import conv

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "neural_rr.npz")

# noisy composed (3) + diff_albedo (3) + spec_albedo (3) + normal_roughness (4)
# + depth (1) + previous output (3) + previous valid (1)
C_IN = 18
HIDDEN = 32
DILATIONS = (1, 2, 4, 8)
TAP_DIL = 2
TAP_OFFS = [(dy, dx) for dy in (-2, -1, 0, 1, 2) for dx in (-2, -1, 0, 1, 2)]
C_OUT = len(TAP_OFFS) + 1   # 25 kernel logits + 1 temporal alpha
LAYERS = len(DILATIONS) + 1  # trunk + 3x3 head


@dataclasses.dataclass
class NeuralRRHistory:
    color: torch.Tensor   # (H, W, 3) previous denoised output
    valid: torch.Tensor   # () int32: 0 on the first frame

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "NeuralRRHistory":
        return NeuralRRHistory(color=torch.zeros((h, w, 3), dtype=dtype, device=device),
                               valid=torch.tensor(0, dtype=torch.int32, device=device))


def load_weights(path: str = WEIGHTS_PATH, device=None) -> dict:
    """The shipped weights as OIHW tensors on ``device`` (the CUDA card when
    None)."""
    return conv.load_weights(path, device)


def apply(params: dict, noisy: torch.Tensor, guides: dict, prev: torch.Tensor,
          prev_valid) -> torch.Tensor:
    """Denoise (H, W, 3) noisy composed radiance. guides: (H, W, 3)
    diff_albedo and spec_albedo, (H, W, 4) normal_roughness, (H, W) depth;
    prev: (H, W, 3) reprojected previous output; prev_valid: 0 or 1."""
    v = torch.as_tensor(prev_valid, device=noisy.device).to(noisy.dtype).expand(
        noisy.shape[:2])[..., None]
    x = torch.cat([noisy, guides["diff_albedo"], guides["spec_albedo"],
                   guides["normal_roughness"], guides["depth"][..., None], prev * v, v], dim=-1)
    x = conv.conv_stack(x, params, DILATIONS + (1,))
    k = torch.softmax(x[..., :len(TAP_OFFS)], dim=-1)
    alpha = torch.sigmoid(x[..., -1:]) * v

    filtered = torch.zeros_like(noisy)
    for i, (dy, dx) in enumerate(TAP_OFFS):
        filtered = filtered + common.shifted(noisy, dy * TAP_DIL, dx * TAP_DIL) * k[..., i:i + 1]
    out = filtered * (1.0 - alpha) + prev * alpha
    return geo.clip_min(out, 0.0)


def denoise(params: dict, noisy: torch.Tensor, guides: dict, mv_xy: torch.Tensor,
            hist: NeuralRRHistory, reset=False):
    """One recurrent step: reproject the previous output, denoise, update the
    history (invalid on the first frame and on a reset). Returns (denoised,
    new history)."""
    prev = common.reproject(hist.color, mv_xy)
    drop = common.reset_mask(reset, noisy) | (hist.valid == 0)
    valid = torch.where(drop, 0, 1).to(torch.int32)
    out = apply(params, noisy, guides, prev, valid)
    return out, NeuralRRHistory(color=out, valid=torch.ones_like(hist.valid))
