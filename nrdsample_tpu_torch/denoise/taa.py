"""TAA — temporal anti-aliasing (counterpart of
``nrdsample_tpu/denoise/taa.py``; Shaders/Taa.cs.hlsl): closest-velocity
dilation over 3x3, a bicubic history gather, a variance clamp of the history
to the 3x3 (5x5 under the wide mask) neighbourhood, and a CIELAB-JND boost of
the mix rate.

The resolve after the gather is one kernel on the card,
``csrc/taa_resolve.cu``; ``resolve_tail`` is its plain version, which CPU
tensors take. The bicubic gather goes through the bilinear gather kernel
(five launches). The TAA-weight debug view comes with the debug views.
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.denoise import common, taa_cuda
from nrdsample_tpu_torch.mathlib import color, geometry as geo


@dataclasses.dataclass
class TaaHistory:
    color: torch.Tensor   # (H, W, 3)
    valid: torch.Tensor   # () int32: 0 before the first frame

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "TaaHistory":
        return TaaHistory(color=torch.zeros((h, w, 3), dtype=dtype, device=device),
                          valid=torch.tensor(0, dtype=torch.int32, device=device))


def closest_velocity_dilation(mv_xy, view_z):
    """The motion of the closest (smallest viewZ) pixel of the 3x3
    neighbourhood (Taa.cs.hlsl:97-101): keeps edges stable under motion."""
    best_z, best_mv = view_z, mv_xy
    for dy, dx in common.stencil_taps(1):
        zn = common.shifted(view_z, dy, dx)
        best_mv = torch.where((zn < best_z)[..., None], common.shifted(mv_xy, dy, dx), best_mv)
        best_z = torch.minimum(best_z, zn)
    return best_mv


def requests(hist: TaaHistory, mv, view_z):
    """The history gather: (plane, positions) of the bicubic sample at the
    dilated velocity."""
    h, w = view_z.shape
    mv_d = closest_velocity_dilation(mv[..., :2], view_z)
    return hist.color, common.pixel_positions(h, w, mv.device) + mv_d


def _moments(cur, radius: int):
    """(mean, sigma) of the (2r+1)^2 clamped neighbourhood, per channel."""
    s1 = torch.zeros_like(cur)
    s2 = torch.zeros_like(cur)
    for dy, dx in common.stencil_taps(radius):
        cn = common.shifted(cur, dy, dx)
        s1 = s1 + cn
        s2 = s2 + cn * cn
    inv_n = 1.0 / float((2 * radius + 1) ** 2)
    mu = s1 * inv_n
    return mu, torch.sqrt(torch.clamp_min(s2 * inv_n - mu * mu, 0.0) + 1e-12)


def resolve_tail(cur, prev, mv_d, wide_mask, reset_mix, sigma_scale: float, base_mix: float):
    """The resolve after the history gather (Taa.cs.hlsl:56-147), the plain
    version of the TAA kernel. cur/prev (H, W, 3); mv_d (H, W, 2) dilated
    velocity; wide_mask (H, W) float (> 0.5 = 5x5 neighbourhood) or None;
    reset_mix (H, W) float in {0, 1}."""
    h, w = cur.shape[:2]
    mu, sigma = _moments(cur, 1)
    if wide_mask is not None:
        mu5, sigma5 = _moments(cur, 2)
        wm = (wide_mask > 0.5)[..., None]
        mu = torch.where(wm, mu5, mu)
        sigma = torch.where(wm, sigma5, sigma)
    lo = mu - sigma * sigma_scale
    hi = mu + sigma * sigma_scale
    clamped = torch.minimum(torch.maximum(prev, lo), hi)

    # disocclusion-driven mix-rate boost by the CIELAB just-noticeable difference
    d = (color.rgb_to_lab(torch.clamp(prev, 0.0, 1.0))
         - color.rgb_to_lab(torch.clamp(clamped, 0.0, 1.0)))
    jnd = torch.clamp(torch.sqrt(geo.dot3(d, d)) * (1.0 / 23.0), 0.0, 1.0)
    mix = torch.clamp(base_mix + jnd * 0.5, 0.0, 1.0)
    mix = torch.where(common.in_screen(mv_d, h, w), mix, 1.0)
    mix = torch.maximum(mix, reset_mix)
    return clamped + (cur - clamped) * mix[..., None]


def resolve(cur, prev, mv_d, wide_mask, reset_mix, sigma_scale: float, base_mix: float):
    """``resolve_tail`` on CPU tensors; the TAA kernel on CUDA tensors."""
    if cur.device.type == "cuda":
        return taa_cuda.taa_resolve_cuda(cur, prev, mv_d, wide_mask, reset_mix, sigma_scale,
                                         base_mix)
    if cur.device.type == "cpu":
        return resolve_tail(cur, prev, mv_d, wide_mask, reset_mix, sigma_scale, base_mix)
    raise ValueError(f"no TAA resolve for device {cur.device}")


def apply(hist: TaaHistory, cur, mv, view_z, wide_mask=None, reset=False, base_mix: float = 0.1):
    """One TAA step on cur (H, W, 3). Returns (antialiased, new history)."""
    h, w = view_z.shape
    mv_d = closest_velocity_dilation(mv[..., :2], view_z)
    prev = common.reproject(hist.color, mv_d, bicubic=True)
    drop = common.reset_mask(reset, cur) | (hist.valid == 0)
    reset_mix = torch.where(drop, 1.0, 0.0).to(cur.dtype).expand(h, w)
    wide_f = None if wide_mask is None else wide_mask.to(cur.dtype)
    out = resolve(cur, prev, mv_d, wide_f, reset_mix, cfgmod.TAA_SIGMA_SCALE, base_mix)
    return out, TaaHistory(color=out, valid=torch.ones_like(hist.valid))
