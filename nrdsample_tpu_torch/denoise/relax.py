"""RELAX — the SVGF-family diffuse/specular denoiser (counterpart of
``nrdsample_tpu/denoise/relax.py``):

  1. temporal accumulation of the illumination and of the first two
     luminance moments, with motion reprojection and depth/normal
     disocclusion;
  2. variance estimation, with a 3x3 spatial fallback for short histories;
  3. five à-trous iterations (3x3 at steps 1, 2, 4, 8, 16) with depth,
     normal and luminance edge stopping; the variance is filtered alongside.

Steps 1-2 (behind an anti-firefly clamp) are one kernel on the card,
``csrc/relax_taccum.cu``, and each à-trous iteration another,
``csrc/relax_atrous.cu``; ``taccum_plain`` and ``atrous_iteration`` are their
plain versions, which CPU tensors take. All stencils clamp to the edge.
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch.denoise import atrous_cuda, common, taccum_cuda
from nrdsample_tpu_torch.mathlib import color, filtering, geometry as geo
from nrdsample_tpu_torch.ops import _kernels


@dataclasses.dataclass
class RelaxHistory:
    illum: torch.Tensor     # (H, W, 3) accumulated illumination
    moments: torch.Tensor   # (H, W, 2) accumulated (mu1, mu2) of luminance
    view_z: torch.Tensor    # (H, W)
    normal: torch.Tensor    # (H, W, 3)
    frames: torch.Tensor    # (H, W) accumulated frame count

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "RelaxHistory":
        return RelaxHistory(
            illum=torch.zeros((h, w, 3), dtype=dtype, device=device),
            moments=torch.zeros((h, w, 2), dtype=dtype, device=device),
            view_z=torch.full((h, w), 1e5, dtype=dtype, device=device),
            normal=torch.zeros((h, w, 3), dtype=dtype, device=device),
            frames=torch.zeros((h, w), dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class RelaxSettings:
    """The exercised subset of nrd::RelaxSettings. ``max_accumulated_frames``
    may be a 0-d tensor (the frame's runtime cap)."""

    max_accumulated_frames: object = 30
    atrous_iterations: int = 5
    enable_anti_firefly: bool = True
    phi_luminance: float = 4.0
    phi_normal: float = 64.0
    phi_depth: float = 1.0
    disocclusion_threshold: float = 0.02


def taccum_requests(hist: RelaxHistory, mv_xy):
    """The history gather of the temporal accumulation: ONE packed
    10-channel plane [illum(3), moments(2), view_z, normal(3), frames] and
    its sample positions cur + mv."""
    packed = torch.cat([hist.illum, hist.moments, hist.view_z[..., None], hist.normal,
                        hist.frames[..., None]], dim=-1)
    h, w = hist.view_z.shape
    return packed, common.pixel_positions(h, w, mv_xy.device) + mv_xy


def temporal_accumulate(hist: RelaxHistory, illum, view_z, normal, mv, s: RelaxSettings,
                        reset=False, confidence=None):
    """Step 1: reproject and accumulate the illumination and the moments.
    Returns (acc_illum, acc_moments, frames, new history)."""
    h, w = view_z.shape
    mv_xy = mv[..., :2]
    plane, pos = taccum_requests(hist, mv_xy)
    pre = filtering.sample_bilinear(plane, pos)
    prev_illum, prev_moments = pre[..., 0:3], pre[..., 3:5]
    prev_z, prev_n, prev_frames = pre[..., 5], pre[..., 6:9], pre[..., 9]

    valid = common.disocclusion_weight(view_z, mv[..., 2], prev_z, normal, prev_n,
                                       s.disocclusion_threshold)
    valid = valid * common.in_screen(mv_xy, h, w).to(view_z.dtype)
    valid = torch.where(common.reset_mask(reset, valid), 0.0, valid)
    if confidence is not None:
        # the history-confidence clamp: lighting changes cut the history
        valid = valid * confidence

    max_acc = torch.as_tensor(s.max_accumulated_frames, dtype=view_z.dtype, device=view_z.device)
    frames = torch.minimum(prev_frames * valid + 1.0, max_acc)
    alpha = (1.0 / frames)[..., None]

    lum = color.luminance(illum)
    new_moments = torch.stack([lum, lum * lum], dim=-1)
    hit = valid[..., None] > 0
    acc_illum = torch.where(hit, prev_illum * (1.0 - alpha) + illum * alpha, illum)
    acc_moments = torch.where(hit, prev_moments * (1.0 - alpha) + new_moments * alpha, new_moments)
    new_hist = RelaxHistory(illum=acc_illum, moments=acc_moments, view_z=view_z, normal=normal,
                            frames=frames)
    return acc_illum, acc_moments, frames, new_hist


def estimate_variance(illum, moments, frames):
    """Step 2: temporal variance of the luminance, with a 3x3 spatial
    estimate for histories shorter than 4 frames."""
    m1 = moments[..., 0]
    var_t = geo.clip_min(moments[..., 1] - m1 * m1, 0.0)
    lum = color.luminance(illum)
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    for dy, dx in common.stencil_taps(1):
        ln = common.shifted(lum, dy, dx)
        s1 = s1 + ln
        s2 = s2 + ln * ln
    mu1 = s1 * (1.0 / 9.0)
    var_s = geo.clip_min(s2 * (1.0 / 9.0) - mu1 * mu1, 0.0)
    return torch.where(frames < 4.0, torch.maximum(var_s, var_t), var_t)


def taccum_plain(hist: RelaxHistory, illum, view_z, normal, mv, s: RelaxSettings, reset=False,
                 confidence=None):
    """The plain version of the taccum kernel: anti-firefly, temporal
    accumulation, variance. Returns (acc_illum, acc_moments, frames,
    variance)."""
    if s.enable_anti_firefly:
        illum = common.anti_firefly(illum)
    acc, m, frames, _ = temporal_accumulate(hist, illum, view_z, normal, mv, s, reset, confidence)
    return acc, m, frames, estimate_variance(acc, m, frames)


def taccum(hist: RelaxHistory, illum, view_z, normal, mv, s: RelaxSettings, reset=False,
           confidence=None):
    """``taccum_plain`` on CPU tensors; the taccum kernel on CUDA tensors,
    differentiable through ``taccum_plain``."""
    if illum.device.type == "cuda":
        def kernel(hi, hm, hz, hn, hf, il, vz, n, m, conf):
            return taccum_cuda.taccum_variance_cuda(
                hi, hm, hz, hn, hf, il, vz, n, m, s.max_accumulated_frames,
                s.disocclusion_threshold, s.enable_anti_firefly, reset=reset, confidence=conf)

        def plain(hi, hm, hz, hn, hf, il, vz, n, m, conf):
            return taccum_plain(RelaxHistory(hi, hm, hz, hn, hf), il, vz, n, m, s, reset, conf)

        return _kernels.with_plain_backward(
            kernel, plain, hist.illum, hist.moments, hist.view_z, hist.normal, hist.frames,
            illum, view_z, normal, mv, confidence)
    if illum.device.type == "cpu":
        return taccum_plain(hist, illum, view_z, normal, mv, s, reset, confidence)
    raise ValueError(f"no RELAX taccum for device {illum.device}")


_KERNEL_3 = (0.25, 0.5, 0.25)  # B3-spline à-trous 1D weights


def atrous_iteration(illum, variance, view_z, normal, step: int, s: RelaxSettings):
    """One edge-stopped à-trous iteration: a 3x3 stencil at stride ``step``
    (the plain version of the à-trous kernel). Returns (illum, variance)."""
    lum_c = color.luminance(illum)
    # +eps inside the sqrt keeps its gradient finite at 0
    sigma_l = torch.sqrt(geo.clip_min(variance, 0.0) + 1e-12) * s.phi_luminance + 1e-4
    abs_z = geo.clip_min(geo.absolute(view_z), 1e-3)
    packed = torch.cat([illum, variance[..., None], view_z[..., None], normal], dim=-1)
    acc = torch.zeros_like(illum)
    acc_var = torch.zeros_like(variance)
    acc_w = torch.zeros_like(variance)
    for iy, ky in enumerate(_KERNEL_3):
        for ix, kx in enumerate(_KERNEL_3):
            dy, dx = (iy - 1) * step, (ix - 1) * step
            tap = common.shifted(packed, dy, dx)
            illum_n, var_n, z_n, n_n = tap[..., 0:3], tap[..., 3], tap[..., 4], tap[..., 5:8]
            wz = torch.exp(-geo.absolute(z_n - view_z)
                           / (s.phi_depth * abs_z * (abs(dy) + abs(dx) + 1e-3)))
            wn = torch.pow(geo.clip(geo.dot3(n_n, normal), 0.0, 1.0), s.phi_normal)
            wl = torch.exp(-geo.absolute(color.luminance(illum_n) - lum_c) / sigma_l)
            wgt = ky * kx * wz * wn * wl
            acc = acc + illum_n * wgt[..., None]
            acc_var = acc_var + var_n * wgt * wgt
            acc_w = acc_w + wgt
    inv = 1.0 / geo.clip_min(acc_w, 1e-6)
    return acc * inv[..., None], acc_var * inv * inv


def atrous(illum, variance, view_z, normal, step: int, s: RelaxSettings):
    """``atrous_iteration`` on CPU tensors; the à-trous kernel on CUDA
    tensors, differentiable through ``atrous_iteration``."""
    if illum.device.type == "cuda":
        return _kernels.with_plain_backward(
            lambda *t: atrous_cuda.atrous_iteration_cuda(*t, step, s.phi_luminance,
                                                         s.phi_normal, s.phi_depth),
            lambda *t: atrous_iteration(*t, step, s), illum, variance, view_z, normal)
    if illum.device.type == "cpu":
        return atrous_iteration(illum, variance, view_z, normal, step, s)
    raise ValueError(f"no RELAX à-trous for device {illum.device}")


def denoise(hist: RelaxHistory, illum, view_z, normal, mv, s: RelaxSettings = RelaxSettings(),
            reset=False, confidence=None):
    """RELAX for one signal. illum: (H, W, 3) demodulated radiance;
    confidence: optional (H, W) [0, 1] history-confidence plane. Returns
    (denoised, new history); the history keeps the FIRST à-trous output,
    which cuts the temporal lag (the SVGF feedback)."""
    acc_illum, acc_moments, frames, variance = taccum(hist, illum, view_z, normal, mv, s, reset,
                                                      confidence)
    out, var, first = acc_illum, variance, None
    for i in range(s.atrous_iterations):
        out, var = atrous(out, var, view_z, normal, 1 << i, s)
        if i == 0:
            first = out
    return out, RelaxHistory(illum=first, moments=acc_moments, view_z=view_z, normal=normal,
                             frames=frames)
