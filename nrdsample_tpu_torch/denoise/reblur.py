"""REBLUR: the recurrent-blur diffuse/specular denoiser (counterpart of
``nrdsample_tpu/denoise/reblur.py``).

1. temporal accumulation with a disocclusion-aware accumulation speed and a
   spatial fix-up of fresh disocclusions;
2. an adaptive-radius bilateral blur as a reach-budgeted dilated 3x3 chain
   (the radius shrinks with accumulated frames and normalized hit distance,
   and with roughness for the specular signal);
3. temporal stabilization: the blurred signal is clamped to the fast
   history's neighbourhood mean +- sigma, and the frame count is cut where it
   sat outside (anti-lag).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from nrdsample_tpu_torch.denoise import common, gatherpass
from nrdsample_tpu_torch.mathlib import color, geometry as geo
from nrdsample_tpu_torch.scene import camera as cam_mod


@dataclasses.dataclass
class ReblurHistory:
    illum: torch.Tensor        # (H, W, 3)
    fast_illum: torch.Tensor   # (H, W, 3) short-history (fast) channel
    hitdist: torch.Tensor      # (H, W)
    view_z: torch.Tensor       # (H, W)
    normal: torch.Tensor       # (H, W, 3)
    frames: torch.Tensor       # (H, W)

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "ReblurHistory":
        z = torch.zeros((h, w, 3), dtype=dtype, device=device)
        return ReblurHistory(
            illum=z, fast_illum=z, hitdist=torch.zeros((h, w), dtype=dtype, device=device),
            view_z=torch.full((h, w), 1e5, dtype=dtype, device=device),
            normal=torch.zeros((h, w, 3), dtype=dtype, device=device),
            frames=torch.zeros((h, w), dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class ReblurSettings:
    """The exercised subset of nrd::ReblurSettings. The two frame caps may be
    0-d tensors (the frame passes the per-frame Settings value)."""

    max_accumulated_frames: Any = 30
    max_fast_accumulated_frames: Any = 6
    blur_radius_px: float = 15.0
    min_blur_radius_px: float = 1.0
    disocclusion_threshold: float = 0.02
    anti_lag_sigma: float = 2.0
    enable_anti_firefly: bool = True
    phi_normal: float = 64.0
    phi_depth: float = 1.0
    history_fix_frame_num: float = 3.0   # frames below which the history is fixed up
    history_fix_stride: int = 2


def spec_magic_curve(roughness):
    """GetSpecMagicCurve (Shared.hlsli:305-311)."""
    f = 1.0 - torch.exp2(-200.0 * roughness * roughness)
    return f * geo.pow01(roughness, 0.5)


def specular_dominant_factor(roughness):
    """Share of the specular lobe that behaves like a mirror: 1 at r = 0,
    0 at r = 1."""
    r = geo.clip(roughness, 0.0, 1.0)
    return (1.0 - r) * (torch.sqrt(1.0 - r) + r)


def specular_virtual_mv(cam, x, view_dir, spec_hitdist, roughness, mv, width: int, height: int,
                        miss=None):
    """Motion for the specular history: a reflection moves with the virtual
    image at X + V hitT D behind the surface, not with the surface. x:
    (H, W, 3) primary hit; view_dir: (H, W, 3) unit eye-to-surface; mv:
    (H, W, 3) surface motion. Returns (H, W, 3): xy blended toward the
    virtual motion, z the surface's (for the disocclusion test)."""
    amount = specular_dominant_factor(roughness)
    xv = x + view_dir * (spec_hitdist * amount)[..., None]
    uv_cur = cam_mod.world_to_uv(cam, x, prev=False)
    uv_prev = cam_mod.world_to_uv(cam, xv, prev=True)
    wh = torch.tensor([width, height], dtype=torch.float32, device=x.device)
    mv_virt_xy = (uv_prev - uv_cur) * wh
    mv_xy = mv[..., :2] + (mv_virt_xy - mv[..., :2]) * amount[..., None]
    if miss is not None:
        mv_xy = torch.where(miss[..., None], mv[..., :2], mv_xy)
    return torch.cat([mv_xy, mv[..., 2:3]], dim=-1)


def blur_radius(hitdist, view_z, roughness, frames, s: ReblurSettings, is_spec: bool, unproject):
    """Per-pixel blur radius in pixels: shrinks with convergence, scales with
    the hit distance, and for specular with the spec magic curve."""
    conv = frames / s.max_accumulated_frames
    radius = s.blur_radius_px * (1.0 - 0.9 * conv)
    pixel_size = geo.clip_min(geo.absolute(view_z) * unproject, 1e-6)
    hit_factor = geo.clip(hitdist / (pixel_size * 30.0), 0.05, 1.0)
    radius = radius * hit_factor
    if is_spec:
        radius = radius * geo.clip(spec_magic_curve(roughness), 0.05, 1.0)
    return geo.clip_min(radius, s.min_blur_radius_px)


_GAUSS_3 = (0.25, 0.5, 0.25)
_BLUR_STEPS = (1, 2, 4, 8)


def _edge_weights(z_n, n_n, view_z, normal, s: ReblurSettings):
    wz = torch.exp(-geo.absolute(z_n - view_z)
                   / (s.phi_depth * geo.clip_min(geo.absolute(view_z), 1e-3)))
    wn = torch.pow(geo.clip(torch.sum(n_n * normal, dim=-1), 0.0, 1.0), s.phi_normal)
    return wz, wn


def adaptive_blur(illum, hitdist, view_z, normal, roughness, frames, frame_idx,
                  s: ReblurSettings, is_spec: bool, unproject):
    """Adaptive-radius bilateral blur as a dilated 3x3 chain (steps 1, 2, 4,
    8): pass ``step`` engages with gate clip(remaining / step, 0, 1) and uses
    up gate x step of the radius. Returns (blurred illum, blurred hitdist)."""
    radius = blur_radius(hitdist, view_z, roughness, frames, s, is_spec, unproject)
    geom = torch.cat([view_z[..., None], normal], dim=-1)
    out = illum
    out_hd = hitdist
    remaining = geo.clip_min(radius - 0.5, 0.0)   # sub-pixel radii stay sharp
    for step in _BLUR_STEPS:
        gate = geo.clip(remaining / step, 0.0, 1.0)
        remaining = geo.clip_min(remaining - gate * step, 0.0)
        packed = torch.cat([out, out_hd[..., None], geom], dim=-1)
        acc = torch.zeros_like(out)
        acc_hd = torch.zeros_like(out_hd)
        acc_w = torch.zeros_like(out_hd)
        for iy, ky in enumerate(_GAUSS_3):
            for ix, kx in enumerate(_GAUSS_3):
                dy, dx = (iy - 1) * step, (ix - 1) * step
                tap = common.shifted(packed, dy, dx)
                wz, wn = _edge_weights(tap[..., 4], tap[..., 5:8], view_z, normal, s)
                wgt = ky * kx * wz * wn * (gate if (dy or dx) else 1.0)
                acc = acc + tap[..., 0:3] * wgt[..., None]
                acc_hd = acc_hd + tap[..., 3] * wgt
                acc_w = acc_w + wgt
        inv = 1.0 / geo.clip_min(acc_w, 1e-6)
        out = acc * inv[..., None]
        out_hd = acc_hd * inv
    return out, out_hd


def history_fix(acc, fast, view_z, normal, frames, s: ReblurSettings):
    """HistoryFix: where fewer than ``history_fix_frame_num`` frames were
    accumulated (a fresh disocclusion), blend toward a wide 5x5, stride-2
    depth/normal-bilateral blur. Returns (fixed slow, fixed fast)."""
    fix_w = geo.clip(1.0 - frames / s.history_fix_frame_num, 0.0, 1.0)
    st = s.history_fix_stride
    acc_s = torch.zeros_like(acc)
    acc_f = torch.zeros_like(fast)
    w_sum = torch.zeros_like(view_z)
    for dy, dx in common.stencil_taps(2):
        wz, wn = _edge_weights(common.shifted(view_z, dy * st, dx * st),
                               common.shifted(normal, dy * st, dx * st), view_z, normal, s)
        wgt = wz * wn
        acc_s = acc_s + common.shifted(acc, dy * st, dx * st) * wgt[..., None]
        acc_f = acc_f + common.shifted(fast, dy * st, dx * st) * wgt[..., None]
        w_sum = w_sum + wgt
    inv = 1.0 / geo.clip_min(w_sum, 1e-6)
    blur_s = acc_s * inv[..., None]
    blur_f = acc_f * inv[..., None]
    return (acc + (blur_s - acc) * fix_w[..., None],
            fast + (blur_f - fast) * fix_w[..., None])


def taccum_requests(hist: ReblurHistory, mv_xy) -> dict:
    """Gather plan of the temporal accumulation, both at cur + mv: 'illum',
    the bicubic history colour; 'packed', the bilinear [fast (3), hitdist,
    view_z, normal (3), frames]."""
    packed = torch.cat([hist.fast_illum, hist.hitdist[..., None], hist.view_z[..., None],
                        hist.normal, hist.frames[..., None]], dim=-1)
    h, w = hist.view_z.shape
    pos = common.pixel_positions(h, w, mv_xy.device) + mv_xy
    return {"illum": (hist.illum, pos), "packed": (packed, pos)}


def accumulate(hist: ReblurHistory, illum, hitdist, view_z, normal, mv, s: ReblurSettings,
               reset=False, confidence=None):
    """Temporal accumulation and history fix-up. Returns (acc, fast, hd,
    frames)."""
    h, w = view_z.shape
    mv_xy = mv[..., :2]
    pre = gatherpass.execute_inline(
        taccum_requests(hist, mv_xy),
        {"illum": gatherpass.BICUBIC, "packed": gatherpass.BILINEAR})
    prev_illum = pre["illum"]
    packed = pre["packed"]
    prev_fast, prev_hd = packed[..., 0:3], packed[..., 3]
    prev_z, prev_n, prev_frames = packed[..., 4], packed[..., 5:8], packed[..., 8]

    valid = common.disocclusion_weight(view_z, mv[..., 2], prev_z, normal, prev_n,
                                       s.disocclusion_threshold)
    valid = valid * common.in_screen(mv_xy, h, w).to(view_z.dtype)
    valid = torch.where(common.reset_mask(reset, valid), 0.0, valid)
    if confidence is not None:
        valid = valid * confidence

    frames = torch.minimum(prev_frames * valid + 1.0,
                           torch.as_tensor(s.max_accumulated_frames, dtype=valid.dtype,
                                           device=valid.device))
    fast_frames = torch.minimum(prev_frames * valid + 1.0,
                                torch.as_tensor(s.max_fast_accumulated_frames,
                                                dtype=valid.dtype, device=valid.device))
    alpha = 1.0 / frames
    alpha_f = 1.0 / fast_frames

    acc = prev_illum * (1 - alpha[..., None]) + illum * alpha[..., None]
    acc = torch.where(valid[..., None] > 0, acc, illum)
    fast = prev_fast * (1 - alpha_f[..., None]) + illum * alpha_f[..., None]
    fast = torch.where(valid[..., None] > 0, fast, illum)
    hd = prev_hd * (1 - alpha) + hitdist * alpha
    hd = torch.where(valid > 0, hd, hitdist)

    acc, fast = history_fix(acc, fast, view_z, normal, frames, s)
    return acc, fast, hd, frames


def stabilize(blurred, fast, frames, s: ReblurSettings):
    """Clamp the blurred slow signal to the fast channel's 3x3 mean +-
    anti_lag_sigma x sigma, and divide the frame count by 1 + the luminance
    distance outside that box in sigma units (anti-lag). Returns
    (stabilized signal, frames to keep in the history)."""
    mu = torch.zeros_like(blurred)
    mu2 = torch.zeros_like(blurred)
    for dy, dx in common.stencil_taps(1):
        f_n = common.shifted(fast, dy, dx)
        mu = mu + f_n
        mu2 = mu2 + f_n * f_n
    mu = mu / 9.0
    sigma = torch.sqrt(geo.clip_min(mu2 / 9.0 - mu * mu, 0.0) + 1e-12)
    lo = mu - sigma * s.anti_lag_sigma
    hi = mu + sigma * s.anti_lag_sigma
    clamped = torch.minimum(torch.maximum(blurred, lo), hi)
    out_dist = color.luminance(geo.absolute(blurred - clamped))
    sig_lum = color.luminance(sigma) * s.anti_lag_sigma + 1e-6
    delta = out_dist / sig_lum
    return clamped, frames / (1.0 + delta)
