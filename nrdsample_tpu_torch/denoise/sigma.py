"""SIGMA: the sun-shadow denoiser, a penumbra-width blur and a short
temporal accumulation (counterpart of ``nrdsample_tpu/denoise/sigma.py``).

The penumbra half-width at a receiver is blocker distance x tan(sun angular
radius) / pixel size. The binary visibility is blurred by a depth-stopped
dilated 3x3 chain whose reach is budgeted by that radius, then blended with
the reprojected history where it survives the disocclusion test.
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch.denoise import common
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import reproject as repr_mod


@dataclasses.dataclass
class SigmaHistory:
    shadow: torch.Tensor   # (H, W)
    frames: torch.Tensor   # (H, W)
    view_z: torch.Tensor   # (H, W), for the temporal disocclusion test

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "SigmaHistory":
        return SigmaHistory(
            shadow=torch.ones((h, w), dtype=dtype, device=device),
            frames=torch.zeros((h, w), dtype=dtype, device=device),
            view_z=torch.full((h, w), 1e6, dtype=dtype, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SigmaSettings:
    max_accumulated_frames: int = 5   # short history: shadows move
    max_radius_px: float = 14.0
    phi_depth: float = 1.0
    disocclusion_threshold: float = 0.02


_GAUSS_3 = [0.25, 0.5, 0.25]
_BLUR_STEPS = (1, 2, 4, 8)


def _blur_radius(shadow_hit_dist, view_z, tan_sun_angular_radius, unproject, s: SigmaSettings):
    """(H, W) penumbra radius in pixels, spread by two 3x3 max filters so lit
    pixels bordering a shadow blur too."""
    pixel_size = geo.clip_min(geo.absolute(view_z) * unproject, 1e-6)
    radius = shadow_hit_dist * tan_sun_angular_radius / pixel_size
    for _ in range(2):
        r = radius
        for dy, dx in common.stencil_taps(1):
            r = torch.maximum(r, common.shifted(radius, dy, dx))
        radius = r
    return geo.clip(radius, 0.0, s.max_radius_px)


def _penumbra_blur(shadow, radius, view_z, s: SigmaSettings):
    """Dilated 3x3 chain (steps 1, 2, 4, 8): each pass's neighbour gate is
    clip(remaining / step, 0, 1) and uses up gate x step of the radius, so
    the kernel's half-width never exceeds the local penumbra."""
    out = shadow
    z_plane = view_z[..., None]
    remaining = geo.clip_min(radius - 0.5, 0.0)   # sub-pixel penumbrae stay sharp
    for step in _BLUR_STEPS:
        gate = geo.clip(remaining / step, 0.0, 1.0)
        remaining = geo.clip_min(remaining - gate * step, 0.0)
        packed = torch.cat([out[..., None], z_plane], dim=-1)
        acc = torch.zeros_like(out)
        acc_w = torch.zeros_like(out)
        for iy, ky in enumerate(_GAUSS_3):
            for ix, kx in enumerate(_GAUSS_3):
                dy, dx = (iy - 1) * step, (ix - 1) * step
                tap = common.shifted(packed, dy, dx)
                s_n, z_n = tap[..., 0], tap[..., 1]
                wz = torch.exp(-geo.absolute(z_n - view_z)
                               / (s.phi_depth * geo.clip_min(geo.absolute(view_z), 1e-3)))
                wgt = ky * kx * wz * (gate if (dy or dx) else 1.0)
                acc = acc + s_n * wgt
                acc_w = acc_w + wgt
        out = acc / geo.clip_min(acc_w, 1e-6)
    return out


def requests(hist: SigmaHistory, mv) -> dict:
    """Gather plan: 'temporal' = [hist.shadow, hist.frames, hist.view_z] at
    cur + mv."""
    h, w = hist.view_z.shape
    t_pos = common.pixel_positions(h, w, mv.device) + mv[..., :2]
    t_plane = torch.stack([hist.shadow, hist.frames, hist.view_z], dim=-1)
    return {"temporal": (t_plane, t_pos)}


def denoise(hist: SigmaHistory, shadow, shadow_hit_dist, view_z, mv, tan_sun_angular_radius,
            unproject, frame_idx, s: SigmaSettings = SigmaSettings(), reset=False):
    """shadow: (H, W) visibility; shadow_hit_dist: (H, W) blocker distance
    (0 where unshadowed). Returns (denoised shadow, new history)."""
    h, w = view_z.shape
    t_plane, t_pos = requests(hist, mv)["temporal"]
    temporal = repr_mod.sample_bilinear_auto(t_plane, t_pos)

    radius = _blur_radius(shadow_hit_dist, view_z, tan_sun_angular_radius, unproject, s)
    blurred = _penumbra_blur(shadow, radius, view_z, s)

    # temporal accumulation, rejected where the history is disoccluded
    mv_xy = mv[..., :2]
    prev, prev_frames, prev_z = temporal[..., 0], temporal[..., 1], temporal[..., 2]
    mv_z = mv[..., 2] if mv.shape[-1] > 2 else torch.zeros_like(view_z)
    valid = common.in_screen(mv_xy, h, w).to(view_z.dtype)
    valid = valid * common.disocclusion_weight(view_z, mv_z, prev_z,
                                               threshold=s.disocclusion_threshold)
    valid = torch.where(common.reset_mask(reset, valid), 0.0, valid)
    frames = geo.clip_max(prev_frames * valid + 1.0, s.max_accumulated_frames)
    alpha = 1.0 / frames
    out = prev * (1 - alpha) + blurred * alpha
    out = torch.where(valid > 0, out, blurred)
    out = geo.clip(out, 0.0, 1.0)
    return out, SigmaHistory(shadow=out, frames=frames, view_z=view_z)
