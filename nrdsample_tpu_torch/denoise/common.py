"""Shared denoiser infrastructure: clamped shifts, stencil taps, reprojection
and disocclusion tests (counterpart of ``nrdsample_tpu/denoise/common.py``).

Images are [H, W, C] (or [H, W]); motion is the 2.5D motion of
``scene/camera.get_motion``: mv.xy in pixels with prev_pos = cur_pos + mv.xy,
mv.z = viewZprev - viewZ.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import color, filtering, geometry as geo
from nrdsample_tpu_torch.ops import reproject as repr_mod


def _shift_axis(a: torch.Tensor, s: int, axis: int) -> torch.Tensor:
    """out[i] = a[clamp(i + s, 0, n - 1)] along ``axis``."""
    n = a.shape[axis]
    s = max(-(n - 1), min(s, n - 1))
    if s == 0:
        return a
    reps = [1] * a.dim()
    reps[axis] = abs(s)
    if s > 0:
        return torch.cat([a.narrow(axis, s, n - s), a.narrow(axis, n - 1, 1).repeat(reps)], axis)
    return torch.cat([a.narrow(axis, 0, 1).repeat(reps), a.narrow(axis, 0, n + s)], axis)


def shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Clamped-edge shift of [H, W, ...]: out[y, x] = img[y + dy, x + dx]
    with the indices clamped into the image."""
    return _shift_axis(_shift_axis(img, dy, 0), dx, 1)


def stencil_taps(radius: int):
    """(dy, dx) offsets of a (2r+1)^2 stencil."""
    return [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)]


def pixel_positions(h: int, w: int, device=None) -> torch.Tensor:
    """Continuous pixel centers [H, W, 2] = (x, y)."""
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def reproject(prev: torch.Tensor, mv_xy: torch.Tensor, bicubic: bool = False) -> torch.Tensor:
    """Sample the previous-frame image at cur + mv, bilinear or 5-tap
    bicubic."""
    pos = pixel_positions(prev.shape[0], prev.shape[1], prev.device) + mv_xy
    if bicubic:
        return filtering.sample_bicubic_no_corners(prev, pos,
                                                   bilinear_fn=repr_mod.sample_bilinear_auto)
    return repr_mod.sample_bilinear_auto(prev, pos)


def anti_firefly(img: torch.Tensor) -> torch.Tensor:
    """Clamp each pixel's luminance to the [min, max] of its 8 neighbours,
    keeping its chroma."""
    lum = color.luminance(img)
    nmin = nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ln = shifted(lum, dy, dx)
            nmin = ln if nmin is None else torch.minimum(nmin, ln)
            nmax = ln if nmax is None else torch.maximum(nmax, ln)
    clamped = torch.minimum(torch.maximum(lum, nmin), nmax)
    scale = clamped / geo.clip_min(lum, 1e-9)
    return img * scale[..., None]


def in_screen(mv_xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W] bool: does the reprojected position land on screen?"""
    pos = pixel_positions(h, w, mv_xy.device) + mv_xy
    return (pos[..., 0] >= 0.0) & (pos[..., 0] <= w) & (pos[..., 1] >= 0.0) & (pos[..., 1] <= h)


def disocclusion_weight(view_z, mv_z, prev_view_z_reproj, normal=None, prev_normal_reproj=None,
                        threshold: float = 0.02) -> torch.Tensor:
    """[H, W] in {0, 1}: 1 where the history is valid. The expected previous
    viewZ (viewZ + mv.z) must match the reprojected one relative to the
    depth, and the normals must agree (dot > 0.5) when given."""
    expected = view_z + mv_z
    rel = geo.absolute(prev_view_z_reproj - expected) / geo.clip_min(geo.absolute(view_z), 1e-3)
    ok = (rel < threshold).to(view_z.dtype)
    if normal is not None and prev_normal_reproj is not None:
        ndot = geo.dot3(normal, prev_normal_reproj)
        ok = ok * (ndot > 0.5).to(view_z.dtype)
    return ok


def reset_mask(reset, like: torch.Tensor) -> torch.Tensor:
    """``reset`` (a bool or a 0-d bool tensor) as a bool tensor on ``like``'s
    device."""
    return torch.as_tensor(reset, dtype=torch.bool, device=like.device)
