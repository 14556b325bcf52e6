"""Dynamic resolution scaling (counterpart of ``nrdsample_tpu/pipeline/drs.py``):
the gRectSize mechanism of NRDSample.cpp:2104-2119 as a ladder of render
sizes (BUCKETS). A host-side controller picks a bucket from a smoothed frame
time; the frame renders at the bucket's size and the post chain brings it
back to the display size. The history survives a bucket switch by being
resampled (``resize_history``), as the reference's full-size history
textures persist across rect changes.

The resampling is ``jax.image.resize``'s: "linear" is the triangle kernel of
``scale_and_translate`` with antialiasing (downscaling widens the kernel by
1/scale, and each output's weights are renormalised, which matters at the
borders), applied as explicit (in, out) weight matrices; "nearest" takes input
floor((i + 0.5) * in / out) (torch's "nearest-exact", not "nearest").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BUCKETS = (1.0, 0.875, 0.75, 0.625, 0.5)
# the weight of a new frame time in the controller's EMA
EMA_ALPHA = 0.25


def render_size(width: int, height: int, scale: float) -> tuple[int, int]:
    """A bucket's render size: multiples of 8, at least 16."""
    w = max(int(round(width * scale / 8)) * 8, 16)
    h = max(int(round(height * scale / 8)) * 8, 16)
    return w, h


def bucket_cfg(cfg, scale: float):
    """The RenderConfig of a bucket: its render size, with the display size
    pinned to the original raster so that the post chain upscales back to
    it."""
    w, h = render_size(cfg.width, cfg.height, scale)
    return dataclasses.replace(
        cfg, width=w, height=h,
        output_width=cfg.output_width or cfg.width,
        output_height=cfg.output_height or cfg.height,
        enable_post=True,
    )


class DrsController:
    """The host's feedback loop: an EMA of the frame time against a target;
    one bucket down when over budget, one up when the larger bucket should
    still fit (cost taken as proportional to the pixel count), and three
    frames' rest after each switch."""

    def __init__(self, target_ms: float):
        self.target_ms = float(target_ms)
        self.index = 0
        self.ema_ms = None
        self._cooldown = 0

    @property
    def scale(self) -> float:
        return BUCKETS[self.index]

    def update(self, frame_ms: float) -> float:
        """Feed one frame's wall time; returns the scale of the next frame."""
        self.ema_ms = (frame_ms if self.ema_ms is None
                       else self.ema_ms + EMA_ALPHA * (frame_ms - self.ema_ms))
        if self._cooldown > 0:
            # a switch just happened: let the EMA settle at the new cost
            self._cooldown -= 1
            return self.scale
        if self.ema_ms > self.target_ms and self.index + 1 < len(BUCKETS):
            self.index += 1
            self._cooldown = 3
            self.ema_ms = None
        elif self.index > 0:
            up = BUCKETS[self.index - 1]
            predicted = self.ema_ms * (up / self.scale) ** 2
            if predicted < 0.9 * self.target_ms:
                self.index -= 1
                self._cooldown = 3
                self.ema_ms = None
        return self.scale


def linear_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    antialiased "linear" method along one axis (``compute_weight_mat`` of
    ``scale_and_translate`` with no translation)."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None])
    weights = torch.clamp_min(1.0 - torch.abs(x / kernel_scale), 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def nearest_indices(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out_size,) input index of each output of ``jax.image.resize``'s
    "nearest" method: floor((i + 0.5) * in / out) in float32."""
    pos = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * in_size / out_size
    return torch.floor(pos).long()


def _resize_plane(a: torch.Tensor, new_hw) -> torch.Tensor:
    """Resize the two leading dims of ``a`` to new_hw: linearly (floating
    leaves), else by the nearest sample. A dim of equal size is left as it
    is."""
    if tuple(a.shape[:2]) == tuple(new_hw):
        return a
    for axis, n in enumerate(new_hw):
        m = a.shape[axis]
        if m == n:
            continue
        if a.is_floating_point():
            w = linear_weights(m, n, a.device).to(a.dtype)
            a = torch.tensordot(a, w, dims=([axis], [0])).movedim(-1, axis)
        else:
            a = a.index_select(axis, nearest_indices(m, n, a.device))
    return a.contiguous()


def _map_leaves(obj, fn):
    """fn applied to every tensor of a tree of dataclasses."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_leaves(getattr(obj, f.name), fn)
                                           for f in dataclasses.fields(obj)})
    return obj


def resize_history(history, old_cfg, new_cfg):
    """Resample every per-pixel plane of ``history`` (a ``frame.History``)
    from old_cfg's raster to new_cfg's, keeping the temporal accumulation
    across a bucket switch. A leaf whose leading dims are (h, w), or the
    confidence grid's downscaled raster, is resized; one whose leading dim is
    h * w is resized through a reshape; every other leaf (the SHARC table,
    the frame index) passes through."""
    oh, ow = old_cfg.height, old_cfg.width
    nh, nw = new_cfg.height, new_cfg.width
    if (oh, ow) == (nh, nw):
        return history
    ds = old_cfg.sharc_downscale
    shapes = {
        (oh, ow): (nh, nw),
        (max(oh // ds, 1), max(ow // ds, 1)): (max(nh // ds, 1), max(nw // ds, 1)),
    }

    def leaf(a):
        if a.dim() >= 2 and tuple(a.shape[:2]) in shapes:
            return _resize_plane(a, shapes[tuple(a.shape[:2])])
        if a.dim() >= 1 and a.shape[0] == oh * ow:
            img = a.reshape((oh, ow) + tuple(a.shape[1:]))
            return _resize_plane(img, (nh, nw)).reshape((nh * nw,) + tuple(a.shape[1:]))
        return a

    return _map_leaves(history, leaf)
