"""The SR slot: separable Lanczos-2 resampling as two dense matmuls
(counterpart of ``nrdsample_tpu/post/upscale.py``). The resampling operator
along each axis is a precomputed dense (out, in) matrix, so a resize is
``Wh @ img @ Ww^T``.

``resample_matrix`` is the JAX package's numpy builder; its tensor is cached
per device. The matmuls run in float32 (``torch.backends.cuda.matmul.allow_tf32``
is False by default, and a caller that sets it changes the result).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _lanczos_weight(x: np.ndarray, a: int) -> np.ndarray:
    x = np.abs(x)
    w = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, w, 0.0)


@functools.lru_cache(maxsize=32)
def resample_matrix(n_out: int, n_in: int, a: int = 2) -> np.ndarray:
    """Dense (n_out, n_in) Lanczos-a resampling matrix, rows normalized.

    When minifying, the kernel is stretched by the scale factor (standard
    anti-aliased resampling).
    """
    scale = n_in / n_out
    support = a * max(scale, 1.0)
    src = (np.arange(n_out) + 0.5) * scale - 0.5          # (n_out,)
    lo = np.floor(src - support).astype(np.int64)
    taps = int(np.ceil(2 * support)) + 1
    idx = lo[:, None] + np.arange(taps)[None, :]           # (n_out, taps)
    x = (idx - src[:, None]) / max(scale, 1.0)
    w = _lanczos_weight(x, a)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-8)
    idx = np.clip(idx, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    np.add.at(m, (np.repeat(np.arange(n_out), taps), idx.reshape(-1)), w.reshape(-1))
    return m


@functools.lru_cache(maxsize=32)
def _matrix(n_out: int, n_in: int, a: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resample_matrix(n_out, n_in, a)).to(device)


def lanczos_resize(img: torch.Tensor, out_h: int, out_w: int, a: int = 2) -> torch.Tensor:
    """Resize (H, W, C) [or (H, W)] to (out_h, out_w[, C]) with Lanczos-a."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    wh = _matrix(out_h, h, a, img.device)
    ww = _matrix(out_w, w, a, img.device)
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    c = img.shape[2]
    x = wh @ img.reshape(h, w * c)                          # (out_h, W*C)
    x = x.reshape(out_h, w, c).transpose(1, 2)              # (out_h, C, W)
    x = (x.reshape(out_h * c, w) @ ww.T).reshape(out_h, c, out_w)
    x = x.transpose(1, 2)                                   # (out_h, out_w, C)
    return x[..., 0] if squeeze else x


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Cheap bilinear variant (same matmul formulation, tent kernel)."""
    return lanczos_resize(img, out_h, out_w, a=1)
