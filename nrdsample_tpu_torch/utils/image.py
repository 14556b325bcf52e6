"""PNG writing and the tonemap for display (counterpart of
``nrdsample_tpu/utils/image.py``): the swapchain and Final.cs.hlsl
stand-in of a headless renderer."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from nrdsample_tpu_torch.mathlib import color


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) float [0, 1] or uint8 array as an 8-bit RGB PNG
    (no dependencies)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def tonemap_for_display(hdr: np.ndarray, exposure: float = 1.0) -> np.ndarray:
    """The Uncharted tonemap and sRGB of an HDR array for PNG output
    (ApplyTonemap and the Final pass's sRGB), on the CPU."""
    x = torch.from_numpy(np.asarray(hdr, np.float32)) * exposure
    ldr = color.tonemap_uncharted(x)
    return color.linear_to_srgb(torch.clamp(ldr, 0.0, 1.0)).numpy()
