"""The Final pass and the DlssAfter tonemap (counterpart of
``nrdsample_tpu/post/final.py``).

Final.cs.hlsl:11-63 at output resolution: the split screen (noisy left of
``separator * W``, denoised right, an NV-green divider column), the NRD
validation-overlay alpha blend, the sRGB OETF and a dither before 8-bit
quantization. DlssAfter.cs.hlsl:7-22 is the Uncharted tonemap after the
upscaler, ``tonemap_output`` here.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import color, geometry as geo, rng

#: the divider's colour, an 8-bit sRGB constant
NV_GREEN = (118.0 / 255.0, 185.0 / 255.0, 0.0)


def tonemap_output(hdr: torch.Tensor, exposure) -> torch.Tensor:
    """DlssAfter.cs.hlsl:7-22: exposure and the Uncharted curve at output
    resolution."""
    return color.tonemap_uncharted(hdr * exposure)


def dither_noise(h: int, w: int, frame_index, device=None) -> torch.Tensor:
    """(H, W, 1) white noise of +-0.5/255 (Final.cs.hlsl:31-35), from the
    pixel index, the frame and the stream 977."""
    pix = torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)
    u = rng.uniform1(pix, frame_index, 977)
    return (u[..., None] - 0.5) * (1.0 / 255.0)


def final_pass(denoised: torch.Tensor, noisy: torch.Tensor | None = None, separator=0.0,
               validation: torch.Tensor | None = None, frame_index=0, srgb: bool = True,
               dither: bool = True) -> torch.Tensor:
    """(H, W, 3) tonemapped colour -> display-ready [0, 1] image."""
    h, w = denoised.shape[:2]
    dev = denoised.device
    out = denoised

    # split screen; separator 0 disables it
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    sep_x = separator * w
    if noisy is not None:
        out = torch.where(x < sep_x, noisy, out)

    if validation is not None:
        out = out * (1.0 - validation[..., 3:]) + validation[..., :3] * validation[..., 3:]

    if srgb:
        out = color.linear_to_srgb(geo.clip(out, 0.0, 1.0))

    # the divider column, in display space
    if noisy is not None:
        on_divider = (geo.absolute(x - sep_x) < 1.0) & torch.as_tensor(separator > 0.0, device=dev)
        out = torch.where(on_divider, torch.tensor(NV_GREEN, dtype=out.dtype, device=dev), out)

    if dither:
        out = out + dither_noise(h, w, frame_index, dev)
    return geo.clip(out, 0.0, 1.0)
