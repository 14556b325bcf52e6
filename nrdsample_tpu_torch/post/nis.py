"""The NIS slot: contrast-adaptive sharpening (counterpart of
``nrdsample_tpu/post/nis.py``). A 5-tap cross Laplacian whose gain is scaled
down in high-contrast neighbourhoods to avoid ringing (CAS-style), controlled
by a [0, 1] sharpness like the reference's ``m_Settings.sharpness``."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.denoise.common import shifted
from nrdsample_tpu_torch.mathlib import color, geometry as geo


def sharpen(img: torch.Tensor, sharpness) -> torch.Tensor:
    """Contrast-adaptive sharpen of an (H, W, 3) [0, inf) colour image; the
    neighbours are edge-clamped. sharpness in [0, 1]; 0 is the identity."""
    n = shifted(img, -1, 0)
    s = shifted(img, 1, 0)
    w_ = shifted(img, 0, -1)
    e = shifted(img, 0, 1)

    lum = color.luminance(img)
    ln, ls, lw, le = (color.luminance(t) for t in (n, s, w_, e))
    lmin = torch.minimum(torch.minimum(ln, ls), torch.minimum(torch.minimum(lw, le), lum))
    lmax = torch.maximum(torch.maximum(ln, ls), torch.maximum(torch.maximum(lw, le), lum))
    # CAS-style adaptive gain: full strength in flat regions, rolling off
    # where the local dynamic range is already large
    eps = 1e-4
    contrast = (lmax - lmin) / (lmax + eps)
    gain = torch.sqrt(geo.clip(1.0 - contrast, 0.0, 1.0))
    amount = (sharpness * 0.4 * gain)[..., None]

    laplacian = 4.0 * img - n - s - w_ - e
    return geo.clip_min(img + amount * laplacian, 0.0)
