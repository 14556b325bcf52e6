"""History confidence: lighting-change gradient -> à-trous blur -> confidence
plane (counterpart of ``nrdsample_tpu/denoise/confidence.py``).

The gradient is the luminance change of the SHARC probe field: the previous
frame's probe paths re-traced under the current lighting against the
luminance stored last frame, zeroed where the re-traced depth no longer
matches (motion, not lighting). The confidence plane cuts the denoisers'
history where the lighting changed.
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch.denoise import common
from nrdsample_tpu_torch.mathlib import color, geometry as geo, rng


@dataclasses.dataclass
class ConfidenceHistory:
    probe_lum: torch.Tensor   # (Hs, Ws) last frame's probe luminance
    view_z: torch.Tensor      # (Hs, Ws) last frame's probe viewZ

    @staticmethod
    def create(hs: int, ws: int, dtype=torch.float32, device=None) -> "ConfidenceHistory":
        return ConfidenceHistory(probe_lum=torch.zeros((hs, ws), dtype=dtype, device=device),
                                 view_z=torch.full((hs, ws), 1e5, dtype=dtype, device=device))


def gradient_from_probes(hist: ConfidenceHistory, probes: dict):
    """(gradient at probe resolution, new history) from the probes of
    ``sharc_update_pass`` with the confidence re-trace: |L_prev_retraced -
    L_prev_stored|, zeroed where the re-traced depth moved by 5% or more.
    The new history stores this frame's gradient luminance (the probe
    luminance with the dynamic-object term)."""
    grad = geo.absolute(probes["prev_retrace_lum"] - hist.probe_lum)
    rel = (geo.absolute(probes["prev_retrace_vz"] - hist.view_z)
           / geo.clip_min(geo.absolute(hist.view_z), 1e-3))
    grad = torch.where(rel < 0.05, grad, 0.0)
    return grad, ConfidenceHistory(probe_lum=probes["grad_lum"], view_z=probes["view_z"])


def atrous_blur(grad, view_z, normal, iterations: int = 5):
    """Cross-bilateral à-trous blur of the gradient (ConfidenceBlur.cs.hlsl:
    33-87): Gaussian x depth x normal² weights at steps 1, 2, 4, 8, 16."""
    gauss = (0.25, 0.5, 0.25)
    geom = torch.cat([view_z[..., None], normal], dim=-1)
    out = grad
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        acc_w = torch.zeros_like(out)
        packed = torch.cat([out[..., None], geom], dim=-1)
        for iy, ky in enumerate(gauss):
            for ix, kx in enumerate(gauss):
                tap = common.shifted(packed, (iy - 1) * step, (ix - 1) * step)
                g_n, z_n, n_n = tap[..., 0], tap[..., 1], tap[..., 2:5]
                wz = torch.exp(-geo.absolute(z_n - view_z)
                               / geo.clip_min(geo.absolute(view_z) * 0.1, 1e-3))
                wn = geo.clip(geo.dot3(n_n, normal), 0.0, 1.0) ** 2
                w = ky * kx * wz * wn
                acc = acc + g_n * w
                acc_w = acc_w + w
        out = acc / geo.clip_min(acc_w, 1e-9)
    return out


def gradient_to_confidence(grad, frame, relax_square: bool = False):
    """Blurred gradient -> [0, 1] history confidence (ConfidenceBlur.cs.hlsl:
    91-103): a big change gives a low confidence; Bayer-dithered."""
    c = 1.0 - geo.clip(color.inverse_tonemap_lum(geo.clip(grad, 0.0, 0.99)), 0.0, 1.0)
    c = color.linear_to_srgb(c)
    if relax_square:
        c = c * c
    h, w = c.shape
    py, px = torch.meshgrid(torch.arange(h, device=c.device), torch.arange(w, device=c.device),
                            indexing="ij")
    dither = (rng.bayer4x4(px, py, frame) - 0.5) * (1.0 / 16.0)
    return geo.clip(c + dither, 0.0, 1.0)
