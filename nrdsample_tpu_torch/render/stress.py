"""Stress-test fault injection and sanitization (counterpart of
``nrdsample_tpu/render/stress.py``).

The four injectors write faults into the traced G-buffer: the DRS test puts
GARBAGE (NaN) outside the dynamic-resolution rect, the inf test outside the
denoising range of view-z, the firefly test multiplies rare pixels' indirect
signals by 10^4, and the material-id test writes stripes into the material
id. Sanitization zeroes non-finite or negative radiance and neutralizes the
pixels outside the rect, so that nothing downstream reads garbage.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch import config
from nrdsample_tpu_torch.config import RenderConfig, Settings
from nrdsample_tpu_torch.mathlib import rng

GARBAGE = float("nan")

#: view-z beyond this is outside the denoising range
DENOISING_RANGE = 1.0e4


def rect_mask(cfg: RenderConfig, settings: Settings, pixel_idx: torch.Tensor) -> torch.Tensor:
    """True for the pixels inside the DRS rect: the top-left
    ceil(size * resolution_scale) columns and rows."""
    px = pixel_idx % cfg.width
    py = torch.div(pixel_idx, cfg.width, rounding_mode="floor")
    rw = torch.ceil(cfg.width * settings.resolution_scale).to(torch.int32)
    rh = torch.ceil(cfg.height * settings.resolution_scale).to(torch.int32)
    return (px < rw) & (py < rh)


def _poison(a: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    while bad.dim() < a.dim():
        bad = bad[..., None]
    return torch.where(bad, GARBAGE, a)


def apply_stress_tests(gb: dict, cfg: RenderConfig, settings: Settings,
                       pixel_idx: torch.Tensor, frame) -> dict:
    """The G-buffer with the faults of the enabled stress tests written in."""
    out = dict(gb)
    if cfg.use_drs_stress_test:
        outside = ~rect_mask(cfg, settings, pixel_idx)
        for k in ("diff_radiance", "spec_radiance", "direct_lighting", "emission", "view_z"):
            out[k] = _poison(out[k], outside)
    if cfg.use_inf_stress_test:
        far = torch.abs(gb["view_z"]) > DENOISING_RANGE
        for k in ("diff_radiance", "spec_radiance"):
            out[k] = _poison(out[k], far)
    if cfg.use_firefly_test:
        u = rng.uniform1(pixel_idx, frame, 555)
        spike = (u < 0.004).to(out["diff_radiance"].dtype) * 9999.0 + 1.0
        out["diff_radiance"] = out["diff_radiance"] * spike[..., None]
        out["spec_radiance"] = out["spec_radiance"] * spike[..., None]
    if cfg.use_material_id_test:
        py = torch.div(pixel_idx, cfg.width, rounding_mode="floor")
        out["material_id"] = (torch.div(py, 8, rounding_mode="floor") % 2).to(
            out["material_id"].dtype)
    return out


def is_valid_radiance(c: torch.Tensor) -> torch.Tensor:
    """Finite and non-negative; reduced over the channels of an (..., C)
    tensor of more than one dimension."""
    ok = torch.isfinite(c) & (c >= 0.0)
    return ok.all(dim=-1) if c.dim() > 1 else ok


def sanitize_gbuffer(gb: dict, cfg: RenderConfig, settings: Settings,
                     pixel_idx: torch.Tensor) -> dict:
    """Radiance that is not valid, and every pixel outside the DRS rect, goes
    to 0; hit distances and the shadow planes that are not finite go to 0;
    view-z that is not finite goes to INF."""
    out = dict(gb)
    inside = rect_mask(cfg, settings, pixel_idx)
    for k in ("diff_radiance", "spec_radiance", "direct_lighting", "emission"):
        if k in out:
            a = out[k]
            valid = is_valid_radiance(a) & inside
            out[k] = torch.where(valid[..., None] if a.dim() > 1 else valid, a, 0.0)
    for k in ("diff_hitdist", "spec_hitdist", "shadow", "shadow_hit_dist"):
        if k in out:
            v = out[k]
            out[k] = torch.where(torch.isfinite(v) & inside, v, 0.0)
    vz = out["view_z"]
    out["view_z"] = torch.where(torch.isfinite(vz) & inside, vz, config.INF)
    return out

