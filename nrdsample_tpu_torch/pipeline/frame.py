"""The frame function (counterpart of ``nrdsample_tpu/pipeline/frame.py``):
``render_frame`` = ``trace_frame`` (everything that launches rays) followed by
``image_frame`` (composition + REFERENCE accumulation), threading an explicit
``History``. Eager PyTorch: each call runs on the device of its tensors."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from nrdsample_tpu_torch.config import Denoiser, RenderConfig, Settings
from nrdsample_tpu_torch.denoise import composition, reference
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.render import trace_opaque
from nrdsample_tpu_torch.scene.types import Camera, Scene


@dataclasses.dataclass
class History:
    """Cross-frame state: the frame index and the REFERENCE accumulator
    (the other denoisers' slots arrive with their slices)."""

    frame_index: torch.Tensor   # () int32
    reference: Any = None       # reference.ReferenceHistory

    @staticmethod
    def create(cfg: RenderConfig, device=None) -> "History":
        trace_opaque.check_config_supported(cfg)
        return History(
            frame_index=torch.tensor(0, dtype=torch.int32, device=device),
            reference=reference.ReferenceHistory.create(cfg.n_pixels, cfg.dtype, device),
        )


def trace_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                cfg: RenderConfig, settings: Settings, history: History,
                pixel_idx=None):
    """Phase 1 — the opaque trace. Returns (gb, aux): per-pixel planes and
    the pixel-independent outputs (none in this slice)."""
    gb = trace_opaque.trace_opaque(ctx, scene, cam, cfg, settings, history.frame_index,
                                   pixel_idx)
    gb.pop("shadow_ray")
    return gb, {}


def image_frame(cfg: RenderConfig, settings: Settings, cam: Camera,
                history: History, gb: dict, aux: dict, reset_history=False):
    """Phase 2 — composition and REFERENCE accumulation. Returns
    (outputs, new history); outputs["color"] is the accumulated HDR
    radiance (N, 3)."""
    if cfg.denoiser != Denoiser.REFERENCE or history.reference is None:
        raise NotImplementedError("only the REFERENCE denoiser is ported (slice 1)")
    composed = composition.compose(gb, gb["diff_radiance"], gb["spec_radiance"], gb["shadow"])
    composed, new_ref = reference.accumulate(history.reference, composed, reset=reset_history)
    outputs = {
        "color": composed,
        "final": composed,
        "display": None,
        "debug": None,
        "view_z": gb["view_z"],
        "normal": gb["normal"],
        "shadow": gb["shadow"],
        "diff_radiance": gb["diff_radiance"],
        "spec_radiance": gb["spec_radiance"],
        "gbuffer": gb,
        "glass_mask": None,
        "taa_wide_mask": None,
    }
    return outputs, History(frame_index=history.frame_index + 1, reference=new_ref)


def render_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                 cfg: RenderConfig, settings: Settings, history: History,
                 reset_history=False, pixel_idx=None):
    """One frame: trace_frame then image_frame. Returns (outputs, history)."""
    # dynamic camFov: 0 keeps the camera's own FoV
    fov = settings.cam_fov.to(torch.float32)
    cam = dataclasses.replace(
        cam,
        tan_half_fov_y=torch.where(fov > 0.0, torch.tan(torch.deg2rad(fov * 0.5)),
                                   cam.tan_half_fov_y),
    )
    # blink: smooth pulse on the emissive cubes' intensity
    blink_wave = 0.5 + 0.5 * torch.sin(history.frame_index.to(torch.float32) * 0.4)
    settings = dataclasses.replace(
        settings,
        emission_intensity_cubes=torch.where(
            settings.blink > 0, settings.emission_intensity_cubes * blink_wave,
            settings.emission_intensity_cubes,
        ),
    )
    gb, aux = trace_frame(ctx, scene, cam, cfg, settings, history, pixel_idx=pixel_idx)
    return image_frame(cfg, settings, cam, history, gb, aux, reset_history)
