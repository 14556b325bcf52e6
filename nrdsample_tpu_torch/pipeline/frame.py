"""The frame function (counterpart of ``nrdsample_tpu/pipeline/frame.py``):
``render_frame`` = ``trace_frame`` (everything that launches rays) followed by
``image_frame`` (the denoisers, then composition), threading an explicit
``History``. Eager PyTorch: each call runs on the device of its tensors.

Two denoiser paths are ported: REFERENCE accumulation, and REBLUR with SIGMA
for the sun shadow. The image work runs as ``image_frame_begin`` (hit-distance
reconstruction, SIGMA, REBLUR temporal accumulation) then
``image_frame_finish`` (REBLUR blur and stabilization, composition, history
assembly), with every history gather inline.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from nrdsample_tpu_torch.config import Denoiser, RenderConfig, Settings, TracingMode
from nrdsample_tpu_torch.denoise import checkerboard, common, composition, reblur, reference, sigma
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.render import trace_opaque
from nrdsample_tpu_torch.scene import camera as cam_mod
from nrdsample_tpu_torch.scene.types import Camera, Scene


@dataclasses.dataclass
class History:
    """Cross-frame state: the frame index and the slots of the configured
    denoiser (unused slots are None; the other denoisers' slots arrive with
    their slices)."""

    frame_index: torch.Tensor   # () int32
    reference: Any = None       # reference.ReferenceHistory
    reblur_diff: Any = None     # reblur.ReblurHistory
    reblur_spec: Any = None
    sigma: Any = None           # sigma.SigmaHistory

    @staticmethod
    def create(cfg: RenderConfig, device=None) -> "History":
        """The empty history of ``cfg`` on ``device`` (the CUDA card when
        None)."""
        trace_opaque.check_config_supported(cfg)
        device = resolve(device)
        h, w, dt = cfg.height, cfg.width, cfg.dtype
        kw: dict[str, Any] = {"frame_index": torch.tensor(0, dtype=torch.int32, device=device)}
        if cfg.denoiser == Denoiser.REFERENCE:
            kw["reference"] = reference.ReferenceHistory.create(cfg.n_pixels, dt, device)
        elif cfg.denoiser == Denoiser.REBLUR:
            kw["reblur_diff"] = reblur.ReblurHistory.create(h, w, dt, device)
            kw["reblur_spec"] = reblur.ReblurHistory.create(h, w, dt, device)
            kw["sigma"] = sigma.SigmaHistory.create(h, w, dt, device)
        return History(**kw)


def trace_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                cfg: RenderConfig, settings: Settings, history: History,
                pixel_idx=None):
    """Phase 1 — the opaque trace. Returns (gb, aux): per-pixel planes and
    the pixel-independent outputs (none in the ported paths)."""
    gb = trace_opaque.trace_opaque(ctx, scene, cam, cfg, settings, history.frame_index,
                                   pixel_idx)
    gb.pop("shadow_ray")
    return gb, {}


def _reblur_spec_mv(cfg: RenderConfig, cam: Camera, gb: dict, img):
    """Specular virtual-motion vector for REBLUR: the specular history
    follows the virtual image behind the reflector, not the surface."""
    x_img = img(gb["primary_x"])
    eye = cam.view_to_world[:3, 3]
    vdir = geo.normalize(x_img - eye)
    return reblur.specular_virtual_mv(
        cam, x_img, vdir, img(gb["spec_hitdist"]), img(gb["roughness"]), img(gb["mv"]),
        cfg.width, cfg.height, miss=img(gb["miss"]))


def _max_acc(settings: Settings):
    """Accumulation-frame cap from Settings, floored at 1."""
    return torch.clamp_min(settings.max_accumulated_frame_num, 1).to(torch.float32)


def _reblur_settings(settings: Settings) -> reblur.ReblurSettings:
    max_acc = _max_acc(settings)
    return reblur.ReblurSettings(max_accumulated_frames=max_acc,
                                 max_fast_accumulated_frames=torch.clamp_min(max_acc / 5.0, 1.0))


def image_frame_begin(cfg: RenderConfig, settings: Settings, cam: Camera,
                      history: History, gb: dict, aux: dict, reset_history=False) -> dict:
    """Phase 2a — hit-distance reconstruction, SIGMA, and REBLUR's temporal
    accumulation. Returns the ``mid`` dict for ``image_frame_finish``;
    mid["gb_updates"] holds the G-buffer planes changed here."""
    frame = history.frame_index
    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    def flat(a):
        return a.reshape((n_local,) + a.shape[2:])

    diff, spec, shadow = gb["diff_radiance"], gb["spec_radiance"], gb["shadow"]

    # AREA_3X3 hit-distance reconstruction: probabilistic lobe selection
    # leaves the unsampled lobe's hit distance at 0
    gb_updates: dict = {}
    if cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC and cfg.denoiser == Denoiser.REBLUR:
        gb_updates = {
            k: flat(checkerboard.hitdist_reconstruct_3x3(img(gb[k])))
            for k in ("diff_hitdist", "spec_hitdist")
        }
        gb = dict(gb, **gb_updates)

    new_h: dict[str, Any] = {"frame_index": frame + 1}
    if history.sigma is not None:
        tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        shadow_img, new_h["sigma"] = sigma.denoise(
            history.sigma, img(shadow), img(gb["shadow_hit_dist"]), img(gb["view_z"]),
            img(gb["mv"]), tan_sun, unproj, frame, reset=reset_history)
        shadow = flat(shadow_img)

    reblur_mid: dict = {}
    if cfg.denoiser == Denoiser.REBLUR:
        s = _reblur_settings(settings)
        for sig, hist_sig, radiance, hitdist_key, mv_sig in (
            ("reblur_diff", history.reblur_diff, diff, "diff_hitdist", img(gb["mv"])),
            ("reblur_spec", history.reblur_spec, spec, "spec_hitdist",
             _reblur_spec_mv(cfg, cam, gb, img)),
        ):
            illum_in = img(radiance)
            if s.enable_anti_firefly:
                illum_in = common.anti_firefly(illum_in)
            reblur_mid[sig] = reblur.accumulate(
                hist_sig, illum_in, img(gb[hitdist_key]), img(gb["view_z"]),
                img(gb["normal"]), mv_sig, s, reset=reset_history)

    return {"gb_updates": gb_updates, "diff": diff, "spec": spec, "shadow": shadow,
            "new_h": new_h, "reblur": reblur_mid}


def image_frame_finish(cfg: RenderConfig, settings: Settings, cam: Camera,
                       history: History, gb: dict, aux: dict, mid: dict,
                       reset_history=False):
    """Phase 2b — REBLUR blur and stabilization, composition, REFERENCE
    accumulation and the new history. ``gb`` has mid["gb_updates"] merged
    in. Returns (outputs, new history)."""
    frame = history.frame_index
    diff, spec, shadow = mid["diff"], mid["spec"], mid["shadow"]
    new_h = dict(mid["new_h"])
    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    def flat(a):
        return a.reshape((n_local,) + a.shape[2:])

    if cfg.denoiser == Denoiser.REBLUR:
        s = _reblur_settings(settings)
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        outs = {}
        for sig in ("reblur_diff", "reblur_spec"):
            acc, fast, hd, frames_sig = mid["reblur"][sig]
            blurred, hd_blur = reblur.adaptive_blur(
                acc, hd, img(gb["view_z"]), img(gb["normal"]), img(gb["roughness"]),
                frames_sig, frame, s, sig == "reblur_spec", unproj)
            out_sig, frames_sig = reblur.stabilize(blurred, fast, frames_sig, s)
            new_h[sig] = reblur.ReblurHistory(
                illum=out_sig, fast_illum=fast, hitdist=hd_blur, view_z=img(gb["view_z"]),
                normal=img(gb["normal"]), frames=frames_sig)
            outs[sig] = flat(out_sig)
        diff, spec = outs["reblur_diff"], outs["reblur_spec"]

    composed = composition.compose(gb, diff, spec, shadow)
    if cfg.denoiser == Denoiser.REFERENCE and history.reference is not None:
        composed, new_h["reference"] = reference.accumulate(history.reference, composed,
                                                            reset=reset_history)
    outputs = {
        "color": composed,
        "final": composed,
        "display": None,
        "debug": None,
        "view_z": gb["view_z"],
        "normal": gb["normal"],
        "shadow": shadow,
        "diff_radiance": diff,
        "spec_radiance": spec,
        "gbuffer": gb,
        "glass_mask": None,
        "taa_wide_mask": None,
    }
    return outputs, History(**new_h)


def image_frame(cfg: RenderConfig, settings: Settings, cam: Camera,
                history: History, gb: dict, aux: dict, reset_history=False):
    """Phase 2 — image_frame_begin then image_frame_finish. Returns
    (outputs, new history); outputs["color"] is the composed HDR radiance
    (N, 3), accumulated under REFERENCE."""
    trace_opaque.check_config_supported(cfg)
    ported = {Denoiser.REFERENCE: history.reference, Denoiser.REBLUR: history.reblur_diff}
    if ported.get(cfg.denoiser) is None:
        raise NotImplementedError(
            f"denoiser {cfg.denoiser.name} with this History: only REFERENCE and REBLUR are "
            "ported, each with the History of its own RenderConfig")
    mid = image_frame_begin(cfg, settings, cam, history, gb, aux, reset_history)
    gb = dict(gb, **mid["gb_updates"])
    return image_frame_finish(cfg, settings, cam, history, gb, aux, mid, reset_history)


def render_frame(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                 cfg: RenderConfig, settings: Settings, history: History,
                 reset_history=False, pixel_idx=None):
    """One frame: trace_frame then image_frame. Returns (outputs, history).
    Each phase is a ``torch.profiler`` range of its own name, which
    ``profile_frame`` reads."""
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
    with torch.profiler.record_function("trace_frame"):
        gb, aux = trace_frame(ctx, scene, cam, cfg, settings, history, pixel_idx=pixel_idx)
    with torch.profiler.record_function("image_frame"):
        return image_frame(cfg, settings, cam, history, gb, aux, reset_history)
