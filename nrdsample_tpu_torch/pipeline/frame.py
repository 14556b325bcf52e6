"""The frame function (counterpart of ``nrdsample_tpu/pipeline/frame.py``):
``render_frame`` = ``trace_frame`` (everything that launches rays) followed by
``image_frame`` (the denoisers, then composition), threading an explicit
``History``. Eager PyTorch: each call runs on the device of its tensors.

Every denoiser path is ported: REFERENCE accumulation, REBLUR or RELAX with
SIGMA for the sun shadow, and the learned recurrent denoiser of the RR slot
(NEURAL); with them the SHARC radiance cache and its history-confidence
plane, the L1 cache, the SH resolve, the OCCLUSION and DIRECTIONAL_OCCLUSION
modes, HALF (checkerboard) tracing, TAA, the output-resolution chain (the SR
slot, NIS, the Final pass), the debug views and the validation overlay. The trace
runs the SHARC update pass before the opaque trace (with the PSR walk and
the L1 cache), then the stress tests and sanitization; with glass (a
``SceneContexts`` with a transparent context) it then marches the
sun-shadow rays through the glass layers and traces the glass delta chains.
The image work runs as ``image_frame_begin`` (history confidence,
hit-distance reconstruction or the checkerboard resolve, SIGMA, the
occlusion planes, RELAX, REBLUR temporal accumulation) then
``image_frame_finish`` (REBLUR blur and stabilization, SH resolve and
composition, the glass overlay, the RR slot, REFERENCE, TAA, ``post_chain``,
the debug view, the validation overlay, the L1 history, history assembly),
with every history gather inline.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import Denoiser, NrdMode, RenderConfig, Settings, TracingMode
from nrdsample_tpu_torch.denoise import (checkerboard, common, composition, confidence,
                                         occlusion, reblur, reference, relax, sh, sigma, taa)
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.mathlib import color, geometry as geo
from nrdsample_tpu_torch.ops import sharc, traversal
from nrdsample_tpu_torch.post import final as final_mod, guides, neural_rr, neural_sr, nis, upscale
from nrdsample_tpu_torch.render import l1cache, sharc_update, stress, trace_opaque, trace_transparent
from nrdsample_tpu_torch.scene import camera as cam_mod
from nrdsample_tpu_torch.scene.types import Camera, Scene


@dataclasses.dataclass
class History:
    """Cross-frame state: the frame index and the slots of the configured
    denoiser, radiance caches and TAA (unused slots are None)."""

    frame_index: torch.Tensor   # () int32
    reference: Any = None       # reference.ReferenceHistory
    relax_diff: Any = None      # relax.RelaxHistory
    relax_spec: Any = None
    reblur_diff: Any = None     # reblur.ReblurHistory
    reblur_spec: Any = None
    sigma: Any = None           # sigma.SigmaHistory
    taa: Any = None             # taa.TaaHistory
    sharc: Any = None           # sharc.SharcState (the L2 radiance cache)
    l1: Any = None              # l1cache.L1History (the previous frame's irradiance)
    confidence: Any = None      # confidence.ConfidenceHistory (probe luminance)
    neural_rr: Any = None       # neural_rr.NeuralRRHistory (the RR slot)

    @staticmethod
    def create(cfg: RenderConfig, device=None) -> "History":
        """The empty history of ``cfg`` on ``device`` (the CUDA card when
        None)."""
        device = resolve(device)
        h, w, dt = cfg.height, cfg.width, cfg.dtype
        kw: dict[str, Any] = {"frame_index": torch.tensor(0, dtype=torch.int32, device=device)}
        if cfg.use_sharc:
            kw["sharc"] = sharc.SharcState.create(cfg.sharc_capacity, dt, device)
            if cfg.use_confidence:
                ds = cfg.sharc_downscale
                kw["confidence"] = confidence.ConfidenceHistory.create(
                    max(h // ds, 1), max(w // ds, 1), dt, device)
        if cfg.use_l1_cache:
            kw["l1"] = l1cache.L1History.create(h, w, dt, device)
        if cfg.denoiser == Denoiser.REFERENCE:
            kw["reference"] = reference.ReferenceHistory.create(cfg.n_pixels, dt, device)
        elif cfg.denoiser == Denoiser.RELAX:
            kw["relax_diff"] = relax.RelaxHistory.create(h, w, dt, device)
            kw["relax_spec"] = relax.RelaxHistory.create(h, w, dt, device)
            kw["sigma"] = sigma.SigmaHistory.create(h, w, dt, device)
        elif cfg.denoiser == Denoiser.REBLUR:
            kw["reblur_diff"] = reblur.ReblurHistory.create(h, w, dt, device)
            kw["reblur_spec"] = reblur.ReblurHistory.create(h, w, dt, device)
            kw["sigma"] = sigma.SigmaHistory.create(h, w, dt, device)
        elif cfg.denoiser == Denoiser.NEURAL:
            kw["neural_rr"] = neural_rr.NeuralRRHistory.create(h, w, dt, device)
        if cfg.use_taa:
            kw["taa"] = taa.TaaHistory.create(h, w, dt, device)
        return History(**kw)


def _shadow_translucency_march(tctx: traversal.TraceContext, scene: Scene, cfg: RenderConfig,
                               sxo: torch.Tensor, sdir: torch.Tensor):
    """March the sun-shadow rays through up to PT_SHADOW_GLASS_LAYERS glass
    layers of the transparent context (opaque blockers are in the binary
    shadow already). Each layer multiplies the translucency by lerp(0.9, 0,
    (1 - NoV)^2.5) and by the glass tint; the march stops once the
    translucency's luminance is at most 0.01. Returns (translucency (N, 3),
    distance to the first glass layer (N,), 0 where none)."""
    n_px = sxo.shape[0]
    f32, dev = cfg.dtype, sxo.device
    trans = torch.ones((n_px, 3), dtype=f32, device=dev)
    first_t = torch.zeros((n_px,), dtype=f32, device=dev)
    dist = torch.zeros((n_px,), dtype=f32, device=dev)   # distance marched so far
    o = sxo
    active = torch.ones((n_px,), dtype=torch.bool, device=dev)
    tr = tctx.tris
    for _ in range(cfgmod.PT_SHADOW_GLASS_LAYERS):
        hit = traversal.closest_hit(tctx, o, sdir)
        found = (hit["tri"] >= 0) & active
        tri_local = torch.clamp_min(hit["tri"] - tctx.tri_offset, 0).long()
        n_geom = geo.normalize(geo.cross(tr.e1[tri_local], tr.e2[tri_local]))
        p = torch.pow(geo.clip(1.0 - geo.absolute(geo.dot3(n_geom, sdir)), 0.0, 1.0), 2.5)
        factor = 0.9 * (1.0 - p)
        tint = scene.materials.base_color[tr.material[tri_local].long()]
        trans = trans * torch.where(found[..., None], factor[..., None] * tint, 1.0)
        t = torch.where(found, hit["t"], 0.0)
        first_t = torch.where(found & (first_t == 0.0), dist + t, first_t)
        dist = dist + t
        # past the layer: hitT plus an epsilon
        o = o + sdir * (t + 1e-3 * torch.where(found, 1.0, 0.0))[..., None]
        active = found & (color.luminance(trans) > 0.01)
    return trans, first_t


def trace_frame(ctx, scene: Scene, cam: Camera, cfg: RenderConfig, settings: Settings,
                history: History, pixel_idx=None, dynamics=None, probe_mesh=None):
    """Phase 1 — the SHARC update pass, the opaque trace, the stress tests
    and sanitization, and with glass the shadow translucency march and the
    glass delta chains. ``ctx`` is a
    TraceContext or a SceneContexts; ``dynamics`` is the opaque trace's
    (InstancedScene, m_curr, m_prev) of an animated frame. Returns (gb, aux): per-pixel planes
    (with glass: glass_color, glass_mask and the tinted shadow) and the
    pixel-independent outputs {"sharc": the updated cache, "probes": the
    probe planes}.

    ``pixel_idx``, flat int32 pixel indices (the whole image when None),
    selects the pixels: every per-pixel plane is aligned with it, and each
    pixel's RNG is keyed by its index, so a block traces what the whole
    image traces there. ``probe_mesh`` (``parallel.mesh.PixelMesh``)
    splits the SHARC probe traces over its ranks
    (``sharc_update.sharc_update_pass``); the cache and the probe planes
    in ``aux`` stay whole on every rank."""
    ctxs = ctx if isinstance(ctx, traversal.SceneContexts) else traversal.SceneContexts(ctx, None)
    frame = history.frame_index
    sharc_state, probes = history.sharc, None
    if cfg.use_sharc and sharc_state is not None:
        sharc_state, probes = sharc_update.sharc_update_pass(ctxs, scene, cam, cfg, settings, frame,
                                                             sharc_state, probe_mesh=probe_mesh)
    gb = trace_opaque.trace_opaque(ctxs.opaque, scene, cam, cfg, settings, frame, pixel_idx,
                                   sharc_state if cfg.use_sharc else None,
                                   history.l1 if cfg.use_l1_cache else None,
                                   dynamics=dynamics)
    shadow_ray = gb.pop("shadow_ray")

    stress_on = (cfg.use_drs_stress_test or cfg.use_inf_stress_test or cfg.use_firefly_test
                 or cfg.use_material_id_test)
    if stress_on or cfg.use_sanitization:
        pidx = pixel_idx if pixel_idx is not None else torch.arange(
            cfg.n_pixels, dtype=torch.int32, device=gb["view_z"].device)
        if stress_on:
            gb = stress.apply_stress_tests(gb, cfg, settings, pidx, frame)
        if cfg.use_sanitization:
            gb = stress.sanitize_gbuffer(gb, cfg, settings, pidx)

    if ctxs.transparent is not None and cfg.use_translucency:
        # the sun-shadow ray through the glass layers: the luminance of the
        # translucency scales the shadow, its chroma tints it at composition,
        # and the nearest layer joins SIGMA's penumbra distance as a blocker
        trans_rgb, glass_t = _shadow_translucency_march(ctxs.transparent, scene, cfg, *shadow_ray)
        off = settings.disable_shadows > 0
        trans_rgb = torch.where(off, torch.ones_like(trans_rgb), trans_rgb)
        lum = color.luminance(trans_rgb)
        gb["shadow"] = gb["shadow"] * lum
        tint = trans_rgb / geo.clip_min(lum, 1e-6)[..., None]
        gb["shadow_tint"] = torch.where((lum > 1e-6)[..., None], tint, torch.ones_like(tint))
        hd = gb["shadow_hit_dist"]
        glass_t = torch.where(off, 0.0, glass_t)
        gb["shadow_hit_dist"] = torch.where(
            glass_t > 0.0, torch.where(hd > 0.0, torch.minimum(hd, glass_t), glass_t), hd)

    if ctxs.transparent is not None:
        if pixel_idx is None:
            pixel_idx = torch.arange(cfg.n_pixels, dtype=torch.int32, device=gb["view_z"].device)
        gb["glass_color"], gb["glass_mask"] = trace_transparent.trace_transparent_color(
            ctxs, scene, cam, cfg, settings, frame, gb, pixel_idx,
            sharc_state if cfg.use_sharc else None)
    return gb, {"sharc": sharc_state, "probes": probes}


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
                                 max_fast_accumulated_frames=geo.clip_min(max_acc / 5.0, 1.0))


def _confidence_plane(cfg: RenderConfig, settings: Settings, history: History, probes: dict):
    """(H, W) history-confidence plane from the probe gradient, and the new
    confidence history: gradient -> à-trous blur -> confidence at probe
    resolution, spread over the pixels of each probe (nearest, the
    remainder rows and columns taking the edge probe)."""
    grad, new_hist = confidence.gradient_from_probes(history.confidence, probes)
    grad = confidence.atrous_blur(grad, probes["view_z"], probes["normal"])
    conf_lo = confidence.gradient_to_confidence(grad, history.frame_index,
                                                relax_square=cfg.denoiser == Denoiser.RELAX)
    conf_lo = conf_lo * settings.prev_frame_confidence
    hs, ws = conf_lo.shape
    ds, dev = cfg.sharc_downscale, conf_lo.device
    rows = torch.clamp_max(torch.arange(cfg.height, device=dev) // ds, hs - 1)
    cols = torch.clamp_max(torch.arange(cfg.width, device=dev) // ds, ws - 1)
    return conf_lo[rows][:, cols], new_hist


def image_frame_begin(cfg: RenderConfig, settings: Settings, cam: Camera,
                      history: History, gb: dict, aux: dict, reset_history=False) -> dict:
    """Phase 2a — history confidence, hit-distance reconstruction or the
    checkerboard resolve, SIGMA, the occlusion planes of the occlusion
    modes, RELAX, and REBLUR's temporal accumulation. Returns the ``mid``
    dict for ``image_frame_finish``; mid["gb_updates"] holds the G-buffer
    planes changed here."""
    frame = history.frame_index
    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    def flat(a):
        return a.reshape((n_local,) + a.shape[2:])

    diff, spec, shadow = gb["diff_radiance"], gb["spec_radiance"], gb["shadow"]

    # the history-confidence plane (gPrevFrameConfidence) from the SHARC probes
    conf_img, new_conf = None, history.confidence
    probes = aux.get("probes")
    if (cfg.use_sharc and cfg.use_confidence and history.confidence is not None
            and probes is not None and n_local == cfg.n_pixels):
        conf_img, new_conf = _confidence_plane(cfg, settings, history, probes)
        # a history-control signal (gPrevFrameConfidence), not a radiance
        # path: detached from autograd, as the other history gates are
        conf_img = conf_img.detach()

    # AREA_3X3 hit-distance reconstruction: probabilistic lobe selection
    # leaves the unsampled lobe's hit distance at 0
    gb_updates: dict = {}
    if (cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC
            and cfg.denoiser in (Denoiser.REBLUR, Denoiser.RELAX)):
        gb_updates = {
            k: flat(checkerboard.hitdist_reconstruct_3x3(img(gb[k])))
            for k in ("diff_hitdist", "spec_hitdist")
        }
        gb = dict(gb, **gb_updates)
    if cfg.tracing_mode == TracingMode.HALF and n_local == cfg.n_pixels:
        # each lobe was traced on half of the pixels: fill the others
        cb = checkerboard.checkerboard_mask(h_local, w, frame)
        diff = flat(checkerboard.resolve(img(diff), cb))
        spec = flat(checkerboard.resolve(img(spec), ~cb))
        gb_updates = {"diff_hitdist": flat(checkerboard.resolve(img(gb["diff_hitdist"]), cb)),
                      "spec_hitdist": flat(checkerboard.resolve(img(gb["spec_hitdist"]), ~cb))}
        gb = dict(gb, **gb_updates)

    new_h: dict[str, Any] = {"frame_index": frame + 1}
    if new_conf is not None:
        new_h["confidence"] = new_conf
    if history.sigma is not None:
        tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
        unproj = cam_mod.unproject_scale(cam, cfg.height)
        shadow_img, new_h["sigma"] = sigma.denoise(
            history.sigma, img(shadow), img(gb["shadow_hit_dist"]), img(gb["view_z"]),
            img(gb["mv"]), tan_sun, unproj, frame, reset=reset_history)
        shadow = flat(shadow_img)

    if cfg.nrd_mode in (NrdMode.OCCLUSION, NrdMode.DIRECTIONAL_OCCLUSION):
        # the denoisers take [0, 1] occlusion planes in place of the radiance
        nh_d = occlusion.norm_hitdist(gb["diff_hitdist"], gb["view_z"])
        nh_s = occlusion.norm_hitdist(gb["spec_hitdist"], gb["view_z"])
        if cfg.nrd_mode == NrdMode.DIRECTIONAL_OCCLUSION:
            d_occ = occlusion.directional_occlusion(nh_d, gb["diff_dir"], gb["normal"])
            s_occ = occlusion.directional_occlusion(nh_s, gb["spec_dir"], gb["normal"])
        else:
            d_occ = occlusion.occlusion_from_hitdist(nh_d)
            s_occ = occlusion.occlusion_from_hitdist(nh_s)
        diff = d_occ[..., None].expand(-1, 3).contiguous()
        spec = s_occ[..., None].expand(-1, 3).contiguous()

    if cfg.denoiser == Denoiser.RELAX:
        s = relax.RelaxSettings(max_accumulated_frames=_max_acc(settings))
        outs = {}
        for sig, hist_sig, radiance in (("relax_diff", history.relax_diff, diff),
                                        ("relax_spec", history.relax_spec, spec)):
            out_sig, new_h[sig] = relax.denoise(
                hist_sig, img(radiance), img(gb["view_z"]), img(gb["normal"]), img(gb["mv"]), s,
                reset=reset_history, confidence=conf_img)
            outs[sig] = flat(out_sig)
        diff, spec = outs["relax_diff"], outs["relax_spec"]

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
                img(gb["normal"]), mv_sig, s, reset=reset_history, confidence=conf_img)

    return {"gb_updates": gb_updates, "diff": diff, "spec": spec, "shadow": shadow,
            "new_h": new_h, "reblur": reblur_mid}


def image_frame_finish(cfg: RenderConfig, settings: Settings, cam: Camera,
                       history: History, gb: dict, aux: dict, mid: dict,
                       reset_history=False):
    """Phase 2b — REBLUR blur and stabilization, the SH resolve and
    composition, the glass overlay, the RR slot, REFERENCE accumulation,
    TAA, the output-resolution chain, the debug view, the validation
    overlay and the new history. ``gb`` has mid["gb_updates"] merged in.
    Returns (outputs, new history)."""
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

    if cfg.nrd_mode in (NrdMode.OCCLUSION, NrdMode.DIRECTIONAL_OCCLUSION):
        composed = occlusion.compose_occlusion(gb, diff[..., 0], spec[..., 0], shadow)
    elif cfg.nrd_mode == NrdMode.SH:
        # the SH resolve re-sharpens each lobe with the shading normal
        composed = composition.compose(
            gb, sh.resolve({"radiance": diff, "dir": gb["diff_dir"]}, gb["normal"]),
            sh.resolve({"radiance": spec, "dir": gb["spec_dir"]}, gb["normal"]),
            shadow)
    else:
        composed = composition.compose(gb, diff, spec, shadow)
    glass_mask = gb.get("glass_mask")
    if glass_mask is not None:
        composed = torch.where(glass_mask[..., None], gb["glass_color"], composed)
    if cfg.denoiser == Denoiser.NEURAL and history.neural_rr is not None:
        # the RR slot: the learned recurrent denoiser on the noisy composed
        # image and the guide buffers
        rg = guides.rr_guides(gb, near=0.01, mv_type=settings.mv_type)
        rr_g = {k: img(rg[k]) for k in ("diff_albedo", "spec_albedo", "normal_roughness", "depth")}
        den_img, new_h["neural_rr"] = neural_rr.denoise(
            neural_rr.load_weights(device=composed.device), img(composed), rr_g,
            img(gb["mv"])[..., :2], history.neural_rr, reset=reset_history)
        composed = flat(den_img)
    if cfg.denoiser == Denoiser.REFERENCE and history.reference is not None:
        composed, new_h["reference"] = reference.accumulate(history.reference, composed,
                                                            reset=reset_history)

    final, taa_wide_mask = composed, None
    if cfg.use_taa and history.taa is not None:
        # TAA on the exposed image; sky, hair and glass pixels take the wide
        # (5x5) neighbourhood clamp
        taa_wide_mask = gb["miss"] | ((gb["flags"] & cfgmod.FLAG_HAIR) > 0)
        if glass_mask is not None:
            taa_wide_mask = taa_wide_mask | glass_mask
        taa_out, new_h["taa"] = taa.apply(
            history.taa, img(composed * settings.exposure * 1e-2), img(gb["mv"]),
            img(gb["view_z"]), wide_mask=img(taa_wide_mask), reset=reset_history)
        final = flat(taa_out)

    display = None
    if cfg.enable_post:
        display = post_chain(cfg, settings, gb, composed, final, frame,
                             taa_on=cfg.use_taa and history.taa is not None)

    debug = None
    if cfg.on_screen != cfgmod.OnScreen.FINAL:
        taa_w = None
        if cfg.on_screen == cfgmod.OnScreen.TAA_WEIGHT and history.taa is not None:
            taa_w = flat(taa.debug_weight(history.taa, img(composed * settings.exposure * 1e-2),
                                          img(gb["mv"]), img(gb["view_z"])))
        debug = composition.debug_view(cfg.on_screen, gb, composed, sharc_state=aux.get("sharc"),
                                       cam_pos=cam.position, taa_weight=taa_w)

    if cfg.use_validation_overlay:
        # the accumulation-age heatmap of the diffuse denoiser's history
        frames_plane = None
        for k in ("relax_diff", "reblur_diff"):
            if new_h.get(k) is not None:
                frames_plane = new_h[k].frames
        if frames_plane is not None:
            final = composition.validation_overlay(final, flat(frames_plane), _max_acc(settings))

    if cfg.use_sharc:
        new_h["sharc"] = aux["sharc"]
    if cfg.use_l1_cache:
        # next frame's L1 cache: this frame's composed diffuse and specular
        composed_diff = (gb["direct_lighting"] * shadow[..., None] + gb["emission"]
                         + diff * gb["diff_factor"])
        new_h["l1"] = l1cache.update_history(
            cam, composed_diff, spec * gb["spec_factor"], gb["view_z"], gb["normal"],
            cfgmod.sun_direction(settings), h_local, w)
    outputs = {
        "color": composed,
        "final": final,
        "display": display,
        "debug": debug,
        "view_z": gb["view_z"],
        "normal": gb["normal"],
        "shadow": shadow,
        "diff_radiance": diff,
        "spec_radiance": spec,
        "gbuffer": gb,
        "glass_mask": glass_mask,
        "taa_wide_mask": taa_wide_mask,
    }
    return outputs, History(**new_h)


def post_chain(cfg: RenderConfig, settings: Settings, gb: dict, composed: torch.Tensor,
               final: torch.Tensor, frame, taa_on: bool) -> torch.Tensor:
    """The output-resolution chain: the SR slot (the learned residual
    network over the Lanczos-2 resize with ``use_neural_sr``, else the
    resize alone), NIS sharpening with ``use_nis``, then the Final pass with
    the split screen, whose noisy side is the un-denoised signals
    recomposed, tonemapped and resized. ``final`` is the TAA output
    (tonemap range already) when ``taa_on``, else ``composed`` is
    tonemapped. Returns the (out_h, out_w, 3) display image in [0, 1]."""
    n_local = gb["view_z"].shape[0]
    w = cfg.width
    h_local = n_local // w

    def img(a):
        return a.reshape((h_local, w) + a.shape[1:])

    out_h = cfg.output_height or h_local
    out_w = cfg.output_width or w
    exp = settings.exposure * 1e-2
    tm = img(final) if taa_on else final_mod.tonemap_output(img(composed), exp)
    if cfg.use_neural_sr:
        sr_guides = {"normal": img(gb["normal"]), "roughness": img(gb["roughness"]),
                     "depth": img(guides.hw_depth(gb["view_z"], 0.01))}
        tm = neural_sr.apply(neural_sr.load_weights(device=tm.device), tm, sr_guides, out_h, out_w)
    else:
        tm = upscale.lanczos_resize(tm, out_h, out_w)
    if cfg.use_nis:
        tm = nis.sharpen(tm, settings.sharpness)
    noisy = composition.compose(gb, gb["diff_radiance"], gb["spec_radiance"], gb["shadow"])
    noisy_up = upscale.lanczos_resize(final_mod.tonemap_output(img(noisy), exp), out_h, out_w)
    return final_mod.final_pass(tm, noisy=noisy_up, separator=settings.separator,
                                frame_index=frame)


def image_frame(cfg: RenderConfig, settings: Settings, cam: Camera,
                history: History, gb: dict, aux: dict, reset_history=False):
    """Phase 2 — image_frame_begin then image_frame_finish. Returns
    (outputs, new history); outputs["color"] is the composed HDR radiance
    (N, 3), accumulated under REFERENCE; outputs["final"] is the TAA output
    where TAA is on (with the validation overlay blended over it);
    outputs["display"] is the post chain's (out_h, out_w, 3) image with
    ``enable_post``, outputs["debug"] the (N, 3) debug view of
    ``on_screen``."""
    slots = {Denoiser.REFERENCE: history.reference, Denoiser.REBLUR: history.reblur_diff,
             Denoiser.RELAX: history.relax_diff, Denoiser.NEURAL: history.neural_rr}
    if slots.get(cfg.denoiser) is None:
        raise ValueError(f"denoiser {cfg.denoiser.name} with a History that has no "
                         f"{cfg.denoiser.name} slot: create it from the same RenderConfig")
    mid = image_frame_begin(cfg, settings, cam, history, gb, aux, reset_history)
    gb = dict(gb, **mid["gb_updates"])
    return image_frame_finish(cfg, settings, cam, history, gb, aux, mid, reset_history)


def frame_inputs(cam: Camera, settings: Settings, history: History):
    """(cam, settings) of a frame: the dynamic camFov (0 keeps the
    camera's own FoV) and the blink pulse on the emissive cubes'
    intensity."""
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
    return cam, settings


def render_frame(ctx, scene: Scene, cam: Camera, cfg: RenderConfig, settings: Settings,
                 history: History, reset_history=False, pixel_idx=None, dynamics=None):
    """One frame: trace_frame then image_frame. ``ctx`` is a TraceContext or,
    for a scene with glass, the SceneContexts of ``build_scene_contexts``.
    ``dynamics``, an optional (InstancedScene, m_curr, m_prev), gives moving
    instances their true motion vectors. Returns (outputs, history).
    Each phase is a ``torch.profiler`` range of its own name, which
    ``profile_frame`` reads."""
    cam, settings = frame_inputs(cam, settings, history)
    with torch.profiler.record_function("trace_frame"):
        gb, aux = trace_frame(ctx, scene, cam, cfg, settings, history, pixel_idx=pixel_idx,
                              dynamics=dynamics)
    with torch.profiler.record_function("image_frame"):
        return image_frame(cfg, settings, cam, history, gb, aux, reset_history)
