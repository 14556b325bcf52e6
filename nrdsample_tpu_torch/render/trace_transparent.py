"""TraceTransparent — the glass pass (counterpart of
``nrdsample_tpu/render/trace_transparent.py``).

The primary ray is cast again against the transparent context, limited by
the opaque hit distance. On a glass hit two delta chains start, one as a
reflection and one as a refraction, each up to ``delta_bounce_num``
Fresnel-driven bounces with Beer-Lambert absorption inside the medium, each
ending with the radiance cascade; their sum replaces the composed colour on
glass pixels. Both chains run as one 2N-ray wavefront with one deferred
shadow launch for all chain ends.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import RenderConfig, Settings
from nrdsample_tpu_torch.mathlib import geometry as geo, rng
from nrdsample_tpu_torch.ops import sharc, traversal
from nrdsample_tpu_torch.render import gbuffer, lighting
from nrdsample_tpu_torch.scene import camera as cam_mod
from nrdsample_tpu_torch.scene.types import Camera, Scene

GLASS_TINT = (0.9, 0.95, 1.0)   # absorption colour inside glass


def _closest_hit_world(ctxs: traversal.SceneContexts, o, d, t_max=traversal.T_MAX) -> dict:
    """Closest hit against the opaque and the transparent context."""
    a = traversal.closest_hit(ctxs.opaque, o, d, t_max=t_max)
    if ctxs.transparent is None:
        return a
    b = traversal.closest_hit(ctxs.transparent, o, d, t_max=t_max)
    take_b = b["t"] < a["t"]
    return {k: torch.where(take_b, b[k], a[k]) for k in a}


def _fresnel_dielectric(cos_i, eta):
    """Exact dielectric Fresnel reflectance for unpolarized light; eta =
    n_t / n_i. 1 on total internal reflection."""
    cos_i = geo.clip(geo.absolute(cos_i), 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / geo.clip_min(eta * eta, 1e-6)
    cos_t = torch.sqrt(geo.clip_min(1.0 - sin2_t, 0.0) + 1e-12)
    rs = (cos_i - eta * cos_t) / geo.clip_min(cos_i + eta * cos_t, 1e-9)
    rp = (eta * cos_i - cos_t) / geo.clip_min(eta * cos_i + cos_t, 1e-9)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin2_t > 1.0, 1.0, geo.clip(f, 0.0, 1.0))


def _decode(scene: Scene, hit, o, d, sun_dir, tan_sun, cfg: RenderConfig, settings: Settings):
    return gbuffer.decode_hit(scene, hit, o, d, sun_dir, tan_sun, cfg.use_white_furnace,
                              settings.emission_intensity, forced_material=settings.forced_material,
                              emission_scale_cubes=settings.emission_intensity_cubes,
                              use_normal_map=settings.use_normal_map)


def _delta_chain(ctxs: traversal.SceneContexts, scene: Scene, cfg: RenderConfig,
                 settings: Settings, frame, pixel_idx, origin, start_mask, start_is_reflection,
                 glass_props: dict, sun_dir, tan_sun, unproject, cam: Camera,
                 sharc_state: sharc.SharcState | None = None):
    """The delta chains from the first glass hit; returns their radiance.
    Each lane ends its chain at most once, on a non-glass hit or a miss: the
    end's radiance is kept for both sun-shadow outcomes and one batched
    any-hit launch after the loop picks between them."""
    n_px = origin.shape[0]
    f32, dev = cfg.dtype, origin.device
    ior = scene.materials.ior[glass_props["mat"].long()]
    one_minus_tint = 1.0 - torch.tensor(GLASS_TINT, dtype=f32, device=dev)

    props = glass_props
    inside = torch.zeros((n_px,), dtype=torch.bool, device=dev)
    throughput = torch.ones((n_px, 3), dtype=f32, device=dev)
    rad0 = torch.zeros((n_px, 3), dtype=f32, device=dev)   # radiance if shadowed
    rad1 = torch.zeros((n_px, 3), dtype=f32, device=dev)   # radiance if lit
    alive = start_mask
    end_x = origin
    end_n = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev).expand(n_px, 3)
    end_shadowable = torch.zeros((n_px,), dtype=torch.bool, device=dev)

    for bounce in range(cfg.delta_bounce_num):
        dim = 700_000 + 1000 * bounce
        n, v = props["n"], props["v"]
        cos_i = geo.dot3(v, n)
        eta = torch.where(inside, 1.0 / ior, ior)   # n_t / n_i at this interface
        f = _fresnel_dielectric(cos_i, eta)
        # bounce 0: the chain fixes the first event, weighted by Fresnel;
        # later bounces choose by Fresnel, whose probability cancels the weight
        if bounce == 0:
            reflect_now = start_is_reflection
            w = torch.where(reflect_now, f, 1.0 - f)
        else:
            reflect_now = rng.uniform1(pixel_idx, frame, dim) < f
            w = torch.ones_like(f)
        ray_refl = geo.reflect(-v, n)
        ray_refr = geo.refract(-v, n, 1.0 / geo.clip_min(eta, 1e-6))
        reflect_now = reflect_now | (geo.length(ray_refr) < 0.5)   # total internal reflection
        ray = torch.where(reflect_now[..., None], ray_refl, geo.normalize(ray_refr))
        throughput = throughput * w[..., None]
        inside = torch.where(alive & ~reflect_now, ~inside, inside)

        s = torch.where(geo.dot3(ray, props["n_geom"]) >= 0, 1.0, -1.0)
        view_z = cam_mod.world_to_view_z(cam, props["x"])
        xo = geo.offset_ray(props["x"], props["n_geom"] * s[..., None], view_z, unproject,
                            cfgmod.PT_GLASS_RAY_OFFSET)
        props = _decode(scene, _closest_hit_world(ctxs, xo, ray), xo, ray, sun_dir, tan_sun, cfg,
                        settings)

        # Beer-Lambert absorption through the medium
        seg = torch.where(props["miss"], 0.0, props["t"])
        absorb = torch.exp(-seg[..., None] * one_minus_tint * 2.0)
        throughput = torch.where((inside & alive)[..., None], throughput * absorb, throughput)

        hit_is_glass = ((props["flags"] & cfgmod.FLAG_TRANSPARENT) != 0) & ~props["miss"]
        ended = alive & ~hit_is_glass
        direct = lighting.direct_sun_lighting(
            props["n"], props["v"], props["base_color"], props["metalness"], props["roughness"],
            sun_dir, tan_sun, cfg.use_white_furnace)
        l_end0 = props["lemi"]                                       # shadowed (or a miss)
        l_end1 = torch.where(props["miss"][..., None], props["lemi"], direct + props["lemi"])
        shadow_dep = ~props["miss"]
        if sharc_state is not None:
            # the radiance cascade prefers the cache (it holds multi-bounce
            # light) over the analytic direct term
            rad, found = sharc.query(sharc_state, props["x"], props["n"], cam.position,
                                     dither=rng.uniform1(pixel_idx, frame, dim + 7))
            use = found & ~props["miss"]
            l_end0 = torch.where(use[..., None], rad + props["lemi"], l_end0)
            l_end1 = torch.where(use[..., None], rad + props["lemi"], l_end1)
            shadow_dep = shadow_dep & ~use
        rad0 = rad0 + torch.where(ended[..., None], throughput * l_end0, 0.0)
        rad1 = rad1 + torch.where(ended[..., None], throughput * l_end1, 0.0)
        latch = (ended & shadow_dep)[..., None]
        end_x = torch.where(latch, props["x"], end_x)
        end_n = torch.where(latch, props["n_geom"], end_n)
        end_shadowable = end_shadowable | (ended & shadow_dep)
        alive = alive & hit_is_glass

    # one deferred shadow launch for every chain end
    vz = cam_mod.world_to_view_z(cam, end_x)
    sxo, sdir = lighting.sun_shadow_ray_params(end_x, end_n, sun_dir, tan_sun, pixel_idx, frame,
                                               unproject, vz, dim=700_777)
    blocked = traversal.any_hit(ctxs.opaque, sxo, sdir,
                                torch.full((n_px,), traversal.T_MAX, device=dev), coherent=False)
    lit = ~blocked | ~end_shadowable | (settings.disable_shadows > 0)
    return torch.where(lit[..., None], rad1, rad0)


def trace_transparent_color(ctxs: traversal.SceneContexts, scene: Scene, cam: Camera,
                            cfg: RenderConfig, settings: Settings, frame, gb: dict, pixel_idx,
                            sharc_state: sharc.SharcState | None = None):
    """The traversal part of the glass pass: (glass colour (N, 3), glass mask
    (N,)); the caller overlays the colour where the mask is set."""
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)
    origin, direction, _ = cam_mod.camera_rays(cam, cfg.width, cfg.height, pixel_idx, frame)
    hit = traversal.closest_hit(ctxs.transparent, origin, direction, t_max=gb["primary_t"])
    glass = hit["tri"] >= 0
    props = _decode(scene, hit, origin, direction, sun_dir, tan_sun, cfg, settings)

    # both chains in one 2N wavefront; the chain id fixes the first event
    def cat(a):
        return torch.cat([a, a])

    both = _delta_chain(
        ctxs, scene, cfg, settings, frame, torch.cat([pixel_idx, pixel_idx + cfg.n_pixels]),
        cat(origin), cat(glass), torch.cat([torch.ones_like(glass), torch.zeros_like(glass)]),
        {k: cat(v) for k, v in props.items()}, sun_dir, tan_sun, unproject, cam, sharc_state)
    n_px = glass.shape[0]
    return both[:n_px] + both[n_px:], glass


def trace_transparent(ctxs: traversal.SceneContexts, scene: Scene, cam: Camera,
                      cfg: RenderConfig, settings: Settings, frame, composed: torch.Tensor,
                      gb: dict, pixel_idx, sharc_state: sharc.SharcState | None = None):
    """Overlay glass on the composed image. Returns (colour, glass mask)."""
    if ctxs.transparent is None:
        return composed, torch.zeros(composed.shape[:-1], dtype=torch.bool, device=composed.device)
    glass_color, glass = trace_transparent_color(ctxs, scene, cam, cfg, settings, frame, gb,
                                                 pixel_idx, sharc_state)
    return torch.where(glass[..., None], glass_color, composed), glass
