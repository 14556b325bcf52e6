"""TraceOpaque — the per-pixel path tracer as a batched wavefront
(counterpart of ``nrdsample_tpu/render/trace_opaque.py``).

All N pixels advance in lockstep through the bounce loop with an ``alive``
mask; shadow visibility of every bounce and of the primary hit is resolved
by ONE batched any-hit launch after the loop (deferred-shadow scheme).
"""

from __future__ import annotations

import math

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, Settings, TracingMode
from nrdsample_tpu_torch.denoise.reblur import spec_magic_curve
from nrdsample_tpu_torch.mathlib import bluenoise, brdf, color, geometry as geo, rng, sampling
from nrdsample_tpu_torch.ops import sharc, traversal
from nrdsample_tpu_torch.render import emissive_is, gbuffer, l1cache, lighting, raycone
from nrdsample_tpu_torch.scene import camera as cam_mod
from nrdsample_tpu_torch.scene.types import Camera, Scene


def _shadow_rnd(cfg: RenderConfig, pixel_idx, frame, dim: int):
    """USE_BLUE_NOISE_FOR_SHADOWS: the blue-noise disc sample of the sun-shadow
    cone under the temporal denoisers; None (the white PCG stream) under
    REFERENCE accumulation, which wants an equidistributed per-pixel
    sequence."""
    if not cfg.use_blue_noise or cfg.denoiser == Denoiser.REFERENCE:
        return None
    return bluenoise.blue2(pixel_idx, cfg.width, frame, dim)


def estimate_diffuse_probability(props: dict, use_magic_boost: bool = False):
    """EstimateDiffuseProbability (RaytracingShared.hlsli:980-1009)."""
    albedo, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
    n_dot_v = geo.absolute(geo.dot3(props["n"], props["v"]))
    f_env = brdf.environment_term_rtg(f0, n_dot_v, props["roughness"])
    lum_spec = color.luminance(f_env)
    lum_diff = color.luminance(albedo * (1.0 - f_env))
    p = lum_diff / geo.clip_min(lum_diff + lum_spec, 1e-6)
    if use_magic_boost:
        r = props["roughness"]
        f = 1.0 - torch.exp2(-200.0 * (r * r))
        f = f * geo.pow01(r, 0.5)
        p = p + (1.0 - p) * f
    p = torch.where(p < cfgmod.PT_EVIL_TWIN_LOBE_TOLERANCE, 0.0, p)
    p = torch.where(p > 1.0 - cfgmod.PT_EVIL_TWIN_LOBE_TOLERANCE, 1.0, p)
    return p


def _pow5(x):
    # x**5 in the multiplication order of JAX's integer_pow: x * (x^2)^2
    x2 = x * x
    return x * (x2 * x2)


def _burley_diffuse_term(roughness, n_dot_l, n_dot_v, v_dot_h):
    """BRDF::DiffuseTerm_Burley (Disney diffuse), including the 1/pi."""
    f90 = 0.5 + 2.0 * roughness * (v_dot_h * v_dot_h)
    fl = 1.0 + (f90 - 1.0) * _pow5(1.0 - n_dot_l)
    fv = 1.0 + (f90 - 1.0) * _pow5(1.0 - n_dot_v)
    return fl * fv / sampling.PI


def generate_ray_and_update_throughput(props: dict, throughput: torch.Tensor,
                                       is_diffuse: torch.Tensor, pixel_idx, frame,
                                       dim: int, em_set: dict | None = None,
                                       n_candidates: int = 1,
                                       use_translucency: bool = False):
    """GenerateRayAndUpdateThroughput (RaytracingShared.hlsli:725-924), minus
    hair. With em_set and n_candidates > 1 the direction comes from the
    emissive-IS reservoir. use_translucency enables the leaf-transmit lobe.
    Returns (ray_world, throughput', shading_n', is_transmission)."""
    n = props["n"]
    v = props["v"]
    v_local = sampling.to_local(v, n)
    trim = cfgmod.PT_SPEC_LOBE_ENERGY

    if em_set is not None and n_candidates > 1:
        ray_local, mult = emissive_is.reservoir_sample_direction(
            props, em_set, is_diffuse, pixel_idx, frame, dim + 50, n_candidates, trim,
            spec_k_scale=spec_magic_curve(props["roughness"]),
        )
        throughput = throughput * mult[..., None]
    else:
        rnd = rng.uniform2(pixel_idx, frame, dim)
        ray_diff_local = sampling.cosine_ray(rnd)
        h_local = sampling.vndf_ggx(rnd, v_local, props["roughness"], trim)
        ray_spec_local = geo.reflect(-v_local, h_local)
        ray_local = torch.where(is_diffuse[..., None], ray_diff_local, ray_spec_local)

    if use_translucency:
        is_leaf = (props["flags"] & cfgmod.FLAG_LEAF) > 0
        rnd_t = rng.uniform1(pixel_idx, frame, dim + 7)
        is_transmission = is_leaf & is_diffuse & (rnd_t < cfgmod.LEAF_TRANSLUCENCY)
    else:
        is_transmission = torch.zeros_like(is_diffuse)

    albedo, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
    n_dot_l = geo.clip(ray_local[..., 2], 0.0, 1.0)
    h_full = geo.normalize(v_local + ray_local)
    v_dot_h = geo.absolute(geo.dot3(v_local, h_full))
    n_dot_v = geo.absolute(v_local[..., 2])

    k_diff = _burley_diffuse_term(props["roughness"], n_dot_l, n_dot_v, v_dot_h)
    if use_translucency:
        k_diff = torch.where(is_leaf, k_diff / (1.0 - cfgmod.LEAF_TRANSLUCENCY), k_diff)
    w_diff = albedo * (sampling.PI * k_diff)[..., None]
    f = brdf.fresnel_schlick(f0, v_dot_h)
    alpha = props["roughness"] * props["roughness"]
    w_spec = f * sampling.smith_g1(n_dot_l, alpha)[..., None]

    w = torch.where(is_diffuse[..., None], w_diff, w_spec)
    if use_translucency:
        w_trans = geo.pow01(albedo, 1.2) / cfgmod.LEAF_TRANSLUCENCY
        w = torch.where(is_transmission[..., None], w_trans, w)
        ray_local = torch.where(is_transmission[..., None], -ray_local, ray_local)
    throughput = throughput * w

    ray = sampling.to_world(ray_local, n)

    # geometric backface fixes; transmitted rays are exempt
    n_geom = props["n_geom"]
    n_dot_l_geom = geo.dot3(n_geom, ray)
    bad = (n_dot_l_geom < 0.0) & ~is_transmission
    rough_threshold = geo.clip(props["roughness"] / 0.15, 0.0, 1.0)
    kill_rnd = rng.uniform1(pixel_idx, frame, dim + 1)
    kill = bad & (is_diffuse | (kill_rnd < rough_threshold))
    throughput = torch.where(kill[..., None], 0.0, throughput)
    b = geo.absolute(geo.dot3(n_geom, n)) * 0.99
    patched = geo.normalize(
        ray + n_geom * (geo.absolute(n_dot_l_geom) * geo.positive_rcp(b))[..., None])
    patch = bad & ~kill
    ray = torch.where(patch[..., None], patched, ray)
    shading_n = torch.where(patch[..., None], geo.normalize(v + ray), n)
    return ray, throughput, shading_n, is_transmission


def trace_paths(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                cfg: RenderConfig, settings: Settings, frame,
                props0: dict, pixel_idx: torch.Tensor, cone0: dict, primary_shadow: tuple,
                sharc_state: sharc.SharcState | None = None, l1_hist=None):
    """The TraceOpaque() path loop for all pixels. Returns the demodulated
    diff/spec radiance, normalized hit distances and the visibility and
    blocker distance of the caller's ``primary_shadow`` rays (origin,
    direction), which join the single batched shadow launch. A bounce hit
    may take its radiance from the L1 cache's previous frame (``l1_hist``)
    and then from the SHARC cache (``sharc_state``). In HALF tracing mode
    the first bounce's lobe is the pixel's checkerboard colour."""
    n_px = pixel_idx.shape[0]
    f32 = cfg.dtype
    dev = pixel_idx.device
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    albedo0, f00 = brdf.base_color_to_f0_albedo(props0["base_color"], props0["metalness"])
    n_dot_v0 = geo.absolute(geo.dot3(props0["n"], props0["v"]))
    f_env0 = brdf.environment_term_rtg(f00, n_dot_v0, props0["roughness"])
    diff_factor0 = albedo0 * (1.0 - f_env0) + 0.001
    spec_factor0 = f_env0 + 0.001

    zeros3 = lambda: torch.zeros((n_px, 3), dtype=f32, device=dev)
    zeros1 = lambda: torch.zeros((n_px,), dtype=f32, device=dev)
    diff_radiance, spec_radiance = zeros3(), zeros3()
    diff_hitdist, spec_hitdist, diff_path_num = zeros1(), zeros1(), zeros1()
    diff_dir, spec_dir = zeros3(), zeros3()

    px = pixel_idx % cfg.width
    py = torch.div(pixel_idx, cfg.width, rounding_mode="floor")

    em_set = None
    n_cand = 1
    if cfg.use_importance_sampling and scene.has_emissive:
        em_set = emissive_is.build_emissive_set(scene, settings.emission_intensity,
                                                clusters=ctx.emissive)
        n_cand = cfg.importance_samples

    path_num = cfg.rpp * (2 if cfg.tracing_mode == TracingMode.FULL else 1)

    # Deferred shadows: every shadow-dependent term is computed for both
    # outcomes (c0 / c1) and selected after one batched any-hit launch.
    per_path = []
    for path in range(path_num):
        throughput = torch.ones((n_px, 3), dtype=f32, device=dev)
        alive = ~props0["miss"]
        is_diffuse_path = torch.zeros((n_px,), dtype=torch.bool, device=dev)
        first_ray = zeros3()
        records = []
        props = props0
        cone = cone0

        for bounce in range(1, cfg.bounce_num + 1):
            dim_base = 10_000 * (path + 1) + 100 * bounce
            diffuse_prob = estimate_diffuse_probability(props)
            diffuse_prob = (diffuse_prob != 0.0).to(f32) * geo.clip(
                diffuse_prob, settings.min_probability, 1.0 - settings.min_probability
            )
            rnd_lobe = rng.uniform1(pixel_idx, frame, dim_base)
            if bounce == 1 and cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC:
                # a sample in every 3x3 area on the 1st bounce: Bayer +
                # screen-uniform Weyl decorrelation
                rnd_lobe = torch.remainder(rng.bayer4x4(px, py, 0) + rng.weyl1d(frame), 1.0)
            is_diffuse = rnd_lobe < diffuse_prob
            if cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC or bounce > 1:
                sel_pdf = torch.where(is_diffuse, diffuse_prob, 1.0 - diffuse_prob)
                throughput = throughput / geo.clip_min(sel_pdf, 1e-6)[..., None]
            elif cfg.tracing_mode == TracingMode.HALF:
                is_diffuse = rng.checkerboard(px, py, frame).to(torch.bool)
            else:  # FULL: alternate paths
                is_diffuse = torch.full((n_px,), bool(path & 1), device=dev)

            if bounce == 1:
                is_diffuse_path = is_diffuse

            ray, throughput, _, is_trans = generate_ray_and_update_throughput(
                props, throughput, is_diffuse, pixel_idx, frame, dim_base + 2,
                em_set=em_set, n_candidates=n_cand, use_translucency=cfg.use_translucency,
            )
            if bounce == 1:
                first_ray = ray

            alive = alive & (color.luminance(throughput) >= cfgmod.PT_THROUGHPUT_THRESHOLD)

            view_z = cam_mod.world_to_view_z(cam, props["x"])
            xo = geo.offset_ray(props["x"], props["n_geom"], view_z, unproject,
                                cfgmod.PT_BOUNCE_RAY_OFFSET)
            if cfg.use_translucency:
                # transmitted rays start on the back side of the leaf
                xo_back = props["x"] - props["n_geom"] * cfgmod.LEAF_THICKNESS
                xo = torch.where(is_trans[..., None], xo_back, xo)
            cone = raycone.reflect(cone, props["curvature"],
                                   torch.where(is_diffuse, 1.0, props["roughness"]))
            hit = traversal.closest_hit_alpha(ctx, scene, xo, ray, coherent=False)
            cone = raycone.propagate(cone, hit["t"])
            props = gbuffer.decode_hit(
                scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
                settings.emission_intensity, forced_material=settings.forced_material,
                emission_scale_cubes=settings.emission_intensity_cubes,
                with_tangent=cfg.use_hair_sss, cone_width=cone["width"],
                use_normal_map=settings.use_normal_map,
            )

            direct = lighting.direct_sun_lighting(
                props["n"], props["v"], props["base_color"], props["metalness"],
                props["roughness"], sun_dir, tan_sun, cfg.use_white_furnace,
                flags=props["flags"] if cfg.use_hair_sss else None,
                tangent=props.get("tangent"),
            )
            view_z_b = cam_mod.world_to_view_z(cam, props["x"])
            sxo, sdir = lighting.sun_shadow_ray_params(
                props["x"], props["n_geom"], sun_dir, tan_sun, pixel_idx, frame,
                unproject, view_z_b, dim=dim_base + 5,
                rnd=_shadow_rnd(cfg, pixel_idx, frame, dim_base + 5),
            )
            l_hit0 = props["lemi"]             # shadow = 0
            l_hit1 = direct + props["lemi"]    # shadow = 1
            l_cached = props["lemi"]
            cache_w = zeros1()

            if l1_hist is not None:
                # the L1 cache: the previous frame's composed radiance
                # reprojected onto the hit
                l1, w1 = l1cache.radiance_from_previous_frame(
                    l1_hist, cam, props, pixel_idx, cfg.width, cfg.height, sun_dir,
                    settings.prev_frame_confidence)
                use_l1 = (w1 > 0.0) & ~props["miss"]
                l_cached = torch.where(use_l1[..., None], l1, l_cached)
                cache_w = torch.where(use_l1, w1, cache_w)

            if sharc_state is not None:
                # L2 SHARC lookup, gated by the lobe's footprint against the
                # voxel size; the level rounding is dithered per pixel and
                # frame so the LOD rings dissolve into noise
                lod_dither = rng.uniform1(pixel_idx, frame, dim_base + 11)
                vs = sharc.voxel_size(sharc.grid_level(props["x"], cam.position, dither=lod_dither))
                rt = torch.where(is_diffuse, 1.0, props["roughness"])
                lobe_tan = rt * rt / (1.0 + rt * rt)
                footprint = props["t"] * lobe_tan * 2.0
                footprint_norm = geo.clip(footprint / geo.clip_min(vs, 1e-6), 0.0, 1.0)
                if bounce == cfg.bounce_num:
                    gate = torch.ones_like(is_diffuse)
                else:
                    gate = rng.uniform1(pixel_idx, frame, dim_base + 8) < footprint_norm
                gate = gate & (rng.uniform1(pixel_idx, frame, dim_base + 10) > cache_w)
                rad, found = sharc.query(sharc_state, props["x"], props["n"], cam.position,
                                         dither=lod_dither)
                use = found & gate & ~props["miss"]
                l_cached = torch.where(use[..., None], rad, l_cached)
                cache_w = torch.where(use, 1.0, cache_w)

            # stochastic choice of the analytic term by the cache confidence;
            # the last bounce takes the max so no energy is dropped
            miss_rnd = rng.uniform1(pixel_idx, frame, dim_base + 9)
            use_analytic = (miss_rnd >= cache_w) & ~props["miss"]
            if bounce < cfg.bounce_num:
                repl0, repl1 = l_hit0, l_hit1
            else:
                repl0 = torch.maximum(l_cached, l_hit0)
                repl1 = torch.maximum(l_cached, l_hit1)
            l_c0 = torch.where(use_analytic[..., None], repl0, l_cached)
            l_c1 = torch.where(use_analytic[..., None], repl1, l_cached)

            live3 = alive[..., None]
            contrib0 = l_c0 * throughput * live3
            contrib1 = l_c1 * throughput * live3
            throughput = throughput * (1.0 - cache_w)[..., None]

            diffuse_like = estimate_diffuse_probability(props, use_magic_boost=True)
            records.append({
                "sxo": sxo, "sdir": sdir,
                "c0": contrib0, "c1": contrib1,
                "lem_thr": color.luminance(props["lemi"] * throughput),
                "diffuse_like": torch.where(is_diffuse, 1.0, diffuse_like),
                "hit_t": torch.where(alive, props["t"], 0.0),
                "curv": props["curvature"],
            })
            alive = alive & ~props["miss"]

        per_path.append((is_diffuse_path, first_ray, records))

    # ---- ONE batched shadow launch for every pending visibility ray ----
    all_recs = [r for (_, _, recs) in per_path for r in recs]
    origins = torch.cat([r["sxo"] for r in all_recs] + [primary_shadow[0]], dim=0)
    dirs = torch.cat([r["sdir"] for r in all_recs] + [primary_shadow[1]], dim=0)
    blocked, hit_t = traversal.any_hit_t(
        ctx, origins, dirs, torch.full((origins.shape[0],), traversal.T_MAX, device=dev),
        coherent=False,
    )
    # disable_shadows skips the sun shadow ray (visibility 1)
    vis = torch.where(settings.disable_shadows > 0, 1.0, 1.0 - blocked.to(f32))
    seg = slice(len(all_recs) * n_px, None)
    primary_shadow_vis = vis[seg]
    # closest-blocker distance of the primary sun-shadow ray; 0 where unblocked
    primary_shadow_hitt = torch.where(blocked[seg], hit_t[seg], 0.0).to(f32)

    # ---- replay: select contribs by visibility, rebuild the accumulation ----
    rec_i = 0
    for is_diff, first_ray, recs in per_path:
        lsum = zeros3()
        acc_hitdist = zeros1()
        acc_diffuse_like_motion = zeros1()
        acc_curvature = zeros1()
        for r in recs:
            s = vis[rec_i * n_px:(rec_i + 1) * n_px]
            rec_i += 1
            contrib = torch.where(s[..., None] > 0.5, r["c1"], r["c0"])
            lsum = lsum + contrib
            a = color.luminance(contrib)
            b = color.luminance(lsum)
            importance = a / (b + 1e-6)
            importance = importance * (1.0 - r["lem_thr"] / (a + 1e-6))
            thin_lens = r["hit_t"] / (2.0 * acc_curvature * r["hit_t"] + 1.0)
            acc_hitdist = acc_hitdist + thin_lens * geo.smoothstep(0.2, 0.0, acc_diffuse_like_motion)
            acc_diffuse_like_motion = acc_diffuse_like_motion + 1.0 - importance * (
                1.0 - r["diffuse_like"]
            )
            acc_curvature = acc_curvature + r["curv"]

        diff_radiance = diff_radiance + torch.where(is_diff[..., None], lsum, 0.0)
        spec_radiance = spec_radiance + torch.where(is_diff[..., None], 0.0, lsum)
        diff_hitdist = diff_hitdist + torch.where(is_diff, acc_hitdist, 0.0)
        spec_hitdist = spec_hitdist + torch.where(is_diff, 0.0, acc_hitdist)
        diff_path_num = diff_path_num + is_diff.to(f32)
        wdir = color.luminance(lsum)[..., None] + 1e-6
        diff_dir = diff_dir + torch.where(is_diff[..., None], first_ray * wdir, 0.0)
        spec_dir = spec_dir + torch.where(is_diff[..., None], 0.0, first_ray * wdir)

    # demodulation + averaging
    radiance_norm = 1.0 / float(cfg.rpp)
    diff_radiance = diff_radiance / diff_factor0 * radiance_norm
    spec_radiance = spec_radiance / spec_factor0 * radiance_norm
    diff_radiance = diff_radiance * settings.indirect_diffuse.to(f32)
    spec_radiance = spec_radiance * settings.indirect_specular.to(f32)
    if cfg.use_moving_emission_fix:
        # primary emission / 2 pi rides in both denoised signals
        emi0 = torch.where(props0["miss"][..., None], 0.0, props0["lemi"])
        emi0 = emi0 / (2.0 * math.pi)
        diff_radiance = diff_radiance + emi0
        spec_radiance = spec_radiance + emi0
    diff_norm = torch.where(diff_path_num > 0, 1.0 / geo.clip_min(diff_path_num, 1.0), 0.0)
    spec_cnt = path_num - diff_path_num
    spec_norm = torch.where(spec_cnt > 0, 1.0 / geo.clip_min(spec_cnt, 1.0), 0.0)
    return {
        "diff_radiance": diff_radiance,
        "spec_radiance": spec_radiance,
        "diff_hitdist": diff_hitdist * diff_norm,
        "spec_hitdist": spec_hitdist * spec_norm,
        "diff_factor": diff_factor0,
        "spec_factor": spec_factor0,
        "diff_dir": diff_dir * diff_norm[..., None],
        "spec_dir": spec_dir * spec_norm[..., None],
        "primary_shadow": primary_shadow_vis,
        "primary_shadow_hitdist": primary_shadow_hitt,
    }


def is_delta(props: dict) -> torch.Tensor:
    """IsDelta: the mirror-like hits (roughness below 0.041, and metal or
    dark) that the PSR walk passes through."""
    bc = props["base_color"]
    luma = torch.tensor([0.2126, 0.7152, 0.0722], dtype=bc.dtype, device=bc.device)
    dark = (bc * luma).sum(-1) < 0.005
    return (props["roughness"] < 0.041) & ((props["metalness"] > 0.941) | dark) & ~props["miss"]


def psr_walk(ctx, scene, cfg: RenderConfig, settings: Settings, cam: Camera, props: dict,
             sun_dir, tan_sun, unproject):
    """Primary Surface Replacement: follow up to cfg.psr_bounce_num mirror
    (delta) bounces from the primary hits, so that the G-buffer describes
    the virtual surface seen in the mirror. Every lane is traced (one
    ``traversal.closest_hit`` a bounce); only delta lanes advance.

    Returns (props', l_psr (N, 3) the emission seen along the chain,
    psr_throughput (N, 3) the chain's Fresnel product, virt_dist (N,) the
    accumulated thin-lens-corrected distance that places the virtual
    surface, mirror_mat (N, 3, 3) the product of the chain's Householder
    matrices)."""
    n_px = props["x"].shape[0]
    f32, dev = cfg.dtype, props["x"].device
    l_psr = torch.zeros((n_px, 3), dtype=f32, device=dev)
    throughput = torch.ones((n_px, 3), dtype=f32, device=dev)
    virt_dist = torch.zeros((n_px,), dtype=f32, device=dev)
    acc_curv = torch.zeros((n_px,), dtype=f32, device=dev)
    eye = torch.eye(3, dtype=f32, device=dev).expand(n_px, 3, 3)
    mirror_mat = eye
    for _ in range(cfg.psr_bounce_num):
        delta = is_delta(props)
        # the curvature accumulates at the origin of each mirror bounce
        acc_curv = torch.where(delta, acc_curv + props["curvature"], acc_curv)
        n_s = props["n"]
        house = eye - 2.0 * n_s[:, :, None] * n_s[:, None, :]
        mirror_mat = torch.where(delta[:, None, None], torch.bmm(house, mirror_mat), mirror_mat)
        _, f0 = brdf.base_color_to_f0_albedo(props["base_color"], props["metalness"])
        f = brdf.fresnel_schlick(f0, geo.absolute(geo.dot3(props["v"], props["n"])))
        ray = geo.reflect(-props["v"], props["n"])
        vz = cam_mod.world_to_view_z(cam, props["x"])
        xo = geo.offset_ray(props["x"], props["n_geom"], vz, unproject, cfgmod.PT_BOUNCE_RAY_OFFSET)
        hit = traversal.closest_hit(ctx, xo, ray)
        new_props = gbuffer.decode_hit(
            scene, hit, xo, ray, sun_dir, tan_sun, cfg.use_white_furnace,
            settings.emission_intensity, forced_material=settings.forced_material,
            emission_scale_cubes=settings.emission_intensity_cubes,
            with_tangent=cfg.use_hair_sss, use_normal_map=settings.use_normal_map,
        )
        new_throughput = throughput * f
        l_new = l_psr + new_throughput * new_props["lemi"] * (~new_props["miss"])[..., None]
        props = {k: torch.where(delta.view(-1, *([1] * (new_props[k].dim() - 1))),
                                new_props[k], props[k]) for k in props}
        sel = delta[..., None]
        throughput = torch.where(sel, new_throughput, throughput)
        l_psr = torch.where(sel, l_new, l_psr)
        # thin lens: a curved mirror moves the virtual image off the
        # unfolded distance
        thin = new_props["t"] / (2.0 * acc_curv * new_props["t"] + 1.0)
        virt_dist = torch.where(delta, virt_dist + thin, virt_dist)
    return props, l_psr, throughput, virt_dist, mirror_mat


def trace_opaque(ctx: traversal.TraceContext, scene: Scene, cam: Camera,
                 cfg: RenderConfig, settings: Settings, frame,
                 pixel_idx: torch.Tensor | None = None,
                 sharc_state: sharc.SharcState | None = None, l1_hist=None,
                 dynamics=None):
    """Primary ray + G-buffer + indirect path loop (TraceOpaque.cs.hlsl main).
    ``pixel_idx`` (flat int32 indices) selects the pixels to trace;
    ``sharc_state`` is the radiance cache the bounces may read, ``l1_hist``
    the L1 cache's previous frame. With cfg.psr_bounce_num > 0 the PSR walk
    replaces mirror pixels' G-buffer by the virtual surface: view-z and
    motion at the virtual point, the normal unfolded through the transposed
    mirror matrix.

    ``dynamics``, an optional (InstancedScene, m_curr, m_prev) of (I, 3, 4)
    per-instance transforms, gives moving objects their motion: Xprev =
    M_prev M_curr^-1 X by the hit's instance (``instances.prev_position``,
    TraceOpaque.cs.hlsl:610-614); without it Xprev = X. A PSR pixel's motion
    is taken at its virtual point, moved by Xprev - X."""
    dev = scene.tris.p0.device
    if pixel_idx is None:
        pixel_idx = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    n_px = pixel_idx.shape[0]
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    origin, direction, uv = cam_mod.camera_rays(cam, cfg.width, cfg.height, pixel_idx, frame)
    # ray cone: primary spread = one pixel angle
    pixel_angle = 2.0 * cam.tan_half_fov_y / cfg.height
    cone = {
        "width": torch.zeros((n_px,), dtype=cfg.dtype, device=dev),
        "spread": pixel_angle.to(cfg.dtype).expand(n_px),
    }
    hit = traversal.closest_hit_alpha(ctx, scene, origin, direction)
    cone = raycone.propagate(cone, hit["t"])
    props = gbuffer.decode_hit(
        scene, hit, origin, direction, sun_dir, tan_sun, cfg.use_white_furnace,
        settings.emission_intensity, forced_material=settings.forced_material,
        emission_scale_cubes=settings.emission_intensity_cubes, with_tangent=cfg.use_hair_sss,
        cone_width=cone["width"], use_normal_map=settings.use_normal_map,
    )
    props = gbuffer.apply_overrides(props, settings.roughness_override, settings.metalness_override)

    l_psr = torch.zeros((n_px, 3), dtype=cfg.dtype, device=dev)
    psr_throughput = torch.ones((n_px, 3), dtype=cfg.dtype, device=dev)
    primary_t0 = props["t"]
    gb_normal = props["n"]
    x_gbuf = props["x"]
    if cfg.psr_bounce_num > 0:
        x0, v0 = props["x"], props["v"]
        props, l_psr, psr_throughput, virt_dist, mirror_mat = psr_walk(
            ctx, scene, cfg, settings, cam, props, sun_dir, tan_sun, unproject)
        # the virtual surface X0 - V0 * distance, and its normal unfolded
        # into camera space by the inverse (transposed) mirror matrix
        x_gbuf = x0 - v0 * virt_dist[..., None]
        gb_normal = torch.einsum("nji,nj->ni", mirror_mat, props["n"])
    view_z = torch.where(props["miss"], cfgmod.INF, cam_mod.world_to_view_z(cam, x_gbuf))
    if dynamics is not None:
        from nrdsample_tpu_torch.scene import instances

        inst, m_curr, m_prev = dynamics
        x_prev = instances.prev_position(inst, m_curr, m_prev, props["x"], props["tri"])
    else:
        x_prev = props["x"]
    x_prev_virt = x_gbuf + (x_prev - props["x"])
    mv = cam_mod.get_motion(cam, x_gbuf, x_prev_virt, cfg.width, cfg.height)

    # direct lighting at the primary hit: unshadowed sun + emission
    direct = lighting.direct_sun_lighting(
        props["n"], props["v"], props["base_color"], props["metalness"],
        props["roughness"], sun_dir, tan_sun, cfg.use_white_furnace,
        flags=props["flags"] if cfg.use_hair_sss else None, tangent=props.get("tangent"),
    )
    direct = torch.where(props["miss"][..., None], 0.0, direct)
    emission = torch.where(
        props["miss"][..., None],
        lighting.sky_intensity(direction, sun_dir, tan_sun, cfg.use_white_furnace),
        props["lemi"],
    )

    p_sxo, p_sdir = lighting.sun_shadow_ray_params(
        props["x"], props["n_geom"], sun_dir, tan_sun, pixel_idx, frame,
        unproject, view_z, dim=501, rnd=_shadow_rnd(cfg, pixel_idx, frame, 501),
    )
    paths = trace_paths(ctx, scene, cam, cfg, settings, frame, props, pixel_idx,
                        cone0=cone, primary_shadow=(p_sxo, p_sdir), sharc_state=sharc_state,
                        l1_hist=l1_hist)
    shadow = paths.pop("primary_shadow")
    shadow = torch.where(props["miss"], 1.0, shadow)
    shadow = torch.where(settings.disable_shadows > 0, 1.0, shadow)
    shadow_hit_dist = paths.pop("primary_shadow_hitdist")
    shadow_hit_dist = torch.where(props["miss"], 0.0, shadow_hit_dist)
    shadow_hit_dist = torch.where(settings.disable_shadows > 0, 0.0, shadow_hit_dist)

    return {
        "view_z": view_z,
        "mv": mv,
        "mv_world": x_prev_virt - x_gbuf,
        "normal": gb_normal,
        "roughness": props["roughness"],
        "metalness": props["metalness"],
        "base_color": props["base_color"],
        "material_id": torch.where(props["metalness"] > 0.5, cfgmod.MATERIAL_ID_METAL,
                                   cfgmod.MATERIAL_ID_DEFAULT),
        "direct_lighting": direct,
        "emission": emission,
        "shadow": shadow,
        "shadow_hit_dist": shadow_hit_dist,
        "shadow_ray": (p_sxo, p_sdir),
        "miss": props["miss"],
        "primary_x": x_gbuf,
        "primary_t": primary_t0,
        "uv": uv,
        "tri": props["tri"],
        "flags": props["flags"],
        "curvature": props["curvature"],
        "mip": props["mip"],
        "l_psr": l_psr,
        "psr_throughput": psr_throughput,
        **paths,
    }
