"""SharcUpdate — the 1/5-resolution cache-population tracer (counterpart of
``nrdsample_tpu/render/sharc_update.py``).

At SHARC_DOWNSCALE reduced resolution each probe traces a primary ray and
SHARC_PROPAGATION_DEPTH diffuse bounces, recording per vertex (position,
normal, direct light, segment throughput); a backward sweep composes the
suffix radiance at every vertex and one batched update scatters them into the
hash grid. With ``use_confidence`` the previous frame's probe paths are traced
again under the current lighting, for the history-confidence gradient. With
``sharc_full_mode`` and glass in the scene, a second probe trace first jumps
through the glass delta events (FULL mode) so that the cache fills behind
and through glass.

Under the sharded frame (``parallel/mesh.py``) each rank traces a contiguous
block of the probe ids and the probe planes are gathered back to the whole
grid, in canonical order, before the scatter into the cache
(``sharc_update_pass``'s ``probe_mesh``).
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import RenderConfig, Settings
from nrdsample_tpu_torch.mathlib import color, geometry as geo, rng, sampling
from nrdsample_tpu_torch.ops import sharc, traversal
from nrdsample_tpu_torch.render import gbuffer, lighting
from nrdsample_tpu_torch.scene import camera as cam_mod
from nrdsample_tpu_torch.scene.types import Camera, Scene


def _decode(scene: Scene, hit, origin, direction, sun_dir, tan_sun, cfg: RenderConfig,
            settings: Settings):
    return gbuffer.decode_hit(scene, hit, origin, direction, sun_dir, tan_sun,
                              cfg.use_white_furnace, settings.emission_intensity,
                              forced_material=settings.forced_material,
                              emission_scale_cubes=settings.emission_intensity_cubes,
                              use_normal_map=settings.use_normal_map)


def _contexts(ctx) -> traversal.SceneContexts:
    return ctx if isinstance(ctx, traversal.SceneContexts) else traversal.SceneContexts(ctx, None)


def _delta_walk(ctxs: traversal.SceneContexts, scene: Scene, origin, direction, pixel_idx, frame,
                delta_bounces: int):
    """FULL-mode prologue: move each probe ray through up to
    ``delta_bounces`` glass events (Fresnel-chosen reflection or refraction
    at each), so the cache fills behind and through glass; rays that meet no
    glass keep their ray. Returns (origin, direction) of the ray after the
    glass."""
    from nrdsample_tpu_torch.render.trace_transparent import _fresnel_dielectric

    tctx = ctxs.transparent
    tr = tctx.tris
    o, d = origin, direction
    inside = torch.zeros(origin.shape[:1], dtype=torch.bool, device=origin.device)
    active = torch.ones_like(inside)
    for bounce in range(delta_bounces):
        hit_t = traversal.closest_hit(tctx, o, d)
        hit_o = traversal.closest_hit(ctxs.opaque, o, d)
        glass = (hit_t["tri"] >= 0) & (hit_t["t"] < hit_o["t"]) & active
        tri_local = torch.clamp_min(hit_t["tri"] - tctx.tri_offset, 0).long()
        n_geom = geo.normalize(geo.cross(tr.e1[tri_local], tr.e2[tri_local]))
        n_geom = torch.where(geo.dot3(n_geom, d)[..., None] > 0, -n_geom, n_geom)   # against the ray
        ior = scene.materials.ior[tr.material[tri_local].long()]
        eta = torch.where(inside, 1.0 / ior, ior)
        f = _fresnel_dielectric(geo.absolute(geo.dot3(d, n_geom)), eta)
        reflect_now = rng.uniform1(pixel_idx, frame, 820_000 + 1000 * bounce) < f
        ray_refr = geo.refract(d, n_geom, 1.0 / geo.clip_min(eta, 1e-6))
        reflect_now = reflect_now | (geo.length(ray_refr) < 0.5)   # total internal reflection
        new_d = torch.where(reflect_now[..., None], geo.reflect(d, n_geom), geo.normalize(ray_refr))
        x = o + d * hit_t["t"][..., None]
        s = torch.where(geo.dot3(new_d, n_geom) >= 0, 1.0, -1.0)
        new_o = x + n_geom * (s * 1e-4)[..., None]
        inside = torch.where(glass & ~reflect_now, ~inside, inside)
        o = torch.where(glass[..., None], new_o, o)
        d = torch.where(glass[..., None], new_d, d)
        active = glass
    return o, d


def _trace_probe_paths(ctxs, scene: Scene, cam: Camera, cfg: RenderConfig, settings: Settings,
                       frame, sidx: torch.Tensor | None = None, mode: str = "curr"):
    """Trace the 1/ds-resolution probe paths of frame index ``frame`` with
    that frame's RNG streams and ``cam``: a pure function of its arguments,
    so a previous frame index and camera replay that frame's paths under the
    current lighting. ``sidx``, (m,) int32 probe ids, selects the probes
    (the whole grid when None); each probe's RNG is keyed by its id, so a
    block of ids traces what the whole grid traces there. ``mode`` "full"
    first walks the camera ray through glass (``_delta_walk``). Returns
    (first_l (m, 3), probe_vz (m,), probe_n (m, 3), per-vertex records {x,
    n, l, alive} stacked (depth, m, ...), grad_lum (m,) with the
    dynamic-object term)."""
    ctxs = _contexts(ctxs)
    ctx = ctxs.opaque
    ds = cfg.sharc_downscale
    sw, sh = max(cfg.width // ds, 1), max(cfg.height // ds, 1)
    dev = scene.tris.p0.device
    sun_dir = cfgmod.sun_direction(settings)
    tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
    unproject = cam_mod.unproject_scale(cam, cfg.height)

    # the low-res grid on full-res pixels, with a per-frame sub-pixel offset
    if sidx is None:
        sidx = torch.arange(sw * sh, dtype=torch.int32, device=dev)
    off = rng.hash_u32(sidx, frame, 9001)
    px = torch.clamp_max((sidx % sw) * ds + (off[..., 0] % ds).to(torch.int32), cfg.width - 1)
    py = torch.clamp_max(torch.div(sidx, sw, rounding_mode="floor") * ds
                         + (off[..., 1] % ds).to(torch.int32), cfg.height - 1)
    pixel_idx = py * cfg.width + px

    origin, direction, _ = cam_mod.camera_rays(cam, cfg.width, cfg.height, pixel_idx, frame,
                                               sample_dim=7)
    if mode == "full" and ctxs.transparent is not None:
        origin, direction = _delta_walk(ctxs, scene, origin, direction, pixel_idx, frame,
                                        cfg.delta_bounce_num)
    props = _decode(scene, traversal.closest_hit(ctx, origin, direction), origin, direction,
                    sun_dir, tan_sun, cfg, settings)
    alive = ~props["miss"]
    probe_vz = cam_mod.world_to_view_z(cam, props["x"])
    probe_n = props["n"]

    exposure = geo.clip_min(settings.exposure * 1e-2, 1e-3)
    grad_extra = torch.zeros(sidx.shape, dtype=cfg.dtype, device=dev)
    path_w = grad_extra + 1.0
    verts = []
    for bounce in range(cfgmod.SHARC_PROPAGATION_DEPTH):
        dim = 800_000 + 1000 * bounce
        view_z = cam_mod.world_to_view_z(cam, props["x"])
        direct = lighting.direct_sun_lighting(
            props["n"], props["v"], props["base_color"], props["metalness"], props["roughness"],
            sun_dir, tan_sun, cfg.use_white_furnace)
        shadow = lighting.sun_shadow_ray(ctx, props["x"], props["n_geom"], sun_dir, tan_sun,
                                         pixel_idx, frame, unproject, view_z, dim=dim + 5)
        shadow = torch.where(settings.disable_shadows > 0, 1.0, shadow)
        l_direct = direct * shadow[..., None] + props["lemi"]

        # diffuse propagation, cosine-sampled: the segment throughput is the
        # diffuse albedo
        ray = sampling.to_world(sampling.cosine_ray(rng.uniform2(pixel_idx, frame, dim + 1)),
                                props["n"])
        seg_w = props["base_color"] * (1.0 - props["metalness"][..., None])
        verts.append({"x": props["x"], "n": props["n"], "l": l_direct, "w": seg_w,
                      "alive": alive})
        static_origin = (props["flags"] & cfgmod.FLAG_STATIC) != 0

        xo = geo.offset_ray(props["x"], props["n_geom"], view_z, unproject,
                            cfgmod.PT_BOUNCE_RAY_OFFSET)
        props = _decode(scene, traversal.closest_hit(ctx, xo, ray), xo, ray, sun_dir, tan_sun,
                        cfg, settings)
        # a static origin hitting a dynamic object adds an AO-style hitT term
        dyn_hit = ((props["flags"] & cfgmod.FLAG_STATIC) == 0) & ~props["miss"]
        ao = torch.sqrt(geo.clip(props["t"] / cfgmod.SHARC_GRADIENT_HITDIST_SCALE, 0.0, 1.0))
        term = (1.0 - ao) * torch.where(static_origin & dyn_hit & alive, 1.0, 0.0)
        grad_extra = grad_extra + term * path_w * 25.0 / exposure
        path_w = path_w * color.luminance(seg_w)
        alive = alive & ~props["miss"]

    # backward sweep from the last segment's sky/emission: suffix radiance at
    # every vertex
    l_next = props["lemi"]
    l_heres = [None] * len(verts)
    for i in reversed(range(len(verts))):
        l_next = verts[i]["l"] + verts[i]["w"] * l_next
        l_heres[i] = l_next
    stacked = {"x": torch.stack([v["x"] for v in verts]), "n": torch.stack([v["n"] for v in verts]),
               "l": torch.stack(l_heres), "alive": torch.stack([v["alive"] for v in verts])}
    first_l = l_heres[0]
    return first_l, probe_vz, probe_n, stacked, color.luminance(first_l) + grad_extra


def _rev_flat(a: torch.Tensor) -> torch.Tensor:
    """Flatten stacked (depth, m, ...) vertex records last vertex first."""
    return torch.flip(a, dims=(0,)).reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def sharc_update_pass(ctx, scene: Scene, cam: Camera, cfg: RenderConfig, settings: Settings,
                      frame, state: sharc.SharcState, probe_mesh=None):
    """Trace the probe paths, scatter their vertices into the cache and
    resolve it. ``ctx`` is a TraceContext or SceneContexts. Returns (resolved
    state, probes): the probe planes at 1/ds resolution for the
    history-confidence gradient, with the previous frame's paths re-traced
    under the current lighting when ``use_confidence``. With
    ``sharc_full_mode`` and a transparent context, the vertices of a second
    trace through glass join the same scatter (it adds no gradient).

    ``probe_mesh``, a ``parallel.mesh.PixelMesh`` of more than one rank,
    splits every probe trace (the current paths, the FULL pass, the
    previous frame's re-trace): rank r traces the contiguous ids [r *
    n_loc, (r + 1) * n_loc) cut at the grid's end, n_loc = ceil(n / ranks),
    and ``mesh.gather_probes`` puts the planes back in canonical order
    before the scatter, so the cache and the probe planes equal the
    unsplit pass's on every rank. The gather's backward sums over the
    ranks: every rank's pixels read the whole cache."""
    ctxs = _contexts(ctx)
    ds = cfg.sharc_downscale
    sw, sh = max(cfg.width // ds, 1), max(cfg.height // ds, 1)
    n_px = sw * sh
    sidx, gather = None, None
    if probe_mesh is not None and probe_mesh.size > 1:
        from nrdsample_tpu_torch.parallel import mesh as mesh_mod

        lo, hi = mesh_mod.block_bounds(n_px, probe_mesh.size, probe_mesh.rank)
        sidx = torch.arange(lo, hi, dtype=torch.int32, device=scene.tris.p0.device)

        def gather(a, dim):
            return mesh_mod.gather_probes(a, probe_mesh, n_px, dim)

    def trace(cam_t, frame_t, mode="curr"):
        out = _trace_probe_paths(ctxs, scene, cam_t, cfg, settings, frame_t, sidx=sidx, mode=mode)
        if gather is None:
            return out
        first_l, probe_vz, probe_n, stacked, grad_lum = out
        return (gather(first_l, 0), gather(probe_vz, 0), gather(probe_n, 0),
                {k: gather(v, 1) for k, v in stacked.items()}, gather(grad_lum, 0))

    first_l, probe_vz, probe_n, stacked, grad_lum = trace(cam, frame)
    xs, ns, ls, ms = (_rev_flat(stacked[k]) for k in ("x", "n", "l", "alive"))
    if cfg.sharc_full_mode and ctxs.transparent is not None:
        stacked_f = trace(cam, frame, mode="full")[3]
        xs, ns, ls, ms = (torch.cat([a, _rev_flat(stacked_f[k])])
                          for a, k in zip((xs, ns, ls, ms), ("x", "n", "l", "alive")))
    # LOD dithering on the write side too, so both rings near a level
    # boundary stay populated for the dithered queries
    lod_dither = rng.uniform1(torch.arange(xs.shape[0], dtype=torch.int32, device=xs.device),
                              frame, 800_077)
    state = sharc.update(state, xs, ns, ls, cam.position, frame, mask=ms, dither=lod_dither)

    probes = {
        "radiance": first_l.reshape(sh, sw, 3),
        "grad_lum": grad_lum.reshape(sh, sw),
        "view_z": probe_vz.reshape(sh, sw),
        "normal": probe_n.reshape(sh, sw, 3),
    }
    if cfg.use_confidence:
        prev_cam = dataclasses.replace(cam, view_to_world=cam.view_to_world_prev,
                                       jitter=cam.jitter_prev)
        _, prev_vz, _, _, prev_grad_lum = trace(prev_cam, frame - 1)
        probes["prev_retrace_lum"] = prev_grad_lum.reshape(sh, sw)
        probes["prev_retrace_vz"] = prev_vz.reshape(sh, sw)
    return sharc.resolve(state, frame), probes
