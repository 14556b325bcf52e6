"""Analytic sun/sky model, direct lighting and shadow-ray setup (counterpart
of ``nrdsample_tpu/render/lighting.py``)."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch import config as cfg
from nrdsample_tpu_torch.mathlib import brdf, color, geometry as geo, rng, sampling
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.render import hair_sss


def _vec3(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def sun_intensity(v: torch.Tensor, sun_dir: torch.Tensor, tan_angular_radius,
                  white_furnace: bool = False) -> torch.Tensor:
    """Radiance of the sun disk (+glow) seen along v."""
    if white_furnace:
        return torch.zeros(v.shape[:-1] + (3,), dtype=v.dtype, device=v.device)
    b = geo.dot3(v, sun_dir)
    d = geo.length(v - sun_dir * b[..., None])
    glow = torch.clamp(1.015 - d, 0.0, 1.0)
    glow = glow * (b * 0.5 + 0.5) * 0.6
    a = geo.sqrt01(1.0 - b * b) / torch.where(torch.abs(b) < 1e-6, 1e-6, b)
    sun = 1.0 - geo.smoothstep(tan_angular_radius * 0.9, tan_angular_radius * 1.66 + 0.01, a)
    sun = sun * (b > 0.0)
    sun = sun * (1.0 - geo.pow01(1.0 - v[..., 2], 4.85))
    sun = sun * geo.smoothstep(0.0, 0.1, sun_dir[2])
    sun = sun + glow
    sun_color = torch.stack(
        [torch.ones_like(sun), torch.full_like(sun, 0.6), torch.full_like(sun, 0.3)], dim=-1
    )
    warm = _vec3([1.0, 0.9, 0.7], v)
    t = geo.sqrt01(sun_dir[2])
    sun_color = (1 - t) * sun_color + t * warm
    sun_color = sun_color * sun[..., None]
    sun_color = sun_color * geo.smoothstep(-0.01, 0.05, sun_dir[2])
    return color.from_gamma(sun_color) * cfg.SUN_INTENSITY


def sky_intensity(v: torch.Tensor, sun_dir: torch.Tensor, tan_angular_radius,
                  white_furnace: bool = False) -> torch.Tensor:
    """Sky radiance along v (includes the sun disk)."""
    if white_furnace:
        return torch.ones(v.shape[:-1] + (3,), dtype=v.dtype, device=v.device)
    atmosphere = geo.sqrt01(1.0 - torch.clamp(v[..., 2], 0.0, 1.0))
    scatter = geo.pow01(sun_dir[2], 1.0 / 15.0)
    scatter = 1.0 - torch.clamp(scatter, 0.8, 1.0)
    scatter_color = _vec3([1.0, 1.0, 1.0], v) * (1 - scatter) + _vec3([1.5, 0.45, 0.0], v) * scatter
    base = _vec3([0.2, 0.4, 0.8], v)
    w = (atmosphere / 1.3)[..., None]
    sky = base * (1 - w) + scatter_color * w
    sky = sky * torch.clamp(1.0 + sun_dir[2], 0.0, 1.0)
    ground = 0.5 + 0.5 * geo.smoothstep(-1.0, 0.0, v[..., 2])
    sky = sky * ground[..., None]
    return color.from_gamma(sky) * cfg.SKY_INTENSITY + sun_intensity(v, sun_dir, tan_angular_radius)


def sun_basis(sun_dir: torch.Tensor):
    """Orthonormal basis perpendicular to the sun direction."""
    t, b = geo.orthonormal_basis(sun_dir[None, :])
    return t[0], b[0]


def direct_sun_lighting(n, v, base_color, metalness, roughness, sun_dir,
                        tan_angular_radius, white_furnace: bool = False,
                        flags=None, tangent=None):
    """Unshadowed sun + pseudo-sky-IS lighting at a surface [..., 3]; the
    shadow term is applied separately. With ``flags`` (use_hair_sss),
    FLAG_HAIR surfaces take the hair BCSDF along ``tangent`` (where it is
    None, the first axis of the normal's orthonormal basis) and FLAG_SKIN
    surfaces the subsurface wrap diffuse."""
    csun = sun_intensity(sun_dir[None, :], sun_dir, tan_angular_radius, white_furnace)[0]
    csky = sky_intensity(-v, sun_dir, tan_angular_radius, white_furnace)
    n_dot_l = torch.clamp(geo.dot3(n, sun_dir), 0.0, 1.0)
    shadow_fade = geo.smoothstep(0.03, 0.1, n_dot_l)

    albedo, f0 = brdf.base_color_to_f0_albedo(base_color, metalness)
    t = geo.smoothstep(0.0, 0.2, roughness)[..., None]
    cimp = csky * (1 - t) + csun * t
    cimp = cimp * geo.smoothstep(-0.01, 0.05, sun_dir[2])

    h = geo.normalize(sun_dir + v)
    n_dot_h = torch.clamp(geo.dot3(n, h), 0.0, 1.0)
    v_dot_h = torch.clamp(geo.dot3(v, h), 0.0, 1.0)
    n_dot_v = torch.abs(geo.dot3(n, v))

    alpha = roughness * roughness
    d = sampling.ggx_d(n_dot_h, alpha)
    g_vis = brdf.smith_g2_correlated(n_dot_v, n_dot_l, alpha)
    f = brdf.fresnel_schlick(f0, v_dot_h)
    cspec = torch.clamp(f * (d * g_vis * n_dot_l)[..., None], 0.0, 1.0)
    cdiff = (csun * albedo) * n_dot_l[..., None] / sampling.PI

    lighting = cspec * cimp + cdiff * (1.0 - f)
    lighting = lighting * shadow_fade[..., None]

    if flags is not None:
        is_skin = (flags & cfg.FLAG_SKIN) != 0
        if tangent is None:
            tangent, _ = geo.orthonormal_basis(n)
        is_hair = (flags & cfg.FLAG_HAIR) != 0
        sss = csun * albedo * hair_sss.sss_wrap_diffuse(geo.dot3(n, sun_dir),
                                                        base_color) / sampling.PI
        lighting = torch.where(is_skin[..., None], sss + cspec * cimp, lighting)
        bcsdf = hair_sss.hair_bcsdf_eval(sun_dir, v, tangent, base_color, roughness)
        hair_l = csun * bcsdf * torch.clamp(geo.dot3(n, sun_dir) * 0.5 + 0.5, 0.0, 1.0)[..., None]
        lighting = torch.where(is_hair[..., None], hair_l, lighting)
    return lighting


def sun_shadow_ray_params(x, n, sun_dir, tan_angular_radius, pixel_idx, frame,
                          unproject, view_z, dim: int = 7000, rnd=None):
    """Jittered sun-cone visibility ray (origin, direction), for the batched
    shadow launch of the path tracer. ``rnd`` overrides the (n, 2) disc
    sample (blue noise under the temporal denoisers); the default is the
    white PCG stream."""
    if rnd is None:
        rnd = rng.uniform2(pixel_idx, frame, dim)
    disk = sampling.cosine_ray(rnd)[..., :2] * tan_angular_radius
    bx, by = sun_basis(sun_dir)
    sdir = geo.normalize(bx * disk[..., 0:1] + by * disk[..., 1:2] + sun_dir)
    xo = geo.offset_ray(x, n, view_z, unproject, cfg.PT_SHADOW_RAY_OFFSET)
    return xo, sdir


def sun_shadow_ray(ctx, x, n, sun_dir, tan_angular_radius, pixel_idx, frame, unproject, view_z,
                   dim: int = 7000):
    """Cast one jittered sun-cone visibility ray per element (the SHARC probe
    paths; the frame's own path batches its shadow rays). Returns visibility
    in {0, 1}."""
    xo, sdir = sun_shadow_ray_params(x, n, sun_dir, tan_angular_radius, pixel_idx, frame,
                                     unproject, view_z, dim)
    blocked = traversal.any_hit(ctx, xo, sdir, traversal.T_MAX)
    return 1.0 - blocked.to(x.dtype)
