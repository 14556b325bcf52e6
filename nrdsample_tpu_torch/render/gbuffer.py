"""Hit decoding and material fetch (counterpart of
``nrdsample_tpu/render/gbuffer.py``). A textured scene multiplies the
material constants by its texels, fetched at the ray-cone mip, and bends
the shading normal by its normal maps; a scene with per-instance material
scales (``tri_instance`` and ``instance_scales``) scales them by its hit
triangle's instance."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.render import lighting
from nrdsample_tpu_torch.scene.types import Scene

T_MAX = traversal.T_MAX

_COBALT = (0.672411, 0.637331, 0.585456)


def decode_hit(scene: Scene, hit: dict, origin: torch.Tensor, direction: torch.Tensor,
               sun_dir: torch.Tensor, tan_sun_radius, white_furnace: bool = False,
               emission_scale=1.0, forced_material=None, emission_scale_cubes=None,
               with_tangent: bool = False, cone_width=None, use_normal_map=None) -> dict:
    """Geometry + material props of each ray's hit. On a miss lemi is the
    sky radiance along the ray and base_color is 0. ``with_tangent`` adds
    props["tangent"], the interpolated vertex tangent made orthogonal to
    the shading normal (the normal's orthonormal-basis tangent where it
    vanishes), for the hair BCSDF.

    With ``scene.textures`` the texels at the hit's uv multiply base colour,
    roughness, metalness and emission; ``cone_width`` (the ray cone's width
    at the hit) picks their mip (0 without it) and adds the normal map's
    slope over it to the curvature; the normal map, gated by
    ``use_normal_map`` (on when None), bends the shading normal in the
    tangent frame and the tangent follows it.

    With ``scene.tri_instance`` and ``scene.instance_scales`` the hit
    triangle's instance row scales base colour, metalness, emission and
    roughness (InstanceData, RaytracingShared.hlsli:456-468), and the normal
    map is fetched a second time, at the uv times the row's normalUvScale."""
    tri = torch.clamp_min(hit["tri"], 0).long()
    miss = hit["tri"] < 0
    u = hit["u"]
    v_bc = hit["v"]
    t = hit["t"]

    tr = scene.tris
    f32 = tr.p0.dtype
    # one wide row gather for every per-triangle attribute (material id rides
    # along as an exact float)
    tri_pack = torch.cat(
        [tr.p0, tr.e1, tr.e2, tr.n0, tr.n1, tr.n2, tr.material.to(f32)[:, None]], dim=1
    )
    g = tri_pack[tri]
    p0, e1, e2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
    tn0, tn1, tn2 = g[..., 9:12], g[..., 12:15], g[..., 15:18]
    mat = g[..., 18].to(torch.int64)

    x = p0 + u[..., None] * e1 + v_bc[..., None] * e2
    x = torch.where(miss[..., None], origin + direction * T_MAX, x)

    w = 1.0 - u - v_bc
    n_smooth = geo.normalize(w[..., None] * tn0 + u[..., None] * tn1 + v_bc[..., None] * tn2)
    n_geom = geo.normalize(geo.cross(e1, e2))
    view = -direction

    # two-sided: flip normals to face the incoming ray
    n_geom = n_geom * torch.sign(geo.dot3(n_geom, view))[..., None]
    n_smooth = n_smooth * torch.sign(geo.dot3(n_smooth, view))[..., None]
    textures = scene.textures
    tangent = None
    if with_tangent or textures is not None:
        # the texture branch's attributes ride along in one more row gather
        tt = torch.cat([tr.t0, tr.t1, tr.t2] + ([] if textures is None else [
            tr.uv0, tr.uv1, tr.uv2, tr.world_area[:, None], tr.bitan_sign[:, None]]), dim=1)[tri]
        t_raw = w[..., None] * tt[..., 0:3] + u[..., None] * tt[..., 3:6] + v_bc[..., None] * tt[..., 6:9]
        t_raw = t_raw - n_smooth * geo.dot3(t_raw, n_smooth)[..., None]
        t_fallback, _ = geo.orthonormal_basis(n_smooth)
        tangent = geo.normalize(torch.where(geo.length(t_raw)[..., None] > 1e-6, t_raw, t_fallback))

    mats = scene.materials
    mat_pack = torch.cat(
        [mats.base_color, mats.roughness[:, None], mats.metalness[:, None],
         mats.emission, mats.flags.to(f32)[:, None]], dim=1
    )
    mg = mat_pack[mat]
    base_color = mg[..., 0:3]
    roughness = mg[..., 3]
    metalness = mg[..., 4]
    flags = mg[..., 8].to(torch.int32)
    if emission_scale_cubes is not None:
        is_cube = (flags & cfgmod.FLAG_FORCED_EMISSION) != 0
        e_scale = torch.where(is_cube, torch.as_tensor(emission_scale_cubes, dtype=f32),
                              torch.as_tensor(emission_scale, dtype=f32))[..., None]
    else:
        e_scale = emission_scale
    emission = mg[..., 5:8] * e_scale

    inst_sc = None
    if scene.tri_instance is not None and scene.instance_scales is not None:
        inst_sc = scene.instance_scales[scene.tri_instance[tri].long()]
        base_color = base_color * inst_sc[..., 0:3]
        metalness = metalness * inst_sc[..., 3]
        emission = emission * inst_sc[..., 4:7]
        roughness = roughness * inst_sc[..., 7]

    mip = torch.zeros_like(t)
    local_curv = mip
    if textures is not None:
        from nrdsample_tpu_torch.render import raycone
        from nrdsample_tpu_torch.scene import textures as tex_mod

        tuv0, tuv1, tuv2 = tt[..., 9:11], tt[..., 11:13], tt[..., 13:15]
        world_area, bitan_sign = tt[..., 15], tt[..., 16]
        uv = w[..., None] * tuv0 + u[..., None] * tuv1 + v_bc[..., None] * tuv2
        if cone_width is not None:
            mip = raycone.texture_mip(cone_width, world_area, raycone.uv_area(tuv0, tuv1, tuv2),
                                      geo.dot3(n_geom, view), textures.base_res,
                                      max_mip=textures.n_mips - 1.0)
        texel = tex_mod.sample(textures, mat, uv, mip)
        base_color = base_color * texel[..., 0:3]
        roughness = roughness * texel[..., 5]
        metalness = metalness * texel[..., 6]
        emission = emission * texel[..., 7:8]
        # normal mapping: tangent-space XY from the map, Z rebuilt, rotated
        # into the (T, B, N) frame and kept in the visible hemisphere; an
        # instance's normalUvScale samples the map at the scaled uv
        n_local_xy = texel[..., 8:10] if inst_sc is None else tex_mod.sample(
            textures, mat, uv * inst_sc[..., 8:10], mip)[..., 8:10]
        if use_normal_map is not None:
            n_local_xy = n_local_xy * torch.as_tensor(use_normal_map, device=t.device).to(f32)
        n_local_sq = n_local_xy[..., 0] * n_local_xy[..., 0] + n_local_xy[..., 1] * n_local_xy[..., 1]
        n_local_z = torch.sqrt(geo.clip(1.0 - n_local_sq, 1e-6, 1.0))
        bitan = geo.cross(n_smooth, tangent) * bitan_sign[..., None]
        n_mapped = geo.normalize(n_local_xy[..., 0:1] * tangent + n_local_xy[..., 1:2] * bitan
                                 + n_local_z[..., None] * n_smooth)
        n_mapped = n_mapped * torch.sign(geo.dot3(n_mapped, view))[..., None]
        n_smooth = torch.where(miss[..., None], n_smooth, n_mapped)
        # the tangent re-orthogonalised against the mapped normal
        t_reproj = tangent - n_smooth * geo.dot3(tangent, n_smooth)[..., None]
        tangent = geo.normalize(torch.where(geo.length(t_reproj)[..., None] > 1e-6, t_reproj, tangent))
        if cone_width is not None:
            # the map's slope over the cone's footprint
            local_curv = (torch.sqrt(geo.clip_min(n_local_sq, 1e-30))
                          / geo.clip_min(cone_width, 1e-6))

    if white_furnace:
        base_color = torch.ones_like(base_color)
        emission = torch.zeros_like(emission)

    if forced_material is not None:
        # GYPSUM = flat white diffuse, COBALT = metal whose roughness encodes
        # the original base color; misses keep their material
        fm = torch.as_tensor(forced_material).to(torch.int32)
        gypsum = (fm == int(cfgmod.ForcedMaterial.GYPSUM)) & ~miss
        cobalt = (fm == int(cfgmod.ForcedMaterial.COBALT)) & ~miss
        prod = geo.clip(base_color[..., 0] * base_color[..., 1] * base_color[..., 2], 0.0, 1.0)
        cobalt_rough = torch.pow(prod, 1.0 / 3.0)
        roughness = torch.where(gypsum, 1.0, torch.where(cobalt, cobalt_rough, roughness))
        metalness = torch.where(gypsum, 0.0, torch.where(cobalt, 1.0, metalness))
        cobalt_color = torch.tensor(_COBALT, dtype=base_color.dtype, device=base_color.device)
        base_color = torch.where(
            gypsum[..., None], 0.5, torch.where(cobalt[..., None], cobalt_color, base_color)
        )

    sky = lighting.sky_intensity(direction, sun_dir, tan_sun_radius, white_furnace)
    lemi = torch.where(miss[..., None], sky, emission)
    base_color = torch.where(miss[..., None], 0.0, base_color)

    out = {
        "miss": miss,
        "t": torch.where(miss, T_MAX, t),
        "x": x,
        "v": view,
        "n": n_smooth,
        "n_geom": n_geom,
        "mat": mat.to(torch.int32),
        "tri": hit["tri"],
        "base_color": base_color,
        "roughness": roughness,
        "metalness": metalness,
        "lemi": lemi,
        "flags": flags,
        # vertex-normal divergence across the triangle edges, worst edge
        "curvature": torch.where(
            miss, 0.0,
            torch.maximum(
                geo.length(tn1 - tn0) * geo.positive_rcp(geo.length(e1)),
                geo.length(tn2 - tn0) * geo.positive_rcp(geo.length(e2)),
            ) + local_curv,
        ),
        "mip": mip,
    }
    if with_tangent:
        out["tangent"] = tangent
    return out


def apply_overrides(props: dict, roughness_override, metalness_override) -> dict:
    """Settings-driven roughness/metalness overrides."""
    out = dict(props)
    out["roughness"] = geo.clip(props["roughness"] + roughness_override, 0.0, 1.0)
    out["metalness"] = geo.clip(props["metalness"] + metalness_override, 0.0, 1.0)
    return out
