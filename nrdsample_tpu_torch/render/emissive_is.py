"""Emissive importance sampling — the light-BVH reservoir (counterpart of
``nrdsample_tpu/render/emissive_is.py``, dense emitter sets only).

Up to K = 16 BRDF-sampled candidate directions are probed against the
emissive-only set in ONE batched launch (the probe kernel on the card); a
weighted reservoir then picks one in proportion to the emissive intensity it
would reach, and throughput is scaled by sum / (chosen * K), clamped to 8.
(K, R) quantities travel as component planes, never as (K, R, 3).
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import color, geometry as geo, rng, sampling
from nrdsample_tpu_torch.ops import emissive_probe
from nrdsample_tpu_torch.scene.types import Scene


def build_emissive_set(scene: Scene, emission_scale=1.0) -> dict:
    """The padded emissive-triangle subset: p0/e1/e2 (E, 3) with zero rows
    for padding, and intensity (E,) = luminance of the material emission."""
    ids = scene.emissive_tris
    valid = ids >= 0
    safe = torch.clamp_min(ids, 0).long()
    tr = scene.tris
    mask = valid[:, None].to(tr.p0.dtype)
    mat = tr.material[safe].long()
    inten = color.luminance(scene.materials.emission[mat]) * emission_scale
    return {
        "p0": tr.p0[safe] * mask,
        "e1": tr.e1[safe] * mask,
        "e2": tr.e2[safe] * mask,
        "intensity": torch.where(valid, inten, 0.0),
        "any": scene.emissive_count > 0,
    }


def light_probe(em: dict, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """CastLightRay_AnyHit: intensity of the nearest emissive surface along
    each ray, 0 on a miss. CUDA rays launch the probe kernel (or raise); CPU
    rays take its plain version."""
    if origin.device.type == "cuda":
        return emissive_probe.light_probe_cuda(em, origin, direction)
    if origin.device.type == "cpu":
        return emissive_probe.light_probe_plain(em, origin, direction)
    raise ValueError(f"no light probe path for device {origin.device}")


def light_probe_batch(em: dict, origin: torch.Tensor, dir_planes, active: torch.Tensor) -> torch.Tensor:
    """All K candidates in one launch: origin (R, 3), dir_planes 3 x (K, R),
    active (K, R) -> intensities (K, R)."""
    dx, dy, dz = dir_planes
    k, r = dx.shape
    d_flat = torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], dim=1)
    o_flat = origin[None].expand(k, r, 3).reshape(k * r, 3)
    return light_probe(em, o_flat, d_flat).reshape(k, r) * active


def reservoir_sample_direction(props: dict, em: dict, is_diffuse: torch.Tensor,
                               pixel_idx, frame, dim: int, n_candidates: int,
                               trim, spec_k_scale=None):
    """Pick a bounce direction by weighted reservoir over K BRDF candidates.
    spec_k_scale scales the candidate count of specular lobes.
    Returns (ray_local [N, 3], throughput multiplier [N])."""
    n = props["n"]
    v_local = sampling.to_local(props["v"], n)
    x = props["x"]
    origin = x + props["n_geom"] * 1e-4

    k_eff = torch.full(x.shape[:-1], float(n_candidates), dtype=x.dtype, device=x.device)
    if spec_k_scale is not None:
        k_spec = torch.ceil(n_candidates * torch.clamp(spec_k_scale, 0.0, 1.0))
        k_eff = torch.where(is_diffuse, k_eff, torch.clamp_min(k_spec, 1.0))

    # phase 1: all candidate directions, one (R,) plane per component and k
    planes = [[] for _ in range(6)]
    for k in range(n_candidates):
        rnd = rng.uniform2(pixel_idx, frame, dim + 3 * k)
        cand_diff = sampling.cosine_ray(rnd)
        h = sampling.vndf_ggx(rnd, v_local, props["roughness"], trim)
        cand_spec = geo.reflect(-v_local, h)
        c = torch.where(is_diffuse[..., None], cand_diff, cand_spec)
        w = sampling.to_world(c, n)
        for p, val in zip(planes, (c[..., 0], c[..., 1], c[..., 2], w[..., 0], w[..., 1], w[..., 2])):
            p.append(val)
    cx, cy, cz, wx, wy, wz = (torch.stack(p) for p in planes)   # 6 x (K, R)
    ks = torch.arange(n_candidates, device=x.device)
    active = (ks[:, None] < k_eff[None, :]).to(x.dtype)

    # phase 2: one batched light probe
    li_all = light_probe_batch(em, origin, (wx, wy, wz), active)

    # phase 3: reservoir fold over the precomputed intensities
    sum_i = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    chosen_i = torch.ones_like(sum_i)
    ray_local = torch.zeros_like(x)
    for k in range(n_candidates):
        li = li_all[k]
        cand = torch.stack([cx[k], cy[k], cz[k]], dim=-1)
        sum_i = sum_i + li
        take_rnd = rng.uniform1(pixel_idx, frame, dim + 3 * k + 2)
        take = (li > 0.0) & (take_rnd < li / torch.clamp_min(sum_i, 1e-9))
        pick = take if k > 0 else torch.ones_like(take)
        ray_local = torch.where(pick[..., None], cand, ray_local)
        chosen_i = torch.where(take, li, chosen_i)

    mult = sum_i / (chosen_i * torch.clamp_min(k_eff, 1.0))
    mult = torch.clamp_max(mult, 8.0)
    mult = torch.where(sum_i > 0.0, mult, 1.0)
    return ray_local, mult.detach()
