"""Emissive importance sampling — the light-BVH reservoir (counterpart of
``nrdsample_tpu/render/emissive_is.py``).

Up to K = 16 BRDF-sampled candidate directions are probed against the
emissive-only set in ONE batched launch; a weighted reservoir then picks one
in proportion to the emissive intensity it would reach, and throughput is
scaled by sum / (chosen * K), clamped to 8. (K, R) quantities travel as
component planes, never as (K, R, 3).

The probe: on the card, sets of at most 512 emitters take the probe kernel,
larger ones a closest hit against their own ClusterSet (the packet kernel;
``build_emissive_clusters``, the JAX package's path on the TPU). On the CPU
every set takes the plain dense probe, in chunks of rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.mathlib import color, geometry as geo, rng, sampling
from nrdsample_tpu_torch.ops import cluster, emissive_probe, packet
from nrdsample_tpu_torch.scene.types import Scene, TriangleSoA

DENSE_EMISSIVE_MAX = emissive_probe.MAX_TRIS   # larger sets take the packet probe on the card
_PROBE_CHUNK = 1 << 19                         # rays per plain-probe chunk


def emissive_cluster_set(scene: Scene):
    """(ClusterSet, base luminance (T',)) of the scene's emissive triangles
    on the host: the clusters of the emitters in BVH order, padded to whole
    clusters, and the luminance of each reordered triangle's emission (0 for
    padding)."""
    ids = scene.emissive_tris.cpu().numpy()
    idx = torch.from_numpy(ids[ids >= 0].astype(np.int64))
    sub = TriangleSoA(**{f.name: getattr(scene.tris, f.name).cpu()[idx]
                         for f in dataclasses.fields(TriangleSoA)})
    cs, tris_p, order = cluster.build_clusters(sub)
    em = scene.materials.emission.cpu().numpy()[sub.material.numpy()[order]]
    lum = em @ np.asarray([0.2126, 0.7152, 0.0722], em.dtype)
    lum = np.concatenate([lum, np.zeros(tris_p.count - len(lum), lum.dtype)])
    return cs, torch.from_numpy(lum)


def build_emissive_clusters(scene: Scene, device) -> dict | None:
    """On a CUDA ``device``, for more than DENSE_EMISSIVE_MAX emitters: the
    emissive ClusterSet (the merged-emissive acceleration structure of the
    reference) and the base luminance of its triangles, for the packet
    probe. None otherwise: the CPU probes every set densely, as the JAX
    package does off the TPU. Once per scene."""
    if (torch.device(device).type != "cuda"
            or int((scene.emissive_tris >= 0).sum()) <= DENSE_EMISSIVE_MAX):
        return None
    cs, lum = emissive_cluster_set(scene)
    return {"clusters": cs.to(device), "base_lum": lum.to(device)}


def build_emissive_set(scene: Scene, emission_scale=1.0, clusters: dict | None = None) -> dict:
    """The padded emissive-triangle subset: p0/e1/e2 (E, 3) with zero rows
    for padding, and intensity (E,) = luminance of the material emission.
    With ``clusters`` (``build_emissive_clusters``) also the ClusterSet and
    the luminance of its triangles, ``cl_lum``."""
    ids = scene.emissive_tris
    valid = ids >= 0
    safe = torch.clamp_min(ids, 0).long()
    tr = scene.tris
    mask = valid[:, None].to(tr.p0.dtype)
    mat = tr.material[safe].long()
    inten = color.luminance(scene.materials.emission[mat]) * emission_scale
    out = {
        "p0": tr.p0[safe] * mask,
        "e1": tr.e1[safe] * mask,
        "e2": tr.e2[safe] * mask,
        "intensity": torch.where(valid, inten, 0.0),
        "any": scene.emissive_count > 0,
    }
    if clusters is not None:
        out["clusters"] = clusters["clusters"]
        out["cl_lum"] = clusters["base_lum"] * emission_scale
    return out


def _detached(em: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in em.items()}


def light_probe(em: dict, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """CastLightRay_AnyHit: intensity of the nearest emissive surface along
    each ray, 0 on a miss. CUDA rays launch the probe kernel (or raise); CPU
    rays take its plain version.

    The result carries no gradient: the rays, the emitters and their
    intensity are detached before either path, on both devices. The
    reservoir uses the intensities only for discrete choices and for a
    multiplier that the JAX package stops the gradient of."""
    em, origin, direction = _detached(em), origin.detach(), direction.detach()
    if origin.device.type == "cuda":
        return emissive_probe.light_probe_cuda(em, origin, direction)
    if origin.device.type == "cpu":
        return torch.cat([emissive_probe.light_probe_plain(em, origin[a:a + _PROBE_CHUNK],
                                                           direction[a:a + _PROBE_CHUNK])
                          for a in range(0, origin.shape[0], _PROBE_CHUNK)])
    raise ValueError(f"no light probe path for device {origin.device}")


def light_probe_batch(em: dict, origin: torch.Tensor, dir_planes, active: torch.Tensor) -> torch.Tensor:
    """All K candidates in one launch: origin (R, 3), dir_planes 3 x (K, R),
    active (K, R) -> intensities (K, R), without a gradient (see
    ``light_probe``). With an emissive ClusterSet the probe is a closest hit
    through the packet kernel (inactive candidates trace too, and are
    masked after)."""
    dx, dy, dz = (p.detach() for p in dir_planes)
    k, r = dx.shape
    d_flat = torch.stack([dx.reshape(-1), dy.reshape(-1), dz.reshape(-1)], dim=1)
    o_flat = origin.detach()[None].expand(k, r, 3).reshape(k * r, 3)
    if "clusters" in em:
        res = packet.closest_hit_packet_cuda(em["clusters"], o_flat, d_flat, sort=True,
                                             need_uv=False)
        hit = res["tri"] >= 0
        li = torch.where(hit, em["cl_lum"].detach()[torch.clamp_min(res["tri"], 0).long()], 0.0)
        return li.reshape(k, r) * active
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
        k_spec = torch.ceil(n_candidates * geo.clip(spec_k_scale, 0.0, 1.0))
        k_eff = torch.where(is_diffuse, k_eff, geo.clip_min(k_spec, 1.0))

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
        take = (li > 0.0) & (take_rnd < li / geo.clip_min(sum_i, 1e-9))
        pick = take if k > 0 else torch.ones_like(take)
        ray_local = torch.where(pick[..., None], cand, ray_local)
        chosen_i = torch.where(take, li, chosen_i)

    mult = sum_i / (chosen_i * geo.clip_min(k_eff, 1.0))
    mult = geo.clip_max(mult, 8.0)
    mult = torch.where(sum_i > 0.0, mult, 1.0)
    return ray_local, mult.detach()
