"""Guide buffers of a learned upscaler or denoiser (counterpart of
``nrdsample_tpu/post/guides.py``; DlssBefore.cs.hlsl:15-62): the hardware
post-projection depth, diffuse and specular albedo, normal and roughness,
the specular hit distance and the motion of the configured ``mvType``."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import brdf, geometry as geo


def hw_depth(view_z: torch.Tensor, near: float, far: float = 1e5) -> torch.Tensor:
    """Linear viewZ -> reversed-Z post-projection depth near / z in [0, 1]
    (an infinite-far projection)."""
    z = geo.clip_min(geo.absolute(view_z), near)
    return geo.clip(near / z, 0.0, 1.0)


def rr_guides(gb: dict, near: float, mv_type=None) -> dict:
    """Guide dict from the flat (N, ...) G-buffer. mv_type (Settings.mvType):
    None or 0 exports the screen-space 2.5D motion, 1 the world-space motion
    ``gb["mv_world"]``."""
    base_color = gb["base_color"]
    metalness = gb["metalness"][..., None]
    roughness = gb["roughness"]
    normal = gb["normal"]
    view_z = gb["view_z"]

    # f0 = lerp(0.04, baseColor, metalness), as GetMaterialProps
    f0 = 0.04 * (1.0 - metalness) + base_color * metalness
    view_dir = gb.get("view_dir", normal)
    n_dot_v = geo.clip(-torch.sum(normal * view_dir, dim=-1), 0.05, 1.0)
    f_env = brdf.environment_term_rtg(f0, n_dot_v, roughness)

    albedo = base_color * (1.0 - metalness)
    if mv_type is None or "mv_world" not in gb:
        mv = gb["mv"]
    else:
        mv = torch.where(torch.as_tensor(mv_type, device=view_z.device) > 0, gb["mv_world"],
                         gb["mv"])
    return {
        "depth": hw_depth(view_z, near),
        "diff_albedo": albedo * (1.0 - f_env),
        "spec_albedo": f_env,
        "normal_roughness": torch.cat([normal, roughness[..., None]], dim=-1),
        "spec_hitdist": gb.get("spec_hitdist", torch.zeros_like(view_z)),
        "mv": mv,
    }
