"""Composition — re-modulation of the denoised signals and the direct term,
the debug views and the validation overlay (counterpart of
``nrdsample_tpu/denoise/composition.py``)."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.config import OnScreen
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import sharc


def compose(gb: dict, diff_radiance: torch.Tensor, spec_radiance: torch.Tensor,
            shadow: torch.Tensor) -> torch.Tensor:
    """HDR radiance [N, 3]: direct * shadow + emission, plus the indirect
    signals re-modulated by the factors TraceOpaque divided out, times the
    PSR throughput, plus the emission the PSR walk collected. With glass the
    scalar shadow is tinted by the trace's chroma plane ``shadow_tint``."""
    shadow_rgb = shadow[..., None]
    tint = gb.get("shadow_tint")
    if tint is not None:
        shadow_rgb = shadow_rgb * tint
    direct = gb["direct_lighting"] * shadow_rgb + gb["emission"]
    diff = diff_radiance * gb["diff_factor"]
    spec = spec_radiance * gb["spec_factor"]
    return direct + (diff + spec) * gb["psr_throughput"] + gb["l_psr"]


def _grey(plane: torch.Tensor) -> torch.Tensor:
    return plane[..., None].expand(*plane.shape, 3)


def _bytes_rgb(h: torch.Tensor, dtype) -> torch.Tensor:
    """The low three bytes of uint32 words (int64 holding them) as RGB in
    [0, 1]."""
    return torch.stack([((h >> s) & 0xFF).to(dtype) / 255.0 for s in (0, 8, 16)], dim=-1)


def debug_view(on_screen: int, gb: dict, composed: torch.Tensor, sharc_state=None, cam_pos=None,
               taa_weight=None) -> torch.Tensor:
    """The ``gOnScreen`` visualizations [N, 3]: the G-buffer views
    (Composition.cs.hlsl:200-238), the SHARC cache and grid
    (USE_SHARC_DEBUG, TraceOpaque.cs.hlsl:117-154) and the TAA weight
    (USE_TAA_DEBUG, Final.cs.hlsl:54-56). A view without its input (and
    MIP_SPECULAR) shows the composed image."""
    if on_screen == OnScreen.FINAL:
        return composed
    if on_screen == OnScreen.BASE_COLOR:
        return gb["base_color"]
    if on_screen == OnScreen.NORMAL:
        return gb["normal"] * 0.5 + 0.5
    if on_screen == OnScreen.ROUGHNESS:
        return _grey(gb["roughness"])
    if on_screen == OnScreen.METALNESS:
        return _grey(gb["metalness"])
    if on_screen == OnScreen.SHADOW:
        return _grey(gb["shadow"])
    if on_screen == OnScreen.MATERIAL_ID:
        return _grey(gb["material_id"] / 3.0)
    if on_screen == OnScreen.WORLD_UNITS:
        return torch.remainder(gb["primary_x"], 1.0)
    if on_screen == OnScreen.DENOISED_DIFFUSE:
        return gb["diff_radiance"] * gb["diff_factor"]
    if on_screen == OnScreen.DENOISED_SPECULAR:
        return gb["spec_radiance"] * gb["spec_factor"]
    if on_screen in (OnScreen.AMBIENT_OCCLUSION, OnScreen.SPECULAR_OCCLUSION):
        hd = gb["diff_hitdist" if on_screen == OnScreen.AMBIENT_OCCLUSION else "spec_hitdist"]
        return _grey(geo.clip(hd / (hd + 1.0), 0.0, 1.0))
    if on_screen == OnScreen.PSR_THROUGHPUT:
        return gb.get("psr_throughput", torch.ones_like(composed))
    if on_screen == OnScreen.INSTANCE_INDEX:
        # the hashed triangle id as a stand-in colour (TraceOpaque.cs.hlsl:666-670):
        # tri * 0x9E3779B9 modulo 2^32
        tri = gb["tri"] if "tri" in gb else gb["material_id"].to(torch.int32)
        h = (torch.clamp_min(tri, 0).to(torch.int64) * 0x9E3779B9) & 0xFFFFFFFF
        return _bytes_rgb(h, composed.dtype)
    if on_screen == OnScreen.UV:
        uv = gb["uv"]
        return torch.cat([torch.remainder(uv, 1.0), torch.zeros_like(uv[..., :1])], dim=-1)
    if on_screen == OnScreen.CURVATURE:
        c = torch.sqrt(geo.absolute(gb.get("curvature", torch.zeros_like(gb["view_z"]))) + 1e-12)
        return _grey(c)
    if on_screen == OnScreen.MIP_PRIMARY:
        return _grey(gb.get("mip", torch.zeros_like(gb["view_z"])) / 8.0)
    if on_screen == OnScreen.SHARC_CACHE and sharc_state is not None:
        # the resolved cache radiance at the primary hit; invalid cells red
        rad, found = sharc.query(sharc_state, gb["primary_x"], gb["normal"], cam_pos)
        red = torch.zeros_like(rad)
        red[..., 0] = 1.0
        return torch.where(found[..., None], rad, red)
    if on_screen == OnScreen.SHARC_GRID and cam_pos is not None:
        # HashGridDebugColoredHash: colour from the grid cell's hash
        x, y, z, w_key, _ = sharc.cell_key(gb["primary_x"], gb["normal"], cam_pos)
        return _bytes_rgb(sharc._hash_u32x4(x, y, z, w_key), composed.dtype)
    if on_screen == OnScreen.TAA_WEIGHT and taa_weight is not None:
        return _grey(taa_weight.to(composed.dtype))
    return composed


def validation_overlay(img: torch.Tensor, frames: torch.Tensor, max_frames,
                       alpha: float = 0.5) -> torch.Tensor:
    """The NRD validation layer's analogue (Final.cs.hlsl:46-51): a green to
    red accumulation-age heatmap (fresh disocclusions red, converged history
    green) blended over ``img`` at ``alpha``. img: (N, 3) or (H, W, 3);
    frames: the matching leading shape."""
    conv = geo.clip(frames / max_frames, 0.0, 1.0)[..., None]
    heat = torch.cat([1.0 - conv, conv, torch.zeros_like(conv)], dim=-1).to(img.dtype)
    return img * (1.0 - alpha) + heat * alpha
