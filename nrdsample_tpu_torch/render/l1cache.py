"""The L1 radiance cache: previous-frame screen-space irradiance
reprojection (counterpart of ``nrdsample_tpu/render/l1cache.py``).

A path vertex is projected into the previous frame, last frame's composed
diffuse and specular are sampled there, and the sample is weighted by the
agreement of view-z, the screen-edge fade, the sun side, the ray length and
the history confidence; the specular part is further weighted by how
view-dependent the hit's material is.

The state is one packed (H, W, 7) plane [|viewZ| sign(N.sun), diff (3),
spec (3)], so the reprojection is one bilinear gather. Its positions are
scattered bounce hits, so it is ``filtering.sample_bilinear`` in plain
PyTorch, as in the JAX package (no Pallas call stands behind it).
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch.mathlib import color, filtering, geometry as geo
from nrdsample_tpu_torch.scene import camera as cam_mod


@dataclasses.dataclass
class L1History:
    packed: torch.Tensor   # (H, W, 7): [|viewZ| sign(N.sun), diff (3), spec (3)]
    valid: torch.Tensor    # () int32

    @staticmethod
    def create(h: int, w: int, dtype=torch.float32, device=None) -> "L1History":
        packed = torch.zeros((h, w, 7), dtype=dtype, device=device)
        packed[..., 0] = 1e5
        return L1History(packed=packed, valid=torch.tensor(0, dtype=torch.int32, device=device))


def _linear_step(a, b, x):
    return geo.clip((x - a) / (b - a), 0.0, 1.0)


def reproject_irradiance(hist: L1History, cam, props: dict, pixel_idx, width: int,
                         height: int, sun_dir, prev_frame_confidence):
    """(l_diff (N, 3), l_spec (N, 3), weight (N,)) of the hits ``props``."""
    x = props["x"]
    size = torch.tensor([width, height], dtype=torch.float32, device=x.device)
    uv = cam_mod.world_to_uv(cam, x, prev=True)
    data = filtering.sample_bilinear(hist.packed, uv * size)
    data_z = data[..., 0]
    l_diff = data[..., 1:4]
    l_spec = data[..., 4:7]
    prev_view_z = geo.absolute(data_z)

    view_z = geo.absolute(geo.affine_transform(cam.world_to_view_prev, x)[..., 2])
    err = (view_z - prev_view_z) * geo.positive_rcp(torch.maximum(view_z, prev_view_z))
    weight = _linear_step(0.01, 0.005, geo.absolute(err))

    # soft screen-edge fade
    f = _linear_step(0.0, 0.1, uv) * _linear_step(1.0, 0.9, uv)
    weight = weight * f[..., 0] * f[..., 1]

    # back faces to the sun do not take front-face samples: sign(N.sun)
    # rides in the stored view-z
    n_dot_l = geo.dot3(props["n"], sun_dir)
    weight = weight * (n_dot_l * torch.sign(data_z) > 0.0)

    # too short a ray reprojects onto itself
    uv_cur = cam_mod.world_to_uv(cam, x, prev=False)
    px = (pixel_idx % width).to(torch.float32) + 0.5
    py = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32) + 0.5
    dxy = (uv_cur - torch.stack([px / width, py / height], -1)) * size
    d = torch.sqrt(geo.clip_min(dxy[..., 0] * dxy[..., 0] + dxy[..., 1] * dxy[..., 1], 1e-30))
    weight = weight * _linear_step(1.0, 3.0, d)

    weight = weight * ~props["miss"]
    weight = weight * prev_frame_confidence * (hist.valid > 0)

    ok = torch.isfinite(l_diff).all(-1) & torch.isfinite(l_spec).all(-1)
    weight = weight * ok
    fade = geo.clip(weight / 0.001, 0.0, 1.0)[..., None]
    return l_diff * fade, l_spec * fade, weight


def radiance_from_previous_frame(hist: L1History, cam, props: dict, pixel_idx, width: int,
                                 height: int, sun_dir, prev_frame_confidence):
    """GetRadianceFromPreviousFrame: (L (N, 3), weight (N,))."""
    l_diff, l_spec, w = reproject_irradiance(hist, cam, props, pixel_idx, width, height,
                                             sun_dir, prev_frame_confidence)
    norm_curv = geo.clip(torch.sqrt(geo.absolute(props["curvature"]) + 1e-12) / 2.5, 0.0, 1.0)
    r = props["roughness"]
    f = 1.0 - torch.exp2(-200.0 * (r * r))
    spec_conf = f * geo.pow01(r, 0.5)
    spec_conf = spec_conf + (1.0 - spec_conf) * norm_curv

    diff_lum = color.luminance(l_diff)
    spec_lum = color.luminance(l_spec)
    spec_w = spec_lum / (diff_lum + spec_lum + 1e-6)
    w = w * (1.0 + (spec_conf - 1.0) * spec_w)

    l_sum = l_diff + l_spec * spec_conf[..., None]
    l_sum = l_sum * geo.clip(w / 0.05, 0.0, 1.0)[..., None]
    return l_sum, w


def update_history(cam, composed_diff, composed_spec, view_z, normal, sun_dir,
                   height: int, width: int) -> L1History:
    """Next frame's L1 state from this frame's composed signals (flat (N, ...)
    planes)."""
    sgn = torch.where(geo.dot3(normal, sun_dir) >= 0, 1.0, -1.0)
    packed = torch.cat([(geo.absolute(view_z) * sgn)[..., None], composed_diff.reshape(-1, 3),
                        composed_spec.reshape(-1, 3)], dim=-1).reshape(height, width, 7)
    return L1History(packed=packed, valid=torch.tensor(1, dtype=torch.int32, device=packed.device))
