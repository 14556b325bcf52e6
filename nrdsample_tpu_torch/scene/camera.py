"""Camera ray generation and screen-space transforms (counterpart of
``nrdsample_tpu/scene/camera.py``). All functions are batched over pixels."""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo, rng, sampling
from nrdsample_tpu_torch.scene.types import Camera


def view_dir_from_uv(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """uv in [0, 1] (y down) -> unit view-space direction (z forward)."""
    x = (uv[..., 0] * 2.0 - 1.0) * cam.tan_half_fov_y * cam.aspect
    y = (1.0 - uv[..., 1] * 2.0) * cam.tan_half_fov_y
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return geo.normalize(d)


def camera_rays(cam: Camera, width: int, height: int, pixel_idx: torch.Tensor,
                frame, sample_dim: int = 0):
    """World-space primary rays for flat pixel indices: (origin [N,3],
    direction [N,3], uv [N,2]), with sub-pixel jitter and thin-lens DoF when
    the aperture is above 0."""
    px = (pixel_idx % width).to(torch.float32) + 0.5
    py = torch.div(pixel_idx, width, rounding_mode="floor").to(torch.float32) + 0.5
    uv = torch.stack([(px + cam.jitter[0]) / width, (py + cam.jitter[1]) / height], dim=-1)
    d_view = view_dir_from_uv(cam, uv)

    rnd = rng.uniform2(pixel_idx, frame, 1000 + sample_dim)
    offset = sampling.cosine_ray(rnd)[..., :2] * cam.aperture
    xv = torch.stack(
        [uv[..., 0] * 0.0 + offset[..., 0], offset[..., 1], torch.zeros_like(offset[..., 0])],
        dim=-1,
    )
    focal_pt = d_view * cam.focal_distance
    d_view_dof = geo.normalize(focal_pt - xv)
    d_view = torch.where(cam.aperture > 0.0, d_view_dof, d_view)

    origin_w = geo.affine_transform(cam.view_to_world, xv)
    dir_w = geo.rotate_vector(cam.view_to_world, d_view)
    return origin_w, geo.normalize(dir_w), uv


def world_to_view_z(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    """Positive forward depth of world points."""
    return geo.affine_transform(cam.world_to_view, p)[..., 2]


def world_to_uv(cam: Camera, p: torch.Tensor, prev: bool = False) -> torch.Tensor:
    """Project world points to screen uv in [0, 1] (y down), unjittered."""
    w2v = cam.world_to_view_prev if prev else cam.world_to_view
    v = geo.affine_transform(w2v, p)
    z = geo.clip_min(v[..., 2], 1e-6)
    x = v[..., 0] / (z * cam.tan_half_fov_y * cam.aspect)
    y = v[..., 1] / (z * cam.tan_half_fov_y)
    return torch.stack([x * 0.5 + 0.5, 0.5 - y * 0.5], dim=-1)


def get_motion(cam: Camera, x: torch.Tensor, x_prev: torch.Tensor, width: int, height: int):
    """2.5D motion vector (pixels, pixels, viewZ delta)."""
    uv = world_to_uv(cam, x, prev=False)
    uv_prev = world_to_uv(cam, x_prev, prev=True)
    size = torch.tensor([width, height], dtype=torch.float32, device=x.device)
    mxy = (uv_prev - uv) * size
    vz = world_to_view_z(cam, x)
    vz_prev = geo.affine_transform(cam.world_to_view_prev, x_prev)[..., 2]
    return torch.cat([mxy, (vz_prev - vz)[..., None]], dim=-1)


def unproject_scale(cam: Camera, height: int) -> torch.Tensor:
    """World size of one pixel at unit viewZ: 2 tan(fov/2) / height."""
    return 2.0 * cam.tan_half_fov_y / height
