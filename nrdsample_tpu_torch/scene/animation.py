"""Animation drivers (counterpart of ``nrdsample_tpu/scene/animation.py``):
orbiting instances, sun drift, emulated camera motion, the "nine brothers"
grid.

  * ``generate_orbit_pool`` is GenerateAnimatedCubes (NRDSample.cpp:2280-2301):
    a pool of instances with random orbit centres, radii, periods, phases,
    axes, spins and scales, drawn from ``np.random.RandomState(seed)`` in the
    JAX package's order, so that one seed gives one pool in both packages;
  * ``orbit_transforms`` is AnimatedInstance::Animate (NRDSample.cpp:314-332);
  * ``animate_sun`` (2017-2027), ``emulate_camera_motion`` (1958-2007) and
    ``nine_brothers_transforms`` (2031-2080).

Every driver is a function of time giving (N, 3, 4) rigid transforms on the
device of its inputs; ``scene/instances.py`` applies them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.scene.types import _to


@dataclasses.dataclass
class OrbitPool:
    """Orbit parameters of a pool of animated instances."""

    center: torch.Tensor      # (N, 3)
    radius: torch.Tensor      # (N, 2) ellipse radii
    period: torch.Tensor      # (N,) seconds per revolution
    phase: torch.Tensor       # (N,)
    axis: torch.Tensor        # (N, 3) orbit plane normal (unit)
    spin_rate: torch.Tensor   # (N,) local rotation, rad/s
    scale: torch.Tensor       # (N,)

    def to(self, device) -> "OrbitPool":
        return _to(self, device)


def generate_orbit_pool(n: int, extent=10.0, seed: int = 0, device=None) -> OrbitPool:
    """A pool of ``n`` orbits on ``device`` (the CUDA card when None)."""
    device = resolve(device)
    rs = np.random.RandomState(seed)
    axis = rs.randn(n, 3).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    arrays = dict(
        center=((rs.rand(n, 3) - 0.5) * 2 * extent).astype(np.float32),
        radius=(0.5 + rs.rand(n, 2) * 2.0).astype(np.float32),
        period=(4.0 + rs.rand(n) * 12.0).astype(np.float32),
        phase=(rs.rand(n) * 2 * np.pi).astype(np.float32),
        axis=axis,
        spin_rate=(rs.randn(n) * 1.5).astype(np.float32),
        scale=(0.3 + rs.rand(n) * 0.7).astype(np.float32),
    )
    return OrbitPool(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def _axis_angle_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit axis, (...,) angle -> (..., 3, 3) Rodrigues rotation."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(ax)
    k = torch.stack([
        torch.stack([zero, -az, ay], dim=-1),
        torch.stack([az, zero, -ax], dim=-1),
        torch.stack([-ay, ax, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(k.shape)
    return eye + s * k + (1.0 - c) * (k @ k)


def _time(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


def orbit_transforms(pool: OrbitPool, t) -> torch.Tensor:
    """(N, 3, 4) rigid transforms of the pool at time ``t`` (seconds)."""
    t = _time(t, pool.period)
    angle = 2.0 * math.pi * t / pool.period + pool.phase

    # an orthonormal basis of each orbit plane
    a = pool.axis
    z = torch.tensor([0.0, 0.0, 1.0], device=a.device)
    x = torch.tensor([1.0, 0.0, 0.0], device=a.device)
    helper = torch.where(torch.abs(a[..., 2:3]) < 0.9, z, x)
    u = geo.cross(a, helper.expand(a.shape))
    u = u / torch.clamp_min(torch.linalg.norm(u, dim=-1, keepdim=True), 1e-9)
    v = geo.cross(a, u)

    pos = (pool.center
           + u * (pool.radius[..., 0:1] * torch.cos(angle)[..., None])
           + v * (pool.radius[..., 1:2] * torch.sin(angle)[..., None]))
    rot = _axis_angle_matrix(a, pool.spin_rate * t) * pool.scale[..., None, None]
    return torch.cat([rot, pos[..., :, None]], dim=-1)


def animate_sun(base_azimuth, base_elevation, t, swing_deg=10.0, period_s=30.0):
    """(azimuth, elevation) in degrees: a sinusoidal drift about the base."""
    t = torch.as_tensor(t, dtype=torch.float32)
    w = 2.0 * math.pi / period_s
    return (base_azimuth + swing_deg * torch.sin(w * t),
            base_elevation + 0.3 * swing_deg * torch.sin(2.0 * w * t))


def emulate_camera_motion(base_eye: torch.Tensor, t, mode: int = 1, amplitude=0.5,
                          period_s=4.0) -> torch.Tensor:
    """The eye moved periodically: mode 1 strafes along x, 2 bobs along z,
    3 circles in the x-z plane."""
    t = _time(t, base_eye)
    w = 2.0 * math.pi / period_s
    dx = amplitude * torch.sin(w * t)
    dz = amplitude * torch.cos(w * t)
    zero = torch.zeros_like(dx)
    if mode == 1:
        off = torch.stack([dx, zero, zero])
    elif mode == 2:
        off = torch.stack([zero, zero, dx])
    else:
        off = torch.stack([dx, zero, dz])
    return base_eye + off


def nine_brothers_transforms(cam_pos: torch.Tensor, forward: torch.Tensor,
                             right: torch.Tensor, up: torch.Tensor,
                             distance=3.0, spacing=1.2) -> torch.Tensor:
    """(9, 3, 4): a 3x3 grid of instances ahead of the camera."""
    steps = torch.arange(3, device=cam_pos.device) - 1
    ii, jj = torch.meshgrid(steps, steps, indexing="ij")
    offs = (ii.reshape(-1, 1) * spacing * right + jj.reshape(-1, 1) * spacing * up)
    pos = cam_pos + forward * distance + offs
    rot = torch.eye(3, dtype=pos.dtype, device=pos.device).expand(9, 3, 3)
    return torch.cat([rot, pos[..., :, None]], dim=-1)
