"""The animated scene of ``cli animate`` (the scene and the frame step of the
JAX package's ``cli.cmd_animate``, ``nrdsample_tpu/cli.py:143-272``): a
static ground box and a pool of cubes on random orbits (AnimatedInstance and
GenerateAnimatedCubes, NRDSample.cpp:304-333, 2280-2301), in cluster mode.

Each frame animates the pool, moves the triangles (``instances.transform_scene``),
refits the clusters on the device (``instances.refit_context``) and renders
with the previous frame's transforms as the frame's ``dynamics``, so that
the motion vectors of the cubes are their true motion (GatherInstanceData,
NRDSample.cpp:3395-3630).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.scene import animation, instances, procedural
from nrdsample_tpu_torch.scene.types import (Camera, Materials, Scene, build_triangle_soa,
                                             look_at, make_scene)

FPS = 24.0                       # the animation clock: frame f is at t = f / FPS
POOL = dict(extent=6.0, seed=3)  # the cube pool of cli animate
EYE, TARGET, FOV = (0.0, -16.0, 8.0), (0.0, 0.0, 1.0), 45.0
SUN_ELEVATION = 55.0


@dataclasses.dataclass
class AnimatedScene:
    """The rest-pose context, its instances, the orbits and the camera."""

    ctx: traversal.TraceContext
    inst: instances.InstancedScene
    pool: animation.OrbitPool
    cam: Camera


def cubes_scene(n_cubes: int) -> tuple[Scene, np.ndarray]:
    """(scene on the CPU, per-triangle instance ids): a 30x30 ground box
    (instance 0) and ``n_cubes`` cubes of side 0.8 at the origin (instances
    1..n), in the three cube materials by turns."""
    parts_v, parts_i, mats_id, inst_id = [], [], [], []
    gv, gi = procedural.make_box([0, 0, -1.0], [30, 30, 0.5])
    parts_v.append(gv)
    parts_i.append(gi)
    mats_id += [0] * len(gi)
    inst_id += [0] * len(gi)
    off = len(gv)
    for k in range(n_cubes):
        cv, ci = procedural.make_box([0, 0, 0], [0.8, 0.8, 0.8])
        parts_v.append(cv)
        parts_i.append(ci + off)
        mats_id += [1 + (k % 3)] * len(ci)
        inst_id += [1 + k] * len(ci)
        off += len(cv)
    tris = build_triangle_soa(np.concatenate(parts_v), np.concatenate(parts_i), None, None,
                              np.array(mats_id, np.int32))
    f32 = torch.tensor
    materials = Materials(
        base_color=f32([[0.55, 0.55, 0.55], [0.8, 0.25, 0.2], [0.2, 0.6, 0.85],
                        [0.9, 0.75, 0.2]], dtype=torch.float32),
        metalness=f32([0.0, 0.1, 0.6, 0.9], dtype=torch.float32),
        roughness=f32([0.8, 0.4, 0.3, 0.2], dtype=torch.float32),
        emission=torch.zeros((4, 3), dtype=torch.float32),
        ior=torch.full((4,), 1.5, dtype=torch.float32),
        flags=torch.full((4,), cfgmod.FLAG_NON_TRANSPARENT, dtype=torch.int32),
    )
    return make_scene(tris, materials), np.array(inst_id, np.int32)


def build(n_cubes: int, device=None, aspect: float = 1.0) -> AnimatedScene:
    """The animated scene of ``n_cubes`` cubes on ``device`` (the CUDA card
    when None), in cluster mode, its camera for an image of ``aspect``
    width / height."""
    device = resolve(device)
    scene, inst_id = cubes_scene(n_cubes)
    ctx, scene = traversal.build_context(scene, mode="cluster", device=device)
    return AnimatedScene(
        ctx=ctx, inst=instances.assign_instance_ids(scene, inst_id, ctx),
        pool=animation.generate_orbit_pool(n_cubes, device=device, **POOL),
        cam=look_at(EYE, TARGET, fov_y_deg=FOV, aspect=aspect, device=device))


def render_config(size: int, denoiser: str = "relax") -> RenderConfig:
    """The frame of cli animate: size x size, one path of one bounce."""
    return RenderConfig(width=size, height=size, rpp=1, bounce_num=1,
                        tracing_mode=TracingMode.FULL_PROBABILISTIC,
                        denoiser=Denoiser[denoiser.upper()])


def transforms(pool: animation.OrbitPool, t) -> torch.Tensor:
    """(1 + N, 3, 4): the ground's identity, then the pool's orbits at t."""
    m = animation.orbit_transforms(pool, t)
    return torch.cat([instances.identity_transforms(1, device=m.device), m])


def pose(anim: AnimatedScene, t):
    """(world scene, refit context, transforms) at time t."""
    m = transforms(anim.pool, t)
    world = instances.transform_scene(anim.inst, m)
    return world, instances.refit_context(anim.ctx, world), m


def render(anim: AnimatedScene, cfg: RenderConfig, settings, history: frame.History, t,
           t_prev):
    """One animated frame at time t, its motion from t_prev: (outputs,
    history)."""
    world, ctx, m_curr = pose(anim, t)
    m_prev = transforms(anim.pool, t_prev)
    return frame.render_frame(ctx, world, anim.cam, cfg, settings, history,
                              dynamics=(anim.inst, m_curr, m_prev))


def frame_times(f: int) -> tuple[float, float]:
    """(t, t_prev) of frame f."""
    t = f / FPS
    return t, max(t - 1.0 / FPS, 0.0)
