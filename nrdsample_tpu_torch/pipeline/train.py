"""Differentiable inverse rendering on one device (counterpart of
``nrdsample_tpu/pipeline/train.py``): pixel gradients flow back to the
material albedo, roughness, metalness, emission and IOR.

Discrete decisions (hits, lobe choice, the reservoir's take, the light
probe) carry no gradient; gradients flow through the continuous shading
factors, with JAX's conventions at the points where a function has no
derivative (``mathlib/geometry.clip`` and ``absolute``). On the card the
three denoiser kernels run their forward and differentiate their plain
versions (``ops/_kernels.with_plain_backward``). ``make_sharded_train_step``
takes the same step over the ranks of a ``parallel.mesh.PixelMesh``.

    python -m nrdsample_tpu_torch.pipeline.train [--size 512] [--iters 4] [--cpu]

runs ``bench_backward`` (counterpart of ``bench.py:bench_backward``) and
prints its JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.pipeline import frame as frame_mod
from nrdsample_tpu_torch.scene.types import Materials

DIFFERENTIABLE_MATERIAL_FIELDS = ("base_color", "metalness", "roughness", "emission", "ior")

#: the physical range of each optimised field (the projection step)
PARAM_BOUNDS = {
    "base_color": (0.0, 1.0),
    "metalness": (0.0, 1.0),
    "roughness": (0.01, 1.0),
    "emission": (0.0, 1e4),
    "ior": (1.0, 2.5),
}


def split_materials(materials: Materials) -> tuple[dict, dict]:
    """(differentiable fields, the rest): the int flags cannot take a
    gradient."""
    diff = {k: getattr(materials, k) for k in DIFFERENTIABLE_MATERIAL_FIELDS}
    rest = {f.name: getattr(materials, f.name) for f in dataclasses.fields(materials)
            if f.name not in DIFFERENTIABLE_MATERIAL_FIELDS}
    return diff, rest


def merge_materials(diff: dict, rest: dict) -> Materials:
    return Materials(**diff, **rest)


def render_color(ctx, cfg, materials: Materials, scene, cam, settings, history, pixel_idx=None):
    """(composed HDR colour (N, 3), new history) of ``scene`` with
    ``materials``."""
    scene = dataclasses.replace(scene, materials=materials)
    out, new_h = frame_mod.render_frame(ctx, scene, cam, cfg, settings, history,
                                        pixel_idx=pixel_idx)
    return out["color"], new_h


def make_loss_fn(ctx, cfg, mesh=None):
    """The L2 image loss against a target, as a function of the
    differentiable material dict (see ``split_materials``). With ``mesh``
    (a ``parallel.mesh.PixelMesh``) the frame is the two-phase sharded
    frame (``parallel.mesh.sharded_render_fn``): each rank traces its block
    of pixels (``pixel_idx``, the rank's ``shard_pixels`` when None) and of
    SHARC probes, and every rank runs the image phase and the loss over the
    whole image against the whole ``target``."""
    render = None
    if mesh is not None:
        from nrdsample_tpu_torch.parallel.mesh import sharded_render_fn

        render = sharded_render_fn(ctx, cfg, mesh)

    def loss_fn(mat_diff: dict, mat_rest: dict, scene, cam, settings, history, target,
                pixel_idx=None):
        materials = merge_materials(mat_diff, mat_rest)
        if render is None:
            color, _ = render_color(ctx, cfg, materials, scene, cam, settings, history, pixel_idx)
        else:
            out, _ = render(dataclasses.replace(scene, materials=materials), cam, settings,
                            history, pixel_idx)
            color = out["color"]
        err = color - target
        return torch.sum(err * err)

    return loss_fn


def project_materials(diff: dict) -> dict:
    """Clamp the optimised parameters into their physical ranges (keeps long
    SGD runs out of NaN-producing regions)."""
    return {k: geo.clip(v, *PARAM_BOUNDS[k]) if k in PARAM_BOUNDS else v
            for k, v in diff.items()}


def value_and_grad(loss_fn, mat_diff: dict, *args, mesh=None):
    """(loss, {field: gradient}) of ``loss_fn(mat_diff, *args)`` with respect
    to every field of ``mat_diff``; a field the loss does not reach gets
    zeros, as ``jax.value_and_grad`` gives. With ``mesh`` of more than one
    rank (a sharded ``make_loss_fn``), each rank's share of the gradients
    is summed over the ranks (one all_reduce), so every rank holds the
    single-rank gradients."""
    params = {k: v.detach().requires_grad_(True) for k, v in mat_diff.items()}
    with torch.enable_grad():
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    g = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
    if mesh is not None and mesh.size > 1:
        from nrdsample_tpu_torch.parallel import distributed

        flat = distributed.collective("all_reduce", torch.cat([v.reshape(-1) for v in g.values()]),
                                      mesh.group)
        g = {k: part.reshape(v.shape) for (k, v), part in
             zip(g.items(), torch.split(flat, [v.numel() for v in g.values()]))}
    return loss.detach(), g


def make_train_step(ctx, cfg, lr: float = 0.05, mesh=None):
    """One SGD step on the material parameters: the sum-of-squares loss,
    then p - lr * g and the projection, without a gradient. The loss is a
    SUM over pixels, so a stable lr scales like 1/n_pixels (the
    inverse-rendering tests use 2e-4 at 32x32). With ``mesh`` the step
    runs over its ranks (``make_loss_fn``, ``value_and_grad``), alike on
    every rank.

    step(materials, scene, cam, settings, history, target, pixel_idx=None)
    -> (loss, new materials)."""
    loss_fn = make_loss_fn(ctx, cfg, mesh)

    def step(materials: Materials, scene, cam, settings, history, target, pixel_idx=None):
        mat_diff, mat_rest = split_materials(materials)
        loss, g = value_and_grad(loss_fn, mat_diff, mat_rest, scene, cam, settings, history,
                                 target, pixel_idx, mesh=mesh)
        with torch.no_grad():
            new_diff = {k: p.detach() - lr * g[k] for k, p in mat_diff.items()}
            return loss, merge_materials(project_materials(new_diff), mat_rest)

    return step


def make_sharded_train_step(ctx, cfg, mesh, lr: float = 0.05):
    """``make_train_step`` over the ranks of ``mesh`` (the JAX package's
    name)."""
    return make_train_step(ctx, cfg, lr, mesh)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _busy_ms(fn, device: torch.device):
    """Device ms of one fn() call under torch.profiler: the summed durations
    of its CUDA kernels (one stream, no overlap; render_frame's two ranges
    appear on the device timeline too and do not count). None off the
    card."""
    if device.type != "cuda":
        return None
    _sync(device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in ("trace_frame", "image_frame")) / 1e3


def bench_backward(size: int = 512, n_iter: int = 4, device=None) -> dict:
    """The backward benchmark (counterpart of ``bench.py:bench_backward``):
    shaderballs (``shader_balls(grid=3, sphere_res=24)``) at size x size,
    REFERENCE, 2 bounces, FULL_PROBABILISTIC, sun 45 degrees, a zero
    target. Times the forward of the L2 loss alone and the loss with its
    gradient for all five material fields (host clock around a device
    synchronisation; one warm-up call, then the mean of ``n_iter``), reports
    backward / forward, and checks the gradient of base_color[1, 0] against
    central finite differences (eps 2e-3) at this scale. Adds each call's
    device-busy ms and the peak of ``torch.cuda.max_memory_allocated`` on
    the card (None on the CPU)."""
    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
    from nrdsample_tpu_torch.device import resolve
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.scene import procedural
    from nrdsample_tpu_torch.scene.types import look_at

    device = resolve(device)
    ctx, scene = traversal.build_context(procedural.shader_balls(grid=3, sphere_res=24),
                                         device=device)
    cfg = RenderConfig(width=size, height=size, rpp=1, bounce_num=2,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE)
    cam = look_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0, device=device)
    settings = make_settings(device, sun_elevation=45.0)
    history = frame_mod.History.create(cfg, device)
    target = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=device)
    loss_fn = make_loss_fn(ctx, cfg)
    mat_diff, mat_rest = split_materials(scene.materials)
    args = (mat_rest, scene, cam, settings, history, target)

    def fwd(diff=mat_diff):
        with torch.no_grad():
            return loss_fn(diff, *args)

    def vag():
        return value_and_grad(loss_fn, mat_diff, *args)

    def time_it(fn):
        fn()                      # warm-up (the kernels' build and load at first)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        _sync(device)
        return (time.perf_counter() - t0) / n_iter

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_fwd = time_it(fwd)
    t_vag = time_it(vag)
    busy_fwd, busy_vag = _busy_ms(fwd, device), _busy_ms(vag, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

    # the finite-difference check on the ball's albedo (red channel)
    _, g = vag()
    idx = (1, 0)
    g_auto = float(g["base_color"][idx])
    eps = 2e-3
    v0 = float(mat_diff["base_color"][idx])

    def loss_at(v):
        bc = mat_diff["base_color"].clone()
        bc[idx] = v
        return float(fwd({**mat_diff, "base_color": bc}))

    g_fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
    rel_err = abs(g_auto - g_fd) / max(abs(g_fd), 1e-6)
    return {
        "grad_forward_ms": t_fwd * 1e3,
        "grad_backward_ms": (t_vag - t_fwd) * 1e3,
        "backward_forward_ratio": t_vag / t_fwd,
        "grad_fd_rel_err": rel_err,
        "grad_allclose_fd": bool(rel_err < 0.08),
        "grad_forward_busy_ms": busy_fwd,
        "grad_value_and_grad_busy_ms": busy_vag,
        "peak_memory_bytes": peak,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the backward benchmark (bench_backward)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions) instead of the CUDA card")
    args = p.parse_args(argv)
    print(json.dumps(bench_backward(args.size, args.iters, "cpu" if args.cpu else None)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
