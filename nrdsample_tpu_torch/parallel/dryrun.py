"""The port's multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``), and the rank functions of the sharded frame and
training step that it, the tests and ``chip_smoke.py`` spawn.

    python -m nrdsample_tpu_torch.parallel.dryrun N [--cpu] [--size 128]

spawns N ranks on the card (gloo, all on one card, where the card count is
below N; NCCL with one card each otherwise) or, with ``--cpu``, N gloo ranks
on the CPU. On the flagship configuration (the glass Cornell box with inner
glass surfaces; RELAX + SIGMA, SHARC with history confidence, the L1 cache,
TAA, TraceTransparent; one bounce) at size x size it holds the sharded
frame's colour to the single-rank frame's (max |diff| < 5e-4, the JAX dry
run's bound), takes one sharded training step towards a zero target with
the loss and the new materials finite, and prints one line.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from nrdsample_tpu_torch.parallel import distributed
from nrdsample_tpu_torch.parallel import mesh as mesh_mod

#: the JAX dry run's bound on the sharded colour against the single-rank one
PARITY_TOL = 5e-4

#: (module, counter) of each kernel wrapper's launch count
COUNTERS = {
    "dense_hit": ("nrdsample_tpu_torch.ops.dense_cuda", "LAUNCHES"),
    "emissive_probe": ("nrdsample_tpu_torch.ops.emissive_probe", "LAUNCHES"),
    "packet_hit": ("nrdsample_tpu_torch.ops.packet", "LAUNCHES"),
    "packet_hit_stream": ("nrdsample_tpu_torch.ops.packet", "STREAM_LAUNCHES"),
    "bilinear_sample": ("nrdsample_tpu_torch.ops.reproject", "LAUNCHES"),
    "relax_taccum": ("nrdsample_tpu_torch.denoise.taccum_cuda", "LAUNCHES"),
    "relax_atrous": ("nrdsample_tpu_torch.denoise.atrous_cuda", "LAUNCHES"),
    "taa_resolve": ("nrdsample_tpu_torch.denoise.taa_cuda", "LAUNCHES"),
}


def launch_counts() -> dict:
    import importlib

    return {k: getattr(importlib.import_module(m), a) for k, (m, a) in COUNTERS.items()}


def flagship(width: int, height: int, device, bounce_num: int = 1, **cfg_kw):
    """(SceneContexts, scene, cam, cfg, settings) of the flagship
    configuration: the glass Cornell box with its inner glass surfaces,
    RELAX + SIGMA, SHARC with history confidence, the L1 cache and TAA,
    FULL_PROBABILISTIC unless ``cfg_kw`` says otherwise, sun at 40
    degrees."""
    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.scene import glass_shell, procedural
    from nrdsample_tpu_torch.scene.types import look_at

    scene = glass_shell.add_inner_glass_surfaces(procedural.cornell_box_glass())
    ctxs, scene = traversal.build_scene_contexts(scene, device=device)
    cfg_kw.setdefault("tracing_mode", TracingMode.FULL_PROBABILISTIC)
    cfg = RenderConfig(width=width, height=height, rpp=1, bounce_num=bounce_num,
                       denoiser=Denoiser.RELAX, use_taa=True, use_sharc=True,
                       use_confidence=True, use_l1_cache=True, **cfg_kw)
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, aspect=width / height,
                  device=device)
    return ctxs, scene, cam, cfg, make_settings(device, sun_elevation=40.0)


def setup(spec: dict, device):
    """(ctx, scene, cam, cfg, settings) of ``spec``: {"name": "flagship"
    (``flagship``'s arguments in "width", "height", "bounce_num", "cfg") or
    a ``pipeline.bench_configs`` name (its overrides in "cfg")}."""
    cfg_kw = dict(spec.get("cfg", {}))
    if spec["name"] == "flagship":
        return flagship(spec["width"], spec["height"], device, spec.get("bounce_num", 1),
                        **cfg_kw)
    from nrdsample_tpu_torch.pipeline import bench_configs

    return bench_configs.setup(spec["name"], device, **cfg_kw)


def history_leaves(obj, prefix: str = "history") -> dict:
    """{path: tensor} of every tensor leaf of a History (or any nest of
    dataclasses)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(history_leaves(v, f"{prefix}.{f.name}"))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}.{f.name}"] = v
    return out


def frame_planes(out: dict, history) -> dict:
    """The planes a sharded frame is held to: color, final, shadow and
    every History leaf."""
    return {**{k: out[k] for k in ("color", "final", "shadow")}, **history_leaves(history)}


def max_abs_diff(got: dict, want: dict) -> dict:
    """{key: max |got - want|} in float64 (inf where a shape differs)."""
    out = {}
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        out[k] = float(np.max(np.abs(g - w))) if g.shape == w.shape and g.size else (
            0.0 if g.shape == w.shape else float("inf"))
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _load(path: str) -> dict:
    with np.load(path) as f:
        return dict(f)


def sharded_frames_rank(mesh, spec: dict, n_frames: int, want=None):
    """Rank function: ``n_frames`` sharded frames of ``spec`` from an empty
    History. Rank 0 returns {"planes": ``frame_planes`` of the last frame}
    or, with ``want`` (an .npz file of the single-rank planes), {"diffs":
    ``max_abs_diff``}; every rank returns its wall ms per
    frame, its block of pixels, the kernels' launches over the frames, its
    peak device memory (None off the card) and "broadcast": [the device
    of rank 0's scene as ``broadcast_scene`` delivers it, the rank's device,
    whether its triangles equal the rank's own build]."""
    from nrdsample_tpu_torch.pipeline import frame as frame_mod

    dev = mesh.device
    ctx, scene, cam, cfg, settings = setup(spec, dev)
    sent = distributed.broadcast_scene(scene)      # every rank built the same scene
    broadcast = [str(sent.tris.p0.device), str(dev),
                 bool(torch.equal(sent.tris.p0.to(dev), scene.tris.p0))]
    del sent
    fn = mesh_mod.sharded_render_fn(ctx, cfg, mesh)
    pixel_idx = mesh_mod.shard_pixels(mesh, cfg.n_pixels)
    hist = frame_mod.History.create(cfg, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before, ms = launch_counts(), []
    with torch.no_grad():
        for _ in range(n_frames):
            _sync(dev)
            t0 = time.perf_counter()
            out, hist = fn(scene, cam, settings, hist, pixel_idx)
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    after = launch_counts()
    res = {"ms": ms, "pixels": [int(pixel_idx[0]), int(pixel_idx[-1]) + 1],
           "launches": {k: after[k] - before[k] for k in after}, "broadcast": broadcast,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    if mesh.rank == 0:
        planes = {k: v.detach().cpu().numpy() for k, v in frame_planes(out, hist).items()}
        res.update({"diffs": max_abs_diff(planes, _load(want))} if want is not None
                   else {"planes": planes})
    return res


def sharded_grads_rank(mesh, spec: dict, want=None, lr: float = 0.05, step: bool = True):
    """Rank function: ``train.value_and_grad`` of the sharded loss
    (``make_loss_fn`` with the mesh) of ``spec``'s first frame towards a
    zero target, then (with ``step``) one
    ``make_sharded_train_step``. Rank 0 returns {"loss", "grads" (or, with
    ``want``, an .npz file of the single-rank gradients by field,
    "gaps": each field's max |diff| over its largest |single-rank entry|)}
    and the step's {"step_loss", "materials": the new differentiable
    fields}; every rank the wall ms of the gradients and of the step, and
    its peak device memory."""
    from nrdsample_tpu_torch.pipeline import frame as frame_mod, train

    dev = mesh.device
    ctx, scene, cam, cfg, settings = setup(spec, dev)
    hist = frame_mod.History.create(cfg, dev)
    target = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    args = (scene.materials, scene, cam, settings, hist, target)
    _sync(dev)
    t0 = time.perf_counter()
    diff, rest = train.split_materials(scene.materials)
    loss, g = train.value_and_grad(train.make_loss_fn(ctx, cfg, mesh), diff, rest, *args[1:],
                                   mesh=mesh)
    _sync(dev)
    res = {"grads_ms": (time.perf_counter() - t0) * 1e3}
    if step:
        t0 = time.perf_counter()
        step_loss, mats = train.make_sharded_train_step(ctx, cfg, mesh, lr)(*args)
        _sync(dev)
        res["step_ms"] = (time.perf_counter() - t0) * 1e3
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    if mesh.rank == 0:
        grads = {k: v.cpu().numpy() for k, v in g.items()}
        res["loss"] = float(loss)
        if step:
            res.update(step_loss=float(step_loss),
                       materials={k: getattr(mats, k).cpu().numpy()
                                  for k in train.DIFFERENTIABLE_MATERIAL_FIELDS})
        if want is None:
            res["grads"] = grads
        else:
            res["gaps"] = {k: float(np.max(np.abs(grads[k] - w))) / max(float(np.max(np.abs(w))),
                                                                          1e-30)
                           for k, w in _load(want).items()}
    return res


def _dryrun_rank(mesh, size: int):
    """One sharded frame (its colour) and one sharded training step towards
    a zero target."""
    from nrdsample_tpu_torch.pipeline import frame as frame_mod, train

    spec = {"name": "flagship", "width": size, "height": size}
    colour = sharded_frames_rank(mesh, spec, 1).get("planes", {}).get("color")
    ctx, scene, cam, cfg, settings = setup(spec, mesh.device)
    target = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=mesh.device)
    loss, mats = train.make_sharded_train_step(ctx, cfg, mesh)(
        scene.materials, scene, cam, settings, frame_mod.History.create(cfg, mesh.device), target)
    if mesh.rank:
        return None
    return {"color": colour, "loss": float(loss),
            "materials": {k: getattr(mats, k).cpu().numpy()
                          for k in train.DIFFERENTIABLE_MATERIAL_FIELDS}}


def dryrun_multichip(n: int, device=None, size: int = 128, timeout_s: float = 900.0) -> dict:
    """Spawn ``n`` ranks on ``device`` (the CUDA card when None) and run the
    dry run of the module docstring; raises AssertionError where the
    parity, the loss or the new materials fail, RankError where a rank
    does. Returns {"err", "loss", "materials": the step's new
    differentiable fields} and prints
    ``dryrun_multichip(n): SIZExSIZE parity_err=... loss=... OK``."""
    from nrdsample_tpu_torch.device import resolve
    from nrdsample_tpu_torch.pipeline import frame as frame_mod

    dev = resolve(device)
    ctx, scene, cam, cfg, settings = flagship(size, size, dev)
    with torch.no_grad():
        out, _ = frame_mod.render_frame(ctx, scene, cam, cfg, settings,
                                        frame_mod.History.create(cfg, dev))
    single = out["color"].cpu().numpy()
    del ctx, scene, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res = distributed.run_ranks(_dryrun_rank, n, (size,), device=str(dev), timeout_s=timeout_s)[0]
    err = float(np.max(np.abs(res["color"] - single)))
    assert err < PARITY_TOL, f"sharded-vs-single parity broke: max |diff| = {err}"
    assert np.isfinite(res["loss"]), "the multi-rank dry run gave a non-finite loss"
    assert all(np.isfinite(v).all() for v in res["materials"].values()), \
        "non-finite materials after the sharded step"
    print(f"dryrun_multichip({n}): {size}x{size} parity_err={err:.2e} "
          f"loss={res['loss']:.6f} OK")
    return {"err": err, "loss": res["loss"], "materials": res["materials"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the multi-rank dry run: a sharded flagship frame "
                                            "against the single-rank one, and a sharded step")
    p.add_argument("n", type=int, help="ranks to spawn")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (the plain "
                                                      "versions) instead of the CUDA card")
    p.add_argument("--size", type=int, default=128, help="image width and height")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, "cpu" if args.cpu else None, args.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
