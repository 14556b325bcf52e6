"""Where the time of a frame goes on the card.

    python -m nrdsample_tpu_torch.profile_frame [config] [--frames N] [--warmup N] [--train]
        [--range MODULE:FUNCTION ...]

Renders one configuration of ``pipeline/bench_configs.py`` (shaderballs512
by default) through ``frame.render_frame`` on the CUDA card: ``--warmup``
frames, then ``--frames`` unprofiled frames timed with a host clock around
``torch.cuda.synchronize()`` (wall ms/frame), then the same number of frames
under ``torch.profiler``. From the profiled frames it prints the device time
per frame (the summed durations of the CUDA kernels, which run on one stream
and do not overlap), kernels per frame, the device time of the
``trace_frame`` and ``image_frame`` ranges that ``render_frame`` opens, and
the kernels with the most device time, then each of the port's hand-written
kernels (``csrc/*.cu``) wherever it ranks; the idle share is 1 - device time /
unprofiled wall time of the same run (the profiler's own host cost inflates
the profiled wall time several-fold).

``--train`` profiles ``pipeline/train.make_train_step`` on the configuration
instead (a zero target, a fresh History each step): its backward's kernels
run outside the two ranges and are counted as "outside the phases".
``--range`` wraps a function of the port (e.g.
``nrdsample_tpu_torch.ops.sharc:update``) in a range of its own for the run
and prints the device time of the kernels it launches (forward only).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import importlib
import re
import time

import torch

from nrdsample_tpu_torch.ops import _kernels
from nrdsample_tpu_torch.pipeline import bench_configs, frame, train as train_mod

PHASES = ("trace_frame", "image_frame")


@contextlib.contextmanager
def _ranges(specs):
    """Each "module:function" of ``specs`` wrapped in a record_function
    range named after it while the block runs."""
    saved = []
    for spec in specs:
        mod_name, fn_name = spec.split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)

        def wrapped(*a, _fn=fn, _spec=spec, **kw):
            with torch.profiler.record_function(_spec):
                return _fn(*a, **kw)

        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def profile(name: str, n_frames: int, warmup: int, train: bool = False,
            ranges: tuple = ()) -> list[str]:
    with _ranges(ranges):
        return _profile(name, n_frames, warmup, train, ranges)


def _profile(name, n_frames, warmup, train, ranges) -> list[str]:
    ctx, scene, cam, cfg, settings = bench_configs.setup(name)
    state = {"hist": frame.History.create(cfg)}
    if train:
        step = train_mod.make_train_step(ctx, cfg, lr=2e-4 * 1024 / cfg.n_pixels)
        target = torch.zeros((cfg.n_pixels, 3), device=state["hist"].frame_index.device)

        def advance():
            step(scene.materials, scene, cam, settings, state["hist"], target)
    else:
        def advance():
            state["hist"] = frame.render_frame(ctx, scene, cam, cfg, settings, state["hist"])[1]

    for _ in range(warmup):
        advance()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        advance()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_frames):
            advance()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames

    # kernels and, on the device timeline, the spans of the two phases
    # (record_function ranges also appear there as annotations)
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in PHASES or e.name in ranges:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            kernels.append((e.time_range.start, e.time_range.elapsed_us() / 1e3 / n_frames, e.name))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    phases = collections.defaultdict(float)
    in_range = collections.defaultdict(float)
    for start, ms, kernel in kernels:
        by_name[kernel][0] += ms
        by_name[kernel][1] += 1
        phase = next((p for a, b, p in spans if p in PHASES and a <= start <= b),
                     "outside the phases")
        phases[phase] += ms
        for r in {p for a, b, p in spans if p in ranges and a <= start <= b}:
            in_range[r] += ms
    busy_ms = sum(v[0] for v in by_name.values())
    n_kernels = len(kernels) / n_frames
    card = torch.cuda.get_device_name(0)
    unit = "training step" if train else "frame"
    lines = [
        f"{name} on {card}: {cfg.width}x{cfg.height}, denoiser {cfg.denoiser.name}"
        + (", make_train_step" if train else ""),
        f"wall {wall_ms:.3f} ms/{unit} over {n_frames} unprofiled {unit}s after {warmup} "
        f"warm-up; profiled wall {prof_wall_ms:.3f} ms/{unit}; peak memory {peak} B",
        f"device busy {busy_ms:.3f} ms/{unit}, idle share {1.0 - busy_ms / wall_ms:.3f} of the "
        f"unprofiled wall time, {n_kernels:.0f} kernels/{unit}",
        f"device ms/{unit} by phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items())),
        *([f"device ms/{unit} in the ranges: "
           + ", ".join(f"{r} {in_range[r]:.3f}" for r in ranges)] if ranges else []),
        f"kernels by device time (ms/{unit}, launches/{unit}, share of busy):",
    ]

    def row(k, ms, n):
        short = k.replace("void ", "").replace("at::native::", "").replace(
            "(anonymous namespace)::", "")
        return f"  {ms:9.3f} {n / n_frames:7.1f} {ms / busy_ms:6.3f}  {short[:130]}"

    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    lines += [row(k, ms, n) for k, (ms, n) in ranked[:25]]
    own = set()
    for src in _kernels.sources():
        with open(src) as f:
            own.update(re.findall(r"__global__[^{;]*?\b(\w+_kernel)\s*\(", f.read()))
    lines.append("the port's own kernels (csrc/*.cu), wherever they rank:")
    lines += [row(k, ms, n) for k, (ms, n) in ranked
              if re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", k).split("(")[0] in own]
    return lines


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="shaderballs512",
                   choices=sorted(bench_configs.CONFIGS))
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--train", action="store_true",
                   help="profile a training step (forward and backward) instead of a frame")
    p.add_argument("--range", action="append", default=[], metavar="MODULE:FUNCTION",
                   help="report the device time of this function's kernels")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the profile is of the card")
    print("\n".join(profile(args.config, args.frames, args.warmup, args.train,
                            tuple(args.range))))


if __name__ == "__main__":
    main()
