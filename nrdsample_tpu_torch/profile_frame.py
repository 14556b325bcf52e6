"""Where the time of a frame goes on the card.

    python -m nrdsample_tpu_torch.profile_frame [config] [--frames N] [--warmup N]

Renders one configuration of ``pipeline/bench_configs.py`` (shaderballs512
by default) through ``frame.render_frame`` on the CUDA card: ``--warmup``
frames, then ``--frames`` unprofiled frames timed with a host clock around
``torch.cuda.synchronize()`` (wall ms/frame), then the same number of frames
under ``torch.profiler``. From the profiled frames it prints the device time
per frame (the summed durations of the CUDA kernels, which run on one stream
and do not overlap), kernels per frame, the device time of the
``trace_frame`` and ``image_frame`` ranges that ``render_frame`` opens, and
the kernels with the most device time; the idle share is 1 - device time /
unprofiled wall time of the same run (the profiler's own host cost inflates
the profiled wall time several-fold).
"""

from __future__ import annotations

import argparse
import collections
import time

import torch

from nrdsample_tpu_torch.pipeline import bench_configs, frame

PHASES = ("trace_frame", "image_frame")


def profile(name: str, n_frames: int, warmup: int) -> list[str]:
    ctx, scene, cam, cfg, settings = bench_configs.setup(name)
    hist = frame.History.create(cfg)
    for _ in range(warmup):
        _, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        _, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_frames):
            _, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames

    # kernels and, on the device timeline, the spans of the two phases
    # (record_function ranges also appear there as annotations)
    spans, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name in PHASES:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        else:
            kernels.append((e.time_range.start, e.time_range.elapsed_us() / 1e3 / n_frames, e.name))
    by_name = collections.defaultdict(lambda: [0.0, 0])
    phases = collections.defaultdict(float)
    for start, ms, kernel in kernels:
        by_name[kernel][0] += ms
        by_name[kernel][1] += 1
        phase = next((p for a, b, p in spans if a <= start <= b), "outside the phases")
        phases[phase] += ms
    busy_ms = sum(v[0] for v in by_name.values())
    n_kernels = len(kernels) / n_frames
    card = torch.cuda.get_device_name(0)
    lines = [
        f"{name} on {card}: {cfg.width}x{cfg.height}, denoiser {cfg.denoiser.name}",
        f"wall {wall_ms:.3f} ms/frame over {n_frames} unprofiled frames after {warmup} warm-up; "
        f"profiled wall {prof_wall_ms:.3f} ms/frame",
        f"device busy {busy_ms:.3f} ms/frame, idle share {1.0 - busy_ms / wall_ms:.3f} of the "
        f"unprofiled wall time, {n_kernels:.0f} kernels/frame",
        "device ms/frame by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(phases.items())),
        "kernels by device time (ms/frame, launches/frame, share of busy):",
    ]
    for k, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        short = k.replace("void ", "").replace("at::native::", "").replace(
            "(anonymous namespace)::", "")
        lines.append(f"  {ms:9.3f} {n / n_frames:7.1f} {ms / busy_ms:6.3f}  {short[:130]}")
    return lines


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="shaderballs512",
                   choices=sorted(bench_configs.CONFIGS))
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--warmup", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device: the profile is of the card")
    print("\n".join(profile(args.config, args.frames, args.warmup)))


if __name__ == "__main__":
    main()
