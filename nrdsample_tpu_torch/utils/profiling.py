"""Profiling and roofline reports (counterpart of
``nrdsample_tpu/utils/profiling.py``): named ranges in the profiler's
trace, a ``torch.profiler`` trace into a directory, a timer with CUDA events
on the card, and the share of the card's roofline a measured time reaches."""

from __future__ import annotations

import contextlib
import os
import time

import torch

#: Peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet): 3.35 TB/s
#: of HBM and 33.5e12 float32 instructions a second outside the tensor
#: cores (67 TFLOP/s counting an FMA as two; the port's kernels are built
#: with --fmad=false). The bound of PERF.md §6. Keyed by a part of the
#: card's name.
HBM_BYTES_PER_S = {"H100": 3.35e12}
F32_OPS_PER_S = {"H100": 33.5e12}

named_scope = torch.profiler.record_function


def device_kind() -> str:
    """The CUDA card's name (``torch.cuda.get_device_name``), "cpu" without
    one."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace (CPU, and the card's kernels where there is
    one) of the block, written to ``logdir/trace.json`` (Chrome's trace
    format). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timeit(fn, *args, iters: int = 5, warmup: int = 1):
    """(seconds per call, last output) of fn(*args): CUDA events around
    ``iters`` calls on the card after ``warmup`` calls; the host clock
    around them on the CPU."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if torch.cuda.is_available():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out


def roofline(name: str, seconds: float, bytes_moved: float, flops: float,
             kind: str | None = None) -> dict:
    """The speed-of-light report of a kernel that took ``seconds`` on the
    card ``kind`` (``device_kind()`` when None): its bound, the larger of
    bytes over the HBM rate and float32 operations over the peak rate, and
    the share of it reached. Raises ValueError for a device without peaks
    here (the CPU has none)."""
    kind = kind or device_kind()
    key = next((k for k in HBM_BYTES_PER_S if k in kind), None)
    if key is None:
        raise ValueError(f"no roofline peaks for {kind!r}; known: {sorted(HBM_BYTES_PER_S)}")
    t_hbm = bytes_moved / HBM_BYTES_PER_S[key]
    t_flop = flops / F32_OPS_PER_S[key]
    sol = max(t_hbm, t_flop)
    rec = {
        "kernel": name,
        "ms": seconds * 1e3,
        "sol_ms": sol * 1e3,
        "efficiency": sol / max(seconds, 1e-12),
        "bound": "hbm" if t_hbm > t_flop else "flop",
        "gbps": bytes_moved / seconds / 1e9,
        "gflops": flops / seconds / 1e9,
    }
    from nrdsample_tpu_torch.utils.log import LOG

    LOG.log("roofline", **rec)
    return rec
