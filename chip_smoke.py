"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--old-csrc DIR]

Builds the port's CUDA kernels from ``nrdsample_tpu_torch/csrc`` and renders
the five configurations of the bench ladder through
``pipeline.frame.render_frame``: first shaderballs512 (cluster traversal
through the packet kernel, REBLUR + SIGMA through the bilinear gather
kernel), then, after holding each of the eight kernels against its plain
PyTorch version on the card at the main paths' shapes, cornell256,
kitchen1080 (dense traversal, RELAX + SIGMA, SH, TAA, SHARC and history
confidence, through the dense hit, emissive probe, bilinear gather, RELAX
taccum, RELAX à-trous and TAA resolve kernels), exterior720 (1.06M
triangles through the supercluster stage 1 and the streaming packet kernel,
glass and the emitters through the resident packet kernel, RELAX + SIGMA,
TAA, SHARC with its FULL pass) and interior1440 (2560x1440, 15,494 triangles
through the resident packet kernel, 24 emitters through the probe, RELAX +
SIGMA, SHARC with confidence, TAA; wall and device-busy ms per frame, peak
memory; then each kernel call of one more frame against its plain version
on that frame's own inputs). It checks that each main path went through its
kernels, compares card frames with CPU frames and the cornellbox-000 golden,
replays the 344
records of ``Tests/*.json`` on the card (the CHECK_ME records twice, one
record of each branch the corpus adds against its CPU frame), holds the
card's NaN positions to the CPU's under the inf stress test without
sanitization (REBLUR, and RELAX + TAA), runs the output chain (kitchen1080
with the post chain to 3840x2160 and with the learned RR denoiser, timed;
every gather call of an RR frame against its plain version; the networks and
a 192x192 -> 384x384 image phase against the CPU; the held-out RR gate; every
debug view; the port's CLI as a subprocess), then the differentiable path
(phase 8: ``train.bench_backward`` at 512x512 with its finite-difference
check, one ``make_train_step`` on kitchen1080 at 1920x1080, the CLI's
``optimize`` as a subprocess, one step's gradients card against CPU, the
five-field step through the probe kernel), then the asset path (phase 9:
(T) the textured kitchen1080 at 1920x1080, with normal maps and an
alpha-tested material, timed, each kernel call of a frame against its plain
version, card against CPU at 80x48, a full-size step with the texels
requiring grad and their gradients card against CPU; (S) the same textures
on shaderballs512, through the resident packet kernel; (G) the 1.06M-
triangle exterior720 written with ``save_glb``, loaded back with
``load_gltf`` and rendered through the streaming kernel beside the
procedural frame, and a small textured .gltf with a PNG of
``utils/image``; (R) the 19 record goldens replayed on the card), then the
animate path (phase 10: 512 cubes on their orbits at 1920x1080 with RELAX,
moved and refit on the card every frame, timed, each kernel call of a
frame against its plain version, the resident packet kernel on the refit
slab among them; a DRS run over a fixed bucket schedule; ``cli animate``;
card against CPU at 96x96; and where shaderballs512's REBLUR trace at 64x64
parts between the card and the CPU, call by call, with its material
gradients card against CPU within GRAD_TOL), and
prints one JSON line of kernels plus a final ``{"ok": true, "device": ...}``
line. Any failed phase exits non-zero
with no result line. It also runs the backward of the three denoiser
dispatchers on (1080, 1920) planes that require grad (the kernel's forward,
the plain version's gradient) and the TAA kernel on the kitchen1080 frame's
own wide mask. Needs a CUDA device; imports nothing of JAX. The option
builds the parent tree's resident packet, streaming packet, bilinear
gather, RELAX taccum, RELAX à-trous and TAA resolve kernels from their
sources and times them beside this tree's on the same inputs; the default
run does not take it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
RAYS_2X1080P = 2 * 1920 * 1080
PROBE_RAYS = 16 * 1920 * 1080
DIVERGENT_RAYS = 3 * 512 * 512   # shaderballs512's batched shadow launch
PLAIN_SUBSET = 1 << 17           # rays of a divergent set held against the plain scan
SB_FRAMES = 8                    # timed shaderballs512 frames, after 2 warm-up
GATHER_REPS = 200                # graph replays per timing of the bilinear gather
GATHER_ROUNDS = 5                # alternating timings of the gather and grid_sample
KERNEL_TOL = 1e-6          # abs and rel, kernel vs plain on the same inputs
FRAME_OUTLIER_FRAC = 0.005  # the frame tolerance of tests/test_torch_frame.py
FRAME_MEAN_REL = 1e-3
# Roofline of one H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of HBM and
# 67 TFLOP/s of float32 outside the tensor cores, which counts an FMA as two
# operations. The kernels are built with --fmad=false, so every multiply and
# every add is an instruction of its own: 33.5e12 such operations a second.
HBM_BYTES_PER_S = 3.35e12
F32_UNFUSED_OPS_PER_S = 33.5e12
# float32 instructions (FP32 ALU and MUFU; index arithmetic, loads and
# control do not count) that the compiled kernels issue, read from
# `python -m nrdsample_tpu_torch.sass_ops` (cuobjdump -sass of the built
# library: sm_90a, --fmad=false, no fast math). Every expf, powf, sqrtf and
# IEEE divide counts as the sequence it compiles to; the divide's and sqrt's
# slow-path subroutines, which run only for operands outside the fast
# path's range, do not count, while the special-case branches inlined in
# powf do (a static count, so a few percent above the executed path).
# One Möller-Trumbore test with its best-hit fold, per kernel: 61 in
# dense_hit_kernel's triangle loop (one MUFU.RCP a test), 58 in
# emissive_probe_kernel's, 932 per 16 tests in the packet kernels' cluster
# loop (test_cluster of packet_walk.cuh). Was 52 with the divide as one.
MT_OPS = {"dense_hit": 61, "emissive_probe": 58, "packet": 932 / 16}
# Per pixel of the denoiser kernels:
# - relax_taccum: 211 for one accumulation (the body of the ring loop; the
#   ring's recomputed positions do not count), 5 for the input luminance the
#   anti-firefly reads (staged once per pixel) and 34 for the 3x3 variance:
#   250, the smaller of this kernel's count and its parent's 256 + 34 (whose
#   accumulation recomputed 9 input luminances, 45 instructions)
TACCUM_OPS = 211 + 5 + 34
# - relax_atrous: 372 per row of 3 taps (the loop over the rows; a tap's 2
#   expf, powf and 2 divides among them), times 3, and 28 outside it (was 350
#   with exp, pow and a divide as one)
ATROUS_OPS = 3 * 372 + 28
# - taa_resolve: 9 per tap of the 3x3 moments (3 adds, 3 multiplies, 3 adds;
#   the 5x5 on wide pixels adds 16 taps, counted per pixel of the run's mask)
#   and 78 for the clamp (3 sqrtf), the tests and the mix (this kernel's
#   phases 1 and 3, read from sass_ops --out's disassembly); the CIELAB
#   distance (6 powf, a sqrtf) only on the pixels that need it
#   (taa_lab_pixels): 413, the parent's 491 + 81 per pixel less the 159 above
#   (this kernel's list loop: 420)
TAA_OPS = 9 * 9 + 78
TAA_WIDE_EXTRA_OPS = 16 * 9
TAA_LAB_OPS = 491 + 81 - TAA_OPS
KITCHEN_FRAMES = 4
EXTERIOR_FRAMES = 3
EXTERIOR_DIVERGENT_RAYS = 786_432   # a sorted bounce-sized set on the exterior
#: the small exterior of the card-vs-CPU check: 3,196 opaque triangles (25
#: clusters), 1,488 glass (12 clusters) and 674 emitters
SMALL_EXTERIOR = dict(cobbles=8, tree_count=6, tree_res=8, lamp_count=4)
#: the NaN case's image: the sky ring's NaN spreads over most of it, not all
NAN_RES = 192
INTERIOR_WARMUP = 2
INTERIOR_FRAMES = 3
#: one record of each branch the record corpus adds, compared card against CPU
BRANCH_RECORDS = (("kitchen", 2, "PSR 1"), ("kitchen", 3, "PSR 2, RELAX"),
                  ("kitchen", 7, "L1 cache"), ("cornellbox", 7, "OCCLUSION"),
                  ("cornellbox", 11, "HALF"), ("cornellbox", 48, "firefly + sanitization"),
                  ("cornellbox", 49, "inf stress + sanitization"), ("shaderballs", 10, "HALF"),
                  ("shaderballs", 42, "DRS stress + sanitization"),
                  ("shaderballs", 43, "material id stress"), ("interior-night", 9, "hair/SSS"))
RECORD_PLANES = ("color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal")


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one fn() call: fn is captured once in a CUDA graph and
    the graph is replayed ``reps`` times between two events, so the host's
    launch overhead (tensor checks, a ctypes call) stays out of the time of
    a kernel that runs for microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def once_ms(fn):
    """(ms, result) of one CUDA-event timing of fn(), for plain versions that
    take seconds."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def device_busy_ms(fn) -> tuple[float, int]:
    """(device ms, kernels) of one call of fn() under torch.profiler: the
    summed durations of its CUDA kernels (one stream, no overlap)."""
    return device_profile(fn)[:2]


def device_profile(fn) -> tuple[float, int, dict]:
    """``device_busy_ms`` and {kernel name: (ms, launches)} of one call of
    fn()."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in ("trace_frame", "image_frame")]
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels), by_name


def nan_mismatch(ref: torch.Tensor, got: torch.Tensor) -> tuple[int, int, int, float, float]:
    """(pixels with a non-finite value on the CPU, on the card, pixels where
    the two disagree on it, and frame_mismatch over the pixels finite in
    both)."""
    ref, got = ref.cpu().reshape(ref.shape[0], -1), got.cpu().reshape(got.shape[0], -1)
    bad_r, bad_g = ~torch.isfinite(ref).all(-1), ~torch.isfinite(got).all(-1)
    both = ~bad_r & ~bad_g
    frac, rel = frame_mismatch(ref[both], got[both]) if bool(both.any()) else (0.0, 0.0)
    return int(bad_r.sum()), int(bad_g.sum()), int((bad_r != bad_g).sum()), frac, rel


def taa_lab_pixels(cur, prev, mv_d, wide, reset_mix, sigma_scale: float) -> int:
    """Pixels whose TAA resolve needs the CIELAB distance: the history and
    the clamped history differ in [0, 1] (else the distance is exactly 0),
    on screen and under a reset_mix below 1 (else the mix does not depend on
    it). From the plain version's moments, which equal the kernel's."""
    from nrdsample_tpu_torch.denoise import common, taa

    mu, sigma = taa._moments(cur, 1)
    if wide is not None:
        mu5, sigma5 = taa._moments(cur, 2)
        wm = (wide > 0.5)[..., None]
        mu, sigma = torch.where(wm, mu5, mu), torch.where(wm, sigma5, sigma)
    cl = torch.minimum(torch.maximum(prev, mu - sigma * sigma_scale), mu + sigma * sigma_scale)
    differs = (prev.clamp(0.0, 1.0) != cl.clamp(0.0, 1.0)).any(-1)
    on = common.in_screen(mv_d, *cur.shape[:2])
    return int((differs & on & ~(reset_mix >= 1.0)).sum())


def parent_ms(old_ms, ms) -> str:
    return "not built" if old_ms is None else f"{old_ms:.4f} ms ({old_ms / ms:.2f}x)"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time of the card for the work: the larger of bytes over the HBM
    rate and operations over the unfused float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_UNFUSED_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seeded_rays(n: int, seed: int, dev):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, bool]:
    diff = (a - b).abs()
    ok = bool((diff <= KERNEL_TOL + KERNEL_TOL * b.abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def t64(o, d, tris, j) -> float:
    """Float64 Möller-Trumbore distance of ray (o, d) to triangle j."""
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def compare_hits(got: dict, ref: dict, o, d, tris) -> tuple[int, float, bool]:
    """(tri mismatches, max |err| of t/u/v, ok): hit/miss equal on every
    ray, tri equal except where a float64 recompute proves an exact tie
    (the packet walk and the per-ray scan break ties in different orders),
    t within KERNEL_TOL on every ray and u/v where tri is equal."""
    if not torch.equal(got["tri"] >= 0, ref["tri"] >= 0):
        return -1, float("inf"), False
    differ = torch.nonzero(got["tri"] != ref["tri"]).flatten().cpu().numpy()
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    ga, rb = got["tri"].cpu().numpy(), ref["tri"].cpu().numpy()
    ties = True
    for i in differ:
        ta, tb = t64(on[i], dn[i], tris, ga[i]), t64(on[i], dn[i], tris, rb[i])
        ties = ties and abs(ta - tb) <= 1e-6 * max(abs(tb), 1.0)
    same = got["tri"] == ref["tri"]
    errs = [max_err(got["t"], ref["t"])] + [max_err(got[k][same], ref[k][same]) for k in "uv"]
    return len(differ), max(e for e, _ in errs), ties and all(ok for _, ok in errs)


def packet_tests_needed(cs, o, d, t_max, res: dict, any_hit: bool, chunk: int = 1 << 16) -> int:
    """Ray/triangle tests the result needs, counted per ray: 128 for each
    cluster whose box the ray enters no later than its final t (for a miss,
    every box it enters inside its t_max). In any-hit mode a blocked ray
    needs only the cluster of its blocker. The bound of the kernels line."""
    from nrdsample_tpu_torch.ops import cluster

    n = 0
    for a in range(0, o.shape[0], chunk):
        s = slice(a, a + chunk)
        e = cluster._cluster_entry(o[s], d[s], cs.bounds_min, cs.bounds_max, t_max[s])
        need = (e < cluster.T_MAX) & (e <= res["t"][s, None])
        if any_hit:
            blocked = (res["tri"][s] >= 0) & (res["t"][s] < t_max[s])
            n += int(blocked.sum()) + int(need[~blocked].sum())
        else:
            n += int(need.sum())
    return n * 128


def packet_walk_tests(keys, t_final, block: int) -> int:
    """Ray/triangle tests of the packet walk itself: per packet, every
    worklist cluster whose (rounded-down) entry key is below the packet's
    largest final t, times ``block`` rays x 128 triangles. Over
    ``packet_tests_needed`` it measures the walk's waste. keys: stage 1's
    (R / block, C) worklist keys; t_final: (R,) in the same ray order."""
    t_pkt = t_final.reshape(-1, block).amax(dim=1)
    return int((keys < t_pkt[:, None]).sum()) * block * 128


def frame_mismatch(ref: torch.Tensor, got: torch.Tensor) -> tuple[float, float]:
    """(share of pixels off by more than 1e-3 (1 + |ref|), relative mean gap)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    ref, got = ref.reshape(ref.shape[0], -1), got.reshape(got.shape[0], -1)
    bad = ((ref - got).abs() > 1e-3 * (1.0 + ref.abs())).any(-1)
    return float(bad.double().mean()), abs(float(got.mean() - ref.mean())) / max(abs(float(ref.mean())), 1e-12)


def warp_walk_tests(cs, o, d, t_max, res: dict, any_hit: bool, chunk: int = 1 << 14) -> int:
    """A lower bound of the ray/triangle tests the streaming kernel's warp
    walk makes: per 32-ray warp (rays in packet order), every cluster whose
    box some lane enters below its final t, x 32 x 128. Such a cluster is
    tested whatever the walk's order, since a lane's best t only falls to its
    final t; in any-hit mode a blocked lane counts only its blocker's
    cluster. The same chunked loop as ``packet_tests_needed``."""
    from nrdsample_tpu_torch.ops import cluster

    n = 0
    for a in range(0, o.shape[0], chunk):
        s = slice(a, a + chunk)
        e = cluster._cluster_entry(o[s], d[s], cs.bounds_min, cs.bounds_max, t_max[s])
        need = (e < cluster.T_MAX) & (e < res["t"][s, None])
        if any_hit:
            blocked = (res["tri"][s] >= 0) & (res["t"][s] < t_max[s])
            own = (torch.arange(cs.count, device=o.device)[None, :]
                   == torch.div(res["tri"][s], 128, rounding_mode="floor")[:, None])
            need = torch.where(blocked[:, None], own, need)
        n += int(need.reshape(-1, 32, cs.count).any(dim=1).sum())
    return n * 32 * 128


#: the parent tree's kernels that ``--old-csrc`` builds, with the port's C
#: signatures
OLD_SOURCES = ("packet_hit.cu", "packet_hit_stream.cu", "bilinear_sample.cu", "relax_taccum.cu",
               "relax_atrous.cu", "taa_resolve.cu")


def build_old_lib(csrc: str):
    """Build the parent tree's packet, gather, RELAX taccum, RELAX à-trous
    and TAA resolve kernels (``csrc`` is its kernel source directory) with the port's nvcc
    flags into a library of their own under the ignored build directory,
    for timing beside the port's kernels; never called on the main path.
    Each takes the port's C signature."""
    import ctypes
    import hashlib

    from nrdsample_tpu_torch.ops import _kernels

    sources = [os.path.join(csrc, f) for f in OLD_SOURCES]
    h = hashlib.sha256()
    for src in sources + [os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh")]:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(_kernels.BUILD_DIR, f"compare_old_{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
        proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", out, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            fail(f"nvcc failed on {sources}:\n{proc.stderr}")
    lib = ctypes.CDLL(out)
    for name in ("nrd_packet_hit", "nrd_packet_hit_stream", "nrd_bilinear_sample",
                 "nrd_relax_taccum", "nrd_relax_atrous", "nrd_taa_resolve"):
        getattr(lib, name).argtypes = _kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def parent_kernels(lib):
    """Inside the block, the port's wrappers launch the parent tree's build
    (``build_old_lib``) of the same C function."""
    from nrdsample_tpu_torch.ops import _kernels

    own, _kernels._lib = _kernels.load(), lib
    try:
        yield
    finally:
        _kernels._lib = own


def time_parent(old_lib, kernel, got) -> tuple[float | None, bool]:
    """(graph-replay ms of the parent's build of ``kernel``, whether its
    results equal ``got`` (this tree's) within KERNEL_TOL); (None, True)
    without a parent build."""
    if old_lib is None:
        return None, True
    with parent_kernels(old_lib):
        old = kernel()
        torch.cuda.synchronize()
        old_ms = graph_ms(kernel)
    old = old if isinstance(old, tuple) else (old,)
    got = got if isinstance(got, tuple) else (got,)
    return old_ms, all(max_err(a, b)[1] for a, b in zip(old, got))


def launch_old(lib, symbol: str, cs, o, d, tm, order, keys, any_hit: bool, need_uv: bool) -> dict:
    """Launch the parent tree's packet kernel ``symbol`` on the port's packet
    kernel arguments."""
    from nrdsample_tpu_torch.ops import _kernels

    r = o.shape[0]
    out = {k: torch.empty(r, dtype=torch.int32 if k == "tri" else torch.float32, device=o.device)
           for k in ("t", "u", "v", "tri")}
    rc = getattr(lib, symbol)(o.data_ptr(), d.data_ptr(), tm.data_ptr(), order.data_ptr(),
                              keys.data_ptr(), cs.slab.data_ptr(), cs.bounds_min.data_ptr(),
                              cs.bounds_max.data_ptr(), cs.count, r // 128, int(any_hit),
                              int(need_uv), out["t"].data_ptr(), out["u"].data_ptr(),
                              out["v"].data_ptr(), out["tri"].data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, symbol)
    return out


#: the parent tree's streaming kernel on exterior720's sets (PERF.md §6;
#: NVIDIA H100 80GB HBM3, 700.00 W), quoted when no parent source is given
#: to compare with
PARENT_STREAM_MS = {"primary": 2.820, "divergent": 21.262, "any_hit": 14.716}


def check_stream_kernel(cs, tris, cam, cfg, dev, card, old_lib=None) -> dict:
    """The streaming packet kernel on the exterior's opaque ClusterSet: its
    coherent camera rays, a divergent bounce-sized set with per-ray t_max
    (re-binned by morton order, as the frame does) and the any-hit mode on
    that set, each held against the plain scan on 2^17 rays drawn from the
    set, then timed alone on stage 1's worklists beside the resident kernel
    on the same inputs. The two kernels share their walk, so their results
    must be identical on every ray. ``old_lib`` (the parent tree's kernels
    built from their source) is timed beside it when given, and its
    streaming kernel's results must be identical too; else the parent's
    times are quoted. Returns {case: (max |err|, stream ms, plain ms, bound,
    subset size, resident ms, stage-1 ms, parent ms, whether the parent ms
    was measured in this call)}."""
    from nrdsample_tpu_torch.ops import cluster, packet, traversal
    from nrdsample_tpu_torch.scene import camera

    pix = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    co, cd, _ = camera.camera_rays(cam, cfg.width, cfg.height, pix, torch.tensor(0, device=dev))
    co, cd = co.contiguous(), cd.contiguous()
    ctm = torch.full((cfg.n_pixels,), traversal.T_MAX, device=dev)
    rs = np.random.RandomState(6)
    n = EXTERIOR_DIVERGENT_RAYS
    vo = torch.from_numpy(rs.uniform([-50.0, -50.0, 0.05], [50.0, 50.0, 15.0],
                                     (n, 3)).astype(np.float32)).to(dev)
    vd = rs.randn(n, 3).astype(np.float32)
    vd = torch.from_numpy(vd / np.linalg.norm(vd, axis=-1, keepdims=True)).to(dev)
    vtm = torch.from_numpy(np.where(rs.uniform(size=n) < 0.5, traversal.T_MAX,
                                    rs.uniform(0.5, 40.0, n)).astype(np.float32)).to(dev)
    out = {}
    for case, (ro, rd, rtm, sort, any_hit) in {
        "primary": (co, cd, ctm, False, False),
        "divergent": (vo, vd, vtm, True, False),
        "any_hit": (vo, vd, vtm, True, True),
    }.items():
        n = ro.shape[0]
        before = packet.STREAM_LAUNCHES
        got = packet.closest_hit_packet_cuda(cs, ro, rd, rtm, sort=sort, any_hit=any_hit,
                                             need_uv=not any_hit)
        torch.cuda.synchronize()
        if packet.STREAM_LAUNCHES != before + 1:
            fail(f"the {case} rays did not take the streaming kernel")
        sub = torch.from_numpy(np.sort(np.random.RandomState(7).choice(n, PLAIN_SUBSET,
                                                                        replace=False))).to(dev)
        so, sd, stm = ro[sub], rd[sub], rtm[sub]
        if any_hit:
            plain_ms, ref = once_ms(lambda: cluster.any_hit_clustered(cs, so, sd, stm))
            blocked = (got["tri"][sub] >= 0) & (got["t"][sub] < stm)
            tri_bad, err, ok = int((blocked != ref).sum()), 0.0, bool(torch.equal(blocked, ref))
            hits = int(ref.sum())
        else:
            plain_ms, ref = once_ms(lambda: cluster.closest_hit_clustered(cs, so, sd, stm))
            tri_bad, err, ok = compare_hits({k: v[sub] for k, v in got.items()}, ref, so, sd, tris)
            hits = int((ref["tri"] >= 0).sum())
        # the kernels alone on stage 1's worklists of the rays in packet order
        perm = (torch.sort(packet._morton_sort_keys(ro, rd, cs), stable=True).indices if sort
                else torch.arange(n, device=dev))
        ko, kd, ktm = ro[perm].contiguous(), rd[perm].contiguous(), rtm[perm].contiguous()
        order, keys = packet.worklists(ko, kd, cs, ktm)
        args = (cs, ko, kd, ktm, order, keys, any_hit, not any_hit)
        a = packet.launch_stream(*args)
        b = packet.launch(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"the streaming and resident kernels differ on the same worklists ({case})")
        ms = graph_ms(lambda: packet.launch_stream(*args))
        res_ms = graph_ms(lambda: packet.launch(*args))
        stage1_ms = median_ms(lambda: packet.worklists(ko, kd, cs, ktm), reps=3)
        tests = packet_tests_needed(cs, ro, rd, rtm, got, any_hit, chunk=1 << 14)
        walk = packet_walk_tests(keys, a["t"], packet.BLOCK_RAYS)
        warp_lb = warp_walk_tests(cs, ko, kd, ktm, a, any_hit)
        bnd = bound_ms(n * (28 + 16) + order.numel() * 8 + cs.slab.numel() * 4,
                       tests * MT_OPS["packet"])
        if old_lib is not None:
            old = launch_old(old_lib, "nrd_packet_hit_stream", cs, ko, kd, ktm, order, keys,
                             any_hit, not any_hit)
            torch.cuda.synchronize()
            if not all(torch.equal(old[k], a[k]) for k in a):
                fail(f"the streaming kernel's results changed from the parent's build ({case})")
            old_ms = graph_ms(lambda: launch_old(old_lib, "nrd_packet_hit_stream", cs, ko, kd,
                                                 ktm, order, keys, any_hit, not any_hit))
            old_src = "built from its source, measured in this call, results identical"
            old_measured = True
            del old
        else:
            old_ms, old_src, old_measured = (PARENT_STREAM_MS[case],
                                             "quoted from PERF.md, not measured in this call",
                                             False)
        print(f"[packet_hit_stream] exterior {case} C={cs.count} N={n} sort={sort} "
              f"any_hit={any_hit}: {'blocked' if any_hit else 'hits'} {hits} of {PLAIN_SUBSET} "
              f"checked, tri (or blocked) differences {tri_bad} (float64-proven ties allowed), "
              f"max|err| t/u/v {err:.3g}; the resident kernel identical on all {n} rays | "
              f"streaming kernel {ms:.3f} ms (the parent's build {old_ms:.3f} ms, {old_src}), "
              f"resident kernel {res_ms:.3f} ms at N={n} (stage 1 {stage1_ms:.3f} ms), plain "
              f"{plain_ms:.3f} ms at N={PLAIN_SUBSET}, bound {bnd[0]:.4f} ms ({bnd[1]}, {tests} "
              f"tests needed; the packet walk would make {walk}, the warp walk at least "
              f"{warp_lb}) ({card})")
        if not ok or hits == 0:
            fail(f"streaming packet kernel disagrees with its plain version ({case})")
        out[case] = (err, ms, plain_ms, bnd, PLAIN_SUBSET, res_ms, stage1_ms, old_ms,
                     old_measured)
        del got, ko, kd, ktm, order, keys, a, b
    return out


def ray_subset(n: int, seed: int, dev) -> torch.Tensor:
    """Sorted indices of PLAIN_SUBSET of n rays (all of them if fewer), drawn
    from a seed."""
    if n <= PLAIN_SUBSET:
        return torch.arange(n, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.sort(torch.randperm(n, generator=g, device=dev)[:PLAIN_SUBSET]).values


def keep_rays(i: int, a: dict, out):
    """What the recorder keeps of a packet or probe call: its arguments with
    the rays, their t_max and the outputs the caller got cut to a seeded
    subset of the rays."""
    o = a["origin"]
    n = o.shape[0]
    sub = ray_subset(n, 100 + i, o.device)
    kept = {k: v for k, v in a.items() if k not in ("origin", "direction", "t_max")}
    kept.update(n=n, origin=o[sub].clone(), direction=a["direction"][sub].clone())
    if "t_max" in a:
        tm = torch.as_tensor(a["t_max"], dtype=torch.float32, device=o.device).expand(n)
        kept["t_max"] = tm[sub].clone()
    kept["out"] = ({k: v[sub].clone() for k, v in out.items()} if isinstance(out, dict)
                   else out[sub].clone())
    return kept


def keep_planes(i: int, a: dict, out):
    """What the recorder keeps of a gather or denoiser call: every argument
    and output, tensors copied whole."""
    def copy(v):
        return v.detach().clone() if torch.is_tensor(v) else v

    kept = {k: copy(v) for k, v in a.items()}
    kept["out"] = tuple(copy(v) for v in out) if isinstance(out, tuple) else copy(out)
    return kept


@contextlib.contextmanager
def recording(specs: dict):
    """Within the block, each wrapper named by specs, {name: (module,
    function name, keep)}, records its outermost calls: keep(call index,
    bound arguments with defaults, result) goes into the yielded {name:
    list}. A call the wrapper makes to itself (the packet wrapper's re-binned
    call) is part of the outer call and not recorded again."""
    import inspect

    kept = {name: [] for name in specs}
    saved = []

    def recorder(name, fn, keep):
        sig = inspect.signature(fn)
        depth = 0

        def rec(*args, **kwargs):
            nonlocal depth
            depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth -= 1
            if depth == 0:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                kept[name].append(keep(len(kept[name]), dict(bound.arguments), out))
            return out

        return rec

    for name, (mod, attr, keep) in specs.items():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, recorder(name, fn, keep))
    try:
        yield kept
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_frame_calls(calls: dict, launches: dict, cs, scene, card: str,
                      label: str = "interior1440") -> dict:
    """Hold each recorded call of the ``label`` frame (``recording``) against
    its plain version on the same inputs; fails on a disagreement, or where
    a kernel has no recorded call or fewer than its launches in the frame.
    Returns {kernel: max |err|}."""
    from nrdsample_tpu_torch.denoise import relax, taa
    from nrdsample_tpu_torch.mathlib import filtering
    from nrdsample_tpu_torch.ops import cluster, emissive_probe, intersect

    tris = {k: getattr(scene.tris, k).cpu().numpy() for k in ("p0", "e1", "e2")}
    frame_err = {}
    for name, got_calls in calls.items():
        if not got_calls or len(got_calls) < launches[name]:
            fail(f"the recorded {label} frame made {len(got_calls)} {name} calls and "
                 f"{launches[name]} launches: a launch went round the recorded wrapper")
        errs, notes = [], []
        for c in got_calls:
            got = c["out"]
            if name == "packet_hit":
                if c["cs"] is not cs:
                    fail(f"a {label} packet call traced another cluster set")
                o, d, tm = c["origin"], c["direction"], c["t_max"]
                if c["any_hit"]:
                    ref = cluster.any_hit_clustered(cs, o, d, tm)
                    blocked = (got["tri"] >= 0) & (got["t"] < tm)
                    n_bad, err, ok = int((blocked != ref).sum()), 0.0, bool(torch.equal(blocked,
                                                                                        ref))
                    what = f"any-hit blocked {int(ref.sum())}"
                else:
                    ref = cluster.closest_hit_clustered(cs, o, d, tm)
                    if not c["need_uv"]:
                        ok_uv = not bool(got["u"].any()) and not bool(got["v"].any())
                        ref = dict(ref, u=torch.zeros_like(ref["u"]) if ok_uv else ref["u"],
                                   v=torch.zeros_like(ref["v"]) if ok_uv else ref["v"])
                    n_bad, err, ok = compare_hits(got, ref, o, d, tris)
                    what = (f"{'sorted' if c['sort'] else 'coherent'} hits "
                            f"{int((ref['tri'] >= 0).sum())}")
                notes.append(f"N={c['n']} {what}, tri (or blocked) differences {n_bad}")
            elif name == "dense_hit":
                ref = intersect.intersect_dense(c["origin"], c["direction"], c["p0"], c["e1"],
                                                c["e2"], c["t_max"])
                n_bad = int((got["tri"] != ref["tri"]).sum())
                pairs = [max_err(got[k], ref[k]) for k in "tuv"]
                err, ok = max(e for e, _ in pairs), n_bad == 0 and all(k for _, k in pairs)
                notes.append(f"N={c['n']} E={c['p0'].shape[0]} hits {int((ref['tri'] >= 0).sum())}")
            elif name == "emissive_probe":
                ref = emissive_probe.light_probe_plain(c["em"], c["origin"], c["direction"])
                err, ok = max_err(got, ref)
                notes.append(f"N={c['n']} lit {int((ref > 0).sum())}")
            elif name == "bilinear_sample":
                ref = filtering.sample_bilinear(c["img"], c["pos"])
                err, ok = max_err(got, ref)
                ok = ok and torch.equal(got, ref)
                notes.append(f"img {tuple(c['img'].shape)} pos {tuple(c['pos'].shape)}")
            elif name == "relax_taccum":
                rs_ = relax.RelaxSettings(max_accumulated_frames=c["max_frames"],
                                          disocclusion_threshold=c["threshold"],
                                          enable_anti_firefly=c["anti_firefly"])
                ref = relax.taccum_plain(
                    relax.RelaxHistory(c["hist_illum"], c["hist_moments"], c["hist_view_z"],
                                       c["hist_normal"], c["hist_frames"]),
                    c["illum"], c["view_z"], c["normal"], c["mv"], rs_, c["reset"],
                    c["confidence"])
                pairs = [max_err(a, b) for a, b in zip(got, ref)]
                err, ok = max(e for e, _ in pairs), all(k for _, k in pairs)
                notes.append(f"{tuple(c['illum'].shape)} accumulated {int((ref[2] > 1.0).sum())}")
            elif name == "relax_atrous":
                rs_ = relax.RelaxSettings(phi_luminance=c["phi_luminance"],
                                          phi_normal=c["phi_normal"], phi_depth=c["phi_depth"])
                ref = relax.atrous_iteration(c["illum"], c["variance"], c["view_z"], c["normal"],
                                             c["step"], rs_)
                pairs = [max_err(a, b) for a, b in zip(got, ref)]
                err, ok = max(e for e, _ in pairs), all(k for _, k in pairs)
                notes.append(f"{tuple(c['illum'].shape)} step {c['step']}")
            else:
                ref = taa.resolve_tail(c["cur"], c["prev"], c["mv_d"], c["wide_mask"],
                                       c["reset_mix"], c["sigma_scale"], c["base_mix"])
                err, ok = max_err(got, ref)
                wide = c["wide_mask"]
                notes.append(f"{tuple(c['cur'].shape)} wide pixels "
                             f"{0 if wide is None else int((wide > 0.5).sum())}")
            errs.append(err)
            if not ok:
                fail(f"the {name} kernel disagrees with its plain version on the {label} "
                     f"frame's own inputs ({notes[-1]})")
        frame_err[name] = max(errs)
        same = {}
        for note in notes:
            same[note] = same.get(note, 0) + 1
        print(f"[{name}] {label} frame's own inputs, {len(got_calls)} calls "
              f"({'; '.join(f'{k} x{n}' for k, n in same.items())}): max|err| "
              f"{frame_err[name]:.3g} against the plain version ({card})")
    return frame_err


OUTPUT_WARMUP = 2
OUTPUT_FRAMES = 3
OUTPUT_W, OUTPUT_H = 3840, 2160   # DLSS "Performance" at 4K renders at 1920x1080
CHAIN_RES, CHAIN_OUT = 192, 384   # the card-against-CPU check of the output chain
CHAIN_SHARC_CAPACITY = 1 << 18    # its SHARC table, cut from 2^22 to keep the CPU frames short
HOLDOUT_RES = 96                  # tests/test_neural_rr.py's held-out kitchen view
NET_TOL = 1e-5                    # the networks, card against CPU (float32 convolutions)
CLI_RENDER = ["render", "--scene", "kitchen", "--size", "512", "--frames", "4", "--denoiser",
              "relax", "--taa", "--upscale", "1024", "--sr", "neural", "--nis", "--separator",
              "0.5"]


def to_device(obj, dev):
    """A copy of obj (tensors, dicts, tuples, dataclasses of them) on dev."""
    import dataclasses

    if torch.is_tensor(obj):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(to_device(v, dev) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk; fails if the file is no PNG."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def check_output_chain(dev, card: str, launches: dict, reset_counts, counters: dict) -> dict:
    """The output chain (phase 5d): (a) kitchen1080 with the post chain to
    3840x2160 (the learned SR network, NIS, the split screen at 0.5) and the
    validation overlay, (b) kitchen1080 with the learned RR denoiser in
    place of RELAX (TAA and SHARC kept): 2 warm-up and 3 timed frames each
    (wall and device-busy ms, idle share, peak memory, launches, the post
    chain's and the RR step's own device ms); every gather call of one (b)
    frame against its plain version; the networks and the 192x192 -> 384x384
    image phase card against CPU; the 96x96 held-out RR gate; every debug
    view once at kitchen1080; the CLI's render at 512 -> 1024. Runs with
    cuDNN's TF32 allowed (PyTorch's default), so the networks' own float32
    scope is what holds them to the CPU. Returns the summary numbers."""
    import dataclasses
    import tempfile

    from nrdsample_tpu_torch.config import Denoiser, OnScreen, RenderConfig, TracingMode
    from nrdsample_tpu_torch.ops import reproject
    from nrdsample_tpu_torch.pipeline import bench_configs, frame
    from nrdsample_tpu_torch.post import final as final_mod, guides, neural_rr, neural_sr, nis
    from nrdsample_tpu_torch.post import upscale
    from nrdsample_tpu_torch.scene import procedural
    from nrdsample_tpu_torch.scene.types import look_at
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.config import make_settings

    summary = {}
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    post_kw = dict(enable_post=True, output_width=OUTPUT_W, output_height=OUTPUT_H,
                   use_neural_sr=True, use_nis=True, use_validation_overlay=True)
    cases = {"a": ("kitchen1080 + post chain to 3840x2160", post_kw,
                   ("dense_hit", "emissive_probe", "bilinear_sample", "relax_taccum",
                    "relax_atrous", "taa_resolve")),
             "b": ("kitchen1080 NEURAL", dict(denoiser=Denoiser.NEURAL),
                   ("dense_hit", "emissive_probe", "bilinear_sample", "taa_resolve"))}

    def separated(settings):
        return dataclasses.replace(settings, separator=torch.tensor(0.5, device=settings.separator.device))

    for key, (label, kw, needed) in cases.items():
        ctx, scene, cam, cfg, settings = bench_configs.setup("kitchen1080", dev, **kw)
        settings = separated(settings)
        hist = frame.History.create(cfg, dev)
        for _ in range(OUTPUT_WARMUP):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(OUTPUT_FRAMES):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / OUTPUT_FRAMES
        counts = {k: m.LAUNCHES for k, m in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        if not all(counts[k] > 0 for k in needed):
            fail(f"({key}) {label} did not launch all of {needed}: {counts}")
        state = {}

        def one_more():
            state["out"], state["hist"] = frame.render_frame(ctx, scene, cam, cfg, settings, hist)

        busy_ms, n_kernels = device_busy_ms(one_more)
        per_frame = {k: n / OUTPUT_FRAMES for k, n in counts.items()}
        line = (f"[output chain ({key})] {label}: {ms:.3f} ms/frame wall over {OUTPUT_FRAMES} "
                f"frames after {OUTPUT_WARMUP} warm-up, device busy {busy_ms:.3f} ms in "
                f"{n_kernels} kernels (one more frame under torch.profiler), idle share "
                f"{1.0 - busy_ms / ms:.3f}, peak memory {peak} B, launches/frame {per_frame}")
        gb = out["gbuffer"]
        for k in ("color", "final"):
            if not bool(torch.isfinite(out[k]).all()) or not float(out[k].mean()) > 0.0:
                fail(f"({key}) {label}: {k} is not finite with a positive mean")
        if key == "a":
            disp = out["display"]
            if (tuple(disp.shape) != (OUTPUT_H, OUTPUT_W, 3) or not bool(torch.isfinite(disp).all())
                    or float(disp.min()) < 0.0 or float(disp.max()) > 1.0):
                fail(f"(a) display {tuple(disp.shape)} is not a finite [0, 1] image at "
                     f"{OUTPUT_W}x{OUTPUT_H}")
            # the post chain alone, on the last frame's inputs (the TAA output
            # before the validation overlay is the new TAA history)
            taa_out = hist.taa.color.reshape(-1, 3)
            frame_idx = hist.frame_index - 1

            def chain():
                return frame.post_chain(cfg, settings, gb, out["color"], taa_out, frame_idx,
                                        taa_on=True)

            again = float((chain() - disp).abs().max())
            if not again <= NET_TOL:
                fail(f"(a) post_chain on the frame's own inputs differs from the frame's display "
                     f"by {again:.3g}")
            h, w = cfg.height, cfg.width
            tm = taa_out.reshape(h, w, 3)
            sr_g = {"normal": gb["normal"].reshape(h, w, 3),
                    "roughness": gb["roughness"].reshape(h, w),
                    "depth": guides.hw_depth(gb["view_z"], 0.01).reshape(h, w)}
            params = neural_sr.load_weights(device=dev)
            up = upscale.lanczos_resize(tm, OUTPUT_H, OUTPUT_W)
            parts = {"post_chain": chain,
                     "lanczos 3 ch": lambda: upscale.lanczos_resize(tm, OUTPUT_H, OUTPUT_W),
                     "neural_sr.apply": lambda: neural_sr.apply(params, tm, sr_g, OUTPUT_H,
                                                                OUTPUT_W),
                     "nis.sharpen": lambda: nis.sharpen(up, settings.sharpness),
                     "final_pass": lambda: final_mod.final_pass(up, noisy=up,
                                                                separator=settings.separator,
                                                                frame_index=frame_idx)}
            times = {}
            for name, fn in parts.items():
                ev = median_ms(fn, reps=5)
                busy, nk = device_busy_ms(fn)
                times[name] = (ev, busy, nk)
            summary["post"] = times
            line += ("; " + ", ".join(f"{n} {t[0]:.3f} ms (busy {t[1]:.3f} in {t[2]} kernels)"
                                      for n, t in times.items()))
        else:
            if int(hist.neural_rr.valid) != 1 or out["display"] is not None:
                fail("(b) the RR history is not valid after the frames")
            h, w = cfg.height, cfg.width
            rg = guides.rr_guides(gb, near=0.01, mv_type=settings.mv_type)
            rr_g = {k: rg[k].reshape((h, w) + rg[k].shape[1:])
                    for k in ("diff_albedo", "spec_albedo", "normal_roughness", "depth")}
            params = neural_rr.load_weights(device=dev)
            noisy_img = out["color"].reshape(h, w, 3)
            mv = gb["mv"].reshape(h, w, 3)[..., :2]

            def rr_step():
                return neural_rr.denoise(params, noisy_img, rr_g, mv, hist.neural_rr)[0]

            ev = median_ms(rr_step, reps=5)
            busy, nk = device_busy_ms(rr_step)
            summary["rr"] = (ev, busy, nk)
            line += f"; neural_rr.denoise {ev:.3f} ms (busy {busy:.3f} in {nk} kernels)"
            # every gather call of one more frame against its plain version
            with recording({"bilinear_sample": (reproject, "sample_bilinear_cuda", keep_planes),
                            "taa_resolve": (counters["taa_resolve"], "taa_resolve_cuda",
                                            keep_planes)}) as calls:
                before = {k: m.LAUNCHES for k, m in counters.items()}
                frame.render_frame(ctx, scene, cam, cfg, settings, state["hist"])
                rec = {k: m.LAUNCHES - before[k] for k, m in counters.items()}
            torch.cuda.synchronize()
            summary["rr_calls"] = check_frame_calls(calls, rec, None, scene, card,
                                                    label="kitchen1080 NEURAL")
            del calls
        summary[key] = (ms, busy_ms, 1.0 - busy_ms / ms, peak, per_frame)
        print(line + f" ({card})")
        del out, hist, state, gb, ctx, scene
        torch.cuda.empty_cache()

    # the networks card against CPU on seeded inputs, TF32 allowed globally
    rs = np.random.RandomState(5)
    f32 = lambda *shape: torch.from_numpy(rs.rand(*shape).astype(np.float32))
    sr_in = (f32(128, 160, 3), {"normal": f32(128, 160, 3), "roughness": f32(128, 160),
                                "depth": f32(128, 160)})
    rr_in = (f32(128, 160, 3), {"diff_albedo": f32(128, 160, 3), "spec_albedo": f32(128, 160, 3),
                                "normal_roughness": f32(128, 160, 4), "depth": f32(128, 160)},
             f32(128, 160, 3))
    errs = {}
    for name, fn, args in (
            ("neural_sr.apply", lambda d, c, g: neural_sr.apply(
                neural_sr.load_weights(device=d), c, g, 256, 320), sr_in),
            ("neural_rr.apply", lambda d, n, g, p: neural_rr.apply(
                neural_rr.load_weights(device=d), n, g, p, 1), rr_in)):
        ref = fn("cpu", *args)
        got = fn(dev, *to_device(args, dev)).cpu()
        err = float((got - ref).abs().max())
        errs[name] = err
        if not torch.allclose(got, ref, rtol=NET_TOL, atol=NET_TOL):
            fail(f"{name} on the card differs from the CPU by {err:.3g} (TF32 in the convolutions?)")
    print(f"[output chain] networks card against CPU with cudnn.allow_tf32 True: max|err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (limit {NET_TOL})")

    # the image phase at 192x192 -> 384x384 card against CPU, from the CPU's
    # trace of the second frame and its history after the first; the whole
    # frames are reported beside it
    for label, kw in (("post chain", dict(post_kw, output_width=CHAIN_OUT,
                                          output_height=CHAIN_OUT)),
                      ("NEURAL", dict(denoiser=Denoiser.NEURAL))):
        runs = {}
        for where in ("cpu", dev):
            ctx, scene, cam, cfg, settings = bench_configs.setup(
                "kitchen1080", where, width=CHAIN_RES, height=CHAIN_RES,
                sharc_capacity=CHAIN_SHARC_CAPACITY, **kw)
            settings = separated(settings)
            h0 = frame.History.create(cfg, where)
            out0, h1 = frame.render_frame(ctx, scene, cam, cfg, settings, h0)
            out1, h2 = frame.render_frame(ctx, scene, cam, cfg, settings, h1)
            runs[where] = (ctx, scene, cam, cfg, settings, h1, out1)
        ctx, scene, cam, cfg, settings, h1, whole_cpu = runs["cpu"]
        gb, aux = frame.trace_frame(ctx, scene, cam, cfg, settings, h1)
        img_cpu = frame.image_frame(cfg, settings, cam, h1, gb, aux)[0]
        _, _, cam_d, _, settings_d, _, whole_card = runs[dev]
        img_card = frame.image_frame(cfg, settings_d, cam_d, to_device(h1, dev),
                                     to_device(gb, dev), to_device(aux, dev))[0]
        planes = ("color", "final") + (("display",) if cfg.enable_post else ())
        rows = []
        for plane in planes:
            for what, a, b in (("image phase", img_cpu, img_card), ("whole frame", whole_cpu,
                                                                    whole_card)):
                frac, rel = frame_mismatch(a[plane].reshape(-1, 3), b[plane].reshape(-1, 3))
                rows.append((plane, what, frac, rel))
                if what == "image phase" and (frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL):
                    fail(f"the {label} image phase at {CHAIN_RES}x{CHAIN_RES} differs between the "
                         f"card and the CPU on {plane}: outlier share {frac:.6f}, mean gap {rel:.3g}")
        print(f"[output chain] {label} {CHAIN_RES}x{CHAIN_RES}"
              + (f" -> {CHAIN_OUT}x{CHAIN_OUT}" if cfg.enable_post else "")
              + " card against CPU (outlier share, mean gap; the image phase from the CPU's "
              "trace of frame 1 is held to PERF.md §2, the whole frame reported): "
              + ", ".join(f"{p} {w} {f:.6f}/{r:.3g}" for p, w, f, r in rows))
        del runs, gb, aux, img_cpu, img_card, whole_cpu, whole_card

    # tests/test_neural_rr.py's held-out gate on the card
    target = np.load(os.path.join(REPO, "Tests", "golden", "neural_rr_holdout.npz"))["target"]
    ctx, scene = traversal.build_context(procedural.kitchen(), device=dev)
    cam = look_at([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], fov_y_deg=65.0, device=dev)
    settings = make_settings(dev, sun_elevation=45.0)
    psnr = {}
    for d in (Denoiser.NEURAL, Denoiser.RELAX):
        cfg = RenderConfig(width=HOLDOUT_RES, height=HOLDOUT_RES, rpp=1, bounce_num=2,
                           tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=d)
        hist = frame.History.create(cfg, dev)
        for _ in range(2):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        img = np.clip(out["color"].cpu().numpy().reshape(HOLDOUT_RES, HOLDOUT_RES, 3), 0, 4)
        psnr[d.name] = float(-10 * np.log10(np.mean((img - np.clip(target, 0, 4)) ** 2) + 1e-12))
    print(f"[output chain] held-out kitchen {HOLDOUT_RES}x{HOLDOUT_RES}, 2 frames: PSNR NEURAL "
          f"{psnr['NEURAL']:.3f} dB, RELAX {psnr['RELAX']:.3f} dB")
    if not psnr["NEURAL"] > psnr["RELAX"]:
        fail("the learned RR denoiser does not beat RELAX on the held-out view on the card")
    summary["holdout"] = psnr

    # every debug view once at kitchen1080, one history carried through them
    ctx, scene, cam, cfg, settings = bench_configs.setup("kitchen1080", dev)
    hist = frame.History.create(cfg, dev)
    means = {}
    for view in OnScreen:
        out, hist = frame.render_frame(ctx, scene, cam, dataclasses.replace(cfg, on_screen=view),
                                       settings, hist)
        dbg = out["debug"]
        if view == OnScreen.FINAL:
            if dbg is not None:
                fail("the FINAL view has a debug image")
            continue
        if tuple(dbg.shape) != (cfg.n_pixels, 3) or not bool(torch.isfinite(dbg).all()):
            fail(f"the {view.name} debug view is not a finite (N, 3) image")
        means[view.name] = float(dbg.mean())
    print(f"[output chain] debug views at kitchen1080, mean of each: "
          + ", ".join(f"{k} {v:.4g}" for k, v in means.items()))
    del ctx, scene, hist, out
    torch.cuda.empty_cache()

    # the port's CLI as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "kitchen.png")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "nrdsample_tpu_torch.cli", *CLI_RENDER,
                            "--out", png], cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        print(f"[output chain] python -m nrdsample_tpu_torch.cli {' '.join(CLI_RENDER)}: rc "
              f"{r.returncode} in {wall:.1f} s; " + " | ".join(
                  (r.stderr.strip().splitlines() or [""])[-2:] + r.stdout.strip().splitlines()))
        if r.returncode != 0 or not os.path.exists(png):
            fail(f"the CLI render failed: {r.stderr[-2000:]}")
        size = png_size(png)
        if size != (1024, 1024):
            fail(f"the CLI wrote a {size} PNG, not 1024x1024")
    torch.backends.cudnn.allow_tf32 = tf32_before
    return summary


TRAIN_FD_LIMIT = 0.08            # bench.py's grad_allclose_fd
TRAIN_BENCH_SIZE = 512
#: kitchen1080's training step runs at the full 1920x1080: the autograd
#: graph saves ~16.0 KB a pixel (the 16 importance candidates' planes among
#: them), ~33 GB in all (PERF.md §6), within the card's 80 GB
TRAIN_KITCHEN_W, TRAIN_KITCHEN_H = 1920, 1080
GRAD_TOL = 1e-4                  # card against CPU, of the field's largest |CPU entry|
#: the CLI's defaults (cornellbox 48x48, 200 iters, sun -30) with the lr of
#: tests/test_grad.py (2e-4 at 32x32) scaled by 1/n_pixels, as --lr's help
#: says: at the default 4e-4 the JAX package's own optimize oscillates and
#: ends unrecovered, and the port with it (PERF.md §6)
OPTIMIZE_ARGS = ["optimize", "--lr", repr(2e-4 * 32 * 32 / (48 * 48))]


def check_training(dev, card: str, reset_counts, counters: dict) -> dict:
    """The differentiable path (phase 8): (A) ``train.bench_backward`` at
    512x512 through the resident packet kernel, its finite-difference check
    within TRAIN_FD_LIMIT; (B) one ``make_train_step`` on kitchen1080 at
    TRAIN_KITCHEN_W x TRAIN_KITCHEN_H (RELAX + SIGMA, SH, TAA, SHARC,
    confidence): wall and device-busy ms, peak memory, each kernel's
    launches in the step (the backward launches none: it differentiates
    the plain versions), finite gradients; (C) ``python -m
    nrdsample_tpu_torch.cli optimize`` as a subprocess (OPTIMIZE_ARGS),
    exit 0 and recovered; (D) one step's gradients card against CPU, every
    field entry by entry within GRAD_TOL of its largest |CPU entry|, on the
    Cornell box at 64x64 and the kitchen at 80x48; (E) ``make_train_step``
    on the Cornell box at 256x256 through the probe kernel, and on
    shaderballs512 through the packet kernel and REBLUR's gathers (its
    specular history is gathered at a position that depends on the
    roughness: the gather kernel's forward, the plain version's gradient).
    Returns the summary numbers."""
    from nrdsample_tpu_torch.ops import packet
    from nrdsample_tpu_torch.pipeline import bench_configs, frame, train

    def synced():
        torch.cuda.synchronize(dev)
        return time.perf_counter()

    def launched(what: str, need) -> dict:
        got = {k: m.LAUNCHES for k, m in counters.items()}
        missing = [k for k in need if not got[k]]
        if missing:
            fail(f"{what} launched no {missing}: {got}")
        return got

    summary = {}
    # (A) the backward bench
    reset_counts()
    t0 = time.perf_counter()
    bench = train.bench_backward(TRAIN_BENCH_SIZE, 4, dev)
    bench_s = time.perf_counter() - t0
    counts = launched("the backward bench", ["packet_hit"])
    print(f"[training] (A) bench_backward at {TRAIN_BENCH_SIZE}x{TRAIN_BENCH_SIZE} "
          f"(shaderballs, REFERENCE, 2 bounces): {json.dumps(bench)}; launches {counts}, "
          f"streaming {packet.STREAM_LAUNCHES}; {bench_s:.1f} s ({card})")
    if not bench["grad_fd_rel_err"] < TRAIN_FD_LIMIT or packet.STREAM_LAUNCHES:
        fail(f"the backward bench's FD check failed or left the resident kernel: {bench}")
    summary["A"] = bench

    # (B) one training step on kitchen1080
    ctx, scene, cam, cfg, settings = bench_configs.setup(
        "kitchen1080", dev, width=TRAIN_KITCHEN_W, height=TRAIN_KITCHEN_H)
    target = torch.zeros((cfg.n_pixels, 3), device=dev)
    step = train.make_train_step(ctx, cfg, lr=2e-4 * 1024 / cfg.n_pixels)
    hist = frame.History.create(cfg, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step(scene.materials, scene, cam, settings, hist, target)    # warm-up
    reset_counts()
    t0 = synced()
    loss, mats = step(scene.materials, scene, cam, settings, hist, target)
    wall_ms = (synced() - t0) * 1e3
    counts = launched("the kitchen1080 training step",
                      [k for k in counters if k != "packet_hit"])
    busy_ms, n_kernels = device_busy_ms(
        lambda: step(scene.materials, scene, cam, settings, hist, target))
    diff, rest = train.split_materials(scene.materials)
    _, grads = train.value_and_grad(train.make_loss_fn(ctx, cfg), diff, rest, scene, cam,
                                    settings, hist, target)
    peak = torch.cuda.max_memory_allocated(dev)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    moved = sum(int((getattr(mats, k) != v).sum()) for k, v in diff.items())
    print(f"[training] (B) kitchen1080 make_train_step at {cfg.width}x{cfg.height}: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms in {n_kernels} kernels, peak memory "
          f"{peak} B, launches in the step {counts}, loss {float(loss):.6g}, gradients finite "
          f"{finite}, largest |gradient| per field "
          + ", ".join(f"{k} {float(g.abs().max()):.4g}" for k, g in grads.items())
          + f", {moved} parameters moved ({card})")
    if not finite or not bool(torch.isfinite(loss)) or not moved:
        fail("the kitchen1080 training step's gradients are not finite or moved nothing")
    summary["B"] = (wall_ms, busy_ms, peak, counts)
    del ctx, scene, hist, grads, mats, step, target
    torch.cuda.empty_cache()

    # (C) the CLI's optimize as a user runs it
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "nrdsample_tpu_torch.cli", *OPTIMIZE_ARGS],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    print(f"[training] (C) python -m nrdsample_tpu_torch.cli {' '.join(OPTIMIZE_ARGS)}: rc "
          f"{r.returncode} in {cli_s:.1f} s; "
          + " | ".join((r.stderr.strip().splitlines() or [""])[-2:]) + f" | {last} ({card})")
    try:
        result = json.loads(last)
    except ValueError:
        result = {}
    if r.returncode != 0 or result.get("recovered") is not True:
        fail(f"optimize did not recover the albedo: {r.stderr[-2000:]}")
    summary["C"] = (cli_s, result)

    # (D) one step's gradients, card against CPU
    worst = {}
    for name, kw in (("cornell256", dict(width=64, height=64)),
                     ("kitchen1080", dict(width=80, height=48, sharc_capacity=1 << 16))):
        grads = {}
        for where in ("cpu", dev):
            ctx, scene, cam, cfg, settings = bench_configs.setup(name, where, **kw)
            diff, rest = train.split_materials(scene.materials)
            grads[where] = train.value_and_grad(
                train.make_loss_fn(ctx, cfg), diff, rest, scene, cam, settings,
                frame.History.create(cfg, where), torch.zeros((cfg.n_pixels, 3), device=where))[1]
        rel = {}
        for k, want in grads["cpu"].items():
            got = grads[dev][k].cpu()
            scale = float(want.abs().max())
            gap = float((got - want).abs().max())
            rel[k] = gap / scale if scale > 0.0 else gap
            if not bool(torch.isfinite(got).all()) or gap > GRAD_TOL * scale:
                fail(f"{name} at {kw['width']}x{kw['height']}: the card's {k} gradient is "
                     f"{gap:.4g} off the CPU's (largest |CPU entry| {scale:.4g})")
        worst[name] = rel
        print(f"[training] (D) {name}'s config at {kw['width']}x{kw['height']}, card against "
              f"CPU gradients, largest gap over the field's largest |CPU entry|: "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    summary["D"] = worst

    # (E) the five-field step through the emissive probe kernel, and through
    # the packet kernel and REBLUR's gathers
    for name, need in (("cornell256", ["dense_hit", "emissive_probe"]),
                       ("shaderballs512", ["packet_hit", "bilinear_sample"])):
        ctx, scene, cam, cfg, settings = bench_configs.setup(name, dev)
        reset_counts()
        t0 = synced()
        loss, mats = train.make_train_step(ctx, cfg, lr=2e-4 * 1024 / cfg.n_pixels)(
            scene.materials, scene, cam, settings, frame.History.create(cfg, dev),
            torch.zeros((cfg.n_pixels, 3), device=dev))
        step_ms = (synced() - t0) * 1e3
        counts = launched(f"the {name} training step", need)
        finite = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(getattr(mats, k)).all())
            for k in train.DIFFERENTIABLE_MATERIAL_FIELDS)
        print(f"[training] (E) {name} make_train_step at {cfg.width}x{cfg.height}, all five "
              f"fields differentiated: {step_ms:.3f} ms (the first step), loss "
              f"{float(loss):.6g}, finite {finite}, launches {counts}")
        if not finite:
            fail(f"the {name} training step is not finite")
    return summary


TEX_WARMUP, TEX_FRAMES = 2, 3         # textured frames: warm-up, then timed
TEX_SMALL = dict(width=80, height=48, sharc_capacity=1 << 16)   # card against CPU
TEX_GRAD_RES = 32                     # the texels' gradients, card against CPU
TEX_GRAD_TOL = 1e-4                   # of the level's largest |CPU entry| (GRAD_TOL)
GLTF_VIEW_Z_FRAC = FRAME_OUTLIER_FRAC  # the loaded exterior's geometry planes
GLTF_MEAN_REL = 0.05                  # its mean luminance against the procedural frame's
GLTF_SMALL_RES = 128


def timed_frames(ctx, scene, cam, cfg, settings, hist, reset_counts, counters: dict, dev):
    """TEX_WARMUP frames, then TEX_FRAMES timed ones with the kernel counts
    set to 0 before them: (wall ms/frame, device-busy ms of one more frame,
    kernels in it, peak memory, per-frame launches, last outputs, history)."""
    from nrdsample_tpu_torch.pipeline import frame

    for _ in range(TEX_WARMUP):
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    per_frame = []
    t0 = time.perf_counter()
    for _ in range(TEX_FRAMES):
        before = {k: count_of(m) for k, m in counters.items()}
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        per_frame.append({k: count_of(m) - before[k] for k, m in counters.items()})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TEX_FRAMES
    peak = torch.cuda.max_memory_allocated(dev)
    busy, n_kernels = device_busy_ms(
        lambda: frame.render_frame(ctx, scene, cam, cfg, settings, hist))
    return ms, busy, n_kernels, peak, per_frame, out, hist


def count_of(m) -> int:
    """A kernel's launch count: its module's LAUNCHES (the streaming packet
    kernel: the packet module's STREAM_LAUNCHES, named by None)."""
    from nrdsample_tpu_torch.ops import packet

    return packet.STREAM_LAUNCHES if m is None else m.LAUNCHES


def check_textured(dev, card: str, launches: dict, reset_counts, counters: dict) -> dict:
    """Phases (T) and (S): the textured variants of kitchen1080 and
    shaderballs512 (``bench_configs.TEXTURED``: box uvs, 256x256 procedural
    maps with normal maps, one alpha-tested material) at full size. Each:
    wall and device-busy ms per frame, peak memory, launches per frame, then
    one more frame with every kernel call recorded and held against its
    plain version. (T) also: the textured kitchen at 80x48 card against CPU
    (PERF.md §2's frame limits), one L2 step at full size with the material
    fields and every mip level's texels requiring grad (forward and
    backward timed apart), and the texels' gradients card against CPU
    (REFERENCE, 32x32, two bounces) within TEX_GRAD_TOL of each level's
    largest |CPU entry|. Adds the timed frames' launches to ``launches``."""
    import dataclasses

    from nrdsample_tpu_torch.config import FLAG_ALPHA_TEST, Denoiser, RenderConfig, TracingMode
    from nrdsample_tpu_torch.denoise import atrous_cuda, taa_cuda, taccum_cuda
    from nrdsample_tpu_torch.mathlib import color
    from nrdsample_tpu_torch.ops import dense_cuda, emissive_probe, packet, reproject
    from nrdsample_tpu_torch.pipeline import bench_configs, frame, train
    from nrdsample_tpu_torch.scene import textures

    summary = {}
    specs = {"dense_hit": (dense_cuda, "closest_hit_dense_cuda", keep_rays),
             "emissive_probe": (emissive_probe, "light_probe_cuda", keep_rays),
             "packet_hit": (packet, "closest_hit_packet_cuda", keep_rays),
             "bilinear_sample": (reproject, "sample_bilinear_cuda", keep_planes),
             "relax_taccum": (taccum_cuda, "taccum_variance_cuda", keep_planes),
             "relax_atrous": (atrous_cuda, "atrous_iteration_cuda", keep_planes),
             "taa_resolve": (taa_cuda, "taa_resolve_cuda", keep_planes)}
    for name, need in (("kitchen1080", ("dense_hit", "emissive_probe", "bilinear_sample",
                                        "relax_taccum", "relax_atrous", "taa_resolve")),
                       ("shaderballs512", ("packet_hit", "bilinear_sample"))):
        label = f"textured {name}"
        t0 = time.perf_counter()
        ctx, scene, cam, cfg, settings = bench_configs.setup(name, dev, textured=True)
        setup_s = time.perf_counter() - t0
        ms, busy, n_kernels, peak, per_frame, out, hist = timed_frames(
            ctx, scene, cam, cfg, settings, frame.History.create(cfg, dev), reset_counts,
            counters, dev)
        for k, m in counters.items():
            launches[k] = launches.get(k, 0) + count_of(m)
        lum = float(color.luminance(out["color"]).mean())
        n_alpha = int(((scene.materials.flags & FLAG_ALPHA_TEST) != 0).sum())
        print(f"[{label}] {cfg.width}x{cfg.height}, {scene.tris.count} triangles, textures "
              f"{tuple(scene.textures.levels[0].shape)} in {scene.textures.n_mips} mips, "
              f"{n_alpha} alpha-tested material(s), set up in {setup_s:.1f} s: {ms:.3f} ms/frame "
              f"wall over {TEX_FRAMES} frames after {TEX_WARMUP} warm-up, device busy "
              f"{busy:.3f} ms in {n_kernels} kernels (one more frame), idle share "
              f"{1.0 - busy / ms:.3f}, peak memory {peak} B, mean luminance {lum:.6g}, "
              f"launches/frame {per_frame[-1]} ({card})")
        if not bool(torch.isfinite(out["color"]).all()) or not lum > 0.0:
            fail(f"the {label} image is not finite with a positive mean luminance")
        if not all(f[k] > 0 for f in per_frame for k in need):
            fail(f"a {label} frame did not launch all of {need}: {per_frame}")
        with recording({k: specs[k] for k in need}) as calls:
            before = {k: count_of(counters[k]) for k in need}
            frame.render_frame(ctx, scene, cam, cfg, settings, hist)
            recorded = {k: count_of(counters[k]) - before[k] for k in need}
        torch.cuda.synchronize()
        errs = check_frame_calls(calls, recorded, getattr(ctx, "clusters", None), scene, card,
                                 label=label)
        summary[name] = dict(ms=ms, busy=busy, peak=peak, launches=per_frame[-1], errs=errs,
                             kernels=n_kernels)
        del calls, out, hist

        if name != "kitchen1080":
            continue
        # one L2 step at full size: the material fields and every level's
        # texels require grad; forward and backward timed apart
        levels = [lv.detach().clone().requires_grad_() for lv in scene.textures.levels]
        diff, rest = train.split_materials(scene.materials)
        diff = {k: v.detach().clone().requires_grad_() for k, v in diff.items()}
        sc = dataclasses.replace(scene, textures=textures.TextureSet(levels),
                                 materials=train.merge_materials(diff, rest))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

        def step():
            h = frame.History.create(cfg, dev)
            col = frame.render_frame(ctx, sc, cam, cfg, settings, h)[0]["color"]
            loss = (col * col).sum()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wrt = [*diff.values(), *levels]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)   # ior: no glass
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(wrt, grads)]
            torch.cuda.synchronize()
            return loss, grads, t1

        step()                                             # warm-up
        t0 = time.perf_counter()
        loss, grads, t1 = step()
        t2 = time.perf_counter()
        step_busy, step_kernels = device_busy_ms(step)
        step_peak = torch.cuda.max_memory_allocated(dev)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        print(f"[{label} step] {cfg.width}x{cfg.height}, L2 loss, gradients of the five "
              f"material fields and the texels of all {len(levels)} levels: forward "
              f"{(t1 - t0) * 1e3:.3f} ms, backward {(t2 - t1) * 1e3:.3f} ms wall, device busy "
              f"{step_busy:.3f} ms in {step_kernels} kernels, peak memory {step_peak} B, loss "
              f"{float(loss.detach()):.6g}, finite {finite}, largest |texel gradient| per level "
              + ", ".join(f"{float(g.abs().max()):.4g}" for g in grads[len(diff):])
              + f" ({card})")
        if not finite or not any(bool(g.any()) for g in grads[len(diff):]):
            fail(f"the {label} step's gradients are not finite or reach no texel")
        summary["step"] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, step_busy, step_peak)
        del ctx, scene, sc, levels, grads, diff, rest, loss
        torch.cuda.empty_cache()

        # the textured kitchen at 80x48, card against CPU: without SHARC whole
        # frames are held to PERF.md §2; with it (a hit on a voxel boundary
        # lands in the neighbouring cell when its last ULP differs, and RELAX
        # spreads that voxel's radiance: the JAX package and the port's CPU
        # frames differ as much) the image phase is held to §2 on one input,
        # the CPU's trace of frame 0, and the whole frames are reported
        for what, kw in (("without SHARC", dict(use_sharc=False, use_confidence=False)),
                         ("its full config", {})):
            outs, traces = {}, {}
            for where in (dev, "cpu"):
                c, s_, cm, cf, st = bench_configs.setup(name, where, textured=True,
                                                        **dict(TEX_SMALL, **kw))
                h = frame.History.create(cf, where)
                if where == "cpu":
                    traces = frame.trace_frame(c, s_, cm, cf, st, frame.History.create(cf, where))
                for _ in range(3):
                    o, h = frame.render_frame(c, s_, cm, cf, st, h)
                outs[where] = (o, cm, st, cf)
            worst = max((*frame_mismatch(outs["cpu"][0][k], outs[dev][0][k]), k)
                        for k in RECORD_PLANES)
            rel = max(frame_mismatch(outs["cpu"][0][k], outs[dev][0][k])[1]
                      for k in ("color", "final"))
            line = (f"[card vs cpu] {label} at {TEX_SMALL['width']}x{TEX_SMALL['height']} "
                    f"{what}, 3 frames: worst outlier share {worst[0]:.6f} ({worst[2]}), color "
                    f"and TAA mean gap {rel:.3g} (rel)")
            if not kw:
                images = {}
                for where in (dev, "cpu"):
                    _, cm, st, cf = outs[where]
                    images[where] = frame.image_frame(cf, st, cm, frame.History.create(cf, where),
                                                      *to_device(traces, where))[0]
                iw = max((*frame_mismatch(images["cpu"][k], images[dev][k]), k)
                         for k in RECORD_PLANES)
                line += (f"; the image phase of frame 0 on the CPU's trace: worst outlier share "
                         f"{iw[0]:.6f} ({iw[2]}), mean gap {iw[1]:.3g}")
                worst, rel = iw, iw[1]
            print(line)
            if worst[0] > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
                fail(f"the card's {label} frame ({what}) disagrees with the CPU frame")

        # the texels' gradients, card against CPU
        grads = {}
        for where in ("cpu", dev):
            c, s, cm, _, st = bench_configs.setup(name, where, textured=True)
            cf = RenderConfig(width=TEX_GRAD_RES, height=TEX_GRAD_RES, rpp=1, bounce_num=2,
                              importance_samples=4, tracing_mode=TracingMode.FULL_PROBABILISTIC,
                              denoiser=Denoiser.REFERENCE)
            lv = [x.detach().clone().requires_grad_() for x in s.textures.levels]
            s = dataclasses.replace(s, textures=textures.TextureSet(lv))
            col = frame.render_frame(c, s, cm, cf, st, frame.History.create(cf, where))[0]["color"]
            grads[where] = [g.cpu() for g in torch.autograd.grad((col * col).sum(), lv)]
        gaps = []
        for level, (want, got) in enumerate(zip(grads["cpu"], grads[dev])):
            scale = float(want.abs().max())
            gap = float((got - want).abs().max())
            gaps.append(gap / scale if scale > 0.0 else gap)
            if not bool(torch.isfinite(got).all()) or gap > TEX_GRAD_TOL * scale:
                fail(f"{label} texels of level {level}: the card's gradient is {gap:.4g} off the "
                     f"CPU's (largest |CPU entry| {scale:.4g})")
        print(f"[card vs cpu] {label} texel gradients (REFERENCE, {TEX_GRAD_RES}x{TEX_GRAD_RES}, "
              f"two bounces), largest gap over the level's largest |CPU entry|, levels 0-"
              f"{len(gaps) - 1}: " + ", ".join(f"{g:.3g}" for g in gaps))
        summary["grad_gaps"] = gaps
    return summary


def check_gltf(dev, card: str, launches: dict, reset_counts, counters: dict) -> dict:
    """Phase (G): the full exterior720 scene written with ``save_glb`` and
    loaded back with ``load_gltf`` (seconds of each), one exterior720 frame
    of the loaded scene through the supercluster stage 1 and the streaming
    kernel beside one of the procedural scene (their geometry planes within
    PERF.md §2's outlier share, their mean luminance within GLTF_MEAN_REL),
    then a small textured .gltf with a PNG written by ``utils/image`` loaded
    and rendered on the card and on the CPU."""
    import tempfile

    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
    from nrdsample_tpu_torch.mathlib import color
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.pipeline import bench_configs, frame
    from nrdsample_tpu_torch.scene import gltf
    from nrdsample_tpu_torch.scene.types import look_at
    from nrdsample_tpu_torch.utils import image

    summary = {}
    spec = bench_configs.CONFIGS["exterior720"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exterior720.glb")
        t0 = time.perf_counter()
        scene = spec["scene"]()
        t1 = time.perf_counter()
        gltf.save_glb(scene, path)
        t2 = time.perf_counter()
        loaded = gltf.load_gltf(path, device=dev)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        size = os.path.getsize(path)
        print(f"[gltf] exterior720 ({scene.tris.count} triangles, {len(scene.materials.flags)} "
              f"materials, built in {t1 - t0:.1f} s): save_glb {t2 - t1:.2f} s, {size} B; "
              f"load_gltf onto the card {t3 - t2:.2f} s: {loaded.tris.count} triangles, "
              f"{len(loaded.materials.flags)} materials, {int(loaded.emissive_count)} emitters "
              f"({card})")
        if loaded.tris.count != scene.tris.count:
            fail("the exterior720 glb lost triangles")
        outs = {}
        for what, sc in (("procedural", scene), ("loaded", loaded)):
            t0 = time.perf_counter()
            ctxs, sc = traversal.build_scene_contexts(sc, device=dev)
            build_s = time.perf_counter() - t0
            eye, target, fov = spec["cam"]
            cfg = RenderConfig(**spec["cfg"], tracing_mode=TracingMode.FULL_PROBABILISTIC)
            cam = look_at(eye, target, fov_y_deg=fov, aspect=cfg.width / cfg.height, device=dev)
            settings = make_settings(dev, **spec["settings"])
            hist = frame.History.create(cfg, dev)
            reset_counts()
            t0 = time.perf_counter()
            out, _ = frame.render_frame(ctxs, sc, cam, cfg, settings, hist)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = {k: count_of(m) for k, m in counters.items()}
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            lum = float(color.luminance(out["color"]).mean())
            print(f"[gltf] exterior720 frame of the {what} scene (contexts in {build_s:.1f} s, "
                  f"opaque {ctxs.opaque.clusters.count} clusters): {ms:.3f} ms (the first "
                  f"frame), mean luminance {lum:.6g}, glass pixels "
                  f"{int(out['glass_mask'].sum())}, launches {got}")
            if not (got["packet_hit_stream"] and got["packet_hit"]):
                fail(f"the {what} exterior720 frame did not take the streaming and resident "
                     f"packet kernels: {got}")
            outs[what] = {k: out[k] for k in ("color", "view_z", "normal", "glass_mask")}
            outs[what]["lum"] = lum
            del ctxs, sc, out, hist
        del scene, loaded
        torch.cuda.empty_cache()
        a, b = outs["procedural"], outs["loaded"]
        geo_frac = max(frame_mismatch(a[k], b[k])[0] for k in ("view_z", "normal"))
        glass_frac = float((a["glass_mask"] != b["glass_mask"]).float().mean())
        lum_rel = abs(b["lum"] - a["lum"]) / a["lum"]
        print(f"[gltf] exterior720 loaded against procedural: view_z / normal outlier share "
              f"{geo_frac:.6f}, glass mask differs on {glass_frac:.6f} of the pixels, mean "
              f"luminance {b['lum']:.6g} against {a['lum']:.6g} ({lum_rel:.3g} rel), colour "
              f"outlier share {frame_mismatch(a['color'], b['color'])[0]:.6f} (emitter order "
              f"and the sampled lights differ)")
        if not bool(torch.isfinite(b["color"]).all()) or geo_frac > GLTF_VIEW_Z_FRAC \
                or glass_frac > GLTF_VIEW_Z_FRAC or lum_rel > GLTF_MEAN_REL:
            fail("the exterior720 frame of the loaded glb does not match the procedural one")
        summary["exterior"] = (t2 - t1, t3 - t2, geo_frac, lum_rel)

        # a small textured .gltf: a ground quad and a box, a PNG base colour
        n = 64
        yy, xx = np.mgrid[0:n, 0:n]
        tex = np.stack([(xx // 8 + yy // 8) % 2 * 0.7 + 0.2, xx / n, yy / n], -1)
        image.write_png(os.path.join(tmp, "checker.png"), tex.astype(np.float32))
        path = write_textured_gltf(tmp, "checker.png")
        outs = {}
        for where in (dev, "cpu"):
            t0 = time.perf_counter()
            sc = gltf.load_gltf(path, tex_res=n, device=where)
            load_s = time.perf_counter() - t0
            ctx, sc = traversal.build_context(sc, device=where)
            cfg = RenderConfig(width=GLTF_SMALL_RES, height=GLTF_SMALL_RES, rpp=1, bounce_num=1,
                               denoiser=Denoiser.REFERENCE)
            cam = look_at([0.0, -3.0, 2.0], [0.0, 0.0, 0.3], fov_y_deg=50.0, device=where)
            settings = make_settings(where, sun_elevation=45.0)
            outs[where] = frame.render_frame(ctx, sc, cam, cfg, settings,
                                             frame.History.create(cfg, where))[0]
            if where == dev:
                print(f"[gltf] textured .gltf ({sc.tris.count} triangles, texture "
                      f"{tuple(sc.textures.levels[0].shape)}, a PNG of utils/image.write_png) "
                      f"loaded onto the card in {load_s:.3f} s")
        frac, rel = frame_mismatch(outs["cpu"]["color"], outs[dev]["color"])
        lum = float(color.luminance(outs[dev]["color"]).mean())
        print(f"[card vs cpu] textured .gltf {GLTF_SMALL_RES}x{GLTF_SMALL_RES} REFERENCE: "
              f"outlier share {frac:.6f}, mean gap {rel:.3g} (rel), mean luminance {lum:.6g}")
        if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL or not lum > 0.0:
            fail("the textured .gltf frame on the card disagrees with the CPU frame")
        summary["small"] = (frac, rel)
    return summary


def write_textured_gltf(folder: str, png_name: str) -> str:
    """A .gltf in ``folder``: a 6x6 ground quad and a unit box above it, with
    uvs, both textured with the PNG ``png_name`` beside it (its buffer a data
    URI). Returns its path."""
    import base64

    ground = np.array([[-3, -3, 0], [3, -3, 0], [3, 3, 0], [-3, 3, 0]], np.float32)
    # the box's corner (x, y, z) is vertex 4 + 4 z + 2 y + x
    box = np.array([[x - 0.5, y - 0.5, 0.2 + z] for z in (0, 1) for y in (0, 1) for x in (0, 1)],
                   np.float32)
    verts = np.concatenate([ground, box])
    uvs = np.concatenate([ground[:, :2] / 2.0, box[:, [0, 2]] + box[:, 1:2]]).astype(np.float32)
    quads = [(0, 1, 2, 3), (4, 5, 7, 6), (8, 9, 11, 10), (4, 5, 9, 8), (6, 7, 11, 10),
             (4, 6, 10, 8), (5, 7, 11, 9)]
    idx = np.array([(a, b, c, a, c, d) for a, b, c, d in quads], np.uint16).reshape(-1)
    buf = verts.tobytes() + uvs.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicFactor": 0.0, "roughnessFactor": 0.6}}],
        "textures": [{"source": 0}], "images": [{"uri": png_name}],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": verts.nbytes},
            {"buffer": 0, "byteOffset": verts.nbytes, "byteLength": uvs.nbytes},
            {"buffer": 0, "byteOffset": verts.nbytes + uvs.nbytes, "byteLength": idx.nbytes}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": len(uvs), "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": len(idx), "type": "SCALAR"}],
    }
    path = os.path.join(folder, "textured.gltf")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def check_goldens(dev, card: str) -> dict:
    """Phase (R): the 19 record goldens of Tests/golden replayed on the card
    through ``replay.render_record`` at their resolution and held to
    tests/test_golden.py's bound (``replay.golden_limit``). A golden the card
    misses is replayed on the CPU too and both results are printed; any miss
    on the card fails the phase."""
    from nrdsample_tpu_torch.pipeline import replay

    t0 = time.perf_counter()
    ids = replay.golden_ids()
    contexts = replay.build_contexts(sorted({s for s, _ in ids}), dev)
    rows, misses = [], []
    for scene_name, index in ids:
        ok, tile, mean, limit = replay.check_golden(contexts, scene_name, index, dev)
        rows.append((f"{scene_name}-{index:03d}", tile, limit))
        if not ok:
            cpu = replay.check_golden(replay.build_contexts([scene_name], "cpu"), scene_name,
                                      index, "cpu")
            misses.append(f"{scene_name} #{index}: card tile error {tile:.4g}, mean error "
                          f"{mean:.4g}, CPU {'passes' if cpu[0] else 'misses'} (tile error "
                          f"{cpu[1]:.4g}); bound {limit:.4g}")
    worst = max(rows, key=lambda r: r[1] / r[2])
    print(f"[goldens] {len(ids)} record goldens on the card in {time.perf_counter() - t0:.1f} s: "
          f"{len(ids) - len(misses)} within the bound, largest tile error over its bound "
          f"{worst[1]:.4g} / {worst[2]:.4g} ({worst[0]}); "
          + "; ".join(f"{n} {t:.3g}" for n, t, _ in rows) + f" ({card})")
    for m in misses:
        print(f"[goldens] MISS {m}")
    if len(ids) != 19 or misses:
        fail(f"{len(misses)} of {len(ids)} goldens miss on the card")
    return {"worst": worst, "n": len(ids)}


ANIM_CUBES = 512                  # GenerateAnimatedCubes' pool (NRDSample.cpp:2280-2301)
ANIM_W, ANIM_H = 1920, 1080
ANIM_WARMUP, ANIM_FRAMES = 2, 8
DRS_SCHEDULE = (1.0, 1.0, 0.5, 0.5, 1.0)   # fixed buckets: the run does not depend on timing
ANIM_SMALL = dict(res=96, cubes=24, frames=3)   # card against CPU
CLI_ANIMATE = ["animate", "--size", "256", "--cubes", "512", "--frames", "6"]


def check_animate(dev, card: str, launches: dict, reset_counts, counters: dict) -> dict:
    """Phase 10, the animate path (``pipeline/animate.py``): (A) 512 cubes on
    their orbits over the ground box at 1920x1080 with RELAX, each frame
    transformed and refit on the card: ANIM_WARMUP frames, then ANIM_FRAMES
    timed ones (wall ms each, the refit's ms, launches), one more under the
    profiler (device-busy ms, the packet kernel's ms and launches), peak
    memory; then one frame with every kernel call recorded and held against
    its plain version on its own inputs, the resident packet kernel on the
    refit slab among them. (B) DRS on the same scene over the fixed bucket
    schedule DRS_SCHEDULE: the history resampled on the card at each switch,
    the display at 1920x1080 and finite, the frame index counting every
    frame. (C) ``cli animate`` as a subprocess. (D) card against CPU at
    96x96 with 24 cubes over 3 frames, the motion plane included (PERF.md
    §2), and the history resampled after a switch from the same input
    within KERNEL_TOL. Adds (A)'s timed launches to ``launches``."""
    import dataclasses
    import tempfile

    from nrdsample_tpu_torch.config import make_settings
    from nrdsample_tpu_torch.denoise import atrous_cuda, taa_cuda, taccum_cuda
    from nrdsample_tpu_torch.mathlib import color
    from nrdsample_tpu_torch.ops import packet, reproject
    from nrdsample_tpu_torch.pipeline import adaptive, animate, drs, frame

    summary = {}
    t0 = time.perf_counter()
    anim = animate.build(ANIM_CUBES, dev, aspect=ANIM_W / ANIM_H)
    cfg = dataclasses.replace(animate.render_config(ANIM_H), width=ANIM_W, height=ANIM_H)
    settings = adaptive.update(make_settings(dev, sun_elevation=animate.SUN_ELEVATION), None,
                               adaptive.FrameTimer().smoothed_ms)
    cs0 = anim.ctx.clusters
    setup_s = time.perf_counter() - t0
    hist = frame.History.create(cfg, dev)
    f = 0
    for _ in range(ANIM_WARMUP):
        out, hist = animate.render(anim, cfg, settings, hist, *animate.frame_times(f))
        f += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    wall, refit, per_frame = [], [], []
    for _ in range(ANIM_FRAMES):
        t, t_prev = animate.frame_times(f)
        before = {k: count_of(m) for k, m in counters.items()}
        torch.cuda.synchronize()
        a = time.perf_counter()
        out, hist = animate.render(anim, cfg, settings, hist, t, t_prev)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - a) * 1e3)
        per_frame.append({k: count_of(m) - before[k] for k, m in counters.items()})
        refit.append(once_ms(lambda: animate.pose(anim, t))[0])
        f += 1
    peak = torch.cuda.max_memory_allocated(dev)
    for k, m in counters.items():
        launches[k] = launches.get(k, 0) + count_of(m)
    t, t_prev = animate.frame_times(f)
    busy, n_kernels, by_name = device_profile(
        lambda: animate.render(anim, cfg, settings, hist, t, t_prev))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    pk = [v for k, v in by_name.items() if "packet" in k]
    packet_ms, packet_n = sum(v[0] for v in pk), sum(v[1] for v in pk)
    lum = float(color.luminance(out["color"]).mean())
    world, ctx2, _ = animate.pose(anim, t)
    print(f"[animate] {ANIM_CUBES} cubes, {len(anim.ctx.order)} triangles in "
          f"{ctx2.clusters.count} clusters, {cfg.width}x{cfg.height} RELAX, set up in "
          f"{setup_s:.1f} s: wall ms/frame over {ANIM_FRAMES} frames after {ANIM_WARMUP} warm-up "
          + ", ".join(f"{x:.3f}" for x in wall)
          + f" (median {statistics.median(wall):.3f}); transform + refit ms "
          + ", ".join(f"{x:.3f}" for x in refit)
          + f"; one more frame: device busy {busy:.3f} ms in {n_kernels} kernels, the packet "
          f"kernel {packet_ms:.3f} ms over {packet_n} launches, idle share "
          f"{1.0 - busy / statistics.median(wall):.3f}; peak memory {peak} B, mean luminance "
          f"{lum:.6g}, launches/frame {per_frame[-1]} ({card})")
    print("[animate] the frame's largest kernels (device ms, launches): "
          + "; ".join(f"{k[:60]} {v[0]:.3f} x{v[1]}" for k, v in top))
    if not bool(torch.isfinite(out["color"]).all()) or not lum > 0.0:
        fail("the animated frame is not finite with a positive mean luminance")
    need = ("packet_hit", "bilinear_sample", "relax_taccum", "relax_atrous")
    if not all(p[k] > 0 for p in per_frame for k in need):
        fail(f"an animated frame did not launch all of {need}: {per_frame}")
    if torch.equal(ctx2.clusters.bounds_min, cs0.bounds_min) or ctx2.clusters.slab.device != dev:
        fail("the refit left the cluster boxes at the rest pose, or off the card")
    mv = out["gbuffer"]["mv"]
    moving = int((mv[:, :2].abs().amax(dim=-1) > 1e-3).sum())
    if moving == 0:
        fail("no pixel of the animated frame moves")
    summary["A"] = dict(wall=wall, refit=refit, busy=busy, kernels=n_kernels,
                        packet=(packet_ms, packet_n), peak=peak, launches=per_frame[-1],
                        moving=moving)

    # every kernel call of one animated frame against its plain version
    specs = {"packet_hit": (packet, "closest_hit_packet_cuda", keep_rays),
             "bilinear_sample": (reproject, "sample_bilinear_cuda", keep_planes),
             "relax_taccum": (taccum_cuda, "taccum_variance_cuda", keep_planes),
             "relax_atrous": (atrous_cuda, "atrous_iteration_cuda", keep_planes),
             "taa_resolve": (taa_cuda, "taa_resolve_cuda", keep_planes)}
    need_rec = tuple(k for k in specs if per_frame[-1].get(k, 0) > 0)
    m_prev = animate.transforms(anim.pool, t_prev)
    with recording({k: specs[k] for k in need_rec}) as calls:
        before = {k: count_of(counters[k]) for k in need_rec}
        frame.render_frame(ctx2, world, anim.cam, cfg, settings, hist,
                           dynamics=(anim.inst, animate.transforms(anim.pool, t), m_prev))
        recorded = {k: count_of(counters[k]) - before[k] for k in need_rec}
    torch.cuda.synchronize()
    summary["errs"] = check_frame_calls(calls, recorded, ctx2.clusters, world, card,
                                        label="animated")
    del calls, out, hist, world, ctx2
    torch.cuda.empty_cache()

    # (B) DRS over a fixed bucket schedule
    cur = drs.bucket_cfg(cfg, DRS_SCHEDULE[0])
    hist = frame.History.create(cur, dev)
    steps = []
    for i, scale in enumerate(DRS_SCHEDULE):
        nxt = drs.bucket_cfg(cfg, scale)
        resize_ms = 0.0
        if nxt != cur:
            resize_ms, hist = once_ms(lambda: drs.resize_history(hist, cur, nxt))
            cur = nxt
        torch.cuda.synchronize()
        a = time.perf_counter()
        out, hist = animate.render(anim, cur, settings, hist, *animate.frame_times(i))
        torch.cuda.synchronize()
        disp = out["display"]
        steps.append((cur.width, cur.height, (time.perf_counter() - a) * 1e3, resize_ms))
        if tuple(disp.shape) != (ANIM_H, ANIM_W, 3) or not bool(torch.isfinite(disp).all()):
            fail(f"DRS frame {i} at {cur.width}x{cur.height}: the display is not a finite "
                 f"{ANIM_W}x{ANIM_H} image")
    print(f"[animate DRS] schedule {DRS_SCHEDULE}: frames (render size, wall ms, history "
          f"resize ms) " + "; ".join(f"{w}x{h} {ms:.3f} {r:.3f}" for w, h, ms, r in steps)
          + f"; frame_index {int(hist.frame_index)}, display {tuple(disp.shape)} ({card})")
    if int(hist.frame_index) != len(DRS_SCHEDULE) or hist.relax_diff.illum.device != dev:
        fail("the DRS run's history lost frames or left the card")
    summary["B"] = steps
    del anim, hist, out, disp
    torch.cuda.empty_cache()

    # (C) the CLI as a user runs it
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "animate.png")
        a = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "nrdsample_tpu_torch.cli", *CLI_ANIMATE,
                            "--out", png], cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - a
        print(f"[animate] python -m nrdsample_tpu_torch.cli {' '.join(CLI_ANIMATE)}: rc "
              f"{r.returncode} in {cli_s:.1f} s; " + " | ".join(
                  (r.stderr.strip().splitlines() or [""])[-1:] + r.stdout.strip().splitlines()))
        if r.returncode != 0 or not os.path.exists(png) or png_size(png) != (256, 256):
            fail(f"cli animate failed or wrote no 256x256 PNG: {r.stderr[-2000:]}")
    summary["C"] = cli_s

    # (D) card against CPU at a small size
    res, cubes, frames = ANIM_SMALL["res"], ANIM_SMALL["cubes"], ANIM_SMALL["frames"]
    outs, hists = {}, {}
    small = animate.render_config(res)
    for where in (dev, "cpu"):
        an = animate.build(cubes, where)
        st = adaptive.update(make_settings(where, sun_elevation=animate.SUN_ELEVATION), None,
                             adaptive.FrameTimer().smoothed_ms)
        h = frame.History.create(small, where)
        for i in range(frames):
            o, h = animate.render(an, small, st, h, *animate.frame_times(i))
        outs[where], hists[where] = dict({k: o[k] for k in RECORD_PLANES},
                                         mv=o["gbuffer"]["mv"]), h
    worst = max((*frame_mismatch(outs["cpu"][k], outs[dev][k]), k) for k in outs["cpu"])
    rel = max(frame_mismatch(outs["cpu"][k], outs[dev][k])[1] for k in ("color", "final"))
    # the resampling from one input: the CPU's history after 3 frames
    half = drs.bucket_cfg(small, 0.5)
    want = drs.resize_history(hists["cpu"], small, half)
    got = drs.resize_history(to_device(hists["cpu"], dev), small, half)
    errs = []
    for k in ("relax_diff", "relax_spec", "sigma"):
        for fld in dataclasses.fields(getattr(want, k)):
            e, ok = max_err(getattr(getattr(got, k), fld.name).cpu().float(),
                            getattr(getattr(want, k), fld.name).float())
            errs.append(e)
            if not ok:
                fail(f"the card's resized history differs from the CPU's ({k}.{fld.name})")
    print(f"[card vs cpu] animate at {res}x{res}, {cubes} cubes, {frames} frames: worst outlier "
          f"share {worst[0]:.6f} ({worst[2]}), color and final mean gap {rel:.3g} (rel); the "
          f"history resized to {half.width}x{half.height} from the CPU's: max|err| "
          f"{max(errs):.3g}")
    if worst[0] > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
        fail("the card's animated frame disagrees with the CPU frame")
    summary["D"] = (worst, rel, max(errs))
    return summary


PIXEL_RES = 64    # shaderballs512's REBLUR config, traced and differentiated card against CPU


def check_reblur_pixel(dev, card: str) -> dict:
    """Where the card's and the CPU's traces of shaderballs512's REBLUR
    config at 64x64 part. Every ``traversal.closest_hit`` and ``any_hit``
    call of one trace_frame is recorded on both devices, in order. For each
    call: the rays whose inputs (origin, direction, t_max) differ in any
    bit between the two, and the rays whose result differs (tri, or
    blocked) split into those with bit-equal inputs, each of which must be
    a tie proven in float64 (``t64``: both triangles' distances within
    1e-6 relative; else the packet kernel is at fault and this fails), and
    those whose inputs already differ. The resident kernel's calls are also
    held against the plain scan on the card's own inputs
    (``check_frame_calls``)."""
    from nrdsample_tpu_torch.ops import packet, traversal
    from nrdsample_tpu_torch.pipeline import bench_configs, frame

    def keep(i, a, out):
        n = a["origin"].shape[0]
        tm = torch.as_tensor(a["t_max"], dtype=torch.float32, device=a["origin"].device)
        return dict(o=a["origin"].detach().cpu(), d=a["direction"].detach().cpu(),
                    t_max=tm.expand(n).cpu(),
                    out=({k: v.cpu() for k, v in out.items()} if isinstance(out, dict)
                         else out.cpu()))

    rec, pk_calls = {}, None
    for where in ("cpu", dev):
        ctx, scene, cam, cfg, settings = bench_configs.setup(
            "shaderballs512", where, width=PIXEL_RES, height=PIXEL_RES)
        specs = {"closest_hit": (traversal, "closest_hit", keep),
                 "any_hit": (traversal, "any_hit", keep)}
        if where != "cpu":
            specs["packet_hit"] = (packet, "closest_hit_packet_cuda", keep_rays)
        with recording(specs) as calls:
            before = packet.LAUNCHES
            gb, _ = frame.trace_frame(ctx, scene, cam, cfg, settings,
                                      frame.History.create(cfg, where))
            n_launch = packet.LAUNCHES - before
        rec[where] = (calls, {k: v.cpu() for k, v in gb.items() if torch.is_tensor(v)})
        if where != "cpu":
            pk_calls = calls.pop("packet_hit")
            torch.cuda.synchronize()
            errs = check_frame_calls({"packet_hit": pk_calls}, {"packet_hit": n_launch},
                                     ctx.clusters, scene, card, label="shaderballs512 at 64x64")
            tris = {k: getattr(scene.tris, k).cpu().numpy() for k in ("p0", "e1", "e2")}
    cpu_calls, cpu_gb = rec["cpu"]
    dev_calls, dev_gb = rec[dev]
    lines, faults, tie_rays, input_rays = [], 0, 0, 0
    for name in ("closest_hit", "any_hit"):
        if len(cpu_calls[name]) != len(dev_calls[name]):
            fail(f"the CPU made {len(cpu_calls[name])} {name} calls, the card "
                 f"{len(dev_calls[name])}")
        for i, (a, b) in enumerate(zip(cpu_calls[name], dev_calls[name])):
            same_in = ((a["o"] == b["o"]).all(-1) & (a["d"] == b["d"]).all(-1)
                       & (a["t_max"] == b["t_max"]))
            if name == "closest_hit":
                differ = a["out"]["tri"] != b["out"]["tri"]
            else:
                differ = a["out"] != b["out"]
            eq_diff = torch.nonzero(differ & same_in).flatten().numpy()
            ties = 0
            for j in eq_diff:
                if name != "closest_hit":
                    faults += 1
                    continue
                ta = t64(a["o"][j].numpy(), a["d"][j].numpy(), tris, int(a["out"]["tri"][j]))
                tb = t64(a["o"][j].numpy(), a["d"][j].numpy(), tris, int(b["out"]["tri"][j]))
                tie = (a["out"]["tri"][j] >= 0 and b["out"]["tri"][j] >= 0
                       and abs(ta - tb) <= 1e-6 * max(abs(tb), 1.0))
                ties += tie
                faults += not tie
            tie_rays += ties
            input_rays += int((differ & ~same_in).sum())
            lines.append(f"{name} #{i} N={a['o'].shape[0]}: inputs differ on "
                         f"{int((~same_in).sum())}, results differ on {int(differ.sum())} "
                         f"({len(eq_diff)} with equal inputs, {ties} of them float64 ties)")
    px = {}
    for k in ("view_z", "normal", "roughness", "spec_hitdist", "diff_hitdist"):
        if k in cpu_gb and k in dev_gb:
            ref, got = cpu_gb[k].reshape(cpu_gb[k].shape[0], -1), dev_gb[k].reshape(
                dev_gb[k].shape[0], -1)
            bad = torch.nonzero(((ref - got).abs() > 1e-3 * (1.0 + ref.abs())).any(-1)).flatten()
            px[k] = bad.tolist()[:8]
    print("[reblur pixel] shaderballs512 REBLUR at 64x64, trace_frame card against CPU, call by "
          "call: " + "; ".join(lines))
    print(f"[reblur pixel] result differences on bit-equal inputs: {tie_rays} float64 ties, "
          f"{faults} not ties; on inputs that already differ: {input_rays}; G-buffer pixels off "
          f"by more than 1e-3 (1 + |ref|): {px} ({card})")
    if faults:
        fail(f"{faults} rays with bit-equal inputs hit other triangles on the card than on the "
             "CPU, and no float64 tie explains it: a packet kernel fault")
    return dict(ties=tie_rays, input_rays=input_rays, pixels=px, errs=errs)


def check_reblur_gradient(dev, card: str) -> dict:
    """shaderballs512's REBLUR config at PIXEL_RES x PIXEL_RES: one step's
    material gradients card against CPU, every field within GRAD_TOL of its
    largest |CPU entry|, as phase 8's (D); fails otherwise. Returns each
    field's largest gap over its largest |CPU entry|."""
    from nrdsample_tpu_torch.pipeline import bench_configs, frame, train

    grads = {}
    for where in ("cpu", dev):
        ctx, scene, cam, cfg, settings = bench_configs.setup(
            "shaderballs512", where, width=PIXEL_RES, height=PIXEL_RES)
        diff, rest = train.split_materials(scene.materials)
        grads[where] = {k: g.cpu() for k, g in train.value_and_grad(
            train.make_loss_fn(ctx, cfg), diff, rest, scene, cam, settings,
            frame.History.create(cfg, where),
            torch.zeros((cfg.n_pixels, 3), device=where))[1].items()}
    rel = {}
    for k, want in grads["cpu"].items():
        got = grads[dev][k]
        scale = float(want.abs().max())
        gap = float((got - want).abs().max())
        rel[k] = gap / scale if scale > 0.0 else gap
        if not bool(torch.isfinite(got).all()) or gap > GRAD_TOL * scale:
            fail(f"shaderballs512 REBLUR at {PIXEL_RES}x{PIXEL_RES}: the card's {k} gradient is "
                 f"{gap:.4g} off the CPU's (largest |CPU entry| {scale:.4g})")
    print(f"[reblur gradient] shaderballs512 REBLUR at {PIXEL_RES}x{PIXEL_RES}, card against CPU "
          "gradients, largest gap over the field's largest |CPU entry| (gate "
          f"{GRAD_TOL:g}): " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()) + f" ({card})")
    return rel


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", metavar="DIR",
                    help="a parent tree's csrc directory (`git archive <commit> "
                         "nrdsample_tpu_torch/csrc`): its resident kernel is timed beside this "
                         "tree's on shaderballs512, its streaming kernel and gather on "
                         "exterior720 and the gather shapes, its RELAX taccum, RELAX à-trous and "
                         "TAA resolve on the (1080, 1920) planes; the streaming kernel and gather "
                         "must give identical results, the denoiser kernels equal ones within the "
                         "kernel limit "
                         "(without it, the streaming kernel's times are quoted from PERF.md)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, make_settings
    from nrdsample_tpu_torch.denoise import atrous_cuda, relax, taa, taa_cuda, taccum_cuda
    from nrdsample_tpu_torch.mathlib import color, filtering
    from nrdsample_tpu_torch.ops import (_kernels, cluster, dense_cuda, emissive_probe, intersect,
                                         packet, reproject, traversal)
    from nrdsample_tpu_torch.pipeline import bench_configs, frame, records
    from nrdsample_tpu_torch.render import emissive_is
    from nrdsample_tpu_torch.scene import camera, procedural
    from nrdsample_tpu_torch.scene.types import look_at

    counters = (dense_cuda, emissive_probe, packet, reproject, taccum_cuda, atrous_cuda, taa_cuda)

    def reset_counts():
        for m in counters:
            m.LAUNCHES = 0
        packet.STREAM_LAUNCHES = 0

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"gpu: {card}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.load()
    print(f"[build] {os.path.relpath(lib_path, REPO)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_kernels.BUILD_SECONDS if _kernels.BUILD_SECONDS is not None else 'cached'})")
    old_lib = build_old_lib(args.old_csrc) if args.old_csrc else None

    # ---- 2. cluster main path at real size: shaderballs512 (REBLUR + SIGMA) ----
    # timed first, before the kernel checks and the other configurations, and
    # again at the end (phase 7) in the same process: the host-bound frame's
    # wall time spreads widely between processes, and the pair shows whether
    # the phases between them move it
    ctx, scene, cam, cfg, settings = bench_configs.setup("shaderballs512", dev)

    def shaderballs_frames():
        """(ms/frame of SB_FRAMES frames after 2 warm-up, the host's ms between the
        returns of successive render_frame calls (no synchronisation between
        them), last outputs, history, (packet_hit, bilinear_sample) launches
        of each timed frame)."""
        hist = frame.History.create(cfg, dev)
        for _ in range(2):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        per_frame = []
        reset_counts()
        stamps = [time.perf_counter()]
        for _ in range(SB_FRAMES):
            before = (packet.LAUNCHES, reproject.LAUNCHES)
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
            per_frame.append((packet.LAUNCHES - before[0], reproject.LAUNCHES - before[1]))
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        host = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        return (time.perf_counter() - stamps[0]) * 1e3 / SB_FRAMES, host, out, hist, per_frame

    def spread(host) -> str:
        return "host ms per frame min {:.3f} median {:.3f} max {:.3f}".format(
            min(host), statistics.median(host), max(host))

    sb_ms, host, out, hist, per_frame = shaderballs_frames()
    launches = {"packet_hit": packet.LAUNCHES, "bilinear_sample": reproject.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    img = out["color"]
    lum = float(color.luminance(img).mean())
    rays_per_px = bench_configs.rays_per_pixel(cfg)
    frames_max = float(hist.reblur_diff.frames.max())
    print(f"[shaderballs512] {sb_ms:.3f} ms/frame over {SB_FRAMES} frames after 2 warm-up, "
          f"{rays_per_px * cfg.n_pixels / (sb_ms * 1e-3):.4g} rays/s ({rays_per_px} rays/px), "
          f"peak memory {peak} B, mean luminance {lum:.6g}, launches/frame (packet_hit, "
          f"bilinear_sample) {per_frame[0]}, REBLUR frames max {frames_max:.3f} "
          f"at frame {int(hist.frame_index)}, {spread(host)} ({card})")
    if tuple(img.shape) != (cfg.n_pixels, 3) or not bool(torch.isfinite(img).all()) or not lum > 0.0:
        fail("shaderballs512 image is not finite with a positive mean luminance")
    if not all(ph > 0 and bl > 0 for ph, bl in per_frame):
        fail(f"a frame did not launch both kernels: per-frame launches {per_frame}")
    if int(hist.frame_index) != SB_FRAMES + 2 or not frames_max > 1.0:
        fail("the REBLUR history did not advance")
    del out, img, hist

    # ---- 3. each kernel against its plain version, main-path shapes ----
    cornell = procedural.cornell_box().to(dev)
    kitchen = procedural.kitchen().to(dev)
    o, d = seeded_rays(RAYS_2X1080P, 0, dev)
    bounded = torch.from_numpy(
        np.random.RandomState(1).uniform(0.5, 4.0, RAYS_2X1080P).astype(np.float32)).to(dev)
    results = {}
    for name, sc in (("cornell", cornell), ("kitchen", kitchen)):
        tr = sc.tris
        for tm_name, tm in (("scalar", traversal.T_MAX), ("per-ray", bounded)):
            got = dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, o, d, tm)
            ref = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, tm)
            torch.cuda.synchronize()
            tri_bad = int((got["tri"] != ref["tri"]).sum())
            errs = [max_err(got[k], ref[k]) for k in "tuv"]
            err = max(e for e, _ in errs)
            ms = graph_ms(lambda: dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, o, d, tm))
            plain_ms = median_ms(lambda: intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, tm))
            hits = int((ref["tri"] >= 0).sum())
            bnd = bound_ms(RAYS_2X1080P * (24 + (4 if tm_name == "per-ray" else 0) + 16)
                           + tr.count * 36, RAYS_2X1080P * tr.count * MT_OPS["dense_hit"])
            print(f"[dense_hit] {name} E={tr.count} N={RAYS_2X1080P} t_max={tm_name}: hits {hits} "
                  f"tri mismatches {tri_bad} max|err| t/u/v {err:.3g} | kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) ({card})")
            if tri_bad or not all(ok for _, ok in errs) or hits == 0:
                fail(f"dense hit kernel disagrees with its plain version ({name}, {tm_name})")
            results[("dense", name, tm_name)] = (err, ms, plain_ms, bnd)
    em = emissive_is.build_emissive_set(kitchen)
    po, pd = seeded_rays(PROBE_RAYS, 2, dev)
    got = emissive_probe.light_probe_cuda(em, po, pd)
    ref = emissive_probe.light_probe_plain(em, po, pd)
    torch.cuda.synchronize()
    probe_err, probe_ok = max_err(got, ref)
    lit = int((ref > 0).sum())
    probe_ms = graph_ms(lambda: emissive_probe.light_probe_cuda(em, po, pd))
    probe_plain_ms = median_ms(lambda: emissive_probe.light_probe_plain(em, po, pd))
    n_em = em["p0"].shape[0]
    probe_bound = bound_ms(PROBE_RAYS * (24 + 4) + n_em * 40,
                           PROBE_RAYS * n_em * MT_OPS["emissive_probe"])
    print(f"[emissive_probe] kitchen E={n_em} N={PROBE_RAYS}: lit {lit} "
          f"max|err| {probe_err:.3g} | kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms, "
          f"bound {probe_bound[0]:.3f} ms ({probe_bound[1]}) ({card})")
    if not probe_ok or lit == 0:
        fail("emissive probe kernel disagrees with its plain version")
    del o, d, bounded, po, pd, got, ref

    # the resident packet kernel on shaderballs512's scene (104 clusters): its
    # coherent camera rays, a divergent shadow-sized set with per-ray t_max
    # (re-binned by morton order, as the frame does), and the any-hit mode on
    # that set, each held against the plain scan on every ray; ctx, scene,
    # cam and cfg are still shaderballs512's of phase 2
    cs = ctx.clusters
    tris = {k: getattr(scene.tris, k).cpu().numpy() for k in ("p0", "e1", "e2")}
    pix = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    co, cd, _ = camera.camera_rays(cam, cfg.width, cfg.height, pix, torch.tensor(0, device=dev))
    co, cd = co.contiguous(), cd.contiguous()
    ctm = torch.full((cfg.n_pixels,), traversal.T_MAX, device=dev)
    rs = np.random.RandomState(3)
    vo = torch.from_numpy(rs.uniform([-4.0, -4.0, 0.02], [4.0, 4.0, 3.0],
                                     (DIVERGENT_RAYS, 3)).astype(np.float32)).to(dev)
    vd = rs.randn(DIVERGENT_RAYS, 3).astype(np.float32)
    vd = torch.from_numpy(vd / np.linalg.norm(vd, axis=-1, keepdims=True)).to(dev)
    vtm = torch.from_numpy(np.where(rs.uniform(size=DIVERGENT_RAYS) < 0.5, traversal.T_MAX,
                                    rs.uniform(0.5, 20.0, DIVERGENT_RAYS)).astype(np.float32)).to(dev)
    packet_res = {}
    for case, (ro, rd, rtm, sort, any_hit) in {
        "primary": (co, cd, ctm, False, False),
        "divergent": (vo, vd, vtm, True, False),
        "any_hit": (vo, vd, vtm, True, True),
    }.items():
        n = ro.shape[0]
        got = packet.closest_hit_packet_cuda(cs, ro, rd, rtm, sort=sort, any_hit=any_hit)
        torch.cuda.synchronize()
        if any_hit:
            plain_ms, ref = once_ms(lambda: cluster.any_hit_clustered(cs, ro, rd, rtm))
            blocked = (got["tri"] >= 0) & (got["t"] < rtm)
            tri_bad, err, ok = int((blocked != ref).sum()), 0.0, bool(torch.equal(blocked, ref))
            hits = int(ref.sum())
        else:
            plain_ms, ref = once_ms(lambda: cluster.closest_hit_clustered(cs, ro, rd, rtm))
            tri_bad, err, ok = compare_hits(got, ref, ro, rd, tris)
            hits = int((ref["tri"] >= 0).sum())
        # the kernel alone on stage 1's worklists of the rays in packet order;
        # with need_uv=False the same t and tri and zero u/v
        perm = (torch.sort(packet._morton_sort_keys(ro, rd, cs), stable=True).indices if sort
                else torch.arange(n, device=dev))
        ko, kd, ktm = ro[perm].contiguous(), rd[perm].contiguous(), rtm[perm].contiguous()
        order, keys = packet.worklists(ko, kd, cs, ktm)
        res = packet.launch(cs, ko, kd, ktm, order, keys, any_hit)
        no_uv = packet.launch(cs, ko, kd, ktm, order, keys, any_hit, need_uv=False)
        torch.cuda.synchronize()
        uv_ok = (torch.equal(no_uv["t"], res["t"]) and torch.equal(no_uv["tri"], res["tri"])
                 and not bool(no_uv["u"].any()) and not bool(no_uv["v"].any()))
        ms = graph_ms(lambda: packet.launch(cs, ko, kd, ktm, order, keys, any_hit))
        no_uv_ms = graph_ms(lambda: packet.launch(cs, ko, kd, ktm, order, keys, any_hit,
                                                  need_uv=False))
        stage1_ms = median_ms(lambda: packet.worklists(ko, kd, cs, ktm))
        tests = packet_tests_needed(cs, ro, rd, rtm, got, any_hit)
        walk = packet_walk_tests(keys, res["t"], packet.BLOCK_RAYS)
        warp_lb = warp_walk_tests(cs, ko, kd, ktm, res, any_hit)
        bnd = bound_ms(n * (28 + 16) + order.numel() * 8 + cs.slab.numel() * 4,
                       tests * MT_OPS["packet"])
        old = "the parent's build not measured in this call"
        old_ms = None
        if old_lib is not None:
            prev = launch_old(old_lib, "nrd_packet_hit", cs, ko, kd, ktm, order, keys, any_hit,
                              True)
            torch.cuda.synchronize()
            n_diff = int((prev["tri"] != res["tri"]).sum())
            old_ms = graph_ms(lambda: launch_old(old_lib, "nrd_packet_hit", cs, ko, kd, ktm, order,
                                                 keys, any_hit, True))
            old = (f"the parent's build {old_ms:.3f} ms (built from its source, this call; "
                   f"{ms / old_ms:.3f}x its time; tri differs on {n_diff} rays)")
            del prev
        print(f"[packet_hit] {case} C={cs.count} N={n} sort={sort} any_hit={any_hit}: "
              f"{'blocked' if any_hit else 'hits'} {hits} of {n} checked, tri (or blocked) "
              f"differences {tri_bad} (float64-proven ties allowed), max|err| t/u/v {err:.3g}, "
              f"need_uv=False {'same t and tri, zero u/v' if uv_ok else 'DIFFERS'} | kernel "
              f"{ms:.3f} ms at N={n} (need_uv=False {no_uv_ms:.3f} ms; stage 1 {stage1_ms:.3f} "
              f"ms), {old}, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, {tests} "
              f"tests needed; the warp walk makes at least {warp_lb}, the packet walk {walk}) "
              f"({card})")
        if not ok or hits == 0:
            fail(f"packet kernel disagrees with its plain version ({case})")
        if not uv_ok:
            fail(f"packet kernel with need_uv=False differs ({case})")
        packet_res[case] = (err, ms, plain_ms, bnd, n, old_ms)
    del vo, vd, vtm, got, ref, ko, kd, ktm, order, keys, res, no_uv

    # bilinear gather kernel at the frame's gather shapes (SIGMA's (512, 512, 3)
    # and REBLUR's packed (512, 512, 9)), small and large motion, off-screen
    centers = torch.stack(torch.meshgrid(torch.arange(512, device=dev) + 0.5,
                                         torch.arange(512, device=dev) + 0.5, indexing="xy"), -1)
    g = torch.Generator(device="cpu").manual_seed(4)
    bil_res = {}
    for c in (3, 9):
        img = torch.rand((512, 512, c), generator=g).to(dev)
        for disp in ("3", "20", "off-screen"):
            jitter = (torch.rand((512, 512, 2), generator=g).to(dev) - 0.5) * 2.0
            pos = centers + (jitter * float(disp) if disp != "off-screen"
                             else jitter * 40.0 + torch.sign(jitter) * 520.0)
            pos = pos.contiguous()
            got = reproject.sample_bilinear_cuda(img, pos)
            ref = filtering.sample_bilinear(img, pos)
            torch.cuda.synchronize()
            err, ok = max_err(got, ref)
            equal = torch.equal(got, ref)
            plain_ms = median_ms(lambda: filtering.sample_bilinear(img, pos))
            # the library yardstick: one grid_sample call on the same inputs
            # (border padding, pixel centres at (i + 0.5) / size * 2 - 1)
            nchw = img.permute(2, 0, 1)[None].contiguous()
            grid = (pos / 512.0 * 2.0 - 1.0)[None].contiguous()

            def lib():
                return torch.nn.functional.grid_sample(nchw, grid, mode="bilinear",
                                                       padding_mode="border", align_corners=False)

            def kernel():
                return reproject.sample_bilinear_cuda(img, pos)

            lib_err = float((lib()[0].permute(1, 2, 0) - ref).abs().max())
            # ~10-µs kernels: 200 replays per timing, so that the window is not
            # a few launches' jitter, and GATHER_ROUNDS timings of each,
            # alternating, compared by their medians
            rounds = [(graph_ms(kernel, reps=GATHER_REPS), graph_ms(lib, reps=GATHER_REPS))
                      for _ in range(GATHER_ROUNDS)]
            ms = statistics.median(k for k, _ in rounds)
            lib_ms = statistics.median(v for _, v in rounds)
            wins = sum(k <= v for k, v in rounds)
            old = ""
            if old_lib is not None:
                def previous():
                    o = torch.empty_like(ref)
                    _kernels.check(old_lib.nrd_bilinear_sample(
                        img.data_ptr(), 512, 512, c, pos.data_ptr(), pos.numel() // 2,
                        o.data_ptr(), torch.cuda.current_stream().cuda_stream), "parent bilinear")
                    return o

                same_old = torch.equal(previous(), got)
                old = (f", the parent's build {graph_ms(previous, reps=GATHER_REPS):.4f} ms "
                       f"(built from its source, this call; "
                       f"{'bit-equal' if same_old else 'NOT bit-equal'})")
                if not same_old:
                    fail(f"the bilinear kernel's results changed from the parent's build (C={c}, "
                         f"{disp})")
            bnd = bound_ms(img.numel() * 4 + pos.numel() * 4 + got.numel() * 4, got.numel() * 10)
            print(f"[bilinear] (512, 512, {c}) displacement {disp} px: max|err| {err:.3g} "
                  f"({'bit-equal' if equal else 'NOT bit-equal'}) | kernel {ms:.4f} ms "
                  f"({bnd[0] / ms:.1%} of its bound; median "
                  f"{'at or below' if ms <= lib_ms else 'ABOVE'} grid_sample's, at or below it "
                  f"in {wins} of {GATHER_ROUNDS} rounds){old}, plain "
                  f"{plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms (its max|diff| {lib_err:.3g}), "
                  f"rounds (kernel, grid_sample) "
                  f"{', '.join(f'({k:.4f}, {v:.4f})' for k, v in rounds)}, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}) ({card})")
            if not ok or not equal:
                fail(f"bilinear kernel disagrees with its plain version (C={c}, {disp})")
            bil_res[(c, disp)] = (err, ms, plain_ms, lib_ms, bnd)

    # RELAX taccum, RELAX à-trous and TAA resolve at kitchen1080's (1080, 1920)
    # planes: smooth depth with 0.5% history noise, normals near +z, motion
    # below 3 px, of 20 px and off screen, a confidence plane and a reset
    kh, kw = 1080, 1920
    n_px = kh * kw
    g = torch.Generator(device="cpu").manual_seed(5)

    def rand(*shape, hi=1.0):
        return (torch.rand(shape, generator=g) * hi).to(dev)

    yy, xx = torch.meshgrid(torch.arange(kh, device=dev, dtype=torch.float32),
                            torch.arange(kw, device=dev, dtype=torch.float32), indexing="ij")
    vz = 3.0 + 0.2 * torch.sin(xx / 300.0) + 0.2 * torch.cos(yy / 200.0)
    nrm = torch.randn((kh, kw, 3), generator=g) * 0.3 + torch.tensor([0.0, 0.0, 1.0])
    nrm = (nrm / nrm.norm(dim=-1, keepdim=True)).to(dev)
    rhist = relax.RelaxHistory(
        illum=rand(kh, kw, 3, hi=2.0), moments=rand(kh, kw, 2),
        view_z=vz * (1.0 + (torch.randn((kh, kw), generator=g) * 0.005).to(dev)),
        normal=nrm, frames=rand(kh, kw, hi=20.0))
    illum = rand(kh, kw, 3, hi=3.0)
    conf = rand(kh, kw)

    def motion(scale: float, off: float = 0.0):
        """(H, W, 3): xy uniform in +-scale px (pushed off by +-off), z in
        +-0.01."""
        m = torch.rand((kh, kw, 3), generator=g) * 2.0 - 1.0
        m[..., :2] = m[..., :2] * scale + torch.sign(m[..., :2]) * off
        m[..., 2] *= 0.01
        return m.to(dev)

    rset = relax.RelaxSettings(max_accumulated_frames=torch.tensor(31.0, device=dev))
    taccum_res = {}
    # the reset case passes its flag as a 0-d device tensor: a host bool would
    # be copied to the card inside the graph capture
    for case, (mv_c, conf_c, reset_c) in {
        "motion < 3 px": (motion(2.5), None, False),
        "motion 20 px": (motion(20.0), None, False),
        "off-screen": (motion(40.0, 2000.0), None, False),
        "confidence": (motion(2.5), conf, False),
        "reset": (motion(2.5), conf, torch.tensor(True, device=dev)),
    }.items():
        def kernel():
            return taccum_cuda.taccum_variance_cuda(
                rhist.illum, rhist.moments, rhist.view_z, rhist.normal, rhist.frames, illum, vz,
                nrm, mv_c, rset.max_accumulated_frames, rset.disocclusion_threshold, True,
                reset=reset_c, confidence=conf_c)

        def plain():
            return relax.taccum_plain(rhist, illum, vz, nrm, mv_c, rset, reset_c, conf_c)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, ref)]
        err = max(e for e, _ in errs)
        accumulated = int((ref[2] > 1.0).sum())
        ms = graph_ms(kernel)
        old_ms, same = time_parent(old_lib, kernel, got)
        plain_ms = median_ms(plain, reps=5)
        n_planes = 10 + 10 + (1 if conf_c is not None else 0) + 7
        bnd = bound_ms(n_px * n_planes * 4, n_px * TACCUM_OPS)
        print(f"[relax_taccum] (1080, 1920) {case}: accumulated pixels {accumulated} max|err| "
              f"{err:.3g} | kernel {ms:.4f} ms, parent's {parent_ms(old_ms, ms)}, plain "
              f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) ({card})")
        keeps_history = case not in ("off-screen", "reset")
        if not all(ok for _, ok in errs) or keeps_history != (accumulated > 0):
            fail(f"RELAX taccum kernel disagrees with its plain version ({case})")
        if not same:
            fail(f"the parent's RELAX taccum kernel disagrees with this tree's ({case})")
        taccum_res[case] = (err, ms, plain_ms, bnd, old_ms)

    atrous_res = {}
    avar = rand(kh, kw, hi=0.5)
    for step in (1, 2, 4, 8, 16):
        def kernel():
            return atrous_cuda.atrous_iteration_cuda(illum, avar, vz, nrm, step, rset.phi_luminance,
                                                     rset.phi_normal, rset.phi_depth)

        def plain():
            return relax.atrous_iteration(illum, avar, vz, nrm, step, rset)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        errs = [max_err(a, b) for a, b in zip(got, ref)]
        err = max(e for e, _ in errs)
        ms = graph_ms(kernel)
        old_ms, same = time_parent(old_lib, kernel, got)
        plain_ms = median_ms(plain, reps=5)
        bnd = bound_ms(n_px * (8 + 4) * 4, n_px * ATROUS_OPS)
        print(f"[relax_atrous] (1080, 1920) step {step}: max|err| {err:.3g} | kernel {ms:.4f} ms, "
              f"parent's {parent_ms(old_ms, ms)}, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) ({card})")
        if not all(ok for _, ok in errs):
            fail(f"RELAX à-trous kernel disagrees with its plain version (step {step})")
        if not same:
            fail(f"the parent's RELAX à-trous kernel disagrees with this tree's (step {step})")
        atrous_res[step] = (err, ms, plain_ms, bnd, old_ms)

    taa_res = {}
    cur, prev = rand(kh, kw, 3, hi=1.5), rand(kh, kw, 3, hi=1.5)
    mv_d = (rand(kh, kw, 2) * 2.0 - 1.0) * 3.0
    mv_d[:64, :, 0] += 2000.0   # a band of pixels whose history lies off screen
    reset_mix = (rand(kh, kw) > 0.9).to(torch.float32)

    def check_taa(case, wm):
        """The TAA kernel against its plain version (and the parent's build)
        on the (1080, 1920) planes above with the wide mask ``wm``."""
        def kernel():
            return taa_cuda.taa_resolve_cuda(cur, prev, mv_d, wm, reset_mix, 2.0, 0.1)

        def plain():
            return taa.resolve_tail(cur, prev, mv_d, wm, reset_mix, 2.0, 0.1)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = max_err(got, ref)
        ms = graph_ms(kernel)
        old_ms, same = time_parent(old_lib, kernel, got)
        plain_ms = median_ms(plain, reps=5)
        n_wide = int((wm > 0.5).sum()) if wm is not None else 0
        n_lab = taa_lab_pixels(cur, prev, mv_d, wm, reset_mix, 2.0)
        bnd = bound_ms(n_px * ((10 if wm is not None else 9) + 3) * 4,
                       n_px * TAA_OPS + n_wide * TAA_WIDE_EXTRA_OPS + n_lab * TAA_LAB_OPS)
        print(f"[taa_resolve] (1080, 1920) {case} ({n_wide} wide pixels, {n_lab} need the "
              f"CIELAB distance): max|err| {err:.3g} | "
              f"kernel {ms:.4f} ms, parent's {parent_ms(old_ms, ms)}, plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}) ({card})")
        if not ok:
            fail(f"TAA resolve kernel disagrees with its plain version ({case})")
        if not same:
            fail(f"the parent's TAA resolve kernel disagrees with this tree's ({case})")
        taa_res[case] = (err, ms, plain_ms, bnd, old_ms)

    check_taa("random 30% wide mask", (rand(kh, kw) > 0.7).to(torch.float32))
    check_taa("no wide mask", None)

    # the backward of the three denoiser dispatchers on card planes that
    # require grad: the kernel's forward, the plain version's gradient
    for name, counter, dispatch, plain_fn, inputs in (
            ("relax_taccum", taccum_cuda,
             lambda *a: relax.taccum(relax.RelaxHistory(*a[:5]), *a[5:9], rset, False, a[9]),
             lambda *a: relax.taccum_plain(relax.RelaxHistory(*a[:5]), *a[5:9], rset, False,
                                           a[9]),
             (rhist.illum, rhist.moments, rhist.view_z, rhist.normal, rhist.frames, illum, vz,
              nrm, motion(2.5), conf)),
            ("relax_atrous", atrous_cuda, lambda *a: relax.atrous(*a, 4, rset),
             lambda *a: relax.atrous_iteration(*a, 4, rset), (illum, avar, vz, nrm)),
            ("taa_resolve", taa_cuda, lambda *a: taa.resolve(*a, 2.0, 0.1),
             lambda *a: taa.resolve_tail(*a, 2.0, 0.1), (cur, prev, mv_d, None, reset_mix))):
        leaves = [None if t is None else t.detach().clone().requires_grad_() for t in inputs]
        before = counter.LAUNCHES
        got = dispatch(*leaves)
        launched = counter.LAUNCHES - before
        want = plain_fn(*leaves)
        got, want = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
        cts = [torch.randn(o.shape, generator=g).to(dev) for o in want]
        given = [t for t in leaves if t is not None]
        grads = [torch.autograd.grad(o, given, cts, allow_unused=True) for o in (got, want)]
        errs = [max_err(a, b) for a, b in zip(*grads) if a is not None or b is not None]
        same_none = all((a is None) == (b is None) for a, b in zip(*grads))
        print(f"[backward] {name} (1080, 1920), {len(errs)} input gradients: kernel launches "
              f"{launched}, max|err| against the plain version's autograd "
              f"{max(e for e, _ in errs):.3g}")
        if launched != 1 or not same_none or not all(ok for _, ok in errs):
            fail(f"the {name} dispatcher's backward disagrees with the plain version's autograd")
        del leaves, got, want, cts, grads
    del rhist, illum, conf, avar, ref, vz, nrm, xx, yy

    # ---- 4. main path, bench config 1: cornell256 ----
    ctx, scene, cam, cfg, settings = bench_configs.setup("cornell256", dev)
    hist = frame.History.create(cfg, dev)
    out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)   # warm-up
    n_frames = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    rays_per_px = bench_configs.rays_per_pixel(cfg)
    print(f"[cornell256] {ms:.3f} ms/frame, {rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s "
          f"({rays_per_px} rays/px, {n_frames} frames after 1 warm-up; {card})")
    img = out["color"]
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        fail("cornell256 image is not finite and positive")
    del out, img, hist

    # ---- 5. dense main path at real size: kitchen1080 (RELAX + SIGMA, SH,
    # TAA, SHARC, history confidence) ----
    ctx, scene, cam, cfg, settings = bench_configs.setup("kitchen1080", dev)
    hist = frame.History.create(cfg, dev)
    kitchen_counters = {"dense_hit": dense_cuda, "emissive_probe": emissive_probe,
                        "bilinear_sample": reproject, "relax_taccum": taccum_cuda,
                        "relax_atrous": atrous_cuda, "taa_resolve": taa_cuda}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_frame = []
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(KITCHEN_FRAMES):
        before = {k: m.LAUNCHES for k, m in kitchen_counters.items()}
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        per_frame.append({k: m.LAUNCHES - before[k] for k, m in kitchen_counters.items()})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / KITCHEN_FRAMES
    for k, m in kitchen_counters.items():
        launches[k] = launches.get(k, 0) + m.LAUNCHES
    peak = torch.cuda.max_memory_allocated(dev)
    lums = {k: float(color.luminance(out[k]).mean()) for k in ("color", "final")}
    rays_per_px = bench_configs.rays_per_pixel(cfg)
    frames_max = float(hist.relax_diff.frames.max())
    n_keys = int((hist.sharc.keys != 0).sum())
    print(f"[kitchen1080] {ms:.3f} ms/frame over {KITCHEN_FRAMES} frames (first included), "
          f"{rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s ({rays_per_px:.4f} rays/px), "
          f"peak memory {peak} B, mean luminance composed {lums['color']:.6g} TAA "
          f"{lums['final']:.6g}, launches/frame {per_frame[-1]}, RELAX frames max "
          f"{frames_max:.3f}, TAA valid {int(hist.taa.valid)}, SHARC keys {n_keys} of "
          f"{hist.sharc.capacity} ({card})")
    for k in ("color", "final"):
        img = out[k]
        if (tuple(img.shape) != (cfg.n_pixels, 3) or not bool(torch.isfinite(img).all())
                or not lums[k] > 0.0):
            fail(f"kitchen1080 {k} image is not finite with a positive mean luminance")
    if not all(n > 0 for f in per_frame for n in f.values()):
        fail(f"a frame did not launch all six kernels: per-frame launches {per_frame}")
    if not frames_max > 1.0 or int(hist.taa.valid) != 1 or n_keys == 0:
        fail("the RELAX, TAA or SHARC history did not advance")
    # the TAA kernel on the frame's own wide mask (misses, hair, glass), which
    # is coherent where the random one above mixes almost every warp
    check_taa("kitchen1080 frame's wide mask",
              out["taa_wide_mask"].reshape(cfg.height, cfg.width).to(torch.float32))
    del out, img, hist, cur, prev, mv_d, reset_mix

    # ---- 5b. the 1.06M-triangle main path: exterior720 (glass, SHARC FULL,
    # emissive clusters); first the streaming packet kernel on its opaque
    # ClusterSet, then a few frames ----
    t0 = time.perf_counter()
    ctxs, scene, cam, cfg, settings = bench_configs.setup("exterior720", dev)
    cs = ctxs.opaque.clusters
    print(f"[exterior720 setup] {scene.tris.count} triangles (opaque {cs.count} clusters, slab "
          f"{packet.vmem_table_bytes(cs)} B; transparent {ctxs.transparent.clusters.count} "
          f"clusters; emissive {ctxs.opaque.emissive['clusters'].count} clusters of "
          f"{int(scene.emissive_count)} emitters) in {time.perf_counter() - t0:.1f} s")
    tris = {k: getattr(scene.tris, k)[:ctxs.transparent.tri_offset].cpu().numpy()
            for k in ("p0", "e1", "e2")}
    stream_res = check_stream_kernel(cs, tris, cam, cfg, dev, card, old_lib)
    del tris
    hist = frame.History.create(cfg, dev)
    exterior_counters = {"packet_hit_stream": None, "packet_hit": packet,
                         "bilinear_sample": reproject, "relax_taccum": taccum_cuda,
                         "relax_atrous": atrous_cuda, "taa_resolve": taa_cuda,
                         "dense_hit": dense_cuda, "emissive_probe": emissive_probe}

    def count(k):
        m = exterior_counters[k]
        return packet.STREAM_LAUNCHES if m is None else m.LAUNCHES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_frame = []
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(EXTERIOR_FRAMES):
        before = {k: count(k) for k in exterior_counters}
        out, hist = frame.render_frame(ctxs, scene, cam, cfg, settings, hist)
        per_frame.append({k: count(k) - before[k] for k in exterior_counters})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / EXTERIOR_FRAMES
    for k in exterior_counters:
        launches[k] = launches.get(k, 0) + count(k)
    peak = torch.cuda.max_memory_allocated(dev)
    lums = {k: float(color.luminance(out[k]).mean()) for k in ("color", "final")}
    rays_per_px = bench_configs.rays_per_pixel(cfg, has_glass=True)
    n_glass = int(out["glass_mask"].sum())
    n_keys = int((hist.sharc.keys != 0).sum())
    frames_max = float(hist.relax_diff.frames.max())
    print(f"[exterior720] {ms:.3f} ms/frame over {EXTERIOR_FRAMES} frames (first included), "
          f"{rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s ({rays_per_px:.4f} rays/px), "
          f"peak memory {peak} B, mean luminance composed {lums['color']:.6g} TAA "
          f"{lums['final']:.6g}, glass pixels {n_glass}, launches/frame {per_frame[-1]}, RELAX "
          f"frames max {frames_max:.3f}, SHARC keys {n_keys} of {hist.sharc.capacity} ({card})")
    planes = ("color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal")
    for k in planes:
        if not bool(torch.isfinite(out[k]).all()):
            fail(f"exterior720 {k} plane is not finite")
    if not all(lums[k] > 0.0 for k in lums) or n_glass == 0 or n_keys == 0:
        fail("exterior720: no light, no glass pixel or no SHARC key")
    needed = ("packet_hit_stream", "packet_hit", "bilinear_sample", "relax_taccum",
              "relax_atrous", "taa_resolve")
    if not all(f[k] > 0 for f in per_frame for k in needed):
        fail(f"an exterior720 frame did not launch all of {needed}: per-frame launches {per_frame}")
    if not frames_max > 1.0 or int(hist.taa.valid) != 1:
        fail("the exterior720 RELAX or TAA history did not advance")
    exterior = (ms, per_frame[-1])
    del out, hist, ctxs, scene, cs

    # ---- 5c. the fifth configuration at full width: interior1440 (15,494
    # triangles in cluster mode through the resident packet kernel, 24
    # emitters through the probe, RELAX + SIGMA, SHARC with confidence, TAA);
    # first its packet and probe kernels against their plain versions on its
    # own camera rays and probe rays ----
    t0 = time.perf_counter()
    ctx, scene, cam, cfg, settings = bench_configs.setup("interior1440", dev)
    cs = ctx.clusters
    print(f"[interior1440 setup] {len(ctx.order)} triangles ({scene.tris.count} padded) in "
          f"{cs.count} clusters (slab "
          f"{packet.vmem_table_bytes(cs)} B), {int(scene.emissive_count)} emitters, "
          f"{cfg.width}x{cfg.height}, in {time.perf_counter() - t0:.1f} s")
    pix = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    co, cd, _ = camera.camera_rays(cam, cfg.width, cfg.height, pix, torch.tensor(0, device=dev))
    co, cd = co.contiguous(), cd.contiguous()
    ctm = torch.full((cfg.n_pixels,), traversal.T_MAX, device=dev)
    got = packet.closest_hit_packet_cuda(cs, co, cd, ctm)
    sub = torch.from_numpy(np.random.RandomState(9).choice(cfg.n_pixels, PLAIN_SUBSET,
                                                           replace=False)).to(dev)
    ref = cluster.closest_hit_clustered(cs, co[sub], cd[sub], ctm[sub])
    tris = {k: getattr(scene.tris, k).cpu().numpy() for k in ("p0", "e1", "e2")}
    tri_bad, err, ok = compare_hits({k: v[sub] for k, v in got.items()}, ref, co[sub], cd[sub],
                                    tris)
    ms = graph_ms(lambda: packet.closest_hit_packet_cuda(cs, co, cd, ctm))
    print(f"[packet_hit] interior1440 camera C={cs.count} N={cfg.n_pixels}: hits "
          f"{int((got['tri'] >= 0).sum())}, on {PLAIN_SUBSET} rays against the plain scan tri "
          f"differences {tri_bad} (float64-proven ties allowed), max|err| t/u/v {err:.3g} | "
          f"stage 1 and kernel {ms:.3f} ms ({card})")
    if not ok:
        fail("the packet kernel disagrees with its plain version on interior1440's camera rays")
    em = emissive_is.build_emissive_set(scene)
    po, pd = co[sub].repeat(16, 1), torch.nn.functional.normalize(
        torch.from_numpy(np.random.RandomState(10).randn(16 * PLAIN_SUBSET, 3).astype(
            np.float32)).to(dev), dim=-1)
    got_p = emissive_probe.light_probe_cuda(em, po, pd)
    ref_p = emissive_probe.light_probe_plain(em, po, pd)
    torch.cuda.synchronize()
    p_err, p_ok = max_err(got_p, ref_p)
    print(f"[emissive_probe] interior1440 E={em['p0'].shape[0]} N={po.shape[0]}: lit "
          f"{int((ref_p > 0).sum())} max|err| {p_err:.3g}")
    if not p_ok or not bool((ref_p > 0).any()):
        fail("the probe kernel disagrees with its plain version on interior1440's emitters")
    del co, cd, ctm, got, ref, tris, po, pd, got_p, ref_p, pix, sub

    hist = frame.History.create(cfg, dev)
    for _ in range(INTERIOR_WARMUP):
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    interior_counters = {"packet_hit": packet, "emissive_probe": emissive_probe,
                         "bilinear_sample": reproject, "relax_taccum": taccum_cuda,
                         "relax_atrous": atrous_cuda, "taa_resolve": taa_cuda,
                         "dense_hit": dense_cuda, "packet_hit_stream": None}

    def icount(k):
        m = interior_counters[k]
        return packet.STREAM_LAUNCHES if m is None else m.LAUNCHES

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    per_frame = []
    reset_counts()
    stamps = [time.perf_counter()]
    for _ in range(INTERIOR_FRAMES):
        before = {k: icount(k) for k in interior_counters}
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        per_frame.append({k: icount(k) - before[k] for k in interior_counters})
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - stamps[0]) * 1e3 / INTERIOR_FRAMES
    for k in interior_counters:
        launches[k] = launches.get(k, 0) + icount(k)
    peak = torch.cuda.max_memory_allocated(dev)
    lums = {k: float(color.luminance(out[k]).mean()) for k in ("color", "final")}
    rays_per_px = bench_configs.rays_per_pixel(cfg)
    frames_max = float(hist.relax_diff.frames.max())
    n_keys = int((hist.sharc.keys != 0).sum())
    state = {}

    def one_more():
        state["out"], state["hist"] = frame.render_frame(ctx, scene, cam, cfg, settings, hist)

    busy_ms, n_kernels = device_busy_ms(one_more)
    busy = (f"device busy {busy_ms:.3f} ms in {n_kernels} kernels (one more frame under "
            f"torch.profiler), idle share {1.0 - busy_ms / ms:.3f} of the timed frames' wall"
            if busy_ms > 0 else "device busy not measured (the profiler saw no device time)")
    print(f"[interior1440] {ms:.3f} ms/frame wall over {INTERIOR_FRAMES} frames after "
          f"{INTERIOR_WARMUP} warm-up (host ms per frame "
          f"{', '.join(f'{(b - a) * 1e3:.3f}' for a, b in zip(stamps, stamps[1:]))}), {busy}, "
          f"{rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s ({rays_per_px:.4f} rays/px), "
          f"peak memory {peak} B, mean luminance composed {lums['color']:.6g} TAA "
          f"{lums['final']:.6g}, launches/frame {per_frame}, RELAX frames max "
          f"{frames_max:.3f}, TAA valid {int(hist.taa.valid)}, SHARC keys {n_keys} of "
          f"{hist.sharc.capacity} ({card})")
    for k in ("color", "final"):
        if not bool(torch.isfinite(out[k]).all()) or not lums[k] > 0.0:
            fail(f"interior1440 {k} image is not finite with a positive mean luminance")
    needed = ("packet_hit", "emissive_probe", "bilinear_sample", "relax_taccum", "relax_atrous",
              "taa_resolve")
    if not all(f[k] > 0 for f in per_frame for k in needed):
        fail(f"an interior1440 frame did not launch all of {needed}: per-frame launches "
             f"{per_frame}")
    if not frames_max > 1.0 or int(hist.taa.valid) != 1 or n_keys == 0 or hist.confidence is None:
        fail("the interior1440 RELAX, TAA, SHARC or confidence history did not advance")
    interior = (ms, busy_ms, peak, per_frame[-1])

    # every kernel of the interior1440 frame on that frame's own inputs: one
    # more frame with each wrapper recording its calls (arguments and the
    # outputs the frame got), then each call against its plain version on the
    # same inputs: the gather, RELAX taccum, RELAX à-trous and TAA on their
    # whole (1440, 2560) planes; the packet kernel's camera, bounce
    # (divergent) and shadow (any-hit) sets and the probe's rays on a seeded
    # subset of PLAIN_SUBSET rays of each call
    with recording({
            "packet_hit": (packet, "closest_hit_packet_cuda", keep_rays),
            "emissive_probe": (emissive_probe, "light_probe_cuda", keep_rays),
            "bilinear_sample": (reproject, "sample_bilinear_cuda", keep_planes),
            "relax_taccum": (taccum_cuda, "taccum_variance_cuda", keep_planes),
            "relax_atrous": (atrous_cuda, "atrous_iteration_cuda", keep_planes),
            "taa_resolve": (taa_cuda, "taa_resolve_cuda", keep_planes)}) as calls:
        before = {k: icount(k) for k in interior_counters}
        frame.render_frame(ctx, scene, cam, cfg, settings, state["hist"])
        recorded_launches = {k: icount(k) - before[k] for k in interior_counters}
    torch.cuda.synchronize()
    del state
    frame_err = check_frame_calls(calls, recorded_launches, cs, scene, card)
    del calls
    del out, hist, ctx, scene, cs
    torch.cuda.empty_cache()

    # ---- 5d. the output chain: kitchen1080 with the post chain to 4K and the
    # validation overlay, and with the learned RR denoiser; the networks and
    # the image phase card against CPU, the held-out RR gate, every debug
    # view, the CLI ----
    chain_counters = {"dense_hit": dense_cuda, "emissive_probe": emissive_probe,
                      "bilinear_sample": reproject, "relax_taccum": taccum_cuda,
                      "relax_atrous": atrous_cuda, "taa_resolve": taa_cuda}
    t0 = time.perf_counter()
    chain = check_output_chain(dev, card, launches, reset_counts, chain_counters)
    for k, e in chain["rr_calls"].items():
        frame_err[k] = max(frame_err.get(k, 0.0), e)
    print(f"[output chain] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 6. card against CPU, end to end; the cornellbox-000 golden ----
    res = 64
    cfg = RenderConfig(width=res, height=res)
    imgs = {}
    for where in ("cuda", "cpu"):
        ctx, scene = traversal.build_context(procedural.cornell_box(), device=where)
        cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device=where)
        settings = make_settings(where, sun_elevation=-30.0, disable_shadows=1)
        out, _ = frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, where))
        imgs[where] = out["color"]
    frac, rel = frame_mismatch(imgs["cpu"], imgs["cuda"])
    print(f"[card vs cpu] cornellbox {res}^2: outlier share {frac:.6f}, mean gap {rel:.3g} (rel)")
    if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
        fail("the card's frame disagrees with the CPU frame")

    outs = {}
    cfg = RenderConfig(width=res, height=res, rpp=1, bounce_num=2, denoiser=Denoiser.REBLUR)
    for where in ("cuda", "cpu"):
        ctx, scene = traversal.build_context(procedural.shader_balls(grid=2, sphere_res=12),
                                             device=where)
        cam = look_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0, device=where)
        settings = make_settings(where, sun_elevation=45.0)
        hist = frame.History.create(cfg, where)
        for _ in range(2):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        outs[where] = out
    worst = []
    for plane in ("color", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"):
        frac, rel = frame_mismatch(outs["cpu"][plane], outs["cuda"][plane])
        worst.append((frac, rel, plane))
    frac, _, plane = max(worst)
    _, rel = frame_mismatch(outs["cpu"]["color"], outs["cuda"]["color"])
    print(f"[card vs cpu] shaderballs grid 2 REBLUR {res}^2, 2 frames: worst outlier share "
          f"{frac:.6f} ({plane}), color mean gap {rel:.3g} (rel)")
    if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
        fail("the card's REBLUR frame disagrees with the CPU frame")

    outs = {}
    for where in ("cuda", "cpu"):
        ctx, scene, cam, cfg, settings = bench_configs.setup("kitchen1080", where, width=80,
                                                             height=48, sharc_capacity=1 << 16)
        hist = frame.History.create(cfg, where)
        for _ in range(3):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        outs[where] = out
    worst = []
    for plane in ("color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"):
        frac, rel = frame_mismatch(outs["cpu"][plane], outs["cuda"][plane])
        worst.append((frac, rel, plane))
    frac, _, plane = max(worst)
    rel = max(r for _, r, p in worst if p in ("color", "final"))
    print(f"[card vs cpu] kitchen RELAX + SH + TAA + SHARC + confidence 80x48, 3 frames: worst "
          f"outlier share {frac:.6f} ({plane}), color and TAA mean gap {rel:.3g} (rel)")
    if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
        fail("the card's kitchen frame disagrees with the CPU frame")

    # the small exterior: on the card with the flat-stage-1 and streaming
    # limits lowered, so that its 25 opaque clusters take the supercluster
    # stage 1 and the streaming kernel (glass and emitters the resident one)
    outs = {}
    flat_max, vmem_limit = packet.FLAT_WORKLIST_MAX_C, packet.PACKET_VMEM_LIMIT
    for where in ("cuda", "cpu"):
        ctxs, scene, cam, cfg, settings = bench_configs.setup(
            "exterior720", where, scene_kw=SMALL_EXTERIOR, width=80, height=48,
            sharc_capacity=1 << 16)
        hist = frame.History.create(cfg, where)
        before = (packet.STREAM_LAUNCHES, packet.LAUNCHES)
        if where == "cuda":
            packet.FLAT_WORKLIST_MAX_C = 16
            packet.PACKET_VMEM_LIMIT = packet.vmem_table_bytes(ctxs.opaque.clusters) - 1
        try:
            for _ in range(3):
                out, hist = frame.render_frame(ctxs, scene, cam, cfg, settings, hist)
        finally:
            packet.FLAT_WORKLIST_MAX_C, packet.PACKET_VMEM_LIMIT = flat_max, vmem_limit
        small_launches = (packet.STREAM_LAUNCHES - before[0], packet.LAUNCHES - before[1])
        if where == "cuda" and not all(small_launches):
            fail(f"the small exterior on the card launched (stream, resident) {small_launches}")
        outs[where] = out
    worst = []
    for plane in ("color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"):
        frac, rel = frame_mismatch(outs["cpu"][plane], outs["cuda"][plane])
        worst.append((frac, rel, plane))
    frac, _, plane = max(worst)
    rel = max(r for _, r, p in worst if p in ("color", "final"))
    glass_same = torch.equal(outs["cpu"]["glass_mask"], outs["cuda"]["glass_mask"].cpu())
    print(f"[card vs cpu] exterior {SMALL_EXTERIOR} 80x48, 3 frames, supercluster stage 1 and "
          f"streaming kernel on the card: worst outlier share {frac:.6f} ({plane}), color and "
          f"TAA mean gap {rel:.3g} (rel), glass mask {'equal' if glass_same else 'DIFFERENT'} "
          f"({int(outs['cpu']['glass_mask'].sum())} pixels)")
    if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL or not glass_same:
        fail("the card's exterior frame disagrees with the CPU frame")

    outs = {}
    for where in ("cuda", "cpu"):
        ctx, scene, cam, cfg, settings = bench_configs.setup("interior1440", where, width=80,
                                                             height=48, sharc_capacity=1 << 16)
        hist = frame.History.create(cfg, where)
        for _ in range(3):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        outs[where] = out
    worst = []
    for plane in RECORD_PLANES:
        frac, rel = frame_mismatch(outs["cpu"][plane], outs["cuda"][plane])
        worst.append((frac, rel, plane))
    frac, _, plane = max(worst)
    rel = max(r for _, r, p in worst if p in ("color", "final"))
    print(f"[card vs cpu] interior1440's scene and config at 80x48, 3 frames: worst outlier "
          f"share {frac:.6f} ({plane}), color and TAA mean gap {rel:.3g} (rel)")
    if frac > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
        fail("the card's interior frame disagrees with the CPU frame")

    golden = np.load(os.path.join(REPO, "Tests", "golden", "cornellbox-000.npz"))
    res = int(golden["res"])
    settings, cam, render, _ = records.load_record_full(
        os.path.join(REPO, "Tests", "cornellbox.json"), 0, device=dev)
    if render:
        fail(f"cornellbox record 0 pins render fields {render}; this check expects none")
    cfg = RenderConfig(width=res, height=res)
    ctx, scene = traversal.build_context(procedural.cornell_box(), device=dev)
    out, _ = frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, dev),
                                reset_history=True)
    img = out["color"].cpu().numpy().reshape(res, res, 3)
    tiles = img.reshape(res // 8, 8, res // 8, 8, 3).mean(axis=(1, 3))
    scale = max(float(golden["std"]), 0.05)
    tile_gap = float(np.abs(tiles - golden["tile_means"]).max())
    mean_gap = abs(float(img.mean()) - float(golden["mean"]))
    print(f"[golden] cornellbox-000 at {res}^2: max tile gap {tile_gap:.4g}, mean gap {mean_gap:.4g} "
          f"(limit {0.02 * scale + 1e-4:.4g})")
    if tile_gap > 0.02 * scale + 1e-4 or mean_gap >= 0.02 * scale + 1e-4:
        fail("the cornellbox-000 golden does not match")

    # ---- 6b. the record corpus on the card: all 344 records of Tests/*.json
    # at 32x32 through records.replay_record (finite, max > 0), the CHECK_ME
    # records twice (identical), and one record of each new branch against
    # its CPU frame ----
    t0 = time.perf_counter()
    contexts = {}
    n_records = bad = 0
    for name in records.REPLAY_SCENES:
        contexts[name] = records.build_replay_context(name, dev)
        for i in range(records.count_records(records.record_path(name))):
            out, _, _ = records.replay_record(*contexts[name], name, i, dev)
            img = out["color"]
            n_records += 1
            if not bool(torch.isfinite(img).all()) or not float(img.max()) > 0.0:
                bad += 1
                print(f"[corpus] {name} #{i}: not finite with a positive maximum")
    corpus_s = time.perf_counter() - t0
    check_bad = []
    for name, idx in records.CHECK_ME.items():
        for i in idx:
            a = records.replay_record(*contexts[name], name, i, dev)[0]
            b = records.replay_record(*contexts[name], name, i, dev)[0]
            if not all(torch.equal(a[k], b[k]) for k in RECORD_PLANES):
                check_bad.append(f"{name} #{i}")
    n_check = sum(len(v) for v in records.CHECK_ME.values())
    print(f"[corpus] {n_records} records at 32x32 on the card in {corpus_s:.1f} s: {bad} not "
          f"finite with a positive maximum; CHECK_ME {n_check} records replayed twice, "
          f"{len(check_bad)} not identical {check_bad} ({card})")
    if n_records != 344 or bad or check_bad:
        fail("the record corpus does not replay on the card")
    cpu_contexts = {}
    for name, i, what in BRANCH_RECORDS:
        if name not in cpu_contexts:
            cpu_contexts[name] = records.build_replay_context(name, "cpu")
        got = records.replay_record(*contexts[name], name, i, dev)[0]
        want = records.replay_record(*cpu_contexts[name], name, i, "cpu")[0]
        worst = max((*frame_mismatch(want[k], got[k]), k) for k in RECORD_PLANES)
        _, rel = frame_mismatch(want["color"], got["color"])
        print(f"[card vs cpu] {name} #{i} ({what}) 32x32: worst outlier share {worst[0]:.6f} "
              f"({worst[2]}), color mean gap {rel:.3g} (rel)")
        if worst[0] > FRAME_OUTLIER_FRAC or rel > FRAME_MEAN_REL:
            fail(f"the card's frame of {name} #{i} ({what}) disagrees with the CPU frame")
    del contexts, cpu_contexts

    # ---- 6c. NaN through the kernels: the inf stress test without
    # sanitization writes NaN into the radiance of the pixels that see the
    # sky (the ring round the box); the denoisers spread it by their
    # footprints, leaving a finite middle. Through REBLUR (the gather) and
    # through RELAX + TAA (gather, taccum, à-trous, TAA), over two frames,
    # the card's non-finite pixels must be the CPU's. The image phase then
    # runs on both devices from the same input, the CPU's trace of the first
    # frame, and must agree within the frame tolerance on the finite pixels
    # as well: of the whole frames, the finite pixels are only reported,
    # since a few pixels' lobe or reservoir choices flip on a last-ULP
    # difference of the trace and REBLUR's blur spreads each over its
    # footprint ----
    nan_cam = ([0.0, -3.6, 1.0], [0.0, 0.0, 1.0], 55.0)
    nan_planes = ("color", "final", "diff_radiance", "spec_radiance", "shadow")

    def nan_report(what, want, got):
        rows = {k: nan_mismatch(want[k], got[k]) for k in nan_planes}
        print(f"[NaN] cornellbox {NAN_RES}x{NAN_RES} inf stress test, no sanitization, {what}: "
              f"per plane (non-finite pixels on the CPU, on the card, positions that differ, "
              f"outlier share and mean gap of the pixels finite in both) "
              + ", ".join(f"{k} {v[0]}/{v[1]}/{v[2]}/{v[3]:.6f}/{v[4]:.3g}"
                          for k, v in rows.items()))
        return rows

    for label, kw in (("REBLUR", dict(denoiser=Denoiser.REBLUR)),
                      ("RELAX + TAA", dict(denoiser=Denoiser.RELAX, use_taa=True))):
        cfg = RenderConfig(width=NAN_RES, height=NAN_RES, use_inf_stress_test=True, **kw)
        outs, inputs = {}, {}
        for where in ("cuda", "cpu"):
            ctx, scene = traversal.build_context(procedural.cornell_box(), device=where)
            cam = look_at(nan_cam[0], nan_cam[1], fov_y_deg=nan_cam[2], device=where)
            settings = make_settings(where, sun_elevation=-30.0, disable_shadows=1)
            hist = frame.History.create(cfg, where)
            inputs[where] = (cam, settings, hist)
            outs[where] = []
            for _ in range(2):
                out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
                outs[where].append(out)
        for f in range(2):
            far = int((outs["cpu"][f]["view_z"] > 1e4).sum())
            rows = nan_report(f"{label}, frame {f} ({far} pixels outside the denoising range)",
                              outs["cpu"][f], outs["cuda"][f])
            if far == 0 or rows["color"][0] == cfg.n_pixels or any(v[2] for v in rows.values()):
                fail(f"the card's non-finite pixels differ from the CPU's ({label}, frame {f})")
        gb, aux = outs["cpu"][0]["gbuffer"], {"sharc": None, "probes": None}
        images = {}
        for where in ("cuda", "cpu"):
            cam, settings, hist = inputs[where]
            gbw = {k: tuple(t.to(where) for t in v) if isinstance(v, tuple) else v.to(where)
                   for k, v in gb.items()}
            images[where] = frame.image_frame(cfg, settings, cam, hist, gbw, aux)[0]
        rows = nan_report(f"{label}, the image phase of frame 0 on the CPU's trace",
                          images["cpu"], images["cuda"])
        if any(v[2] or v[3] > FRAME_OUTLIER_FRAC for v in rows.values()):
            fail(f"the card's image phase disagrees with the CPU's on NaN input ({label})")

    # ---- 7. shaderballs512 again, after every other phase, in the same process ----
    ctx, scene, cam, cfg, settings = bench_configs.setup("shaderballs512", dev)
    again_ms, host = shaderballs_frames()[:2]
    print(f"[shaderballs512 again] {again_ms:.3f} ms/frame over {SB_FRAMES} frames after 2 warm-up, "
          f"after the other phases (phase 2: {sb_ms:.3f}), {spread(host)} ({card})")
    del ctx, scene
    torch.cuda.empty_cache()

    # ---- 8. the differentiable path: the backward bench, a kitchen1080
    # training step, the CLI's optimize, card against CPU gradients, the
    # five-field step through the probe kernel ----
    t0 = time.perf_counter()
    train_counters = {"dense_hit": dense_cuda, "emissive_probe": emissive_probe,
                      "packet_hit": packet, "bilinear_sample": reproject,
                      "relax_taccum": taccum_cuda, "relax_atrous": atrous_cuda,
                      "taa_resolve": taa_cuda}
    training = check_training(dev, card, reset_counts, train_counters)
    print(f"[training] phase in {time.perf_counter() - t0:.1f} s")

    # ---- 9. the asset path: (T) textured kitchen1080 and (S) textured
    # shaderballs512 (normal maps, the alpha test's re-traces), (G) the
    # exterior720 glb written and loaded back, a small textured .gltf, (R)
    # the 19 record goldens on the card ----
    asset_counters = {"dense_hit": dense_cuda, "emissive_probe": emissive_probe,
                      "packet_hit": packet, "packet_hit_stream": None,
                      "bilinear_sample": reproject, "relax_taccum": taccum_cuda,
                      "relax_atrous": atrous_cuda, "taa_resolve": taa_cuda}
    t0 = time.perf_counter()
    textured = check_textured(dev, card, launches, reset_counts, asset_counters)
    t1 = time.perf_counter()
    gltf_res = check_gltf(dev, card, launches, reset_counts, asset_counters)
    t2 = time.perf_counter()
    goldens = check_goldens(dev, card)
    print(f"[asset path] (T) and (S) in {t1 - t0:.1f} s, (G) in {t2 - t1:.1f} s, (R) in "
          f"{time.perf_counter() - t2:.1f} s")
    for k, e in textured["kitchen1080"]["errs"].items():
        frame_err[k] = max(frame_err.get(k, 0.0), e)
    for k, e in textured["shaderballs512"]["errs"].items():
        frame_err[k] = max(frame_err.get(k, 0.0), e)

    # ---- 10. the animate path: 512 orbiting cubes refit on the card each
    # frame at 1920x1080 with RELAX, the DRS schedule, cli animate, card
    # against CPU; and where shaderballs512's REBLUR trace parts between the
    # card and the CPU ----
    t0 = time.perf_counter()
    animated = check_animate(dev, card, launches, reset_counts, asset_counters)
    t1 = time.perf_counter()
    pixel = check_reblur_pixel(dev, card)
    pixel["gradient"] = check_reblur_gradient(dev, card)
    print(f"[animate path] phase in {t1 - t0:.1f} s, the REBLUR trace check in "
          f"{time.perf_counter() - t1:.1f} s")
    for errs in (animated["errs"], pixel["errs"]):
        for k, e in errs.items():
            frame_err[k] = max(frame_err.get(k, 0.0), e)

    dense = results[("dense", "kitchen", "per-ray")]
    prim = packet_res["primary"]
    bil = bil_res[(9, "3")]
    tac = taccum_res["confidence"]
    atr = [atrous_res[st] for st in sorted(atrous_res)]
    taa_w = taa_res["random 30% wide mask"]
    kernels = [
        {"name": "dense_hit", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/dense_hit.cu",
         "replaces": "nrdsample_tpu/ops/dense_pallas.py:33", "launches": launches["dense_hit"],
         "max_abs_err": max(v[0] for k, v in results.items() if k[0] == "dense"),
         "ms": dense[1], "plain_ms": dense[2], "bound_ms": dense[3][0], "bound_by": dense[3][1],
         "library_ms": None},
        {"name": "emissive_probe", "route": "cuda",
         "source": "nrdsample_tpu_torch/csrc/emissive_probe.cu",
         "replaces": "nrdsample_tpu/ops/emissive_probe.py:36",
         "launches": launches["emissive_probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms, "bound_ms": probe_bound[0],
         "bound_by": probe_bound[1], "library_ms": None},
        {"name": "packet_hit", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/packet_hit.cu",
         "replaces": "nrdsample_tpu/ops/packet.py:81", "launches": launches["packet_hit"],
         "max_abs_err": max(v[0] for v in packet_res.values()),
         "ms": prim[1], "plain_ms": prim[2], "bound_ms": prim[3][0], "bound_by": prim[3][1],
         "library_ms": None},
        {"name": "bilinear_sample", "route": "cuda",
         "source": "nrdsample_tpu_torch/csrc/bilinear_sample.cu",
         "replaces": "nrdsample_tpu/ops/reproject.py:38", "launches": launches["bilinear_sample"],
         "max_abs_err": max(v[0] for v in bil_res.values()),
         "ms": bil[1], "plain_ms": bil[2], "bound_ms": bil[4][0], "bound_by": bil[4][1],
         "library_ms": bil[3]},
        {"name": "relax_taccum", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/relax_taccum.cu",
         "replaces": "nrdsample_tpu/denoise/taccum_pallas.py:51",
         "launches": launches["relax_taccum"],
         "max_abs_err": max(v[0] for v in taccum_res.values()),
         "ms": tac[1], "plain_ms": tac[2], "bound_ms": tac[3][0], "bound_by": tac[3][1],
         "library_ms": None},
        # ms and plain_ms: the mean over the five steps of one frame's chain
        {"name": "relax_atrous", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/relax_atrous.cu",
         "replaces": "nrdsample_tpu/denoise/atrous_pallas.py:30",
         "launches": launches["relax_atrous"], "max_abs_err": max(v[0] for v in atr),
         "ms": statistics.mean(v[1] for v in atr), "plain_ms": statistics.mean(v[2] for v in atr),
         "bound_ms": atr[0][3][0], "bound_by": atr[0][3][1], "library_ms": None},
        {"name": "taa_resolve", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/taa_resolve.cu",
         "replaces": "nrdsample_tpu/denoise/taa_pallas.py:57", "launches": launches["taa_resolve"],
         "max_abs_err": max(v[0] for v in taa_res.values()),
         "ms": taa_w[1], "plain_ms": taa_w[2], "bound_ms": taa_w[3][0], "bound_by": taa_w[3][1],
         "library_ms": None},
        # ms and plain_ms: the coherent camera rays of exterior720 (plain_ms
        # on a 2^17-ray subset of them); bound: the tests those rays need
        {"name": "packet_hit_stream", "route": "cuda",
         "source": "nrdsample_tpu_torch/csrc/packet_hit_stream.cu",
         "replaces": "nrdsample_tpu/ops/packet.py:504",
         "launches": launches["packet_hit_stream"],
         "max_abs_err": max(v[0] for v in stream_res.values()),
         "ms": stream_res["primary"][1], "plain_ms": stream_res["primary"][2],
         "bound_ms": stream_res["primary"][3][0], "bound_by": stream_res["primary"][3][1],
         "library_ms": None},
    ]
    for k in kernels:
        if k["name"] in frame_err:
            k["max_abs_err"] = max(k["max_abs_err"], frame_err[k["name"]])
    print(f"[interior1440 summary] {interior[0]:.3f} ms/frame wall, {interior[1]:.3f} ms device "
          f"busy, peak memory {interior[2]} B, launches/frame {interior[3]} ({card})")
    a, b, post = chain["a"], chain["b"], chain["post"]
    print(f"[output chain summary] (a) kitchen1080 + post chain to {OUTPUT_W}x{OUTPUT_H}: "
          f"{a[0]:.3f} ms/frame wall, {a[1]:.3f} ms busy, idle {a[2]:.3f}, peak {a[3]} B, "
          f"post_chain {post['post_chain'][0]:.3f} ms (busy {post['post_chain'][1]:.3f}); "
          f"(b) kitchen1080 NEURAL: {b[0]:.3f} ms/frame wall, {b[1]:.3f} ms busy, idle "
          f"{b[2]:.3f}, peak {b[3]} B, neural_rr.denoise {chain['rr'][0]:.3f} ms (busy "
          f"{chain['rr'][1]:.3f}); launches/frame (a) {a[4]} (b) {b[4]} ({card})")
    print(f"[exterior720 summary] {exterior[0]:.3f} ms/frame, launches/frame {exterior[1]}; "
          f"streaming kernel vs the parent's build vs resident kernel ms on the same "
          f"worklists: "
          + ", ".join(f"{k} {v[1]:.3f} vs {v[7]:.3f}{'' if v[8] else ' (quoted)'} vs {v[5]:.3f}"
                      for k, v in stream_res.items())
          + f" ({card})")
    print("[packet_hit summary] shaderballs512 resident kernel vs the parent's build ms "
          "on the same worklists: "
          + ", ".join(f"{k} {v[1]:.3f} vs "
                      + (f"{v[5]:.3f} ({v[5] / v[1]:.2f}x faster)" if v[5] else "not measured")
                      for k, v in packet_res.items())
          + f" ({card})")
    print("[denoiser summary] this tree's kernel vs the parent's build ms on the same planes: "
          + ", ".join(f"{name} {case} {v[1]:.4f} vs {parent_ms(v[4], v[1])}"
                      for name, res in (("relax_taccum", taccum_res), ("relax_atrous", atrous_res),
                                        ("taa_resolve", taa_res))
                      for case, v in res.items())
          + f" ({card})")
    ab, kb = training["A"], training["B"]
    print(f"[training summary] (A) bench_backward 512x512: forward {ab['grad_forward_ms']:.3f} ms, "
          f"backward {ab['grad_backward_ms']:.3f} ms, ratio {ab['backward_forward_ratio']:.3f}, "
          f"busy {ab['grad_forward_busy_ms']:.3f} / {ab['grad_value_and_grad_busy_ms']:.3f} ms, "
          f"peak {ab['peak_memory_bytes']} B, FD rel err {ab['grad_fd_rel_err']:.4g}; (B) "
          f"kitchen1080 step {kb[0]:.3f} ms wall, {kb[1]:.3f} ms busy, peak {kb[2]} B, launches "
          f"{kb[3]}; (C) optimize {training['C'][0]:.1f} s ({card})")
    tk, ts_ = textured["kitchen1080"], textured["shaderballs512"]
    st = textured["step"]
    print(f"[asset summary] (T) textured kitchen1080: {tk['ms']:.3f} ms/frame wall, "
          f"{tk['busy']:.3f} ms busy, peak {tk['peak']} B, launches/frame {tk['launches']}; "
          f"its L2 step forward {st[0]:.3f} ms, backward {st[1]:.3f} ms, busy {st[2]:.3f} ms, "
          f"peak {st[3]} B; texel gradients card vs CPU "
          f"{max(textured['grad_gaps']):.3g} of the level's largest; (S) textured "
          f"shaderballs512: {ts_['ms']:.3f} ms/frame wall, {ts_['busy']:.3f} ms busy, launches/frame "
          f"{ts_['launches']}; (G) exterior720 glb save {gltf_res['exterior'][0]:.2f} s, load "
          f"{gltf_res['exterior'][1]:.2f} s, geometry outlier share "
          f"{gltf_res['exterior'][2]:.6f}, mean luminance gap {gltf_res['exterior'][3]:.3g}; "
          f"(R) {goldens['n']} goldens, worst tile error {goldens['worst'][1]:.4g} of "
          f"{goldens['worst'][2]:.4g} ({goldens['worst'][0]}) ({card})")
    an = animated["A"]
    print(f"[animate summary] {ANIM_CUBES} cubes at {ANIM_W}x{ANIM_H} RELAX: wall ms/frame median "
          f"{statistics.median(an['wall']):.3f} (min {min(an['wall']):.3f}, max "
          f"{max(an['wall']):.3f}), device busy {an['busy']:.3f} ms, the packet kernel "
          f"{an['packet'][0]:.3f} ms over {an['packet'][1]} launches, transform + refit median "
          f"{statistics.median(an['refit']):.3f} ms, peak {an['peak']} B, launches/frame "
          f"{an['launches']}; DRS frames " + ", ".join(
              f"{w}x{h} {ms:.1f} ms" for w, h, ms, _ in animated["B"])
          + f"; cli animate {animated['C']:.1f} s; card vs CPU worst outlier share "
          f"{animated['D'][0][0]:.6f}, resized history max|err| {animated['D'][2]:.3g} ({card})")
    print(f"gpu: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
