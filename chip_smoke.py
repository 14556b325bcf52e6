"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nrdsample_tpu_torch/csrc`` and renders
four configurations through ``pipeline.frame.render_frame``: first
shaderballs512 (cluster traversal through the packet kernel, REBLUR + SIGMA
through the bilinear gather kernel), then, after holding each of the eight
kernels against its plain PyTorch version on the card at the main paths'
shapes, cornell256, kitchen1080 (dense traversal, RELAX + SIGMA, SH, TAA,
SHARC and history confidence, through the dense hit, emissive probe,
bilinear gather, RELAX taccum, RELAX à-trous and TAA resolve kernels) and
exterior720 (1.06M triangles through the supercluster stage 1 and the
streaming packet kernel, glass and the emitters through the resident packet
kernel, RELAX + SIGMA, TAA, SHARC with its FULL pass). It checks that each
main path went through its kernels, compares card frames with CPU frames
and the cornellbox-000 golden, and prints one JSON line of kernels plus a
final ``{"ok": true, "device": ...}`` line. Any failed phase exits non-zero
with no result line. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

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
KERNEL_TOL = 1e-6          # abs and rel, kernel vs plain on the same inputs
FRAME_OUTLIER_FRAC = 0.005  # the frame tolerance of tests/test_torch_frame.py
FRAME_MEAN_REL = 1e-3
# Roofline of one H100 SXM (NVIDIA's data sheet, 700 W): 3.35 TB/s of HBM and
# 67 TFLOP/s of float32 outside the tensor cores, which counts an FMA as two
# operations. The kernels are built with --fmad=false, so every multiply and
# every add is an instruction of its own: 33.5e12 such operations a second.
HBM_BYTES_PER_S = 3.35e12
F32_UNFUSED_OPS_PER_S = 33.5e12
# float32 operations of one ray/triangle test of moller_trumbore.cuh and the
# best-hit compare, the divide counted as one: pvec, qvec (9 each), det, u,
# v, t (5 each, plus 1 scaling by 1/det for u, v and t), the |det| test, the
# divide, tvec (3), the 4 compares and 1 add of the hit test, t < best
MT_OPS = 9 + 9 + 4 * 5 + 3 + 1 + 1 + 3 + 5 + 1
# float32 operations per pixel of the denoiser kernels, counted from their
# sources (exp, pow, sqrt and a divide count as one; index arithmetic and the
# taccum kernel's recomputed 1-pixel ring do not count):
# - relax_taccum: anti-firefly 9 luminances (5 each), 16 min/max, clamp 2,
#   divide, scale 3 = 67; the gather's position 6 and 10 channels x 15 = 156;
#   disocclusion, on-screen and confidence 20; accumulation (min, divide,
#   luminance, square, 5 blends of 4) 28; the 3x3 variance 27 + 7 = 34
TACCUM_OPS = 67 + 156 + 20 + 28 + 34
# - relax_atrous: per tap luminance 5, depth weight 6 (sub, abs, 2 mul,
#   divide, exp), normal weight 8 (dot 5, clamp 2, pow), luminance weight 4,
#   weight 4, sums 10 = 37, times 9 taps; the centre 11, the end 6
ATROUS_OPS = 9 * 37 + 11 + 6
# - taa_resolve: 3x3 moments 9 x 3 x 3 = 81 (25 x 9 = 225 on wide pixels,
#   counted per pixel of the run's mask), mean and sigma 18, clamp 18,
#   [0, 1] clamps 12, two CIELAB conversions 64, distance and JND 12, mix 4,
#   on-screen 8, reset 1, output 9
TAA_OPS = 81 + 18 + 18 + 12 + 64 + 12 + 4 + 8 + 1 + 9
TAA_WIDE_EXTRA_OPS = 225 - 81
KITCHEN_FRAMES = 4
EXTERIOR_FRAMES = 3
EXTERIOR_DIVERGENT_RAYS = 786_432   # a sorted bounce-sized set on the exterior
#: the small exterior of the card-vs-CPU check: 3,196 opaque triangles (25
#: clusters), 1,488 glass (12 clusters) and 674 emitters
SMALL_EXTERIOR = dict(cobbles=8, tree_count=6, tree_res=8, lamp_count=4)


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


def check_stream_kernel(cs, tris, cam, cfg, dev, card) -> dict:
    """The streaming packet kernel on the exterior's opaque ClusterSet: its
    coherent camera rays, a divergent bounce-sized set with per-ray t_max
    (re-binned by morton order, as the frame does) and the any-hit mode on
    that set, each held against the plain scan on 2^17 rays drawn from the
    set, then timed alone on stage 1's worklists beside the resident kernel
    on the same inputs (which must agree with it exactly). Returns {case:
    (max |err|, stream ms, plain ms, bound, subset size, resident ms,
    stage-1 ms)}."""
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
        a = packet.launch_stream(cs, ko, kd, ktm, order, keys, any_hit, not any_hit)
        b = packet.launch(cs, ko, kd, ktm, order, keys, any_hit)
        torch.cuda.synchronize()
        same = all(torch.equal(a[k], b[k]) for k in ("t", "tri")) and (
            any_hit or all(torch.equal(a[k], b[k]) for k in "uv"))
        ms = graph_ms(lambda: packet.launch_stream(cs, ko, kd, ktm, order, keys, any_hit,
                                                   not any_hit))
        res_ms = graph_ms(lambda: packet.launch(cs, ko, kd, ktm, order, keys, any_hit))
        stage1_ms = median_ms(lambda: packet.worklists(ko, kd, cs, ktm), reps=3)
        tests = packet_tests_needed(cs, ro, rd, rtm, got, any_hit, chunk=1 << 14)
        walk = packet_walk_tests(keys, got["t"][perm], packet.BLOCK_RAYS)
        bnd = bound_ms(n * (28 + 16) + order.numel() * 8 + cs.slab.numel() * 4, tests * MT_OPS)
        print(f"[packet_hit_stream] exterior {case} C={cs.count} N={n} sort={sort} "
              f"any_hit={any_hit}: {'blocked' if any_hit else 'hits'} {hits} of {PLAIN_SUBSET} "
              f"checked, tri (or blocked) differences {tri_bad} (float64-proven ties allowed), "
              f"max|err| t/u/v {err:.3g}, resident kernel on the same worklists "
              f"{'identical' if same else 'DIFFERENT'} | streaming kernel {ms:.3f} ms, resident "
              f"kernel {res_ms:.3f} ms at N={n} (stage 1 {stage1_ms:.3f} ms), plain "
              f"{plain_ms:.3f} ms at N={PLAIN_SUBSET}, bound {bnd[0]:.4f} ms ({bnd[1]}, {tests} "
              f"tests needed; the walk makes {walk}) ({card})")
        if not ok or not same or hits == 0:
            fail(f"streaming packet kernel disagrees with its plain version or the resident "
                 f"kernel ({case})")
        out[case] = (err, ms, plain_ms, bnd, PLAIN_SUBSET, res_ms, stage1_ms)
        del got, ref, ko, kd, ktm, order, keys, a, b
    return out


def main() -> int:
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
                           + tr.count * 36, RAYS_2X1080P * tr.count * MT_OPS)
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
    probe_bound = bound_ms(PROBE_RAYS * (24 + 4) + n_em * 40, PROBE_RAYS * n_em * MT_OPS)
    print(f"[emissive_probe] kitchen E={n_em} N={PROBE_RAYS}: lit {lit} "
          f"max|err| {probe_err:.3g} | kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms, "
          f"bound {probe_bound[0]:.3f} ms ({probe_bound[1]}) ({card})")
    if not probe_ok or lit == 0:
        fail("emissive probe kernel disagrees with its plain version")
    del o, d, bounded, po, pd, got, ref

    # packet kernel on shaderballs512's scene (104 clusters): its coherent
    # camera rays, a divergent shadow-sized set with per-ray t_max (re-binned
    # by morton order, as the frame does), and the any-hit mode on that set;
    # ctx, scene, cam and cfg are still shaderballs512's of phase 2
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
        sub = n if case == "primary" else PLAIN_SUBSET
        so, sd, stm = ro[:sub], rd[:sub], rtm[:sub]
        if any_hit:
            plain_ms, ref = once_ms(lambda: cluster.any_hit_clustered(cs, so, sd, stm))
            blocked = (got["tri"][:sub] >= 0) & (got["t"][:sub] < stm)
            tri_bad, err, ok = int((blocked != ref).sum()), 0.0, bool(torch.equal(blocked, ref))
            hits = int(ref.sum())
        else:
            plain_ms, ref = once_ms(lambda: cluster.closest_hit_clustered(cs, so, sd, stm))
            tri_bad, err, ok = compare_hits({k: v[:sub] for k, v in got.items()}, ref, so, sd, tris)
            hits = int((ref["tri"] >= 0).sum())
        # the kernel alone on stage 1's worklists of the rays in packet order
        perm = (torch.sort(packet._morton_sort_keys(ro, rd, cs), stable=True).indices if sort
                else torch.arange(n, device=dev))
        ko, kd, ktm = ro[perm].contiguous(), rd[perm].contiguous(), rtm[perm].contiguous()
        order, keys = packet._block_worklists(ko, kd, cs, ktm)
        ms = graph_ms(lambda: packet.launch(cs, ko, kd, ktm, order, keys, any_hit))
        stage1_ms = median_ms(lambda: packet._block_worklists(ko, kd, cs, ktm))
        tests = packet_tests_needed(cs, ro, rd, rtm, got, any_hit)
        walk = packet_walk_tests(keys, got["t"][perm], packet.BLOCK_RAYS)
        bnd = bound_ms(n * (28 + 16) + (n // 128) * cs.count * 8 + cs.slab.numel() * 4,
                       tests * MT_OPS)
        print(f"[packet_hit] {case} C={cs.count} N={n} sort={sort} any_hit={any_hit}: "
              f"{'blocked' if any_hit else 'hits'} {hits} of {sub} checked, tri (or blocked) "
              f"differences {tri_bad} (float64-proven ties allowed), max|err| t/u/v {err:.3g} | "
              f"kernel {ms:.3f} ms at N={n} (stage 1 {stage1_ms:.3f} ms), plain {plain_ms:.3f} ms "
              f"at N={sub}, bound {bnd[0]:.4f} ms ({bnd[1]}, {tests} tests needed per ray; "
              f"the walk makes {walk}) ({card})")
        if not ok or hits == 0:
            fail(f"packet kernel disagrees with its plain version ({case})")
        packet_res[case] = (err, ms, plain_ms, bnd, sub)
    del vo, vd, vtm, got, ref, ko, kd, ktm, order, keys

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
            ms = graph_ms(lambda: reproject.sample_bilinear_cuda(img, pos))
            plain_ms = median_ms(lambda: filtering.sample_bilinear(img, pos))
            # the library yardstick: one grid_sample call on the same inputs
            # (border padding, pixel centres at (i + 0.5) / size * 2 - 1)
            nchw = img.permute(2, 0, 1)[None].contiguous()
            grid = (pos / 512.0 * 2.0 - 1.0)[None].contiguous()

            def lib():
                return torch.nn.functional.grid_sample(nchw, grid, mode="bilinear",
                                                       padding_mode="border", align_corners=False)

            lib_err = float((lib()[0].permute(1, 2, 0) - ref).abs().max())
            lib_ms = graph_ms(lib)
            bnd = bound_ms(img.numel() * 4 + pos.numel() * 4 + got.numel() * 4, got.numel() * 10)
            print(f"[bilinear] (512, 512, {c}) displacement {disp} px: max|err| {err:.3g} | kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample {lib_ms:.4f} ms (its "
                  f"max|diff| {lib_err:.3g}), bound {bnd[0]:.4f} ms ({bnd[1]}) ({card})")
            if not ok:
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
        plain_ms = median_ms(plain, reps=5)
        n_planes = 10 + 10 + (1 if conf_c is not None else 0) + 7
        bnd = bound_ms(n_px * n_planes * 4, n_px * TACCUM_OPS)
        print(f"[relax_taccum] (1080, 1920) {case}: accumulated pixels {accumulated} max|err| "
              f"{err:.3g} | kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}) ({card})")
        keeps_history = case not in ("off-screen", "reset")
        if not all(ok for _, ok in errs) or keeps_history != (accumulated > 0):
            fail(f"RELAX taccum kernel disagrees with its plain version ({case})")
        taccum_res[case] = (err, ms, plain_ms, bnd)

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
        plain_ms = median_ms(plain, reps=5)
        bnd = bound_ms(n_px * (8 + 4) * 4, n_px * ATROUS_OPS)
        print(f"[relax_atrous] (1080, 1920) step {step}: max|err| {err:.3g} | kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) ({card})")
        if not all(ok for _, ok in errs):
            fail(f"RELAX à-trous kernel disagrees with its plain version (step {step})")
        atrous_res[step] = (err, ms, plain_ms, bnd)

    taa_res = {}
    cur, prev = rand(kh, kw, 3, hi=1.5), rand(kh, kw, 3, hi=1.5)
    mv_d = (rand(kh, kw, 2) * 2.0 - 1.0) * 3.0
    mv_d[:64, :, 0] += 2000.0   # a band of pixels whose history lies off screen
    wide = (rand(kh, kw) > 0.7).to(torch.float32)
    reset_mix = (rand(kh, kw) > 0.9).to(torch.float32)
    for case, wm in (("wide mask", wide), ("no wide mask", None)):
        def kernel():
            return taa_cuda.taa_resolve_cuda(cur, prev, mv_d, wm, reset_mix, 2.0, 0.1)

        def plain():
            return taa.resolve_tail(cur, prev, mv_d, wm, reset_mix, 2.0, 0.1)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = max_err(got, ref)
        ms = graph_ms(kernel)
        plain_ms = median_ms(plain, reps=5)
        n_wide = int((wm > 0.5).sum()) if wm is not None else 0
        bnd = bound_ms(n_px * ((10 if wm is not None else 9) + 3) * 4,
                       n_px * TAA_OPS + n_wide * TAA_WIDE_EXTRA_OPS)
        print(f"[taa_resolve] (1080, 1920) {case} ({n_wide} wide pixels): max|err| {err:.3g} | "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) "
              f"({card})")
        if not ok:
            fail(f"TAA resolve kernel disagrees with its plain version ({case})")
        taa_res[case] = (err, ms, plain_ms, bnd)
    del rhist, illum, conf, avar, cur, prev, mv_d, wide, reset_mix, got, ref, vz, nrm, xx, yy

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
    del out, img, hist

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
    stream_res = check_stream_kernel(cs, tris, cam, cfg, dev, card)
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

    # ---- 7. shaderballs512 again, after every other phase, in the same process ----
    ctx, scene, cam, cfg, settings = bench_configs.setup("shaderballs512", dev)
    again_ms, host = shaderballs_frames()[:2]
    print(f"[shaderballs512 again] {again_ms:.3f} ms/frame over {SB_FRAMES} frames after 2 warm-up, "
          f"after the other phases (phase 2: {sb_ms:.3f}), {spread(host)} ({card})")

    dense = results[("dense", "kitchen", "per-ray")]
    prim = packet_res["primary"]
    bil = bil_res[(9, "3")]
    tac = taccum_res["confidence"]
    atr = [atrous_res[st] for st in sorted(atrous_res)]
    taa_w = taa_res["wide mask"]
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
    print(f"[exterior720 summary] {exterior[0]:.3f} ms/frame, launches/frame {exterior[1]}; "
          f"streaming vs resident kernel ms on the same worklists: " + ", ".join(
              f"{k} {v[1]:.3f} vs {v[5]:.3f}" for k, v in stream_res.items()) + f" ({card})")
    print(f"gpu: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
