"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nrdsample_tpu_torch/csrc`` and renders
three configurations through ``pipeline.frame.render_frame``: first
shaderballs512 (cluster traversal through the packet kernel, REBLUR + SIGMA
through the bilinear gather kernel), then, after holding each kernel against
its plain PyTorch version on the card at the main paths' shapes, cornell256
and the kitchen at 1920x1080 (dense traversal, REFERENCE). It
checks that each main path went through its kernels, compares card frames
with CPU frames and the cornellbox-000 golden, and prints one JSON line of
kernels plus a final ``{"ok": true, "device": ...}`` line. Any failed phase
exits non-zero with no result line. Needs a CUDA device; imports nothing of
JAX.
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


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, make_settings
    from nrdsample_tpu_torch.mathlib import color, filtering
    from nrdsample_tpu_torch.ops import (_kernels, cluster, dense_cuda, emissive_probe, intersect,
                                         packet, reproject, traversal)
    from nrdsample_tpu_torch.pipeline import bench_configs, frame, records
    from nrdsample_tpu_torch.render import emissive_is
    from nrdsample_tpu_torch.scene import camera, procedural
    from nrdsample_tpu_torch.scene.types import look_at

    counters = (dense_cuda, emissive_probe, packet, reproject)

    def reset_counts():
        for m in counters:
            m.LAUNCHES = 0

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

    # ---- 5. dense main path at real size: the kitchen at 1920x1080 ----
    ctx, scene, cam, cfg, settings = bench_configs.setup("kitchen1080-REFERENCE", dev)
    hist = frame.History.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    n_frames = 4
    per_frame = []
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        before = (dense_cuda.LAUNCHES, emissive_probe.LAUNCHES)
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        per_frame.append((dense_cuda.LAUNCHES - before[0], emissive_probe.LAUNCHES - before[1]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    launches.update(dense_hit=dense_cuda.LAUNCHES, emissive_probe=emissive_probe.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    img = out["color"]
    lum = float(color.luminance(img).mean())
    rays_per_px = bench_configs.rays_per_pixel(cfg)
    print(f"[kitchen1080] {ms:.3f} ms/frame over {n_frames} frames (first included), "
          f"{rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s, peak memory {peak} B, "
          f"mean luminance {lum:.6g}, launches/frame {per_frame[0]} ({card})")
    if tuple(img.shape) != (cfg.n_pixels, 3) or not bool(torch.isfinite(img).all()) or not lum > 0.0:
        fail("kitchen1080 image is not finite with a positive mean luminance")
    if int(hist.reference.frames) != n_frames:
        fail(f"History.reference.frames is {int(hist.reference.frames)}, expected {n_frames}")
    if not all(dh > 0 and pr > 0 for dh, pr in per_frame):
        fail(f"a frame did not launch both kernels: per-frame launches {per_frame}")
    del out, img, hist

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
    ]
    print(f"gpu: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
