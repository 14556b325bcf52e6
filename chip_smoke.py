"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nrdsample_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the main path's
shapes, renders the dense REFERENCE frame (cornell256, then the kitchen at
1920x1080) through ``pipeline.frame.render_frame``, checks the kitchen run
went through both kernels, compares a card frame with a CPU frame and the
cornellbox-000 golden, and prints one JSON line per kernel plus a final
``{"ok": true, "device": ...}`` line. Any failed phase exits non-zero with
no result line. Needs a CUDA device; imports nothing of JAX.
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
KERNEL_TOL = 1e-6          # abs and rel, kernel vs plain on the same inputs
FRAME_OUTLIER_FRAC = 0.005  # the frame tolerance of tests/test_torch_frame.py
FRAME_MEAN_REL = 1e-3


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


def seeded_rays(n: int, seed: int, dev):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, bool]:
    diff = (a - b).abs()
    ok = bool((diff <= KERNEL_TOL + KERNEL_TOL * b.abs()).all())
    return float(diff.max()), ok


def frame_mismatch(ref: torch.Tensor, got: torch.Tensor) -> tuple[float, float]:
    """(share of pixels off by more than 1e-3 (1 + |ref|), relative mean gap)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    bad = ((ref - got).abs() > 1e-3 * (1.0 + ref.abs())).any(-1)
    return float(bad.double().mean()), abs(float(got.mean() - ref.mean())) / max(abs(float(ref.mean())), 1e-12)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    from nrdsample_tpu_torch.config import RenderConfig, make_settings
    from nrdsample_tpu_torch.mathlib import color
    from nrdsample_tpu_torch.ops import _kernels, dense_cuda, emissive_probe, intersect, traversal
    from nrdsample_tpu_torch.pipeline import frame, records
    from nrdsample_tpu_torch.render import emissive_is
    from nrdsample_tpu_torch.scene import procedural
    from nrdsample_tpu_torch.scene.types import look_at

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

    # ---- 2. each kernel against its plain version, main-path shapes ----
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
            ms = median_ms(lambda: dense_cuda.closest_hit_dense_cuda(tr.p0, tr.e1, tr.e2, o, d, tm))
            plain_ms = median_ms(lambda: intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, tm))
            hits = int((ref["tri"] >= 0).sum())
            print(f"[dense_hit] {name} E={tr.count} N={RAYS_2X1080P} t_max={tm_name}: hits {hits} "
                  f"tri mismatches {tri_bad} max|err| t/u/v {err:.3g} | kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms ({card})")
            if tri_bad or not all(ok for _, ok in errs) or hits == 0:
                fail(f"dense hit kernel disagrees with its plain version ({name}, {tm_name})")
            results[("dense", name, tm_name)] = (err, ms, plain_ms)
    em = emissive_is.build_emissive_set(kitchen)
    po, pd = seeded_rays(PROBE_RAYS, 2, dev)
    got = emissive_probe.light_probe_cuda(em, po, pd)
    ref = emissive_probe.light_probe_plain(em, po, pd)
    torch.cuda.synchronize()
    probe_err, probe_ok = max_err(got, ref)
    lit = int((ref > 0).sum())
    probe_ms = median_ms(lambda: emissive_probe.light_probe_cuda(em, po, pd))
    probe_plain_ms = median_ms(lambda: emissive_probe.light_probe_plain(em, po, pd))
    print(f"[emissive_probe] kitchen E={em['p0'].shape[0]} N={PROBE_RAYS}: lit {lit} "
          f"max|err| {probe_err:.3g} | kernel {probe_ms:.3f} ms, plain {probe_plain_ms:.3f} ms ({card})")
    if not probe_ok or lit == 0:
        fail("emissive probe kernel disagrees with its plain version")
    del o, d, bounded, po, pd, got, ref

    # ---- 3. main path, bench config 1: cornell256 ----
    cfg = RenderConfig(width=256, height=256, rpp=1, bounce_num=1)
    ctx, scene = traversal.build_context(procedural.cornell_box(), device=dev)
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device=dev)
    settings = make_settings(dev, sun_elevation=-30.0, disable_shadows=1)
    hist = frame.History.create(cfg, dev)
    out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)   # warm-up
    n_frames = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    rays_per_px = 2.0 + cfg.rpp * cfg.bounce_num * 2.0   # bench.py:count_rays_per_pixel
    print(f"[cornell256] {ms:.3f} ms/frame, {rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s "
          f"({rays_per_px} rays/px, {n_frames} frames after 1 warm-up; {card})")
    img = out["color"]
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        fail("cornell256 image is not finite and positive")

    # ---- 4. main path at real size: the kitchen at 1920x1080 ----
    w, h = 1920, 1080
    cfg = RenderConfig(width=w, height=h, rpp=1, bounce_num=1)
    ctx, scene = traversal.build_context(procedural.kitchen(), device=dev)
    cam = look_at([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], fov_y_deg=65.0, aspect=w / h, device=dev)
    settings = make_settings(dev, sun_elevation=35.0)
    hist = frame.History.create(cfg, dev)
    del out, img
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dense_cuda.LAUNCHES = 0
    emissive_probe.LAUNCHES = 0
    n_frames = 8
    per_frame = []
    t0 = time.perf_counter()
    for _ in range(n_frames):
        before = (dense_cuda.LAUNCHES, emissive_probe.LAUNCHES)
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        per_frame.append((dense_cuda.LAUNCHES - before[0], emissive_probe.LAUNCHES - before[1]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_frames
    launches = {"dense_hit": dense_cuda.LAUNCHES, "emissive_probe": emissive_probe.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    img = out["color"]
    lum = float(color.luminance(img).mean())
    print(f"[kitchen1080] {ms:.3f} ms/frame over {n_frames} frames (first included), "
          f"{rays_per_px * cfg.n_pixels / (ms * 1e-3):.4g} rays/s, peak memory {peak} B, "
          f"mean luminance {lum:.6g}, launches/frame {per_frame[0]} ({card})")
    if tuple(img.shape) != (w * h, 3) or not bool(torch.isfinite(img).all()) or not lum > 0.0:
        fail("kitchen1080 image is not finite with a positive mean luminance")
    if int(hist.reference.frames) != n_frames:
        fail(f"History.reference.frames is {int(hist.reference.frames)}, expected {n_frames}")
    if not all(dh > 0 and pr > 0 for dh, pr in per_frame):
        fail(f"a frame did not launch both kernels: per-frame launches {per_frame}")
    del out, img, hist

    # ---- 5. card against CPU, end to end; the cornellbox-000 golden ----
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

    kernels = [
        {"name": "dense_hit", "route": "cuda", "source": "nrdsample_tpu_torch/csrc/dense_hit.cu",
         "replaces": "nrdsample_tpu/ops/dense_pallas.py:33", "launches": launches["dense_hit"],
         "max_abs_err": max(v[0] for k, v in results.items() if k[0] == "dense"),
         "ms": results[("dense", "kitchen", "per-ray")][1],
         "plain_ms": results[("dense", "kitchen", "per-ray")][2]},
        {"name": "emissive_probe", "route": "cuda",
         "source": "nrdsample_tpu_torch/csrc/emissive_probe.cu",
         "replaces": "nrdsample_tpu/ops/emissive_probe.py:36",
         "launches": launches["emissive_probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms},
    ]
    print(f"gpu: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
