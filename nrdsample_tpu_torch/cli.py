"""Command line of the port (counterpart of ``nrdsample_tpu/cli.py``): the
headless frame driver.

    python -m nrdsample_tpu_torch.cli render --scene cornellbox --size 256 \\
        --frames 16 --bounces 3 --denoiser reference --out render.png
    python -m nrdsample_tpu_torch.cli animate --size 128 --frames 24 --cubes 12
    python -m nrdsample_tpu_torch.cli optimize --scene cornellbox --size 48 --iters 200
    python -m nrdsample_tpu_torch.cli scenes

``render``, ``animate`` and ``optimize`` run on the CUDA card; ``--cpu`` runs
the plain PyTorch versions on the CPU instead. ``render`` writes the debug view
(``--on-screen``), else the post chain's display image (``--upscale``,
``--nis`` or ``--separator``), else the tonemapped final image, as a PNG.
``animate`` renders cubes on orbits over a ground box, the clusters refit on
the device each frame and the cubes' motion vectors their true motion
(``pipeline/animate.py``), with adaptive accumulation and, with
``--drs-target-ms``, dynamic resolution; it writes the last frame as a PNG.
``optimize`` perturbs the scene's albedos, recovers them by SGD through
``pipeline/train.make_train_step`` and ends with a JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SCENES = {}


def _register_scenes():
    from nrdsample_tpu_torch.scene import glass_shell, procedural

    SCENES.update({
        "cornellbox": lambda: procedural.cornell_box(),
        "cornellbox-furnace": lambda: procedural.cornell_box(furnace=True),
        "cornellbox-glass": lambda: glass_shell.add_inner_glass_surfaces(
            procedural.cornell_box_glass()),
        "shaderballs": lambda: procedural.shader_balls(),
        "kitchen": lambda: procedural.kitchen(),
        "interior-night": lambda: procedural.interior_night(),
        "soup": lambda: procedural.random_soup(100_000),
    })


DEFAULT_CAMERAS = {
    "cornellbox": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "cornellbox-furnace": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "cornellbox-glass": ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
    "shaderballs": ([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], 50.0),
    "kitchen": ([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
    "interior-night": ([0.0, -3.5, 1.8], [0.0, 1.5, 1.2], 60.0),
    "soup": ([0.0, -60.0, 25.0], [0.0, 0.0, 5.0], 55.0),
}


def cmd_render(args) -> int:
    import numpy as np
    import torch

    from nrdsample_tpu_torch.config import (Denoiser, NrdMode, OnScreen, RenderConfig,
                                            TracingMode, make_settings)
    from nrdsample_tpu_torch.device import resolve
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.pipeline import frame as frame_mod
    from nrdsample_tpu_torch.scene.types import look_at
    from nrdsample_tpu_torch.utils import image as image_mod

    device = resolve("cpu" if args.cpu else None)
    _register_scenes()
    scene = SCENES[args.scene]()
    eye, target, fov = DEFAULT_CAMERAS[args.scene]
    build = (traversal.build_scene_contexts if args.scene.endswith("-glass")
             else traversal.build_context)
    ctx, scene = build(scene, device=device)
    cam = look_at(eye, target, fov_y_deg=fov, aspect=args.size / args.size, device=device)
    out_size = args.upscale or 0
    cfg = RenderConfig(
        width=args.size, height=args.size, rpp=args.rpp, bounce_num=args.bounces,
        tracing_mode=TracingMode.FULL_PROBABILISTIC,
        denoiser=Denoiser[args.denoiser.upper()],
        nrd_mode=NrdMode[args.nrd_mode.upper().replace("-", "_")],
        on_screen=OnScreen[args.on_screen.upper().replace("-", "_")],
        use_taa=args.taa,
        use_sharc=args.sharc,
        psr_bounce_num=args.psr,
        output_width=out_size, output_height=out_size,
        use_nis=args.nis,
        use_neural_sr=(args.sr == "neural"),
        enable_post=bool(out_size or args.nis or args.separator > 0.0),
        use_validation_overlay=args.validation,
    )
    settings = make_settings(
        device, sun_azimuth=args.sun_azimuth, sun_elevation=args.sun_elevation,
        disable_shadows=1 if args.no_shadows else 0, separator=args.separator,
        exposure=args.exposure * 100.0,
        forced_material={"none": 0, "gypsum": 1, "cobalt": 2}[args.forced_material],
        use_normal_map=0 if args.no_normal_map else 1)
    print(f"scene={args.scene} tris={scene.num_tris} "
          f"mode={getattr(ctx, 'mode', 'opaque+transparent')} "
          f"size={args.size} denoiser={args.denoiser}", file=sys.stderr)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    history = frame_mod.History.create(cfg, device)
    sync()
    t0 = time.perf_counter()
    out = None
    for _ in range(args.frames):
        out, history = frame_mod.render_frame(ctx, scene, cam, cfg, settings, history)
    sync()
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.2f}s ({dt / args.frames * 1e3:.1f} ms/frame incl. "
          f"compile)", file=sys.stderr)

    if out["debug"] is not None:
        img = out["debug"].cpu().numpy().reshape(args.size, args.size, 3)
        image_mod.write_png(args.out, (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    elif cfg.enable_post and out["display"] is not None:
        # the post chain's image is tonemapped and in sRGB at output resolution
        disp = out["display"].cpu().numpy()
        image_mod.write_png(args.out, (disp * 255.0 + 0.5).astype(np.uint8))
    else:
        img = out["final"].cpu().numpy().reshape(args.size, args.size, 3)
        image_mod.write_png(args.out, image_mod.tonemap_for_display(img, args.exposure))
    print(f"wrote {args.out}")
    return 0


def cmd_animate(args) -> int:
    """Animated render: orbiting cubes over a ground box (AnimatedInstance and
    GatherInstanceData, NRDSample.cpp:304-333, 3395-3630). Each frame the
    adaptive accumulation cap follows the smoothed frame time; with
    --drs-target-ms the DRS controller picks the next frame's bucket and a
    switch resamples the history."""
    import numpy as np
    import torch

    from nrdsample_tpu_torch.config import make_settings
    from nrdsample_tpu_torch.device import resolve
    from nrdsample_tpu_torch.pipeline import adaptive, animate, drs, frame as frame_mod
    from nrdsample_tpu_torch.utils import image as image_mod

    device = resolve("cpu" if args.cpu else None)
    anim = animate.build(args.cubes, device)
    cfg = animate.render_config(args.size, args.denoiser)
    settings = make_settings(device, sun_elevation=animate.SUN_ELEVATION)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ctrl = drs.DrsController(args.drs_target_ms) if args.drs_target_ms > 0 else None
    cur_cfg = drs.bucket_cfg(cfg, ctrl.scale) if ctrl else cfg
    hist = frame_mod.History.create(cur_cfg, device)
    timer = adaptive.FrameTimer()
    prev_settings = None
    out = None
    sync()
    t0 = time.perf_counter()
    for f in range(args.frames):
        tf0 = time.perf_counter()
        settings = adaptive.update(settings, prev_settings, timer.smoothed_ms)
        prev_settings = settings
        out, hist = animate.render(anim, cur_cfg, settings, hist, *animate.frame_times(f))
        sync()
        frame_ms = (time.perf_counter() - tf0) * 1e3
        if f > 0:
            timer.update(frame_ms)
        if ctrl is not None:
            next_cfg = drs.bucket_cfg(cfg, ctrl.update(frame_ms))
            if next_cfg != cur_cfg:
                print(f"frame {f}: DRS -> {next_cfg.width}x{next_cfg.height}", file=sys.stderr)
                hist = drs.resize_history(hist, cur_cfg, next_cfg)
                cur_cfg = next_cfg
    dt = time.perf_counter() - t0
    print(f"{args.frames} animated frames in {dt:.2f}s ({dt / args.frames * 1e3:.1f} ms/frame)",
          file=sys.stderr)
    if ctrl is not None:
        img = out["display"].cpu().numpy()
    else:
        img = out["final"].cpu().numpy().reshape(args.size, args.size, 3)
    image_mod.write_png(args.out, image_mod.tonemap_for_display(img, 0.6))
    print(f"wrote {args.out}")
    return 0


def cmd_optimize(args) -> int:
    """Inverse rendering: recover perturbed material albedos from a target
    render. Prints the albedo error every iters // 10 steps and one last
    JSON line; exits 0 when the mean albedo error fell below half of its
    start."""
    import dataclasses

    import numpy as np
    import torch

    from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
    from nrdsample_tpu_torch.device import resolve
    from nrdsample_tpu_torch.ops import traversal
    from nrdsample_tpu_torch.pipeline import frame as frame_mod, train as train_mod
    from nrdsample_tpu_torch.scene.types import look_at

    device = resolve("cpu" if args.cpu else None)
    _register_scenes()
    scene = SCENES[args.scene]()
    eye, target_pt, fov = DEFAULT_CAMERAS[args.scene]
    ctx, scene = traversal.build_context(scene, device=device)
    cam = look_at(eye, target_pt, fov_y_deg=fov, device=device)
    cfg = RenderConfig(width=args.size, height=args.size, rpp=1, bounce_num=1,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE)
    settings = make_settings(device, sun_elevation=args.sun_elevation, disable_shadows=1)

    # the ground-truth image with the true materials
    hist = frame_mod.History.create(cfg, device)
    with torch.no_grad():
        target, _ = train_mod.render_color(ctx, cfg, scene.materials, scene, cam, settings, hist)

    # perturb the albedo and recover it
    rs = np.random.RandomState(0)
    bc_true = scene.materials.base_color.cpu().numpy()
    bc0 = np.clip(bc_true + rs.uniform(-0.3, 0.3, bc_true.shape), 0.05, 0.95)
    materials = dataclasses.replace(
        scene.materials, base_color=torch.from_numpy(bc0.astype(np.float32)).to(device))

    step = train_mod.make_train_step(ctx, cfg, lr=args.lr)
    err0 = float(np.abs(bc0 - bc_true).mean())
    loss = None
    for it in range(args.iters):
        loss, materials = step(materials, scene, cam, settings, hist, target)
        if it % max(args.iters // 10, 1) == 0:
            err = float(np.abs(materials.base_color.cpu().numpy() - bc_true).mean())
            print(f"iter {it:4d}  loss {float(loss):.6f}  albedo_err {err:.4f}", file=sys.stderr)
    err1 = float(np.abs(materials.base_color.cpu().numpy() - bc_true).mean())
    print(json.dumps({
        "initial_albedo_error": err0,
        "final_albedo_error": err1,
        "final_loss": float(loss),
        "recovered": err1 < err0 * 0.5,
    }))
    return 0 if err1 < err0 * 0.5 else 1


def cmd_scenes(_args) -> int:
    _register_scenes()
    for name in SCENES:
        print(name)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nrdsample_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("--scene", default="cornellbox", choices=list(DEFAULT_CAMERAS))
    r.add_argument("--size", type=int, default=256)
    r.add_argument("--frames", type=int, default=16)
    r.add_argument("--rpp", type=int, default=1)
    r.add_argument("--bounces", type=int, default=2)
    r.add_argument("--denoiser", default="reference", choices=["reblur", "relax", "reference"])
    r.add_argument("--taa", action="store_true")
    r.add_argument("--out", default="render.png")
    r.add_argument("--exposure", type=float, default=0.35)
    r.add_argument("--sun-azimuth", type=float, default=-147.0)
    r.add_argument("--sun-elevation", type=float, default=45.0)
    r.add_argument("--no-shadows", action="store_true")
    r.add_argument("--forced-material", default="none", choices=["none", "gypsum", "cobalt"],
                   help="debug material override (RaytracingShared.hlsli:497-515)")
    r.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions) instead of the CUDA card")
    r.add_argument("--nrd-mode", default="normal",
                   choices=["normal", "sh", "occlusion", "directional-occlusion"])
    r.add_argument("--sharc", action="store_true", help="SHARC L2 radiance cache")
    r.add_argument("--psr", type=int, default=0, help="PSR mirror-walk bounces")
    r.add_argument("--upscale", type=int, default=0,
                   help="output resolution (SR slot; 0 = native)")
    r.add_argument("--sr", default="lanczos", choices=["lanczos", "neural"],
                   help="SR-slot kernel: classical Lanczos-2 or the learned residual CNN")
    r.add_argument("--nis", action="store_true", help="NIS-style sharpen")
    r.add_argument("--separator", type=float, default=0.0,
                   help="split-screen noisy|denoised separator in [0,1]")
    r.add_argument("--validation", action="store_true",
                   help="NRD validation-layer overlay (accumulation-age heatmap over the final "
                        "image)")
    r.add_argument("--no-normal-map", action="store_true",
                   help="disable normal mapping (gUseNormalMap off)")
    r.add_argument("--on-screen", default="final",
                   help="debug view (gOnScreen): final, base-color, normal, roughness, metalness, "
                        "shadow, material-id, uv, curvature, mip-primary, instance-index, "
                        "ambient-occlusion, denoised-diffuse, sharc-cache, sharc-grid, "
                        "taa-weight, ...")
    r.set_defaults(fn=cmd_render)

    a = sub.add_parser("animate", help="animated orbiting-cubes demo (device-side refit)")
    a.add_argument("--size", type=int, default=128)
    a.add_argument("--frames", type=int, default=24)
    a.add_argument("--cubes", type=int, default=12)
    a.add_argument("--denoiser", default="relax", choices=["reblur", "relax", "reference"])
    a.add_argument("--out", default="animate.png")
    a.add_argument("--drs-target-ms", type=float, default=0.0,
                   help="dynamic resolution: the target frame time in ms (bucketed render "
                        "size, pipeline/drs.py; 0 = off)")
    a.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions) instead of the CUDA card")
    a.set_defaults(fn=cmd_animate)

    o = sub.add_parser("optimize", help="inverse-rendering demo (recover albedo)")
    o.add_argument("--scene", default="cornellbox", choices=list(DEFAULT_CAMERAS))
    o.add_argument("--size", type=int, default=48)
    o.add_argument("--iters", type=int, default=200)
    o.add_argument("--lr", type=float, default=4e-4,
                   help="SGD lr; the loss sums over pixels, scale ~1/n_pixels")
    o.add_argument("--sun-elevation", type=float, default=-30.0)
    o.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions) instead of the CUDA card")
    o.set_defaults(fn=cmd_optimize)

    s = sub.add_parser("scenes", help="list scenes")
    s.set_defaults(fn=cmd_scenes)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
