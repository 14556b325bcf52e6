"""The configurations of the JAX package's bench ladder (``bench.py:61-76``)
that the port renders, plus the kitchen at 1920x1080 with REFERENCE standing
in for its later denoiser stack. ``setup`` builds one on a device."""

from __future__ import annotations

from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.scene import procedural
from nrdsample_tpu_torch.scene.types import look_at

CONFIGS = {
    # bench.py:61-67
    "cornell256": dict(
        scene=procedural.cornell_box, cam=([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
        cfg=dict(width=256, height=256, rpp=1, bounce_num=1, denoiser=Denoiser.REFERENCE),
        settings=dict(sun_elevation=-30.0, disable_shadows=1)),
    # bench.py:71-76, the headline: cluster traversal, REBLUR + SIGMA
    "shaderballs512": dict(
        scene=lambda: procedural.shader_balls(grid=3, sphere_res=24),
        cam=([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], 50.0),
        cfg=dict(width=512, height=512, rpp=1, bounce_num=2, denoiser=Denoiser.REBLUR),
        settings=dict(sun_elevation=45.0)),
    # bench.py:78-85's scene, camera and size; REFERENCE stands in for its
    # RELAX + SH + TAA + SHARC + confidence stack (slice 3)
    "kitchen1080-REFERENCE": dict(
        scene=procedural.kitchen, cam=([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
        cfg=dict(width=1920, height=1080, rpp=1, bounce_num=1, denoiser=Denoiser.REFERENCE),
        settings=dict(sun_elevation=35.0)),
}


def setup(name: str, device=None, **cfg_overrides):
    """(ctx, scene, cam, cfg, settings) of configuration ``name`` on
    ``device`` (the CUDA card when None); ``cfg_overrides`` replace
    RenderConfig fields (a smaller size, say)."""
    spec = CONFIGS[name]
    kw = dict(spec["cfg"], tracing_mode=TracingMode.FULL_PROBABILISTIC)
    kw.update(cfg_overrides)
    cfg = RenderConfig(**kw)
    ctx, scene = traversal.build_context(spec["scene"](), device=device)
    eye, target, fov = spec["cam"]
    cam = look_at(eye, target, fov_y_deg=fov, aspect=cfg.width / cfg.height, device=device)
    return ctx, scene, cam, cfg, make_settings(device, **spec["settings"])


def rays_per_pixel(cfg: RenderConfig) -> float:
    """Rays traced per pixel per frame, as ``bench.py:count_rays_per_pixel``
    counts them: primary + primary shadow + rpp x bounces x (bounce +
    shadow)."""
    return 2.0 + cfg.rpp * cfg.bounce_num * 2.0
