"""The five configurations of the JAX package's bench ladder
(``bench.py:61-103``). ``setup`` builds one on a device."""

from __future__ import annotations

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.config import Denoiser, NrdMode, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.scene import procedural, textures
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
    # bench.py:78-85: dense traversal, RELAX + SIGMA, the SH resolve, TAA, the
    # SHARC radiance cache and the history-confidence plane
    "kitchen1080": dict(
        scene=procedural.kitchen, cam=([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
        cfg=dict(width=1920, height=1080, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                 nrd_mode=NrdMode.SH, use_taa=True, use_sharc=True, use_confidence=True),
        settings=dict(sun_elevation=35.0)),
    # bench.py:86-96: a street block of 1,058,884 triangles (8,263 opaque
    # clusters: the supercluster stage 1 and the streaming packet kernel),
    # glass windows (the transparent context, shadow translucency and the
    # delta chains), 4,034 emitters (the emissive cluster probe), RELAX +
    # SIGMA, TAA and SHARC with its FULL through-glass pass
    "exterior720": dict(
        scene=lambda **kw: procedural.exterior(**{"cobbles": 120, "tree_count": 450,
                                                  "tree_res": 28, **kw}),
        cam=([0.0, -45.0, 6.0], [0.0, 0.0, 4.0], 55.0),
        cfg=dict(width=1280, height=720, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                 use_sharc=True, use_taa=True),
        settings=dict(sun_elevation=30.0), glass=True),
    # bench.py:97-103: the interior at night (15,494 triangles in cluster
    # mode, 24 emitters for the emissive probe), RELAX + SIGMA, SHARC with
    # the history-confidence plane, TAA; its glass spheres are traced in the
    # one opaque context, as the JAX bench builds it (no glass=True)
    "interior1440": dict(
        scene=procedural.interior_night, cam=([0.0, -3.5, 1.8], [0.0, 1.5, 1.2], 60.0),
        cfg=dict(width=2560, height=1440, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX,
                 use_sharc=True, use_confidence=True, use_taa=True),
        settings=dict(sun_elevation=-20.0)),
}


#: the textured variants of two configurations (``setup(textured=True)``): a
#: box uv chart, ``textures.procedural_maps`` at 256x256 for every material
#: (base colour, roughness, metalness, a normal map) and a cut-out alpha on
#: one material: the kitchen's counter tops, one of the shader balls
TEXTURED = {
    "kitchen1080": dict(res=256, alpha_materials=(4,)),
    "shaderballs512": dict(res=256, alpha_materials=(5,)),
}


def setup(name: str, device=None, scene_kw: dict | None = None, textured: bool = False,
          **cfg_overrides):
    """(ctx, scene, cam, cfg, settings) of configuration ``name`` on
    ``device`` (the CUDA card when None); ``scene_kw`` replaces arguments of
    the scene builder (a smaller scene), ``textured`` gives the scene the
    textures of ``TEXTURED[name]``, ``cfg_overrides`` RenderConfig fields (a
    smaller size, say). A configuration with glass gets the SceneContexts of
    ``build_scene_contexts``."""
    spec = CONFIGS[name]
    kw = dict(spec["cfg"], tracing_mode=TracingMode.FULL_PROBABILISTIC)
    kw.update(cfg_overrides)
    cfg = RenderConfig(**kw)
    build = traversal.build_scene_contexts if spec.get("glass") else traversal.build_context
    scene = spec["scene"](**(scene_kw or {}))
    if textured:
        scene = textures.textured_scene(scene, **TEXTURED[name])
    ctx, scene = build(scene, device=device)
    eye, target, fov = spec["cam"]
    cam = look_at(eye, target, fov_y_deg=fov, aspect=cfg.width / cfg.height, device=device)
    return ctx, scene, cam, cfg, make_settings(device, **spec["settings"])


def rays_per_pixel(cfg: RenderConfig, has_glass: bool = False) -> float:
    """Rays traced per pixel per frame, as ``bench.py:count_rays_per_pixel``
    counts them: primary + primary shadow + rpp x bounces x (bounce +
    shadow), plus with SHARC the probe rays at 1/ds^2 rate (primary +
    propagation depth x (bounce + shadow)), plus with glass the translucency
    march, the transparent recast, 2 chains x delta bounces and the chains'
    end shadow (16.36 for exterior720). Emissive-probe rays are not
    counted."""
    rays = 2.0 + cfg.rpp * cfg.bounce_num * 2.0
    if cfg.use_sharc:
        rays += (1.0 + 2.0 * cfgmod.SHARC_PROPAGATION_DEPTH) / cfg.sharc_downscale ** 2
    if has_glass:
        rays += 1.0 + 1.0 + 2.0 * cfg.delta_bounce_num + 2.0
    return rays
