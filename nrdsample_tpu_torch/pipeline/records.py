"""Settings + camera test records (counterpart of
``nrdsample_tpu/pipeline/records.py``: loading, saving, and the replay
harness of ``nrdsample_tpu/pipeline/replay.py``). A record is one entry of a
``Tests/<scene>.json`` list; its ``render`` block pins RenderConfig fields
and its ``animation`` block, where present, a few frames: with mode "orbit"
(the default) a short camera orbit, with "blink" a still camera.

To replay one record on a device::

    ctx, scene = records.build_replay_context("kitchen", device)
    out, history, frames = records.replay_record(ctx, scene, "kitchen", 3, device)
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from nrdsample_tpu_torch.config import (Denoiser, NrdMode, RenderConfig, Settings,
                                        TracingMode)
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.scene import procedural
from nrdsample_tpu_torch.scene.types import Camera, look_at

RECORD_VERSIONS = (1, 2)
RECORD_VERSION = RECORD_VERSIONS[-1]   # the version record_to_dict writes

#: RenderConfig fields a record may pin (by name, enums as int); every other
#: field stays at the replay harness's defaults
RENDER_FIELDS = (
    "denoiser", "tracing_mode", "nrd_mode", "bounce_num", "rpp",
    "psr_bounce_num", "use_sharc", "use_confidence", "use_taa",
    "use_translucency", "use_hair_sss", "use_l1_cache",
    "use_inf_stress_test", "use_drs_stress_test", "use_firefly_test",
    "use_material_id_test", "use_sanitization",
)
TESTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "Tests")

#: the scenes of the record files, at the replay harness's reduced sizes
REPLAY_SCENES = {
    "cornellbox": procedural.cornell_box,
    "cornellbox-glass": procedural.cornell_box_glass,
    "kitchen": procedural.kitchen,
    "shaderballs": lambda: procedural.shader_balls(grid=2, sphere_res=12),
    "interior-night": lambda: procedural.interior_night(n_lights=8, grid=2, sphere_res=10),
    "exterior": lambda: procedural.exterior(blocks=2, window_grid=2, cobbles=8, tree_count=6,
                                            tree_res=8, lamp_count=4),
}
#: the scenes replayed through an opaque and a transparent context; the
#: interior's glass spheres stay in its one context, as in the JAX replay
GLASS_SCENES = {"cornellbox-glass", "exterior"}

#: Regression-sensitive records of each scene file (indices), one per
#: non-default render bucket the corpus pins: replayed twice, they must give
#: identical frames.
CHECK_ME: dict[str, list[int]] = {
    "cornellbox": [
        0,    # legacy default bucket
        3,    # REBLUR, bounce 1
        4,    # RELAX, bounce 1
        6,    # REBLUR, bounce 2, rpp 2
        7,    # NrdMode.OCCLUSION
        8,    # NrdMode.SH
        10,   # TracingMode.FULL
        11,   # TracingMode.HALF (checkerboard)
        12,   # RELAX + TAA
    ],
    "kitchen": [
        0,
        2,    # PSR mirror walk
        5,    # SHARC + history confidence
        7,    # L1 cache
    ],
    "shaderballs": [0, 3],
    "interior-night": [
        0,
        9,    # hair/SSS
        147,  # blinking emitters (moving-emission fix + lights/cubes split)
    ],
    "cornellbox-glass": [
        2,    # SIGMA translucency march
    ],
}

_ENUMS = {"denoiser": Denoiser, "tracing_mode": TracingMode, "nrd_mode": NrdMode}


def static_bucket(render: dict) -> str:
    """A stable key of a record's ``render`` pins: records with the same key
    replay with the same RenderConfig (the JAX harness's compile bucket)."""
    return ",".join(f"{k}={render[k]}" for k in sorted(render))


def record_to_dict(settings: Settings, cam: Camera, render: dict | None = None,
                   animation: dict | None = None) -> dict:
    """One record of ``settings`` and ``cam``: ``render``, RenderConfig pins
    (fields of RENDER_FIELDS, enums as int); ``animation``, e.g. {"mode":
    "orbit", "frames": 3}."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    d = {
        "version": RECORD_VERSION,
        "settings": {f.name: host(getattr(settings, f.name)).tolist()
                     for f in dataclasses.fields(settings)},
        "camera": {
            "view_to_world": host(cam.view_to_world).tolist(),
            **{k: float(host(getattr(cam, k))) for k in ("tan_half_fov_y", "aspect", "near_z",
                                                          "aperture", "focal_distance",
                                                          "ortho")},
        },
    }
    if render:
        unknown = set(render) - set(RENDER_FIELDS)
        if unknown:
            raise ValueError(f"unknown render fields {sorted(unknown)}")
        d["render"] = {k: v if isinstance(v, bool) else int(v) for k, v in render.items()}
    if animation:
        d["animation"] = animation
    return d


def save_record(path: str, settings: Settings, cam: Camera, index: int | None = None) -> int:
    """Append the record of (settings, cam) to the scene's JSON file at
    ``path``, or overwrite record ``index``; returns the index of the file's
    last record, as the JAX package does."""
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            recs = json.load(f)
    rec = record_to_dict(settings, cam)
    if index is None or index >= len(recs):
        recs.append(rec)
    else:
        recs[index] = rec
    with open(path, "w") as f:
        json.dump(recs, f, indent=1)
    return len(recs) - 1


def dict_to_record(d: dict, device=None) -> tuple[Settings, Camera]:
    """(Settings, Camera) of one record dict on ``device`` (the CUDA card when
    None): integer settings become int32 and the rest float32, as in the JAX
    package."""
    if d.get("version") not in RECORD_VERSIONS:
        raise ValueError(f"unknown record version {d.get('version')}")
    s = Settings(**{
        k: torch.tensor(v, dtype=torch.int32 if isinstance(v, int) else torch.float32)
        for k, v in d["settings"].items()
    })
    c = d["camera"]
    f32 = lambda v: torch.tensor(np.float32(v))
    v2w = torch.tensor(np.array(c["view_to_world"], np.float32))
    cam = Camera(
        view_to_world=v2w,
        view_to_world_prev=v2w.clone(),
        tan_half_fov_y=f32(c["tan_half_fov_y"]),
        aspect=f32(c["aspect"]),
        near_z=f32(c["near_z"]),
        jitter=torch.zeros(2),
        jitter_prev=torch.zeros(2),
        aperture=f32(c["aperture"]),
        focal_distance=f32(c["focal_distance"]),
        ortho=f32(c["ortho"]),
    )
    device = resolve(device)
    return s.to(device), cam.to(device)


def load_record_full(path: str, index: int, device=None):
    """(settings, camera, render overrides, animation | None) of record
    ``index``, with the volatile fields (debug, separator) reset."""
    with open(path) as f:
        d = json.load(f)[index]
    settings, cam = dict_to_record(d, device)
    zero = torch.zeros((), dtype=torch.float32, device=settings.debug.device)
    settings = dataclasses.replace(settings, debug=zero, separator=zero.clone())
    return settings, cam, d.get("render", {}), d.get("animation")


def count_records(path: str) -> int:
    """Number of records in a scene's record file (0 when it is missing)."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return len(json.load(f))


def render_config(render: dict, **base) -> RenderConfig:
    """The RenderConfig of a record's ``render`` block over the replay
    harness's defaults (32x32, one path of one bounce, FULL_PROBABILISTIC,
    REFERENCE), which ``base`` may replace; enum fields are given as ints.
    A record that pins SHARC gets a 2^14-slot cache unless ``base`` sets
    ``sharc_capacity``."""
    kw = dict(width=32, height=32, rpp=1, bounce_num=1,
              tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE)
    kw.update(base)
    for k, v in render.items():
        kw[k] = _ENUMS[k](v) if k in _ENUMS else v
    if kw.get("use_sharc") and "sharc_capacity" not in base:
        kw["sharc_capacity"] = 1 << 14
    return RenderConfig(**kw)


def orbit_cam(cam: Camera, step: int) -> Camera:
    """The camera of frame ``step`` of an animated record: the eye turned by
    4 degrees a frame about world z, still looking at the point 3 units
    ahead of the record's eye (turned with it), at 60 degrees as built and
    then with the record's FoV and aspect; ``view_to_world_prev`` is frame
    step - 1's (its own at step 0). On the device of ``cam``."""
    dev = cam.view_to_world.device

    def at(i):
        ang = np.deg2rad(4.0 * i)
        v2w = cam.view_to_world.cpu().numpy()
        eye = v2w[:3, 3]
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        target = eye + v2w[:3, 2] * 3.0
        return look_at(eye=(rot @ eye).tolist(), target=(rot @ target).tolist(),
                       fov_y_deg=60.0, device=dev)

    cur, prev = at(step), at(max(step - 1, 0))
    return dataclasses.replace(cur, view_to_world_prev=prev.view_to_world,
                               tan_half_fov_y=cam.tan_half_fov_y, aspect=cam.aspect)


def record_path(scene_name: str) -> str:
    return os.path.join(TESTS_DIR, f"{scene_name}.json")


def build_replay_context(scene_name: str, device=None):
    """(ctx, scene) of a record file's scene at the replay size on
    ``device`` (the CUDA card when None)."""
    glass = scene_name in GLASS_SCENES
    build = traversal.build_scene_contexts if glass else traversal.build_context
    return build(REPLAY_SCENES[scene_name](), device=device)


def replay_record(ctx, scene, scene_name: str, index: int, device=None, **base):
    """Render record ``index`` of a scene file through all its frames: its
    own RenderConfig (``render_config(render, **base)``), the history reset
    at the first frame, the history carried across an animated record's
    frames and, where its mode is "orbit" (the default), the camera orbiting
    frame by frame. Returns (outputs of the last frame, history, frames)."""
    device = resolve(device)
    settings, cam, render, animation = load_record_full(record_path(scene_name), index, device)
    cfg = render_config(render, **base)
    hist = frame.History.create(cfg, device)
    frames = (animation or {}).get("frames", 1)
    out = None
    # only orbit records move the camera; a blink record keeps it
    orbit = bool(animation) and animation.get("mode", "orbit") == "orbit"
    for step in range(frames):
        frame_cam = orbit_cam(cam, step) if orbit else cam
        out, hist = frame.render_frame(ctx, scene, frame_cam, cfg, settings, hist,
                                       reset_history=step == 0)
    return out, hist, frames
