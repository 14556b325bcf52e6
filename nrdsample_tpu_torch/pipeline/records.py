"""Settings + camera test records (counterpart of
``nrdsample_tpu/pipeline/records.py``; loading only). A record is one entry
of a ``Tests/<scene>.json`` list."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from nrdsample_tpu_torch.config import Settings
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.scene.types import Camera

RECORD_VERSIONS = (1, 2)


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
