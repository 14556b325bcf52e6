"""Carry parameters and state across from the JAX package.

Each function takes dicts of numpy arrays — the leaves of the JAX package's
``Scene``, ``Camera``, ``Settings`` and ``History`` (the caller does the
jax -> numpy step, so this package never imports jax) — and returns the
port's objects on ``device`` (the CUDA card when None). The values are
copied bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.config import Settings
from nrdsample_tpu_torch.denoise.reblur import ReblurHistory
from nrdsample_tpu_torch.denoise.reference import ReferenceHistory
from nrdsample_tpu_torch.denoise.sigma import SigmaHistory
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.pipeline.frame import History
from nrdsample_tpu_torch.scene.types import Camera, Materials, Scene, TriangleSoA


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _fields(cls, d: dict, device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing leaves {sorted(missing)}")
    return {k: _t(d[k], device) for k in names}


def scene_from_numpy(d: dict, device=None) -> Scene:
    """d: {"tris": {TriangleSoA field: array}, "materials": {Materials field:
    array}, "emissive_tris", "emissive_count", optional "has_emissive",
    "has_alpha_test", "textures", "tri_instance", "instance_scales"}."""
    device = resolve(device)
    for key in ("textures", "tri_instance", "instance_scales"):
        if d.get(key) is not None:
            raise NotImplementedError(f"scene leaf {key!r} is ported in a later slice")
    count = np.asarray(d["emissive_count"])
    return Scene(
        tris=TriangleSoA(**_fields(TriangleSoA, d["tris"], device)),
        materials=Materials(**_fields(Materials, d["materials"], device)),
        emissive_tris=_t(d["emissive_tris"], device),
        emissive_count=_t(count, device),
        has_emissive=bool(d.get("has_emissive", int(count) > 0)),
        has_alpha_test=bool(d.get("has_alpha_test", False)),
    )


def camera_from_numpy(d: dict, device=None) -> Camera:
    """d: {Camera field: array}."""
    return Camera(**_fields(Camera, d, resolve(device)))


def settings_from_numpy(d: dict, device=None) -> Settings:
    """d: {Settings field: 0-d array}; fields left out keep their defaults."""
    unknown = set(d) - {f.name for f in dataclasses.fields(Settings)}
    if unknown:
        raise KeyError(f"Settings: unknown fields {sorted(unknown)}")
    return Settings(**{k: _t(v, "cpu") for k, v in d.items()}).to(resolve(device))


_SLOTS = {"reference": ReferenceHistory, "reblur_diff": ReblurHistory,
          "reblur_spec": ReblurHistory, "sigma": SigmaHistory}


def history_from_numpy(d: dict, device=None) -> History:
    """d: {"frame_index": 0-d array} plus, for each denoiser slot that is
    set, {slot: {leaf: array}}: "reference" (accum, frames), "reblur_diff"
    and "reblur_spec" (illum, fast_illum, hitdist, view_z, normal, frames),
    "sigma" (shadow, frames, view_z)."""
    device = resolve(device)
    slots = {k: cls(**_fields(cls, d[k], device)) for k, cls in _SLOTS.items()
             if d.get(k) is not None}
    return History(frame_index=_t(d["frame_index"], device), **slots)
