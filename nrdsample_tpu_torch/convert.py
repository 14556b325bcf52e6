"""Carry parameters and state across from the JAX package.

Each function takes dicts of numpy arrays — the leaves of the JAX package's
``Scene``, ``Camera``, ``Settings`` and ``ReferenceHistory`` (the caller does
the jax -> numpy step, so this package never imports jax) — and returns the
port's objects on ``device``. The values are copied bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.config import Settings
from nrdsample_tpu_torch.denoise.reference import ReferenceHistory
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
    return Camera(**_fields(Camera, d, device))


def settings_from_numpy(d: dict, device=None) -> Settings:
    """d: {Settings field: 0-d array}; fields left out keep their defaults."""
    unknown = set(d) - {f.name for f in dataclasses.fields(Settings)}
    if unknown:
        raise KeyError(f"Settings: unknown fields {sorted(unknown)}")
    s = Settings(**{k: _t(v, "cpu") for k, v in d.items()})
    return s.to(device) if device is not None else s


def history_from_numpy(d: dict, device=None) -> History:
    """d: {"frame_index": 0-d array, "reference": {"accum", "frames"}}."""
    ref = d.get("reference")
    return History(
        frame_index=_t(d["frame_index"], device),
        reference=None if ref is None else ReferenceHistory(**_fields(ReferenceHistory, ref, device)),
    )
