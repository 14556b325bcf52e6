"""Carry parameters and state across from the JAX package.

Each function takes dicts of numpy arrays — the leaves of the JAX package's
``Scene``, ``Camera``, ``Settings`` and ``History``, or its network weights
(the caller does the jax -> numpy step, so this package never imports jax) —
and returns the port's objects on ``device`` (the CUDA card when None). The
values are copied bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.config import Settings
from nrdsample_tpu_torch.denoise.confidence import ConfidenceHistory
from nrdsample_tpu_torch.denoise.reblur import ReblurHistory
from nrdsample_tpu_torch.denoise.reference import ReferenceHistory
from nrdsample_tpu_torch.denoise.relax import RelaxHistory
from nrdsample_tpu_torch.denoise.sigma import SigmaHistory
from nrdsample_tpu_torch.denoise.taa import TaaHistory
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.ops.sharc import SharcState
from nrdsample_tpu_torch.pipeline.frame import History
from nrdsample_tpu_torch.post.neural_rr import NeuralRRHistory
from nrdsample_tpu_torch.render.l1cache import L1History
from nrdsample_tpu_torch.scene.animation import OrbitPool
from nrdsample_tpu_torch.scene.instances import InstancedScene
from nrdsample_tpu_torch.scene.textures import TextureSet
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
    "has_alpha_test", "textures" ({"levels": [(M, h, w, 10) array per mip
    level]}, a TextureSet's leaves), "tri_instance", "instance_scales"}."""
    device = resolve(device)
    count = np.asarray(d["emissive_count"])
    textures = d.get("textures")
    if textures is not None:
        textures = TextureSet([_t(np.asarray(lv, np.float32), device) for lv in textures["levels"]])
    return Scene(
        tris=TriangleSoA(**_fields(TriangleSoA, d["tris"], device)),
        materials=Materials(**_fields(Materials, d["materials"], device)),
        emissive_tris=_t(d["emissive_tris"], device),
        emissive_count=_t(count, device),
        has_emissive=bool(d.get("has_emissive", int(count) > 0)),
        has_alpha_test=bool(d.get("has_alpha_test", False)),
        textures=textures,
        tri_instance=None if d.get("tri_instance") is None else _t(d["tri_instance"], device),
        instance_scales=(None if d.get("instance_scales") is None
                         else _t(d["instance_scales"], device)),
    )


def orbit_pool_from_numpy(d: dict, device=None) -> OrbitPool:
    """d: {OrbitPool field: array}, the leaves of the JAX package's pool."""
    return OrbitPool(**_fields(OrbitPool, d, resolve(device)))


def instanced_scene_from_numpy(d: dict, device=None) -> InstancedScene:
    """d: {"scene": the dict of ``scene_from_numpy``, "instance_id": (T,)
    int32 (in the context's triangle order, padded, as the JAX package's
    ``assign_instance_ids`` leaves it), "n_instances": int, optional
    "instance_scales": (I, 10)}."""
    device = resolve(device)
    scales = d.get("instance_scales")
    return InstancedScene(
        scene=scene_from_numpy(d["scene"], device),
        instance_id=_t(d["instance_id"], device),
        n_instances=int(d["n_instances"]),
        instance_scales=None if scales is None else _t(scales, device),
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


def conv_params_from_numpy(d: dict, device=None) -> dict:
    """d: {"w{i}": (3, 3, C_in, C_out) HWIO kernel, "b{i}": (C_out,) bias}, a
    network of the JAX package (``post/neural_sr.npz``, ``neural_rr.npz``).
    Returns the same keys with each kernel as an OIHW tensor (contiguous),
    the layout ``torch.nn.functional.conv2d`` takes, and each bias as it
    is."""
    device = resolve(device)
    out = {}
    for k, v in d.items():
        t = _t(v, device)
        if k.startswith("w"):
            if t.dim() != 4:
                raise ValueError(f"{k}: expected an HWIO kernel, got shape {tuple(t.shape)}")
            t = t.permute(3, 2, 0, 1).contiguous()
        elif not k.startswith("b"):
            raise KeyError(f"unknown network parameter {k!r}")
        out[k] = t
    return out


_SLOTS = {"reference": ReferenceHistory, "relax_diff": RelaxHistory, "relax_spec": RelaxHistory,
          "reblur_diff": ReblurHistory, "reblur_spec": ReblurHistory, "sigma": SigmaHistory,
          "taa": TaaHistory, "sharc": SharcState, "confidence": ConfidenceHistory,
          "l1": L1History, "neural_rr": NeuralRRHistory}


def history_from_numpy(d: dict, device=None) -> History:
    """d: {"frame_index": 0-d array} plus, for each slot that is set, {slot:
    {leaf: array}}: "reference" (accum, frames), "relax_diff" and
    "relax_spec" (illum, moments, view_z, normal, frames), "reblur_diff" and
    "reblur_spec" (illum, fast_illum, hitdist, view_z, normal, frames),
    "sigma" (shadow, frames, view_z), "taa" (color, valid), "sharc" (keys
    uint32, accum, resolved, last_seen), "confidence" (probe_lum, view_z),
    "l1" (packed, valid) and "neural_rr" (color, valid).
    SHARC's uint32 keys become the port's int64 keys of the same value."""
    device = resolve(device)
    slots = {}
    for k, cls in _SLOTS.items():
        if d.get(k) is None:
            continue
        leaves = dict(d[k])
        if cls is SharcState:
            leaves["keys"] = np.asarray(leaves["keys"], np.uint32).astype(np.int64)
        slots[k] = cls(**_fields(cls, leaves, device))
    return History(frame_index=_t(d["frame_index"], device), **slots)
