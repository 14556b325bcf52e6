"""Checkpoint and resume (counterpart of
``nrdsample_tpu/pipeline/checkpoint.py``): the History, the Materials and
the step of a long optimisation run, saved as named trees.

One format, the port's own: a numpy ``.npz`` archive (written to a
temporary file, then renamed into place) whose arrays are the trees'
tensors, each with its dtype and shape as they are (the SHARC keys stay
int64 and bit for bit), and whose ``__manifest__`` array holds a JSON
description of the trees: each node is a dataclass of this package
(``History``, its slots, ``Materials``), a dict, a tensor or None. Nothing
is pickled, and a missing or malformed file raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

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
from nrdsample_tpu_torch.scene.types import Materials

FORMAT = "nrdsample_tpu_torch.checkpoint"
VERSION = 1
_MANIFEST = "__manifest__"
#: the dataclasses a checkpoint may hold, by name
CLASSES = {c.__name__: c for c in (History, ReferenceHistory, RelaxHistory, ReblurHistory,
                                   SigmaHistory, TaaHistory, SharcState, ConfidenceHistory,
                                   L1History, NeuralRRHistory, Materials)}


class CheckpointError(ValueError):
    """The file is not a checkpoint of this format, or does not match
    ``like``."""


def _encode(obj, path: str, arrays: dict):
    if obj is None:
        return {"none": True}
    if isinstance(obj, torch.Tensor):
        key = f"t{len(arrays)}"
        arrays[key] = obj.detach().cpu().numpy()
        return {"tensor": key}
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in CLASSES:
        return {"dataclass": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name), f"{path}.{f.name}", arrays)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        return {"dict": {k: _encode(v, f"{path}[{k!r}]", arrays) for k, v in obj.items()}}
    raise TypeError(f"{path}: cannot checkpoint a {type(obj).__name__}")


def save(path: str, step: int, **trees: Any) -> None:
    """Save the named trees (History, Materials, dicts of tensors) and the
    step to ``path``."""
    arrays: dict = {}
    manifest = {"format": FORMAT, "version": VERSION, "step": int(step),
                "trees": {name: _encode(t, name, arrays) for name, t in trees.items()}}
    arrays[_MANIFEST] = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _decode(node, like, path: str, data, device, match: bool):
    """The tree of ``node``; with ``match``, ``like`` is its live
    counterpart, which it must equal in structure, shape and dtype."""
    if not isinstance(node, dict):
        raise CheckpointError(f"{path}: malformed manifest node")
    if "none" in node:
        if match and like is not None:
            raise CheckpointError(f"{path}: None in the checkpoint, a {type(like).__name__} "
                                  "in like")
        return None
    if "tensor" in node:
        if node["tensor"] not in data.files:
            raise CheckpointError(f"{path}: array {node['tensor']!r} missing")
        arr = data[node["tensor"]]
        if match:
            if not isinstance(like, torch.Tensor):
                raise CheckpointError(f"{path}: a tensor in the checkpoint, a "
                                      f"{type(like).__name__} in like")
            if (tuple(arr.shape) != tuple(like.shape)
                    or torch.from_numpy(np.empty(0, arr.dtype)).dtype != like.dtype):
                raise CheckpointError(f"{path}: {arr.dtype}{tuple(arr.shape)} in the "
                                      f"checkpoint, {like.dtype}{tuple(like.shape)} in like")
            device = like.device
        return torch.from_numpy(arr.copy()).to(device)
    if "dataclass" in node:
        cls = CLASSES.get(node["dataclass"])
        fields = node.get("fields")
        if cls is None or not isinstance(fields, dict):
            raise CheckpointError(f"{path}: unknown dataclass {node['dataclass']!r}")
        if match and type(like) is not cls:
            raise CheckpointError(f"{path}: a {cls.__name__} in the checkpoint, a "
                                  f"{type(like).__name__} in like")
        names = [f.name for f in dataclasses.fields(cls)]
        if sorted(fields) != sorted(names):
            raise CheckpointError(f"{path}: {cls.__name__} fields {sorted(fields)}")
        return cls(**{k: _decode(fields[k], getattr(like, k) if match else None, f"{path}.{k}",
                                 data, device, match) for k in names})
    if "dict" in node:
        items = node["dict"]
        if match and (not isinstance(like, dict) or sorted(like) != sorted(items)):
            raise CheckpointError(f"{path}: dict keys {sorted(items)} do not match like")
        return {k: _decode(v, like[k] if match else None, f"{path}[{k!r}]", data, device, match)
                for k, v in items.items()}
    raise CheckpointError(f"{path}: malformed manifest node")


def restore(path: str, like: dict[str, Any] | None = None, device=None) -> dict[str, Any]:
    """{"step": int, name: tree, ...} as ``save`` wrote them. ``like``, a
    dict of the same-named live trees, must match the saved trees in
    structure, shape and dtype, and puts each tensor on its counterpart's
    device; without it the tensors go to ``device`` (the CUDA card when
    None). Raises FileNotFoundError for a missing file and CheckpointError
    for one that is not a checkpoint or does not match ``like``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    device = resolve(device) if like is None else None
    try:
        with np.load(path, allow_pickle=False) as data:
            return _restore(data, path, like, device)
    except CheckpointError:
        raise
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
        raise CheckpointError(f"{path} is not a readable checkpoint: {e}") from e


def _restore(data, path: str, like, device) -> dict[str, Any]:
    if not hasattr(data, "files") or _MANIFEST not in data.files:
        raise CheckpointError(f"{path} has no manifest")
    manifest = json.loads(data[_MANIFEST].tobytes().decode())
    if (not isinstance(manifest, dict) or manifest.get("format") != FORMAT
            or manifest.get("version") != VERSION or not isinstance(manifest.get("trees"), dict)
            or not isinstance(manifest.get("step"), int)):
        raise CheckpointError(f"{path} is not a {FORMAT} version {VERSION} checkpoint")
    trees = manifest["trees"]
    if like is not None and sorted(like) != sorted(trees):
        raise CheckpointError(f"{path} holds trees {sorted(trees)}, like names {sorted(like)}")
    return {"step": manifest["step"],
            **{name: _decode(node, None if like is None else like[name], name, data, device,
                             like is not None)
               for name, node in trees.items()}}
