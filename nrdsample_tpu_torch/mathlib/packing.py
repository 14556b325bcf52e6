"""Unit-vector and value packing (counterpart of
``nrdsample_tpu/mathlib/packing.py``): the octahedral encoding of unit
vectors, and the G-buffer plane of normal, roughness and material id."""

from __future__ import annotations

import torch


def _sign_not_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0.0, 1.0, -1.0)


def encode_oct(n: torch.Tensor) -> torch.Tensor:
    """Octahedral encoding of unit vectors [..., 3] -> [..., 2] in [-1, 1]."""
    l1 = torch.sum(torch.abs(n), dim=-1, keepdim=True)
    p = n[..., :2] / torch.clamp_min(l1, 1e-15)
    fold = (1.0 - torch.abs(p.flip(-1))) * _sign_not_zero(p)
    return torch.where(n[..., 2:3] <= 0.0, fold, p)


def decode_oct(e: torch.Tensor) -> torch.Tensor:
    """Octahedral [..., 2] -> unit vectors [..., 3]."""
    z = 1.0 - torch.sum(torch.abs(e), dim=-1, keepdim=True)
    fold = (1.0 - torch.abs(e.flip(-1))) * _sign_not_zero(e)
    v = torch.cat([torch.where(z < 0.0, fold, e), z], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def pack_normal_roughness(n: torch.Tensor, roughness: torch.Tensor,
                          material_id: torch.Tensor) -> torch.Tensor:
    """The [..., 4] G-buffer plane: oct.x, oct.y, roughness, material id."""
    return torch.cat([encode_oct(n), roughness[..., None], material_id[..., None]], dim=-1)


def unpack_normal_roughness(p: torch.Tensor):
    """(normal [..., 3], roughness [...], material id [...]) of a packed plane."""
    return decode_oct(p[..., :2]), p[..., 2], p[..., 3]
