"""Stateless counter-based RNG + low-discrepancy sequences.

The PCG4D hash of the JAX package, bit for bit. It relies on uint32
wraparound; torch's uint32 lacks ``+`` and ``>>`` on the CPU, so the words
travel as int64 holding values below 2^32 and are masked after every add and
multiply. An int64 product of two such values wraps modulo 2^64, which keeps
its low 32 bits exact.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020): int64 [..., 4] words below
    2^32 -> int64 [..., 4] words below 2^32."""
    v = (v * 1664525 + 1013904223) & _MASK
    x, y, z, w = v.unbind(-1)
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK
    return torch.stack([x, y, z, w], dim=-1)


def hash_u32(pixel: torch.Tensor, frame, dim) -> torch.Tensor:
    """4 independent 32-bit random words per element (int64 [..., 4]).

    pixel: integer tensor (flat pixel/ray index); frame, dim: ints or
    integer tensors broadcastable to pixel's shape."""
    pixel = pixel.to(torch.int64)
    frame = torch.as_tensor(frame, device=pixel.device).to(torch.int64).expand(pixel.shape)
    dim = torch.as_tensor(dim, device=pixel.device).to(torch.int64).expand(pixel.shape)
    v = torch.stack([pixel, frame, dim, torch.full_like(pixel, _GOLDEN)], dim=-1) & _MASK
    return pcg4d(v)


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    # the top 24 bits -> [0, 1), exact in float32
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform4(pixel, frame, dim) -> torch.Tensor:
    """4 uniform floats in [0, 1) per element: [..., 4]."""
    return _to_unit_float(hash_u32(pixel, frame, dim))


def uniform2(pixel, frame, dim) -> torch.Tensor:
    return uniform4(pixel, frame, dim)[..., :2]


def uniform1(pixel, frame, dim) -> torch.Tensor:
    return uniform4(pixel, frame, dim)[..., 0]


_BAYER4 = ((0, 8, 2, 10), (12, 4, 14, 6), (3, 11, 1, 9), (15, 7, 13, 5))


def bayer4x4(px: torch.Tensor, py: torch.Tensor, frame=0) -> torch.Tensor:
    """Ordered-dither value in [0, 1) for integer pixel coords, rotating with
    frame by a Weyl step."""
    table = torch.tensor(_BAYER4, dtype=torch.float32, device=px.device) / 16.0
    base = table[py.to(torch.int64) & 3, px.to(torch.int64) & 3]
    rot = torch.as_tensor(frame, device=px.device).to(torch.float32) * 0.618034
    return torch.remainder(base + rot, 1.0)


def weyl1d(n, seed: int = 0) -> torch.Tensor:
    """1-D Weyl (additive-recurrence) sequence."""
    n = torch.as_tensor(n).to(torch.float32)
    return torch.remainder(float(seed) + n * 0.618034, 1.0)


def weyl2d(n) -> torch.Tensor:
    """2-D Weyl sequence with the plastic-number basis (the R2 sequence):
    [..., 2] in [0, 1)."""
    n = torch.as_tensor(n).to(torch.float32)[..., None]
    alphas = torch.tensor([0.7548776662, 0.5698402910], dtype=torch.float32, device=n.device)
    return torch.remainder(n * alphas, 1.0)


def _halton_iters(base: int) -> int:
    import math

    return max(1, int(math.ceil(32 * math.log(2) / math.log(base))))


def halton(n, base: int) -> torch.Tensor:
    """Radical inverse of the int32 ``n`` in ``base`` (float32, unrolled
    over the 32-bit range)."""
    n = torch.as_tensor(n).to(torch.int32)
    result = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    f = torch.tensor(1.0, dtype=torch.float32, device=n.device)
    inv_b = torch.tensor(1.0 / base, dtype=torch.float32, device=n.device)
    for _ in range(_halton_iters(base)):
        f = f * inv_b
        result = result + f * torch.remainder(n, base).to(torch.float32)
        n = torch.div(n, base, rounding_mode="floor")
    return result


def halton23(n) -> torch.Tensor:
    """The (2, 3) Halton point [..., 2] of camera jitter."""
    return torch.stack([halton(n, 2), halton(n, 3)], dim=-1)


def checkerboard(px, py, frame) -> torch.Tensor:
    """2x2 checkerboard selector alternating per frame: int32 0/1."""
    f = torch.as_tensor(frame, device=px.device).to(torch.int32)
    return (px.to(torch.int32) ^ py.to(torch.int32) ^ f) & 1
