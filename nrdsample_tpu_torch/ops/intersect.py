"""Dense ray-triangle closest hit: the plain PyTorch version of the dense hit
kernel (``csrc/dense_hit.cu``), counterpart of
``nrdsample_tpu/ops/intersect.py:intersect_dense``.

A loop over the triangle table on (R,) tensors, with the epsilons and the
first-hit tie-break of the JAX package's Möller-Trumbore (``_mt_intersect``):
a triangle replaces the best hit only when its t is strictly smaller."""

from __future__ import annotations

import torch

EPS = 1e-7
T_MAX = 1e5  # INF of config.py


def mt_intersect(ox, oy, oz, dx, dy, dz, p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Möller-Trumbore on component planes; returns (t, u, v, hit). Backface
    hits count (two-sided traversal)."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    small = torch.abs(det) < EPS
    inv_det = torch.where(small, 0.0, torch.reciprocal(torch.where(det == 0, 1.0, det)))
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = ~small & (u >= -1e-6) & (v >= -1e-6) & (u + v <= 1.0 + 1e-6) & (t > 1e-5)
    return t, u, v, hit


def intersect_dense(origin: torch.Tensor, direction: torch.Tensor,
                    p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
                    t_max=T_MAX) -> dict:
    """Closest hit of R rays against T triangles: dict(t, u, v, tri) of (R,)
    tensors; on a miss t = t_max and tri = -1. ``t_max`` is a number or an
    (R,) tensor."""
    r = origin.shape[0]
    o = origin.unbind(-1)
    d = direction.unbind(-1)
    best_t = torch.empty(r, dtype=origin.dtype, device=origin.device)
    best_t.copy_(torch.as_tensor(t_max, dtype=origin.dtype).expand(r))
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=origin.device)
    # the table's entries enter as Python floats (exact copies of the float32
    # values), so each op is one (R,)-tensor op with a scalar
    for j, row in enumerate(torch.cat([p0, e1, e2], dim=1).detach().cpu().tolist()):
        t, u, v, hit = mt_intersect(*o, *d, *row)
        hit = hit & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        best_u = torch.where(hit, u, best_u)
        best_v = torch.where(hit, v, best_v)
        best_i = torch.where(hit, j, best_i)
    return {"t": best_t, "u": best_u, "v": best_v, "tri": best_i}
