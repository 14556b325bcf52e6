"""Dense closest hit on the card: wrapper of ``csrc/dense_hit.cu``, the
port of ``nrdsample_tpu/ops/dense_pallas.py:closest_hit_dense_pallas``. Its
plain version is ``ops/intersect.intersect_dense``; ``ops/traversal`` picks
one of the two by the device of the rays.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels, intersect

T_MAX = intersect.T_MAX
MAX_TRIS = 1024  # traversal.DENSE_CUTOFF: the kernel takes all of dense mode

#: launches of the dense hit kernel (incremented once per launch)
LAUNCHES = 0


def closest_hit_dense_cuda(p0, e1, e2, origin, direction, t_max=T_MAX) -> dict:
    """Launch the dense hit kernel. origin/direction (N, 3) float32 and
    p0/e1/e2 (E, 3) float32 on one CUDA device, E <= 1024; t_max a number or
    an (N,) float32 tensor. Returns dict(t, u, v, tri) of (N,) tensors."""
    global LAUNCHES
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_dense_cuda needs CUDA tensors, got {dev}")
    n, e = origin.shape[0], p0.shape[0]
    if e > MAX_TRIS:
        raise ValueError(f"dense hit kernel takes at most {MAX_TRIS} triangles, got {e}")
    f32 = torch.float32
    check = _kernels.check_tensor
    check("origin", origin, f32, (n, 3), dev)
    check("direction", direction, f32, (n, 3), dev)
    for name, x in (("p0", p0), ("e1", e1), ("e2", e2)):
        check(name, x, f32, (e, 3), dev)
    tm_ptr, tm_scalar = None, 0.0
    if isinstance(t_max, torch.Tensor) and t_max.dim() > 0:
        check("t_max", t_max, f32, (n,), dev)
        tm_ptr = t_max.data_ptr()
    else:
        tm_scalar = float(t_max)
    t = torch.empty(n, dtype=f32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_dense_hit(origin.data_ptr(), direction.data_ptr(), p0.data_ptr(),
                               e1.data_ptr(), e2.data_ptr(), e, tm_ptr, tm_scalar, n,
                               t.data_ptr(), u.data_ptr(), v.data_ptr(), tri.data_ptr(),
                               stream)
    _kernels.check(rc, "nrd_dense_hit")
    LAUNCHES += 1
    return {"t": t, "u": u, "v": v, "tri": tri}

