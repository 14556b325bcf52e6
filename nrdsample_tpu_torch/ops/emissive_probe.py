"""Emissive light probe: wrapper of ``csrc/emissive_probe.cu`` (the port of
``nrdsample_tpu/ops/emissive_probe.py:light_probe_pallas``) and its plain
PyTorch version ``light_probe_plain``.

``render/emissive_is.light_probe`` picks one of the two by the device of the
rays.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels, intersect

MAX_TRIS = 512  # the JAX package's emissive_is.DENSE_EMISSIVE_MAX

#: launches of the probe kernel (incremented once per launch)
LAUNCHES = 0


def light_probe_plain(em: dict, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Intensity of the nearest emissive triangle along each ray, 0 on a
    miss: a loop over the emissive table on (N,) tensors with the dense
    hit's test and tie-break (best t starts at T_MAX)."""
    o = origin.unbind(-1)
    d = direction.unbind(-1)
    best_t = torch.full((origin.shape[0],), intersect.T_MAX, dtype=origin.dtype,
                        device=origin.device)
    li = torch.zeros_like(best_t)
    rows = torch.cat([em["p0"], em["e1"], em["e2"], em["intensity"][:, None]], dim=1)
    for row in rows.detach().cpu().tolist():
        t, _, _, hit = intersect.mt_intersect(*o, *d, *row[:9])
        hit = hit & (t < best_t)
        best_t = torch.where(hit, t, best_t)
        li = torch.where(hit, row[9], li)
    return li


def light_probe_cuda(em: dict, origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Launch the probe kernel. origin/direction (N, 3) float32; em["p0"],
    em["e1"], em["e2"] (E, 3) and em["intensity"] (E,) float32, E <= 512,
    all on one CUDA device. Returns (N,) float32. Raises on an input that
    requires grad: the kernel has no backward."""
    global LAUNCHES
    _kernels.check_no_grad("light_probe_cuda", origin, direction,
                           *(em[k] for k in ("p0", "e1", "e2", "intensity")))
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"light_probe_cuda needs CUDA tensors, got {dev}")
    n, e = origin.shape[0], em["p0"].shape[0]
    if e > MAX_TRIS:
        raise ValueError(f"probe kernel takes at most {MAX_TRIS} emitters, got {e}")
    f32 = torch.float32
    check = _kernels.check_tensor
    check("origin", origin, f32, (n, 3), dev)
    check("direction", direction, f32, (n, 3), dev)
    for name in ("p0", "e1", "e2"):
        check(name, em[name], f32, (e, 3), dev)
    check("intensity", em["intensity"], f32, (e,), dev)
    out = torch.empty(n, dtype=f32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_emissive_probe(origin.data_ptr(), direction.data_ptr(),
                                    em["p0"].data_ptr(), em["e1"].data_ptr(),
                                    em["e2"].data_ptr(), em["intensity"].data_ptr(), e, n,
                                    out.data_ptr(), stream)
    _kernels.check(rc, "nrd_emissive_probe")
    LAUNCHES += 1
    return out

