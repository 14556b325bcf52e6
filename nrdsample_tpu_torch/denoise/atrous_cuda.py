"""One RELAX à-trous iteration on the card: the wrapper of
``csrc/relax_atrous.cu``, the port of the Pallas kernel
``nrdsample_tpu/denoise/atrous_pallas.py:_iteration_kernel``
(``atrous_iteration_pallas``). Its plain version is
``relax.atrous_iteration``; ``relax.atrous`` picks one of the two by the
device of the planes. The step is a runtime argument, so one kernel serves
the five iterations.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels

#: launches of the à-trous kernel (incremented once per launch)
LAUNCHES = 0


def atrous_iteration_cuda(illum, variance, view_z, normal, step: int, phi_luminance: float,
                          phi_normal: float, phi_depth: float):
    """Launch one iteration on float32 planes of one CUDA device: illum
    (H, W, 3), variance (H, W), view_z (H, W), normal (H, W, 3). Returns
    (illum (H, W, 3), variance (H, W))."""
    global LAUNCHES
    _kernels.check_no_grad("atrous_iteration_cuda", illum, variance, view_z, normal)
    dev = illum.device
    if dev.type != "cuda":
        raise ValueError(f"atrous_iteration_cuda needs CUDA tensors, got {dev}")
    h, w = view_z.shape
    f32 = torch.float32
    illum, variance, view_z, normal = (t.contiguous() for t in (illum, variance, view_z, normal))
    for name, t, shape in (("illum", illum, (h, w, 3)), ("variance", variance, (h, w)),
                           ("view_z", view_z, (h, w)), ("normal", normal, (h, w, 3))):
        _kernels.check_tensor(name, t, f32, shape, dev)
    if int(step) <= 0:
        raise ValueError(f"step must be positive, got {step}")
    out_illum = torch.empty((h, w, 3), dtype=f32, device=dev)
    out_var = torch.empty((h, w), dtype=f32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_relax_atrous(illum.data_ptr(), variance.data_ptr(), view_z.data_ptr(),
                                  normal.data_ptr(), h, w, int(step), float(phi_luminance),
                                  float(phi_normal), float(phi_depth), out_illum.data_ptr(),
                                  out_var.data_ptr(), stream)
    _kernels.check(rc, "nrd_relax_atrous")
    LAUNCHES += 1
    return out_illum, out_var
