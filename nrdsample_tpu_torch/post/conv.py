"""The 3x3 'SAME' convolution of the learned networks, in float32.

The weights are the JAX package's HWIO arrays carried across as OIHW
(``convert.conv_params_from_numpy``). Both libraries compute
cross-correlation, so the kernel is not flipped; a 3x3 kernel at dilation d
pads by d on each side. cuDNN would run float32 convolutions in TF32 by
default (``torch.backends.cudnn.allow_tf32``), which differs from the
float32 of the JAX package by ~1e-3; ``conv_stack`` turns TF32 off for its
own calls only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from nrdsample_tpu_torch.device import resolve


def conv_stack(x: torch.Tensor, params: dict, dilations) -> torch.Tensor:
    """Run (H, W, C) ``x`` through the convolutions ``params["w{i}"]`` (OIHW)
    and ``params["b{i}"]`` at ``dilations[i]``, a ReLU between each two.
    Returns (H, W, C_out)."""
    y = x.permute(2, 0, 1)[None]
    last = len(dilations) - 1
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        for i, d in enumerate(dilations):
            y = F.conv2d(y, params[f"w{i}"], params[f"b{i}"], padding=d, dilation=d)
            if i < last:
                y = torch.relu(y)
    return y[0].permute(1, 2, 0)


def load_weights(path: str, device=None) -> dict:
    """The network weights of ``path`` as OIHW tensors on ``device`` (the CUDA
    card when None), loaded once per path and device; raises
    FileNotFoundError when the file is missing (the port ships its copies, so
    a frame never falls back to another image)."""
    return _load(path, resolve(device))


@functools.lru_cache(maxsize=8)
def _load(path: str, device: torch.device) -> dict:
    from nrdsample_tpu_torch import convert

    with np.load(path) as z:
        return convert.conv_params_from_numpy({k: z[k] for k in z.files}, device)
