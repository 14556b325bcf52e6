"""Where the port's entry points put their tensors: on the CUDA card unless
the caller names another device."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Without a card, None raises here rather than carrying on on the CPU: the
    CPU runs only the kernels' plain versions, and a caller who wants that
    asks for it with ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device=None means the CUDA card, and torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")
