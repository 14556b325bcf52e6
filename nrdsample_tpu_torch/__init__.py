"""nrdsample_tpu_torch — the PyTorch/CUDA port of ``nrdsample_tpu``.

Mirrors the JAX package's module tree: each module here has its counterpart at
the same relative path under ``nrdsample_tpu/``. Plain tensor code is PyTorch
(eager, explicit ``device``); every Pallas kernel on the ported path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes``.

Ported so far: the dense-mode (<= 1024 triangles) path-traced frame with the
REFERENCE accumulator — ``pipeline.frame.render_frame`` end to end. Branches of
later slices raise ``NotImplementedError``.
"""

__version__ = "0.1.0"
