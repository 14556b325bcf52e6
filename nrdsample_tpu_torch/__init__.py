"""nrdsample_tpu_torch — the PyTorch/CUDA port of ``nrdsample_tpu``.

Mirrors the JAX package's module tree: each module here has its counterpart at
the same relative path under ``nrdsample_tpu/``. Plain tensor code is PyTorch
(eager, explicit ``device``); every Pallas kernel on the ported path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes``.

Ported so far: ``pipeline.frame.render_frame`` end to end for scenes in
dense mode (<= 1024 triangles, brute-force hits) and in cluster mode (up to
2048 clusters of 128 triangles, the packet kernel), with the REFERENCE
accumulator or REBLUR + SIGMA. Entry points put their tensors on the CUDA
card unless the caller passes ``device="cpu"``. Branches of later slices
raise ``NotImplementedError``.
"""

__version__ = "0.1.0"
