"""nrdsample_tpu_torch — the PyTorch/CUDA port of ``nrdsample_tpu``.

Mirrors the JAX package's module tree: each module here has its counterpart at
the same relative path under ``nrdsample_tpu/``. Plain tensor code is PyTorch
(eager, explicit ``device``); every Pallas kernel on the ported path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes``.

Ported so far: every branch of ``pipeline.frame.render_frame`` (every
denoiser, the radiance caches, TAA, the output-resolution chain with the
learned SR and RR networks, the debug views), for scenes in dense mode
(<= 1024 triangles) and cluster mode, with glass, textures, normal maps
and the alpha test; glTF scenes (``scene.gltf.load_gltf``); the record
replay and its golden gate (``pipeline.replay``); the single-device
training step, its backward bench and checkpoints (``pipeline/train.py``,
``checkpoint.py``), with JAX's gradient conventions; and the ``render``,
``optimize`` and ``scenes`` commands of ``python -m
nrdsample_tpu_torch.cli``. Entry points
put their tensors on the CUDA card unless the caller passes
``device="cpu"``. Instanced scenes (the animate path, a later slice) raise
``NotImplementedError``.
"""

__version__ = "0.1.0"
