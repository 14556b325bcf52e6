"""nrdsample_tpu_torch — the PyTorch/CUDA port of ``nrdsample_tpu``.

Mirrors the JAX package's module tree: each module here has its counterpart at
the same relative path under ``nrdsample_tpu/``. Plain tensor code is PyTorch
(eager, explicit ``device``); every Pallas kernel on the ported path is a
hand-written CUDA C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at
first use and bound through ``ctypes``.

Ported so far: every branch of ``pipeline.frame.render_frame`` (every
denoiser, the radiance caches, TAA, the output-resolution chain with the
learned SR and RR networks, the debug views), for scenes in dense mode
(<= 1024 triangles), cluster mode and the bvh8 mode, with glass, textures,
normal maps and the alpha test; glTF scenes (``scene.gltf.load_gltf``);
instanced, animated scenes (``pipeline.animate``); the record replay, record
saving and the golden gate (``pipeline.records``, ``pipeline.replay``); the
training step, its backward bench and checkpoints (``pipeline/train.py``,
``checkpoint.py``), with JAX's gradient conventions; the frame and the
training step sharded over ``torch.distributed`` ranks (``parallel/``);
``utils.log`` and ``utils.profiling``; and the ``render``, ``optimize``,
``animate`` and ``scenes`` commands of ``python -m nrdsample_tpu_torch.cli``.
Entry points put their tensors on the CUDA card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
