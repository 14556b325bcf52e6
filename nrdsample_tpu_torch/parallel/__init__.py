"""Multi-process rendering and training on ``torch.distributed`` (counterpart
of ``nrdsample_tpu/parallel/``): process bring-up and the scene broadcast
(``distributed``), the pixel mesh and the two-phase sharded frame (``mesh``),
the explicit row halo of a row-sharded stencil (``halo``) and the port's
multi-rank dry run (``dryrun``)."""
