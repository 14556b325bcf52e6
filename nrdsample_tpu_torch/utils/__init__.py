"""Host-side helpers (counterpart of ``nrdsample_tpu/utils``)."""
