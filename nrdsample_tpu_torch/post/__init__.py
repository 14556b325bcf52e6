"""The output-resolution chain (counterpart of ``nrdsample_tpu/post``): the
SR slot (``upscale.lanczos_resize``, or ``neural_sr`` over it), NIS
sharpening (``nis``), the Final pass (``final``), the guide buffers a
learned upscaler or denoiser reads (``guides``) and the learned denoiser of
the RR slot (``neural_rr``)."""
