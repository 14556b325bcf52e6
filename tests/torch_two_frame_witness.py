"""The witness of ``test_torch_remainders.py``'s two-frame gradient, under
RELAX and under the REFERENCE denoiser: JAX's own gradient swing when its
G-buffer moves one ULP, and the port's end-to-end and pinned gaps, each as
a field's largest |diff| over its largest |JAX entry|. On the CPU, about a
minute a denoiser::

    JAX_PLATFORMS=cpu python tests/torch_two_frame_witness.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import test_torch_remainders as t  # noqa: E402


def main() -> int:
    for jden, den in ((t.JDenoiser.RELAX, t.Denoiser.RELAX),
                      (t.JDenoiser.REFERENCE, t.Denoiser.REFERENCE)):
        want = t._jax_two_frames(jden)
        row = {"denoiser": den.name,
               "jax_one_ulp_swing": [t.gradient_gaps(g, want["grads"])
                                     for g in want["nudged_grads"]]}
        for name, pin in (("port_end_to_end", False), ("port_at_jax_gbuffer", True)):
            _, grads, _ = t.port_two_frames(want, den, pin_to_jax=pin)
            row[name] = t.gradient_gaps(grads, want["grads"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
