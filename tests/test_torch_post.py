"""The port's output chain against the JAX package's, on seeded numpy
inputs: the Lanczos resampling matrix (equal) and resize, NIS sharpening,
the DlssAfter tonemap, the Final pass (split screen, overlay, divider,
dither), the guide buffers, and the colour helpers the chain uses. Values
within 1e-6 abs/rel; the dither's noise exactly equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.mathlib import color as jcolor
from nrdsample_tpu.mathlib import rng as jrng
from nrdsample_tpu.post import final as jfinal, guides as jguides, nis as jnis
from nrdsample_tpu.post import upscale as jupscale
from nrdsample_tpu_torch.mathlib import color
from nrdsample_tpu_torch.post import final, guides, nis, upscale
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(seed, *shape, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _close(got, want, **tol):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, **(tol or TOL))


@pytest.mark.parametrize("n_out,n_in,a", [(48, 32, 2), (20, 32, 2), (37, 17, 2), (32, 32, 2),
                                          (2160, 1080, 2), (40, 24, 1)])
def test_resample_matrix_equal(n_out, n_in, a):
    want = jupscale.resample_matrix(n_out, n_in, a)
    got = upscale.resample_matrix(n_out, n_in, a)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("out_hw", [(48, 80), (13, 21), (24, 40)], ids=["up", "down", "same"])
@pytest.mark.parametrize("channels", [3, None], ids=["hwc", "hw"])
def test_lanczos_resize(out_hw, channels):
    x = _rand(1, 24, 40, *(() if channels is None else (channels,)), hi=3.0)
    want = jupscale.lanczos_resize(jnp.asarray(x), *out_hw)
    _close(upscale.lanczos_resize(torch.from_numpy(x), *out_hw), want)


def test_bilinear_resize():
    x = _rand(2, 16, 24, 3)
    _close(upscale.bilinear_resize(torch.from_numpy(x), 33, 47),
           jupscale.bilinear_resize(jnp.asarray(x), 33, 47))


@pytest.mark.parametrize("sharpness", [0.0, 0.15, 1.0])
def test_sharpen(sharpness):
    x = _rand(3, 24, 40, 3, hi=2.0)
    want = jnis.sharpen(jnp.asarray(x), jnp.float32(sharpness))
    _close(nis.sharpen(torch.from_numpy(x), torch.tensor(sharpness)), want)


def test_tonemap_output():
    x = _rand(4, 24, 40, 3, hi=20.0)
    want = jfinal.tonemap_output(jnp.asarray(x), jnp.float32(0.35))
    _close(final.tonemap_output(torch.from_numpy(x), torch.tensor(0.35)), want)


@pytest.mark.parametrize("fn", ["to_gamma", "srgb_to_linear", "tonemap_uncharted",
                                "linear_to_srgb"])
def test_color_helpers(fn):
    x = _rand(5, 4096, 3, lo=-0.5, hi=8.0)
    _close(getattr(color, fn)(torch.from_numpy(x)), getattr(jcolor, fn)(jnp.asarray(x)))


FINAL_CASES = {
    "split_overlay_divider_dither": dict(noisy=True, separator=0.5, validation=True, frame=3),
    "no_split": dict(noisy=False, separator=0.0, validation=False, frame=0),
    "separator_off": dict(noisy=True, separator=0.0, validation=False, frame=7),
    "linear_no_dither": dict(noisy=True, separator=0.3, validation=True, frame=1, srgb=False,
                             dither=False),
}


@pytest.mark.parametrize("case", sorted(FINAL_CASES))
def test_final_pass(case):
    c = FINAL_CASES[case]
    den, noisy, val = _rand(6, 24, 40, 3, hi=1.2), _rand(7, 24, 40, 3), _rand(8, 24, 40, 4)
    flags = dict(srgb=c.get("srgb", True), dither=c.get("dither", True))
    want = jfinal.final_pass(jnp.asarray(den), jnp.asarray(noisy) if c["noisy"] else None,
                             jnp.float32(c["separator"]),
                             jnp.asarray(val) if c["validation"] else None,
                             jnp.int32(c["frame"]), **flags)
    got = final.final_pass(torch.from_numpy(den), torch.from_numpy(noisy) if c["noisy"] else None,
                           torch.tensor(c["separator"]),
                           torch.from_numpy(val) if c["validation"] else None,
                           torch.tensor(c["frame"], dtype=torch.int32), **flags)
    _close(got, want)
    if c["noisy"] and c["separator"] > 0.0 and flags["srgb"]:
        # the divider column is NV green, up to the dither
        divider = np.abs(np.arange(40) - c["separator"] * 40) < 1.0
        assert divider.any()
        gap = np.abs(got.numpy()[:, divider] - np.float32(final.NV_GREEN))
        assert gap.max() <= 0.5 / 255.0 + 1e-6


@pytest.mark.parametrize("frame_index", [0, 5])
def test_dither_noise_exact(frame_index):
    """The dither is the port's PCG stream 977 over the pixel index: equal to
    JAX's bit for bit."""
    h, w = 24, 40
    pix = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    want = (jrng.uniform1(pix, frame_index, 977)[..., None] - 0.5) * (1.0 / 255.0)
    got = final.dither_noise(h, w, torch.tensor(frame_index, dtype=torch.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_hw_depth():
    vz = _rand(9, 32, 32, lo=-50.0, hi=50.0)
    _close(guides.hw_depth(torch.from_numpy(vz), 0.01), jguides.hw_depth(jnp.asarray(vz), 0.01))


def _gbuffer(seed, n=1024):
    rs = np.random.RandomState(seed)
    normal = rs.randn(n, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return {
        "base_color": rs.rand(n, 3).astype(np.float32),
        "metalness": rs.rand(n).astype(np.float32),
        "roughness": rs.rand(n).astype(np.float32),
        "normal": normal,
        "view_z": rs.uniform(0.005, 30.0, n).astype(np.float32),
        "spec_hitdist": rs.rand(n).astype(np.float32) * 5.0,
        "mv": rs.randn(n, 3).astype(np.float32),
        "mv_world": rs.randn(n, 3).astype(np.float32),
    }


@pytest.mark.parametrize("mv_type", [None, 0, 1])
def test_rr_guides(mv_type):
    gb = _gbuffer(10)
    want = jguides.rr_guides({k: jnp.asarray(v) for k, v in gb.items()}, near=0.01,
                             mv_type=None if mv_type is None else jnp.int32(mv_type))
    got = guides.rr_guides({k: torch.from_numpy(v) for k, v in gb.items()}, near=0.01,
                           mv_type=None if mv_type is None else torch.tensor(mv_type,
                                                                             dtype=torch.int32))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    assert np.array_equal(got["mv"].numpy(), gb["mv_world" if mv_type == 1 else "mv"])
