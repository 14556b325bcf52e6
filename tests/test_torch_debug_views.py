"""The debug views, the validation overlay and the TAA-weight plane against
the JAX package's. All 21 ``OnScreen`` views run on the G-buffer, composed
colour and SHARC cache of one JAX frame (the second ``relax_post`` frame of
tests/test_torch_frame_post.py, carried across) with a seeded TAA-weight
plane: the hashed views (INSTANCE_INDEX, SHARC_GRID) exactly equal, the
others within 1e-6 abs/rel. The overlay and ``taa.debug_weight`` run on
seeded planes. The TAA weight is held within 1e-5, the bound
tests/test_torch_taa.py holds the TAA mix to: its CIELAB distance takes the
port's pow(x, 1/3) (the TAA kernel's cube root) where JAX takes cbrt, one
float32 ULP apart, which the 116/500/200 scales and the JND's 0.5/23 make
up to ~1.2e-6 on the weight."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import OnScreen as JOnScreen
from nrdsample_tpu.denoise import composition as jcomposition, taa as jtaa
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import OnScreen
from nrdsample_tpu_torch.denoise import composition, taa
from test_torch_frame_post import cached_frames
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = dict(rtol=1e-6, atol=1e-6)
TAA_TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = {OnScreen.INSTANCE_INDEX, OnScreen.SHARC_GRID}


@pytest.fixture(scope="module")
def jax_gbuffer(tmp_path_factory):
    _, extra = cached_frames(tmp_path_factory, "relax_post")
    return extra


def test_every_view_is_listed():
    assert [v.name for v in OnScreen] == [v.name for v in JOnScreen] and len(OnScreen) == 21


@pytest.mark.parametrize("view", list(OnScreen), ids=lambda v: v.name)
def test_debug_view_matches_jax(jax_gbuffer, view):
    gb, composed, sharc = jax_gbuffer["gbuffer"], jax_gbuffer["composed"], jax_gbuffer["sharc"]
    cam_pos = jax_gbuffer["cam_pos"]
    taa_w = np.random.RandomState(int(view)).uniform(0.1, 1.0, composed.shape[0]).astype(np.float32)
    want = jcomposition.debug_view(
        int(view), {k: jnp.asarray(v) for k, v in gb.items()}, jnp.asarray(composed),
        sharc_state=_jax_sharc(sharc), cam_pos=jnp.asarray(cam_pos), taa_weight=jnp.asarray(taa_w))
    state = convert.history_from_numpy({"frame_index": np.int32(0), "sharc": sharc},
                                       device="cpu").sharc
    got = composition.debug_view(
        view, {k: torch.from_numpy(v) for k, v in gb.items()}, torch.from_numpy(composed),
        sharc_state=state, cam_pos=torch.from_numpy(cam_pos), taa_weight=torch.from_numpy(taa_w))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if view in EXACT:
        assert np.array_equal(got.numpy(), want)
        assert len(np.unique(want.reshape(-1, 3), axis=0)) > 1
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    if view == OnScreen.SHARC_CACHE:
        red = (want == np.float32([1.0, 0.0, 0.0])).all(-1)
        assert 0 < int(red.sum()) < want.shape[0], "the cache is neither empty nor full"


def _jax_sharc(d):
    from nrdsample_tpu.ops.sharc import SharcState

    return SharcState(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("shape", [(1024,), (24, 40)], ids=["flat", "image"])
def test_validation_overlay(shape):
    rs = np.random.RandomState(3)
    img = rs.rand(*shape, 3).astype(np.float32)
    frames = rs.uniform(0.0, 40.0, shape).astype(np.float32)
    want = jcomposition.validation_overlay(jnp.asarray(img), jnp.asarray(frames), jnp.float32(31.0))
    got = composition.validation_overlay(torch.from_numpy(img), torch.from_numpy(frames),
                                         torch.tensor(31.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _taa_planes(seed, h=24, w=40):
    rs = np.random.RandomState(seed)
    return {
        "hist": rs.rand(h, w, 3).astype(np.float32),
        "cur": rs.rand(h, w, 3).astype(np.float32),
        "mv": (rs.randn(h, w, 3) * 2.0).astype(np.float32),
        "view_z": rs.uniform(1.0, 10.0, (h, w)).astype(np.float32),
        "wide": rs.rand(h, w) < 0.3,
    }


@pytest.mark.parametrize("valid,wide", [(1, False), (1, True), (0, False)])
def test_taa_debug_weight(valid, wide):
    p = _taa_planes(4 + valid + 2 * wide)
    jh = jtaa.TaaHistory(color=jnp.asarray(p["hist"]), valid=jnp.int32(valid))
    th = taa.TaaHistory(color=torch.from_numpy(p["hist"]), valid=torch.tensor(valid,
                                                                             dtype=torch.int32))
    want = jtaa.debug_weight(jh, jnp.asarray(p["cur"]), jnp.asarray(p["mv"]),
                             jnp.asarray(p["view_z"]),
                             wide_mask=jnp.asarray(p["wide"]) if wide else None)
    got = taa.debug_weight(th, torch.from_numpy(p["cur"]), torch.from_numpy(p["mv"]),
                           torch.from_numpy(p["view_z"]),
                           wide_mask=torch.from_numpy(p["wide"]) if wide else None)
    assert got.shape == p["view_z"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TAA_TOL)
    if valid:
        assert 0.1 <= float(got.min()) < float(got.max()) <= 1.0
    else:
        assert bool((got == 1.0).all())
