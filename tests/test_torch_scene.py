"""The port's scene layer against the JAX package's: procedural scene arrays
are exactly equal, the convert.py carry-across is an exact round trip, and
camera rays agree within 1e-6 (a few float32 ULPs of XLA's dot vs the
port's per-component products, and of sin/cos in the aperture sample)."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Settings as JSettings
from nrdsample_tpu.pipeline import frame as jframe, records as jrecords
from nrdsample_tpu.pipeline.replay import TESTS_DIR, cfg_from_render
from nrdsample_tpu.scene import camera as jcam, procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import make_settings
from nrdsample_tpu_torch.pipeline import records
from nrdsample_tpu_torch.scene import camera, procedural
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = 1e-6


def _np_leaves(obj):
    """Dataclass (JAX or port) -> nested dict of numpy leaves."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _np_leaves(v)
        elif v is None or isinstance(v, bool):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _assert_leaves_equal(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_leaves_equal(got[k], want[k], f"{path}.{k}")
        elif want[k] is None or isinstance(want[k], bool):
            assert got[k] == want[k], f"{path}.{k}"
        else:
            assert got[k].dtype == want[k].dtype, f"{path}.{k}: {got[k].dtype} vs {want[k].dtype}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}.{k}")


@pytest.mark.parametrize("name", ["cornell_box", "kitchen", "shader_balls"])
def test_procedural_scene_arrays_equal(name):
    want = _np_leaves(getattr(jproc, name)())
    got = _np_leaves(getattr(procedural, name)())
    _assert_leaves_equal(got, want)


def test_cornell_furnace_equal():
    _assert_leaves_equal(_np_leaves(procedural.cornell_box(furnace=True)),
                         _np_leaves(jproc.cornell_box(furnace=True)))


def test_look_at_equal():
    kw = dict(eye=[0.0, -1.6, 1.6], target=[0.0, 1.5, 1.2], fov_y_deg=65.0, aspect=16 / 9)
    _assert_leaves_equal(_np_leaves(look_at(**kw, device="cpu")), _np_leaves(jlook_at(**kw)))


@pytest.mark.parametrize("name", ["cornell_box", "kitchen"])
def test_convert_scene_round_trip(name):
    want = _np_leaves(getattr(jproc, name)())
    got = _np_leaves(convert.scene_from_numpy(want, device="cpu"))
    for key in ("textures", "tri_instance", "instance_scales"):
        assert got.pop(key) is None and want.pop(key) is None
    _assert_leaves_equal(got, want)


def test_convert_camera_settings_history_round_trip():
    cam = jlook_at([0.3, -3.0, 1.1], [0.0, 0.0, 1.0], fov_y_deg=39.0, aspect=1.5)
    cam = dataclasses.replace(cam, jitter=jnp.asarray([0.25, -0.125], jnp.float32),
                              aperture=jnp.float32(0.05))
    _assert_leaves_equal(_np_leaves(convert.camera_from_numpy(_np_leaves(cam), device="cpu")), _np_leaves(cam))
    s = JSettings(sun_elevation=jnp.float32(-30.0), disable_shadows=jnp.int32(1),
                  blink=jnp.int32(1))
    _assert_leaves_equal(_np_leaves(convert.settings_from_numpy(_np_leaves(s), device="cpu")), _np_leaves(s))
    # the REFERENCE history, and with the L1 cache's; REBLUR's two signal
    # histories plus SIGMA's; RELAX's with SIGMA's, TAA's, the SHARC cache
    # and the confidence history; the RR slot's
    slots = ("reference", "relax_diff", "relax_spec", "reblur_diff", "reblur_spec", "sigma", "taa",
             "sharc", "confidence", "l1", "neural_rr")
    relax_cfg = dataclasses.replace(cfg_from_render({"denoiser": 1}, res=10), use_taa=True,
                                    use_sharc=True, use_confidence=True, sharc_capacity=64)
    for cfg in (cfg_from_render({}, res=8), cfg_from_render({"use_l1_cache": True}, res=8),
                cfg_from_render({"denoiser": 0}, res=8), relax_cfg,
                cfg_from_render({"denoiser": 3}, res=8)):
        h = jframe.History.create(cfg)
        h = dataclasses.replace(h, frame_index=jnp.int32(5))
        want = {k: None if getattr(h, k) is None else _np_leaves(getattr(h, k)) for k in slots}
        want["frame_index"] = np.asarray(h.frame_index)
        got = _np_leaves(convert.history_from_numpy(want, device="cpu"))
        if want["sharc"] is not None:
            # SHARC's uint32 keys arrive as the port's int64 keys, same values
            keys = want["sharc"].pop("keys")
            got_keys = got["sharc"].pop("keys")
            assert keys.dtype == np.uint32 and got_keys.dtype == np.int64
            np.testing.assert_array_equal(got_keys, keys.astype(np.int64))
        _assert_leaves_equal(got, want)


def test_convert_rejects_textures():
    """A JAX TextureSet's levels carry across bit for bit (textures are
    ported); the instance leaves of the animate path are still refused."""
    from nrdsample_tpu.scene import textures as jtextures

    leaves = _np_leaves(jproc.cornell_box())
    maps = [{"base_color": np.random.RandomState(m).rand(8, 8, 4).astype(np.float32)}
            for m in range(len(leaves["materials"]["flags"]))]
    ts = jtextures.build_texture_set(maps, res=8)
    leaves["textures"] = {"levels": [np.asarray(lv) for lv in ts.levels]}
    got = convert.scene_from_numpy(leaves, device="cpu").textures
    assert got.n_mips == ts.n_mips == 4 and got.base_res == 8
    for a, b in zip(got.levels, ts.levels):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for key in ("tri_instance", "instance_scales"):
        bad = dict(_np_leaves(jproc.cornell_box()), **{key: np.zeros(4, np.int32)})
        with pytest.raises(NotImplementedError):
            convert.scene_from_numpy(bad, device="cpu")


def test_record_load_matches_jax():
    path = os.path.join(TESTS_DIR, "cornellbox.json")
    for index in (0, 3, 12):
        js, jc, jr, ja = jrecords.load_record_full(path, index)
        s, c, r, a = records.load_record_full(path, index, device="cpu")
        assert r == jr and a == ja
        _assert_leaves_equal(_np_leaves(s), _np_leaves(js))
        _assert_leaves_equal(_np_leaves(c), _np_leaves(jc))


def test_make_settings_dtypes():
    s = make_settings("cpu", sun_elevation=35.0, disable_shadows=1)
    want = _np_leaves(JSettings(sun_elevation=jnp.float32(35.0), disable_shadows=jnp.int32(1)))
    _assert_leaves_equal(_np_leaves(s), want)


def _cams(aperture):
    cam = jlook_at([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], fov_y_deg=65.0, aspect=16 / 9)
    cam = dataclasses.replace(cam, jitter=jnp.asarray([0.3, -0.2], jnp.float32),
                              aperture=jnp.float32(aperture), focal_distance=jnp.float32(2.5))
    return cam, convert.camera_from_numpy(_np_leaves(cam), device="cpu")


@pytest.mark.parametrize("aperture", [0.0, 0.04])
def test_camera_rays_match(aperture):
    jc, tc = _cams(aperture)
    w, h = 48, 27
    pix = np.arange(w * h, dtype=np.int32)
    want = jcam.camera_rays(jc, w, h, jnp.asarray(pix), jnp.int32(3))
    got = camera.camera_rays(tc, w, h, torch.from_numpy(pix), torch.tensor(3, dtype=torch.int32))
    for g, e in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=TOL, atol=TOL)


def test_screen_transforms_match():
    jc, tc = _cams(0.0)
    jc = dataclasses.replace(jc, view_to_world_prev=jlook_at([0.1, -1.5, 1.6], [0.0, 1.5, 1.2]).view_to_world)
    tc = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    p = np.random.RandomState(3).uniform(-2, 2, (500, 3)).astype(np.float32) + [0, 2.5, 1]
    p = p.astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p)
    pairs = [
        (jcam.world_to_view_z(jc, jp), camera.world_to_view_z(tc, tp)),
        (jcam.world_to_uv(jc, jp), camera.world_to_uv(tc, tp)),
        (jcam.world_to_uv(jc, jp, prev=True), camera.world_to_uv(tc, tp, prev=True)),
        (jcam.get_motion(jc, jp, jp, 64, 36), camera.get_motion(tc, tp, tp, 64, 36)),
        (jcam.unproject_scale(jc, 36), camera.unproject_scale(tc, 36)),
    ]
    # motion vectors are differences of two projections scaled to pixels:
    # one float32 ULP of each uv (~6e-8) becomes ~4e-6 px, so allow 1e-5
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=1e-5)
