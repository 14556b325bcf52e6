"""The port's SHARC radiance cache, its update pass and the history-confidence
steps against the JAX package's.

- The hash, slot and checksum are bit for bit (uint32 arithmetic done in
  int64 with masking).
- ``update`` with many samples per slot, claimers and non-claimers mixed,
  gives JAX's keys and last-seen frames exactly: the last sample aimed at a
  slot wins, as in XLA's serial scatter. The scatter-added accumulation
  agrees within 1e-6 (the CPU adds in index order, as XLA does).
- ``resolve`` and ``query`` agree within 1e-6; the whole update pass on the
  kitchen at 40x25 (40 probes, 160 cache writes) and the confidence steps
  (gradient, à-trous blur, dithered mapping) within 1e-5 (XLA's FMAs, exp
  and log2 differ from torch's by a few ULPs)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.denoise import confidence as jconf
from nrdsample_tpu.ops import sharc as jsharc, traversal as jtraversal
from nrdsample_tpu.render import sharc_update as jsharc_update
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.denoise import confidence
from nrdsample_tpu_torch.ops import sharc
from nrdsample_tpu_torch.pipeline import bench_configs
from nrdsample_tpu_torch.render import sharc_update

TOL = 1e-5


def _np_leaves(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _np_leaves(v) if dataclasses.is_dataclass(v) else np.asarray(v)
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _samples(seed, n):
    """(pos, normal, cam_pos, dither) around a room-sized scene."""
    rs = np.random.RandomState(seed)
    pos = rs.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    nrm = rs.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return pos, nrm, np.array([0.3, -1.6, 1.6], np.float32), rs.rand(n).astype(np.float32)


def test_hash_is_bit_exact():
    rs = np.random.RandomState(0)
    words = rs.randint(-2 ** 31, 2 ** 31, (4, 10000), dtype=np.int64).astype(np.int32)
    want = np.asarray(jsharc._hash_u32x4(*(jnp.asarray(w) for w in words)))
    got = sharc._hash_u32x4(*(torch.from_numpy(w) for w in words)).numpy()
    assert want.dtype == np.uint32 and np.array_equal(got, want.astype(np.int64))


def test_slot_and_checksum_are_bit_exact():
    pos, nrm, cam, dither = _samples(1, 20000)
    for d in (None, dither):
        jslot, jsum, jlvl = jax.jit(jsharc.slot_and_checksum, static_argnums=3)(
            jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam), 1 << 22,
            dither=None if d is None else jnp.asarray(d))
        slot, csum, lvl = sharc.slot_and_checksum(
            torch.from_numpy(pos), torch.from_numpy(nrm), torch.from_numpy(cam), 1 << 22,
            dither=None if d is None else torch.from_numpy(d))
        assert np.array_equal(slot.numpy(), np.asarray(jslot).astype(np.int64))
        assert np.array_equal(csum.numpy(), np.asarray(jsum).astype(np.int64))
        assert np.array_equal(lvl.numpy(), np.asarray(jlvl))


def _state(seed, capacity):
    """A half-filled cache: keys, accumulation, resolved values, last seen."""
    rs = np.random.RandomState(seed)
    keys = np.where(rs.rand(capacity) < 0.5, rs.randint(1, 2 ** 32, capacity, dtype=np.uint64),
                    0).astype(np.uint32)
    return {"keys": keys, "accum": rs.rand(capacity, 4).astype(np.float32),
            "resolved": (rs.rand(capacity, 4) * [1, 1, 1, 200]).astype(np.float32),
            "last_seen": rs.randint(0, 40, capacity).astype(np.int32)}


def _both(d):
    j = jsharc.SharcState(**{k: jnp.asarray(v) for k, v in d.items()})
    t = convert.history_from_numpy({"frame_index": np.int32(0), "sharc": d}, device="cpu").sharc
    return j, t


def test_update_with_duplicate_slots_matches_jax():
    """2,000 samples into 64 slots: every slot is aimed at many times, by
    samples that claim an empty slot, own it, or neither (masked off or a
    foreign checksum), and the last of them decides its key and frame."""
    capacity = 64
    pos, nrm, cam, dither = _samples(2, 2000)
    rs = np.random.RandomState(3)
    rad = rs.rand(2000, 3).astype(np.float32)
    mask = rs.rand(2000) < 0.8
    js, ts = _both(_state(4, capacity))
    want = jax.jit(jsharc.update)(js, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(rad),
                                  jnp.asarray(cam), 37, mask=jnp.asarray(mask),
                                  dither=jnp.asarray(dither))
    got = sharc.update(ts, torch.from_numpy(pos), torch.from_numpy(nrm), torch.from_numpy(rad),
                       torch.from_numpy(cam), torch.tensor(37, dtype=torch.int32),
                       mask=torch.from_numpy(mask), dither=torch.from_numpy(dither))
    slot = sharc.slot_and_checksum(torch.from_numpy(pos), torch.from_numpy(nrm),
                                   torch.from_numpy(cam), capacity,
                                   dither=torch.from_numpy(dither))[0]
    assert int(torch.bincount(slot, minlength=capacity).min()) > 5
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys).astype(np.int64))
    assert np.array_equal(got.last_seen.numpy(), np.asarray(want.last_seen))
    assert 0 < int((got.last_seen == 37).sum()) < capacity
    _close(got.accum, want.accum, 1e-6)


def test_resolve_and_query_match_jax():
    js, ts = _both(_state(5, 4096))
    jupdate, jresolve = jax.jit(jsharc.update), jax.jit(jsharc.resolve)
    want, got = jresolve(js, 60), sharc.resolve(ts, torch.tensor(60, dtype=torch.int32))
    assert np.array_equal(got.keys.numpy(), np.asarray(want.keys).astype(np.int64))
    _close(got.resolved, want.resolved, 1e-6)
    assert float(got.accum.abs().max()) == 0.0
    pos, nrm, cam, dither = _samples(6, 3000)
    # write these cells first so the queries find entries
    js = jupdate(want, jnp.asarray(pos), jnp.asarray(nrm), jnp.ones((3000, 3)), jnp.asarray(cam),
                 61)
    ts = sharc.update(got, torch.from_numpy(pos), torch.from_numpy(nrm), torch.ones((3000, 3)),
                      torch.from_numpy(cam), 61)
    js, ts = jresolve(js, 61), sharc.resolve(ts, 61)
    jrad, jfound = jax.jit(jsharc.query)(js, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam))
    rad, found = sharc.query(ts, torch.from_numpy(pos), torch.from_numpy(nrm), torch.from_numpy(cam))
    assert np.array_equal(found.numpy(), np.asarray(jfound)) and bool(found.any())
    _close(rad, jrad, 1e-6)


@pytest.fixture(scope="module")
def update_pass():
    """The JAX and port update passes of the kitchen at 40x25 (8x5 probes),
    with the confidence re-trace, over two frames."""
    w, h, cap = 40, 25, 1 << 12
    spec = bench_configs.CONFIGS["kitchen1080"]
    jctx, jscene = jtraversal.build_context(jproc.kitchen())
    eye, target, fov = spec["cam"]
    jc = jlook_at(eye, target, fov_y_deg=fov, aspect=w / h)
    js = JSettings(sun_elevation=jnp.float32(35.0))
    jcfg = JRenderConfig(width=w, height=h, use_sharc=True, use_confidence=True, sharc_capacity=cap)
    fn = jax.jit(lambda st, f: jsharc_update.sharc_update_pass(jctx, jscene, jc, jcfg, js, f, st))
    ctx, scene, _, cfg, _ = bench_configs.setup("kitchen1080", "cpu", width=w, height=h,
                                                 sharc_capacity=cap)
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    jstate, state = jsharc.SharcState.create(cap), sharc.SharcState.create(cap, device="cpu")
    out = []
    for f in range(2):
        jstate, jprobes = fn(jstate, jnp.int32(f))
        state, probes = sharc_update.sharc_update_pass(ctx, scene, cam, cfg, settings,
                                                       torch.tensor(f, dtype=torch.int32), state)
        out.append((jprobes, probes))
    return jstate, state, out


def test_update_pass_matches_jax(update_pass):
    jstate, state, out = update_pass
    assert np.array_equal(state.keys.numpy(), np.asarray(jstate.keys).astype(np.int64))
    assert int((state.keys != 0).sum()) > 0
    assert np.array_equal(state.last_seen.numpy(), np.asarray(jstate.last_seen))
    _close(state.resolved, jstate.resolved)
    for jprobes, probes in out:
        assert set(probes) == set(jprobes)
        for k, v in probes.items():
            _close(v, jprobes[k])


def test_confidence_steps_match_jax(update_pass):
    """Gradient from the re-traced probes, the 5-step à-trous blur and the
    dithered mapping, from a previous-frame history."""
    jprobes, probes = update_pass[2][1]
    rs = np.random.RandomState(7)
    hs, ws = probes["view_z"].shape
    hist = {"probe_lum": rs.rand(hs, ws).astype(np.float32),
            "view_z": (np.asarray(jprobes["view_z"]) * (1 + rs.randn(hs, ws) * 0.03)).astype(np.float32)}
    jh = jconf.ConfidenceHistory(**{k: jnp.asarray(v) for k, v in hist.items()})
    th = convert.history_from_numpy({"frame_index": np.int32(0), "confidence": hist},
                                    device="cpu").confidence
    jgrad, jnew = jconf.gradient_from_probes(jh, jprobes)
    grad, new = confidence.gradient_from_probes(th, probes)
    _close(grad, jgrad)
    _close(new.probe_lum, jnew.probe_lum)
    jblur = jconf.atrous_blur(jgrad, jprobes["view_z"], jprobes["normal"])
    blur = confidence.atrous_blur(grad, probes["view_z"], probes["normal"])
    _close(blur, jblur)
    for relax_square in (False, True):
        _close(confidence.gradient_to_confidence(blur, torch.tensor(3), relax_square),
               jconf.gradient_to_confidence(jblur, jnp.int32(3), relax_square))
