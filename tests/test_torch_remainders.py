"""A loss over two frames through the History against JAX, and the port's
remainders against the JAX package: ``mathlib/packing.py``, the Halton and
Weyl sequences of ``mathlib/rng.py``, record saving in
``pipeline/records.py``, ``utils/log.py``, ``utils/profiling.py`` and the
BVH8 mode (``scene/bvh.py``, ``ops/traversal.py``).

**Two frames through the History.** The Cornell box at 24x24 with RELAX,
one bounce: frame 0 from an empty History, frame 1 from frame 0's, the loss
the sum of squares of frame 1's colour against a seeded target, the
gradient of every field of ``DIFFERENTIABLE_MATERIAL_FIELDS`` against
``jax.value_and_grad`` of the same loss (session-cached). The camera is
moved 13 mm along x, off the box's mirror plane: at the centred camera
three camera rays run along box edges where two faces give the same
float32 t, and the packages pick different faces (different materials);
the test checks that no camera ray's triangle differs.

The gradient is held three ways:

- **At JAX's G-buffer**: the port's trace runs under autograd, its float
  planes' values replaced by JAX's (``gb + (jax_gb - gb).detach()``), so
  both image phases, History included, see the same inputs: every field
  within 1e-4 of its largest |entry| (PERF.md section 2).
- **The witness**: JAX's own gradient with its own G-buffer moved one ULP
  (every finite entry of every float plane of both frames, up or down by a
  seeded sign). RELAX's edge-stopping weight
  exp(-|dl| / (sqrt(var + 1e-12) k + 1e-4)) on the first frames' variance,
  a difference of two nearly equal moments, turns that into a swing of
  about 2% of emission's largest entry in JAX alone (the other fields
  move by less than 1e-5). ``tests/torch_two_frame_witness.py`` runs the
  same nudges with the REFERENCE denoiser in place of RELAX, where no
  field moves by more than 1e-6, and the port's end-to-end gradient there
  is within 1e-4 of JAX's.
- **End to end**, the port's trace as it is: every field within
  ``max(1e-4, WITNESS_FACTOR * swing)`` of its largest |entry|, where
  ``swing`` is the field's largest swing over the nudges. The port's
  planes part from JAX's by a few ULPs (PyTorch's and XLA's CPU
  transcendentals), so the bound takes twice JAX's one-ULP swing; a field
  that JAX holds to 1e-4 under the nudges is held to 1e-4 here.
"""
import dataclasses
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser, RenderConfig as JRenderConfig
from nrdsample_tpu.config import Settings as JSettings, TracingMode as JTracingMode
from nrdsample_tpu.mathlib import packing as jpacking, rng as jrng
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe, records as jrecords, train as jtrain
from nrdsample_tpu.scene import bvh as jbvh, procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu.utils import log as jlog, profiling as jprof
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode
from nrdsample_tpu_torch.mathlib import packing, rng
from nrdsample_tpu_torch.ops import intersect, traversal
from nrdsample_tpu_torch.pipeline import frame, records, train
from nrdsample_tpu_torch.scene import bvh, procedural
from nrdsample_tpu_torch.utils import log, profiling
from torch_session_cache import declare, session_cached, share_cores_between_workers

share_cores_between_workers()

FIELDS = train.DIFFERENTIABLE_MATERIAL_FIELDS
FIELD_TOL = 1e-4
WITNESS_FACTOR = 2.0      # end to end: twice JAX's own one-ULP swing (module docstring)
NUDGE_SEEDS = (0, 2)
RES = 24
EYE_X = 0.013             # off the box's mirror plane (the module docstring)
CORNELL_CAM = ([EYE_X, -3.2, 1.0], [EYE_X, 0.0, 1.0], 39.0)


def _np_leaves(obj):
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


def _target():
    return np.random.RandomState(7).rand(RES * RES, 3).astype(np.float32)


def _float_planes(gb):
    return {k: v for k, v in gb.items()
            if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.floating)}


def _nudge(planes, seed):
    """Every finite entry of every plane one ULP up or down (seeded sign)."""
    rs = np.random.RandomState(seed)
    out = {}
    for k in sorted(planes):
        v = planes[k]
        up = rs.rand(*v.shape) < 0.5
        moved = np.where(up, np.nextafter(v, np.float32(np.inf)),
                         np.nextafter(v, np.float32(-np.inf))).astype(np.float32)
        out[k] = np.where(np.isfinite(v), moved, v)
    return out


def _jax_two_frames(denoiser=JDenoiser.RELAX):
    """value_and_grad of the two-frame loss in the JAX package, with each
    frame's float G-buffer planes and camera-ray triangles, and the same
    gradient with the G-buffer of both frames nudged one ULP (``_nudge``,
    one seed each of NUDGE_SEEDS). One frame's vjp, compiled once, is
    chained through the History: frame 1's gives the materials' and frame
    0's History's cotangents, frame 0's then carries the History's back to
    the materials (half the compile of the two frames unrolled, the same
    gradient). The nudged planes enter as ``gb + stop_gradient(nudged -
    gb)`` behind a traced switch, so the nudged runs reuse the compile."""
    jctx, jscene = jtraversal.build_context(jproc.cornell_box())
    jc = jlook_at(*CORNELL_CAM[:2], fov_y_deg=CORNELL_CAM[2])
    js = JSettings(sun_elevation=jnp.float32(-30.0), disable_shadows=jnp.int32(1))
    jcfg = JRenderConfig(width=RES, height=RES, rpp=1, bounce_num=1,
                         tracing_mode=JTracingMode.FULL_PROBABILISTIC, denoiser=denoiser)
    md, mr = jtrain.split_materials(jscene.materials)
    target = jnp.asarray(_target())

    def trace(md, h):
        sc = dataclasses.replace(jscene, materials=jtrain.merge_materials(md, mr))
        return jframe.trace_frame(jctx, sc, jc, jcfg, js, h)

    def one_frame(md, h, pin, use_pin):
        gb, aux = trace(md, h)
        gb = dict(gb)
        for k, w in pin.items():
            gb[k] = jnp.where(use_pin, gb[k] + jax.lax.stop_gradient(w - gb[k]), gb[k])
        out, h = jframe.image_frame(jcfg, js, jc, h, gb, aux)
        return (out["color"], h), (_float_planes(gb), gb["tri"])

    def is_float(x):
        return jnp.issubdtype(x.dtype, jnp.floating)

    @jax.jit
    def step(md, h, w, ct_h_floats, pin, use_pin):
        """(loss of this frame, next History, aux, the materials' and this
        History's cotangents) for the cotangents w * dloss/dcolor and, on
        the next History's float leaves, ``ct_h_floats``."""
        (color, h_next), vjp_fn, aux = jax.vjp(lambda m, hh: one_frame(m, hh, pin, use_pin),
                                               md, h, has_aux=True)
        leaves, tree = jax.tree.flatten(h_next)
        it = iter(ct_h_floats)
        ct_h = tree.unflatten([next(it) if is_float(x) else np.zeros(x.shape, jax.dtypes.float0)
                               for x in leaves])
        err = color - target
        g_md, g_h = vjp_fn((2.0 * w * err, ct_h))
        return (jnp.sum(err * err), h_next, aux, g_md,
                [x for x in jax.tree.leaves(g_h) if x.dtype != jax.dtypes.float0])

    h0 = jframe.History.create(jcfg)
    zeros = [jnp.zeros_like(x) for x in jax.tree.leaves(h0) if is_float(x)]

    def two_frames(pins, use_pin):
        _, h1, aux0, _, _ = step(md, h0, 0.0, zeros, pins[0], use_pin)
        loss, _, aux1, g1, g1_h = step(md, h1, 1.0, zeros, pins[1], use_pin)
        _, _, _, g0, _ = step(md, h0, 0.0, g1_h, pins[0], use_pin)
        return float(loss), {k: np.asarray(g1[k] + g0[k]) for k in g1}, (aux0, aux1)

    shapes = _float_planes(jax.eval_shape(trace, md, h0)[0])
    unused = {k: jnp.zeros(v.shape, v.dtype) for k, v in shapes.items()}
    loss, grads, aux = two_frames([unused, unused], False)
    planes = [{k: np.asarray(v) for k, v in a[0].items()} for a in aux]
    nudged = [two_frames([_nudge(planes[0], s), _nudge(planes[1], s + 1)], True)[1]
              for s in NUDGE_SEEDS]
    return {"loss": loss, "grads": grads, "nudged_grads": nudged, "planes": planes,
            "tris": [np.asarray(a[1]) for a in aux], "scene": _np_leaves(jscene),
            "cam": _np_leaves(jc), "settings": _np_leaves(js)}


def port_two_frames(want, denoiser=Denoiser.RELAX, pin_to_jax=False):
    """(loss, {field: gradient}, each frame's camera-ray triangles) of the
    port's two-frame loss on ``want``'s scene, camera and settings; with
    ``pin_to_jax`` the trace's float planes take ``want``'s values (the
    module docstring)."""
    ctx, scene = traversal.build_context(convert.scene_from_numpy(want["scene"], device="cpu"),
                                         device="cpu")
    cam = convert.camera_from_numpy(want["cam"], device="cpu")
    settings = convert.settings_from_numpy(want["settings"], device="cpu")
    cfg = RenderConfig(width=RES, height=RES, rpp=1, bounce_num=1,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=denoiser)
    target = torch.from_numpy(_target())
    seen = []

    def render(m, h):
        with pytest.MonkeyPatch.context() as mp:
            if pin_to_jax:
                mp.setattr(frame, "trace_frame", trace_on_jax_values)
            else:
                mp.setattr(frame, "trace_frame", trace_and_record)
            return train.render_color(ctx, cfg, m, scene, cam, settings, h)

    trace = frame.trace_frame

    def trace_and_record(*args, **kw):
        gb, aux = trace(*args, **kw)
        seen.append(gb["tri"].numpy())
        return gb, aux

    def trace_on_jax_values(*args, **kw):
        gb, aux = trace_and_record(*args, **kw)
        for k, v in want["planes"][len(seen) - 1].items():
            w = torch.from_numpy(np.array(v)).reshape(gb[k].shape)
            gb[k] = gb[k] + (w - gb[k]).detach()
        return gb, aux

    def loss_fn(diff, rest):
        m = train.merge_materials(diff, rest)
        _, h1 = render(m, frame.History.create(cfg, "cpu"))
        col, _ = render(m, h1)
        err = col - target
        return torch.sum(err * err)

    diff, rest = train.split_materials(scene.materials)
    loss, grads = train.value_and_grad(loss_fn, diff, rest)
    return float(loss), {k: v.numpy() for k, v in grads.items()}, seen


def gradient_gaps(got, want):
    """Each field's largest |got - want| over its largest |want entry|."""
    return {k: float(np.max(np.abs(got[k] - w))) / max(float(np.abs(w).max()), 1e-30)
            for k, w in want.items()}


declare("torch_remainders_two_frames", lambda _: _jax_two_frames())


@pytest.fixture(scope="module")
def jax_two_frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_remainders_two_frames", _jax_two_frames)


def test_two_frame_loss_gradient_matches_jax(jax_two_frames):
    want = jax_two_frames
    assert float(np.abs(want["grads"]["base_color"]).max()) > 0
    for k in FIELDS:
        assert np.isfinite(want["grads"][k]).all()

    # at JAX's G-buffer: the image phases and the History carry the gradient alike
    loss, grads, tris = port_two_frames(want, pin_to_jax=True)
    for i in range(2):       # no camera ray's triangle differs
        np.testing.assert_array_equal(tris[i], want["tris"][i])
    assert abs(loss - want["loss"]) <= 1e-6 * want["loss"]
    for k, gap in gradient_gaps(grads, want["grads"]).items():
        assert grads[k].shape == want["grads"][k].shape and np.isfinite(grads[k]).all()
        assert gap <= FIELD_TOL, (k, gap)

    # the witness: JAX's own gradient under one-ULP nudges of its G-buffer
    swings = [gradient_gaps(g, want["grads"]) for g in want["nudged_grads"]]
    swing = {k: max(s[k] for s in swings) for k in FIELDS}
    assert swing["emission"] > 10 * FIELD_TOL, swing    # RELAX: JAX misses 1e-4 against itself

    # end to end: the port's trace as it is
    loss, grads, tris = port_two_frames(want)
    for i in range(2):
        np.testing.assert_array_equal(tris[i], want["tris"][i])
    assert abs(loss - want["loss"]) <= 1e-5 * want["loss"]
    for k, gap in gradient_gaps(grads, want["grads"]).items():
        assert np.isfinite(grads[k]).all()
        assert gap <= max(FIELD_TOL, WITNESS_FACTOR * swing[k]), (k, gap, swing[k])


# ---- mathlib/packing.py and the sequences of mathlib/rng.py ----


def _unit_vectors(n, seed):
    v = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    v[:8] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
             [0.6, 0, -0.8], [0, -0.6, 0.8]]
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_octahedral_packing_matches_jax():
    n = _unit_vectors(4096, 0)
    e = packing.encode_oct(torch.from_numpy(n))
    np.testing.assert_array_equal(e.numpy(), np.asarray(jpacking.encode_oct(jnp.asarray(n))))
    d = packing.decode_oct(e)
    np.testing.assert_allclose(d.numpy(), np.asarray(jpacking.decode_oct(jnp.asarray(e.numpy()))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), n, atol=1e-5)
    rs = np.random.RandomState(1)
    rough = rs.rand(4096).astype(np.float32)
    mat = rs.randint(0, 3, 4096).astype(np.float32)
    p = packing.pack_normal_roughness(torch.from_numpy(n), torch.from_numpy(rough),
                                      torch.from_numpy(mat))
    jp = jpacking.pack_normal_roughness(jnp.asarray(n), jnp.asarray(rough), jnp.asarray(mat))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    got = packing.unpack_normal_roughness(p)
    want = jpacking.unpack_normal_roughness(jp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _indices():
    rs = np.random.RandomState(2)
    return np.concatenate([np.arange(4096), rs.randint(0, 2**31 - 1, 4096),
                           [2**31 - 1]]).astype(np.int32)


@pytest.mark.parametrize("base", [2, 3, 5, 7])
def test_halton_matches_jax(base):
    n = _indices()
    np.testing.assert_array_equal(rng.halton(torch.from_numpy(n), base).numpy(),
                                  np.asarray(jrng.halton(jnp.asarray(n), base)))
    assert rng._halton_iters(base) == jrng._halton_iters(base)


def test_halton23_and_weyl2d_match_jax():
    n = _indices()
    np.testing.assert_array_equal(rng.halton23(torch.from_numpy(n)).numpy(),
                                  np.asarray(jrng.halton23(jnp.asarray(n))))
    m = np.arange(100_000, dtype=np.int32)
    np.testing.assert_array_equal(rng.weyl2d(torch.from_numpy(m)).numpy(),
                                  np.asarray(jrng.weyl2d(jnp.asarray(m))))
    assert rng.weyl2d(5).shape == (2,) and rng.halton23(3).shape == (2,)


# ---- record saving ----


def _jax_record_inputs():
    js = JSettings(sun_elevation=jnp.float32(12.5), exposure=jnp.float32(3.25),
                   max_accumulated_frame_num=jnp.int32(17))
    jc = jlook_at([0.3, -2.9, 1.2], [0.1, 0.0, 0.9], fov_y_deg=47.0, aspect=1.5)
    return js, jc


def _port_record_inputs():
    js, jc = _jax_record_inputs()
    return (convert.settings_from_numpy(_np_leaves(js), device="cpu"),
            convert.camera_from_numpy(_np_leaves(jc), device="cpu"))


def test_record_to_dict_and_static_bucket_match_jax():
    js, jc = _jax_record_inputs()
    s, c = _port_record_inputs()
    render = {"denoiser": Denoiser.RELAX, "use_taa": True, "bounce_num": 2}
    jrender = {"denoiser": JDenoiser.RELAX, "use_taa": True, "bounce_num": 2}
    anim = {"mode": "orbit", "frames": 3}
    got = records.record_to_dict(s, c, render, anim)
    assert json.dumps(got) == json.dumps(jrecords.record_to_dict(js, jc, jrender, anim))
    assert records.static_bucket(got["render"]) == jrecords.static_bucket(got["render"])
    assert records.RENDER_FIELDS == jrecords.RENDER_FIELDS
    assert records.RECORD_VERSION == jrecords.RECORD_VERSION
    with pytest.raises(ValueError, match="unknown render fields"):
        records.record_to_dict(s, c, {"width": 64})


def test_saved_record_loads_back_through_both_packages(tmp_path):
    js, jc = _jax_record_inputs()
    s, c = _port_record_inputs()
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    assert records.save_record(str(ours), s, c) == 0
    assert records.save_record(str(ours), s, c) == 1
    assert records.save_record(str(ours), s, c, index=0) == 1
    for _ in range(2):
        jrecords.save_record(str(theirs), js, jc)
    jrecords.save_record(str(theirs), js, jc, index=0)
    assert ours.read_bytes() == theirs.read_bytes()
    d = json.loads(ours.read_text())[1]
    ps, pc = records.dict_to_record(d, device="cpu")
    qs, qc = jrecords.dict_to_record(d)
    for got, want in ((ps, js), (pc, jc), (qs, js), (qc, jc)):
        ref = _np_leaves(want)
        for k, v in _np_leaves(got).items():
            np.testing.assert_array_equal(np.asarray(v), ref[k], err_msg=k)


# ---- utils/log.py and utils/profiling.py ----


def _records(stream):
    return [json.loads(line) for line in stream.getvalue().splitlines()]


def test_logs_match_jax(monkeypatch):
    ours, theirs = io.StringIO(), io.StringIO()
    monkeypatch.setattr(log, "LOG", log.JsonLogger(ours))
    monkeypatch.setattr(jlog, "LOG", jlog.JsonLogger(theirs))
    scene = procedural.kitchen()
    ctx, sc = traversal.build_context(scene, device="cpu")
    jctx, jsc = jtraversal.build_context(jproc.kitchen())
    log.log_scene_stats(sc, ctx)
    jlog.log_scene_stats(jsc, jctx)
    cfg = RenderConfig(width=64, height=40, rpp=2, bounce_num=3)
    jcfg = JRenderConfig(width=64, height=40, rpp=2, bounce_num=3)
    log.log_frame_stats(5, 0.0125, cfg, 7)
    jlog.log_frame_stats(5, 0.0125, jcfg, 7)
    got, want = _records(ours), _records(theirs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.pop("component") == "nrdsample_tpu_torch" and w.pop("component")
        g.pop("ts"), w.pop("ts")
        assert g == w
    assert log.memory_report() == {}


def test_profiling_roofline_matches_jax_with_the_h100_peaks(monkeypatch, tmp_path):
    kind = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(jprof, "device_kind", lambda: kind)
    monkeypatch.setitem(jprof.HBM_GBPS, "H100", profiling.HBM_BYTES_PER_S["H100"] / 1e9)
    monkeypatch.setitem(jprof.F32_TFLOPS, "H100", profiling.F32_OPS_PER_S["H100"] / 1e12)
    monkeypatch.setattr(log, "LOG", log.JsonLogger(io.StringIO()))
    monkeypatch.setattr(jlog, "LOG", jlog.JsonLogger(io.StringIO()))
    for args in (("gather", 9.6e-6, 21.0e6, 1.0e6), ("atrous", 1.38e-4, 1.0e7, 2.4e9)):
        got = profiling.roofline(*args, kind=kind)
        want = jprof.roofline(*args)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-12), k
    with pytest.raises(ValueError, match="no roofline peaks"):
        profiling.roofline("x", 1.0, 1.0, 1.0, kind="cpu")
    assert profiling.device_kind() == "cpu"
    sec, out = profiling.timeit(lambda a: a + 1, torch.ones(3), iters=3)
    assert sec > 0 and torch.equal(out, torch.full((3,), 2.0))
    with profiling.trace(str(tmp_path / "t")):
        with profiling.named_scope("block"):
            torch.ones(8).sum()
    assert "block" in (tmp_path / "t" / "trace.json").read_text()


# ---- the BVH8 mode ----


def _soup():
    return procedural.random_soup(num_tris=3000, extent=20.0, seed=3)


def _bvh_rays(n, seed):
    """``tests/test_bvh.py``'s rays."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3).astype(np.float32) - 0.5) * 30.0
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _jax_bvh8():
    """The JAX package's BVH8 of the soup and its traversals of
    ``tests/test_bvh.py``'s rays."""
    soup = jproc.random_soup(num_tris=3000, extent=20.0, seed=3)
    b, order = jbvh.build_bvh8(np.asarray(soup.tris.p0), np.asarray(soup.tris.e1),
                               np.asarray(soup.tris.e2))
    ctx, _ = jtraversal.build_context(soup.tris, mode="bvh8")
    tr = ctx.tris
    o, d = _bvh_rays(512, 1)
    hit = jtraversal.traverse_bvh8(jnp.asarray(o), jnp.asarray(d), ctx.bvh, tr.p0, tr.e1, tr.e2)
    o2, d2 = _bvh_rays(512, 7)
    occ = jtraversal.occluded_bvh8(jnp.asarray(o2), jnp.asarray(d2), ctx.bvh, tr.p0, tr.e1,
                                   tr.e2, jnp.full((512,), 5.0))
    cornell = jproc.cornell_box()
    cb, corder = jbvh.build_bvh8(np.asarray(cornell.tris.p0), np.asarray(cornell.tris.e1),
                                 np.asarray(cornell.tris.e2))
    return {"min": np.asarray(b.child_min), "max": np.asarray(b.child_max),
            "meta": np.asarray(b.child_meta), "order": order,
            "depth": jbvh.max_depth_estimate(b),
            "hit": {k: np.asarray(v) for k, v in hit.items()}, "occluded": np.asarray(occ),
            "cornell": [np.asarray(cb.child_min), np.asarray(cb.child_max),
                        np.asarray(cb.child_meta), corder]}


declare("torch_remainders_bvh8", lambda _: _jax_bvh8())


@pytest.fixture(scope="module")
def jax_bvh8(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_remainders_bvh8", _jax_bvh8)


def test_bvh8_build_matches_jax(jax_bvh8):
    soup = _soup()
    b, order = bvh.build_bvh8(soup.tris.p0, soup.tris.e1, soup.tris.e2)
    np.testing.assert_array_equal(b.child_min.numpy(), jax_bvh8["min"])
    np.testing.assert_array_equal(b.child_max.numpy(), jax_bvh8["max"])
    np.testing.assert_array_equal(b.child_meta.numpy(), jax_bvh8["meta"])
    np.testing.assert_array_equal(order, jax_bvh8["order"])
    assert bvh.max_depth_estimate(b) == jax_bvh8["depth"] <= 12
    cornell = procedural.cornell_box()
    cb, corder = bvh.build_bvh8(cornell.tris.p0.numpy(), cornell.tris.e1.numpy(),
                                cornell.tris.e2.numpy())
    for got, want in zip((cb.child_min, cb.child_max, cb.child_meta, corder),
                         jax_bvh8["cornell"]):
        np.testing.assert_array_equal(np.asarray(got), want)
    # every triangle in exactly one leaf; decode_leaf agrees with JAX's
    meta = b.child_meta.numpy()
    start, count = bvh.decode_leaf(meta[meta <= -2])
    jstart, jcount = jbvh.decode_leaf(meta[meta <= -2])
    np.testing.assert_array_equal(start, jstart)
    np.testing.assert_array_equal(count, jcount)
    covered = np.zeros(soup.tris.count, np.int64)
    for s, c in zip(start, count):
        covered[s:s + c] += 1
    assert (covered == 1).all()
    tris = bvh.reorder_tris(soup.tris, order)
    np.testing.assert_array_equal(tris.p0.numpy(), soup.tris.p0.numpy()[order])
    np.testing.assert_array_equal(tris.material.numpy(), soup.tris.material.numpy()[order])
    np.testing.assert_array_equal(bvh.build_order(*_aabbs(soup), 4), order)


def _aabbs(scene):
    p0 = scene.tris.p0.numpy()
    p1, p2 = p0 + scene.tris.e1.numpy(), p0 + scene.tris.e2.numpy()
    lo, hi = np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)
    pad = 1e-6 * np.maximum(1.0, np.abs(hi) + np.abs(lo))
    return lo - pad, hi + pad


def test_bvh8_traversal_matches_jax_and_dense(jax_bvh8):
    ctx, scene = traversal.build_context(_soup(), mode="bvh8", device="cpu")
    assert ctx.mode == "bvh8" and ctx.bvh.num_nodes == jax_bvh8["meta"].shape[0]
    np.testing.assert_array_equal(ctx.order, jax_bvh8["order"])
    tr = ctx.tris
    o, d = (torch.from_numpy(a) for a in _bvh_rays(512, 1))
    got = traversal.traverse_bvh8(o, d, ctx.bvh, tr.p0, tr.e1, tr.e2)
    want = jax_bvh8["hit"]
    np.testing.assert_array_equal(got["tri"].numpy(), want["tri"])
    np.testing.assert_allclose(got["t"].numpy(), want["t"], rtol=1e-6, atol=1e-6)
    # barycentrics in [0, 1]: XLA's fused multiply-adds move their last bits
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5)
    assert (want["tri"] >= 0).sum() > 20
    dense = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2)
    for k in got:       # the same Moller-Trumbore on the same operands
        np.testing.assert_array_equal(got[k].numpy(), dense[k].numpy())
    res = traversal.closest_hit(ctx, o, d)
    for k in got:
        assert torch.equal(res[k], got[k])
    o2, d2 = (torch.from_numpy(a) for a in _bvh_rays(512, 7))
    t_max = torch.full((512,), 5.0)
    occ = traversal.occluded_bvh8(o2, d2, ctx.bvh, tr.p0, tr.e1, tr.e2, t_max)
    np.testing.assert_array_equal(occ.numpy(), jax_bvh8["occluded"])
    dense2 = intersect.intersect_dense(o2, d2, tr.p0, tr.e1, tr.e2, t_max)
    np.testing.assert_array_equal(occ.numpy(), (dense2["tri"] >= 0).numpy())
    assert torch.equal(traversal.any_hit(ctx, o2, d2, t_max), occ) and occ.any()


def test_bvh8_camera_hits_match_the_dense_mode():
    """The Cornell box's camera rays at 64x64 in bvh8 mode against dense
    mode: the same hits and t on every ray, and the same triangle (through
    the BVH's permutation) except on exact ties, where two triangles give
    the same t (the box's edges) and each mode keeps the first it tests."""
    from nrdsample_tpu_torch.scene import camera
    from nrdsample_tpu_torch.scene.types import look_at

    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device="cpu")
    o, d, _ = camera.camera_rays(cam, 64, 64, torch.arange(64 * 64, dtype=torch.int32),
                                 torch.tensor(0, dtype=torch.int32))
    hits = {}
    for mode in ("dense", "bvh8"):
        ctx, scene = traversal.build_context(procedural.cornell_box(), mode=mode, device="cpu")
        hits[mode] = traversal.closest_hit(ctx, o, d), ctx
    (dense, _), (wide, ctx) = hits["dense"], hits["bvh8"]
    assert torch.equal(wide["t"], dense["t"]) and (dense["tri"] >= 0).all()
    mapped = torch.from_numpy(ctx.order)[wide["tri"].long()].to(torch.int32)
    tie = mapped != dense["tri"]
    assert int(tie.sum()) < 0.02 * tie.numel()
    tr = procedural.cornell_box().tris
    for i in torch.nonzero(tie).flatten().tolist():
        ts = [intersect.intersect_dense(o[i:i + 1], d[i:i + 1], tr.p0[j:j + 1], tr.e1[j:j + 1],
                                        tr.e2[j:j + 1])["t"] for j in (mapped[i], dense["tri"][i])]
        assert torch.equal(ts[0], ts[1]) and torch.equal(ts[0], dense["t"][i:i + 1])
    with pytest.raises(ValueError, match="unknown traversal mode"):
        traversal.build_context(procedural.cornell_box(), mode="octree", device="cpu")
