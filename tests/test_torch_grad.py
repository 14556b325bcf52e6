"""The port's differentiable path (``pipeline/train.py``) against the JAX
package's.

Gradients of the L2 image loss (``train.make_loss_fn``) with respect to the
five material fields, port against ``jax.value_and_grad`` of the JAX
package's loss, entry by entry, each within 1e-4 of the field's largest
|JAX entry|:

- the Cornell box at 32x32 as it is (REFERENCE, two bounces, four
  importance samples), whose materials sit on their clamp bounds
  (roughness 1, metalness 0): ``geometry.clip`` gives ``jnp.clip``'s 0.5
  at a tie, where a bare ``torch.clamp`` passes the whole gradient;
- the kitchen at 64x40 (RELAX + SIGMA, SH, TAA, SHARC, the
  history-confidence plane), frame 0 from a fresh History and frame 1 from
  frame 0's JAX History: ``geometry.absolute`` gives ``jnp.abs``'s
  derivative +1 at 0 in the denoisers' |a - b| of equal values, and the
  confidence plane is detached as JAX detaches it. Each material's colour
  entries are also held within 1e-4 of that row's largest |JAX entry|
  (the emission of a non-emitter is ~1e-7 of the field's largest entry).

The JAX gradients are computed once per session (``session_cached``). Then:
the three denoiser plain versions on planes with exact ties (zeros, equal
neighbours, values on their clamp bounds) against ``jax.vjp``; the port's
finite differences against its autograd on ``tests/test_grad.py``'s
entries and tolerance; the train step and its projection against JAX's
arithmetic on JAX's gradients; the 24-step albedo recovery with
``test_grad.py``'s thresholds; a checkpoint resumed at step 12 ending
bit-equal to the uninterrupted run; the backward bench; the probe under
autograd."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser, NrdMode as JNrdMode
from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.config import TracingMode as JTracingMode
from nrdsample_tpu.denoise import relax as jrelax, taa as jtaa, taccum_pallas
from nrdsample_tpu.mathlib import filtering as jfiltering
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe, train as jtrain
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.denoise import relax, taa
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import emissive_probe, reproject, traversal
from nrdsample_tpu_torch.pipeline import bench_configs, checkpoint, frame, train
from nrdsample_tpu_torch.render import emissive_is
from nrdsample_tpu_torch.scene import procedural
from nrdsample_tpu_torch.scene.types import look_at
from test_torch_denoise_grad import GRAD_TOL, HIST, _bad, _jax_grads, _torch_grads
from torch_session_cache import (declare, jax_native_order_ready, session_cached,
                                 share_cores_between_workers)

share_cores_between_workers()

FIELDS = train.DIFFERENTIABLE_MATERIAL_FIELDS
FIELD_TOL = 1e-4          # of the field's (or row's) largest |JAX entry|
RES = 32
KW, KH, CAPACITY = 64, 40, 1 << 16
LR = 2e-4
CORNELL_CAM = ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0)


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


def _jax_vag():
    """jit(value_and_grad) of the JAX package's L2 loss, with the new
    history as its aux."""

    def loss(md, mr, sc, c, st, h, target, ctx, cfg):
        color, new_h = jtrain.render_color(ctx, cfg, jtrain.merge_materials(md, mr), sc, c, st, h)
        err = color - target
        return jnp.sum(err * err), new_h

    return jax.value_and_grad(loss, has_aux=True)


def _cornell_cfg():
    return dict(width=RES, height=RES, rpp=1, bounce_num=2, importance_samples=4)


def _jax_cornell():
    jctx, jscene = jtraversal.build_context(jproc.cornell_box())
    jc = jlook_at(*CORNELL_CAM[:2], fov_y_deg=CORNELL_CAM[2])
    js = JSettings(sun_elevation=jnp.float32(-30.0), disable_shadows=jnp.int32(1))
    jcfg = JRenderConfig(tracing_mode=JTracingMode.FULL_PROBABILISTIC,
                         denoiser=JDenoiser.REFERENCE, **_cornell_cfg())
    md, mr = jtrain.split_materials(jscene.materials)
    vag = jax.jit(lambda *a: _jax_vag()(*a, jctx, jcfg))
    (loss, _), g = vag(md, mr, jscene, jc, js, jframe.History.create(jcfg),
                       jnp.zeros((RES * RES, 3), jnp.float32))
    return {"loss": float(loss), "grads": {k: np.asarray(v) for k, v in g.items()},
            "scene": _np_leaves(jscene), "cam": _np_leaves(jc), "settings": _np_leaves(js)}


def _jax_kitchen():
    spec = bench_configs.CONFIGS["kitchen1080"]
    jctx, jscene = jtraversal.build_context(jproc.kitchen())
    eye, target, fov = spec["cam"]
    jc = jlook_at(eye, target, fov_y_deg=fov, aspect=KW / KH)
    js = JSettings(sun_elevation=jnp.float32(35.0))
    jcfg = JRenderConfig(width=KW, height=KH, rpp=1, bounce_num=1, denoiser=JDenoiser.RELAX,
                         nrd_mode=JNrdMode.SH, use_taa=True, use_sharc=True,
                         use_confidence=True, sharc_capacity=CAPACITY)
    md, mr = jtrain.split_materials(jscene.materials)
    vag = jax.jit(lambda *a: _jax_vag()(*a, jctx, jcfg))
    zero = jnp.zeros((KW * KH, 3), jnp.float32)
    jh0 = jframe.History.create(jcfg)
    (l0, jh1), g0 = vag(md, mr, jscene, jc, js, jh0, zero)
    (l1, _), g1 = vag(md, mr, jscene, jc, js, jh1, zero)
    return {"loss": [float(l0), float(l1)],
            "grads": [{k: np.asarray(v) for k, v in g.items()} for g in (g0, g1)],
            "history1": _np_leaves(jh1), "cam": _np_leaves(jc), "settings": _np_leaves(js)}


def _cached(tmp_path_factory, name):
    jax_native_order_ready(tmp_path_factory)
    computes = {"torch_grad_kitchen": _jax_kitchen, "torch_grad_cornell": _jax_cornell}
    return session_cached(tmp_path_factory, name, computes[name], others=computes)


declare("torch_grad_kitchen", lambda _: _jax_kitchen(), native_order=True)
declare("torch_grad_cornell", lambda _: _jax_cornell(), native_order=True)


@pytest.fixture(scope="module")
def jax_cornell(tmp_path_factory):
    return _cached(tmp_path_factory, "torch_grad_cornell")


@pytest.fixture(scope="module")
def jax_kitchen(tmp_path_factory):
    return _cached(tmp_path_factory, "torch_grad_kitchen")


@pytest.fixture(scope="module")
def cornell(jax_cornell):
    """(ctx, scene, cam, cfg, settings) of the port from the JAX package's
    leaves."""
    ctx, scene = traversal.build_context(
        convert.scene_from_numpy(jax_cornell["scene"], device="cpu"), device="cpu")
    cam = convert.camera_from_numpy(jax_cornell["cam"], device="cpu")
    settings = convert.settings_from_numpy(jax_cornell["settings"], device="cpu")
    cfg = RenderConfig(tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE,
                       **_cornell_cfg())
    return ctx, scene, cam, cfg, settings


@pytest.fixture(scope="module")
def cornell_grads(cornell):
    ctx, scene, cam, cfg, settings = cornell
    diff, rest = train.split_materials(scene.materials)
    target = torch.zeros((cfg.n_pixels, 3))
    return train.value_and_grad(train.make_loss_fn(ctx, cfg), diff, rest, scene, cam, settings,
                                frame.History.create(cfg, "cpu"), target)


@pytest.fixture(scope="module")
def kitchen_grads(jax_kitchen):
    ctx, scene, _, cfg, _ = bench_configs.setup("kitchen1080", "cpu", width=KW, height=KH,
                                                sharc_capacity=CAPACITY)
    cam = convert.camera_from_numpy(jax_kitchen["cam"], device="cpu")
    settings = convert.settings_from_numpy(jax_kitchen["settings"], device="cpu")
    loss_fn = train.make_loss_fn(ctx, cfg)
    diff, rest = train.split_materials(scene.materials)
    target = torch.zeros((cfg.n_pixels, 3))
    histories = (frame.History.create(cfg, "cpu"),
                 convert.history_from_numpy(jax_kitchen["history1"], device="cpu"))
    return [train.value_and_grad(loss_fn, diff, rest, scene, cam, settings, h, target)
            for h in histories]


def _assert_entries_match(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    off = np.abs(got - want) > FIELD_TOL * scale
    assert not off.any(), (f"{what}: entries {np.argwhere(off).tolist()} JAX {want[off]} port "
                           f"{got[off]} (field's largest |JAX entry| {scale})")


@pytest.mark.parametrize("field", FIELDS)
def test_cornell_gradients_match_jax_on_the_clamp_bounds(jax_cornell, cornell, cornell_grads,
                                                         field):
    scene = cornell[1]
    loss, grads = cornell_grads
    assert abs(float(loss) - jax_cornell["loss"]) <= 1e-5 * jax_cornell["loss"]
    _assert_entries_match(grads[field], jax_cornell["grads"][field], f"cornell {field}")


def test_cornell_materials_sit_on_their_clamp_bounds(cornell):
    """The setup exercises the ties: roughness 1 and metalness 0."""
    m = cornell[1].materials
    assert bool((m.roughness == 1.0).any()) and bool((m.metalness == 0.0).any())


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_kitchen_gradients_match_jax(jax_kitchen, kitchen_grads, index, field):
    loss, grads = kitchen_grads[index]
    want_loss = jax_kitchen["loss"][index]
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss
    want = jax_kitchen["grads"][index][field]
    _assert_entries_match(grads[field], want, f"kitchen frame {index} {field}")
    if want.ndim == 2:
        for row in range(want.shape[0]):
            _assert_entries_match(grads[field][row], want[row], f"kitchen frame {index} "
                                  f"{field}[{row}]")


def test_kitchen_emission_of_a_non_emitter_matches_jax(jax_kitchen, kitchen_grads):
    """emission[4] (value 0): its gradient flows only through the denoisers'
    stencils, where equal luminances tie in |a - b|."""
    for index in (0, 1):
        got = kitchen_grads[index][1]["emission"][4].numpy()
        want = jax_kitchen["grads"][index]["emission"][4]
        assert np.all(want > 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_step_matches_jax_arithmetic(jax_cornell, cornell):
    """One step of the port's make_train_step against p - lr * g and the
    projection of the JAX package, on JAX's gradients."""
    ctx, scene, cam, cfg, settings = cornell
    step = train.make_train_step(ctx, cfg, lr=LR)
    loss, mats = step(scene.materials, scene, cam, settings, frame.History.create(cfg, "cpu"),
                      torch.zeros((cfg.n_pixels, 3)))
    assert abs(float(loss) - jax_cornell["loss"]) <= 1e-5 * jax_cornell["loss"]
    g = jax_cornell["grads"]
    p = {k: jnp.asarray(getattr(scene.materials, k).numpy()) for k in FIELDS}
    want = jtrain.project_materials({k: p[k] - LR * g[k] for k in FIELDS})
    for k in FIELDS:
        got = getattr(mats, k)
        assert not got.requires_grad and got.dtype == torch.float32
        tol = LR * FIELD_TOL * float(np.abs(g[k]).max()) + 2.4e-7
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]), rtol=0, atol=tol)
    assert torch.equal(mats.flags, scene.materials.flags)


def test_param_bounds_and_projection_match_jax():
    assert train.PARAM_BOUNDS == jtrain.PARAM_BOUNDS
    assert train.DIFFERENTIABLE_MATERIAL_FIELDS == jtrain.DIFFERENTIABLE_MATERIAL_FIELDS
    rs = np.random.RandomState(0)
    vals = {k: (rs.randn(5, 3) * 3.0).astype(np.float32) for k in FIELDS}
    vals["ior"][0, 0], vals["roughness"][1, 1] = 2.5, 0.01
    got = train.project_materials({k: torch.from_numpy(v) for k, v in vals.items()})
    want = jtrain.project_materials({k: jnp.asarray(v) for k, v in vals.items()})
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---- the three denoiser plain versions on planes with exact ties ----


def _tie_relax_planes(seed):
    """Planes with every tie the RELAX plain versions meet: a block of zero
    radiance (equal luminances in the à-trous |a - b|, zero moments and a
    zero temporal variance at the clip_min bound), axis-aligned unit
    normals (the normal term's clip at exactly 1 between equal normals and
    at exactly 0 between orthogonal ones, in either package's order of
    adds), and a confidence plane of exact 0 and 1."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    h, w = 24, 32
    illum = (rs.rand(h, w, 3) * 3.0).astype(f32)
    illum[4:14, 6:20] = 0.0
    vz = (1.0 + rs.rand(h, w) * 5.0).astype(f32)
    n = np.zeros((h, w, 3), f32)
    n[..., 2] = 1.0
    n[12:, :16] = (0.0, 1.0, 0.0)
    n[18:, 16:] = (1.0, 0.0, 0.0)
    mv = ((rs.rand(h, w, 3) * 2 - 1) * np.array([0.8, 0.8, 0.01])).astype(f32)
    hist = {"illum": (rs.rand(h, w, 3) * 2.0).astype(f32),
            "moments": rs.rand(h, w, 2).astype(f32),
            "view_z": (vz * (1.0 + rs.randn(h, w) * 0.005)).astype(f32), "normal": n.copy(),
            "frames": (rs.rand(h, w) * 20).astype(f32)}
    hist["illum"][2:16, 4:22] = 0.0
    hist["moments"][2:16, 4:22] = 0.0
    conf = rs.rand(h, w).astype(f32)
    conf[:, :8], conf[:, 8:12] = 0.0, 1.0
    return hist, illum, vz, n, mv, conf


def _assert_grads_match(got, want, names):
    for name, g, w in zip(names, got, want):
        assert np.isfinite(g).all(), name
        assert not _bad(g, w).any(), f"{name}: max |diff| {np.abs(g - w).max()}"


def test_taccum_backward_matches_jax_at_ties():
    hist, illum, vz, n, mv, conf = _tie_relax_planes(1)
    arrays = [hist[k] for k in HIST] + [illum, vz, n, mv, conf]
    s = relax.RelaxSettings(max_accumulated_frames=torch.tensor(30.0))
    js = jrelax.RelaxSettings(max_accumulated_frames=30.0)

    def plain(hi, hm, hz, hn, hf, il, z, nn, m, c):
        return relax.taccum_plain(relax.RelaxHistory(hi, hm, hz, hn, hf), il, z, nn, m, s,
                                  False, c)

    cts, got = _torch_grads(plain, arrays, 21)
    want = _jax_grads(lambda *a: taccum_pallas._reference_impl(*a, js), arrays, cts)
    _assert_grads_match(got, want, HIST + ("illum", "view_z", "normal", "mv", "confidence"))


@pytest.mark.parametrize("step", [1, 2])
def test_atrous_backward_matches_jax_at_ties(step):
    _, illum, vz, n, _, conf = _tie_relax_planes(2)
    variance = conf * 0.5
    variance[10:20, 10:30] = 0.0
    arrays = [illum, variance, vz, n]
    s = relax.RelaxSettings()
    cts, got = _torch_grads(lambda *t: relax.atrous_iteration(*t, step, s), arrays, 30 + step)
    want = _jax_grads(lambda *a: jrelax.atrous_iteration(*a, step, jrelax.RelaxSettings()),
                      arrays, cts)
    _assert_grads_match(got, want, ("illum", "variance", "view_z", "normal"))


def test_taa_backward_matches_jax_at_the_clip_bounds():
    """The history exactly at 0 and 1, the bounds of the CIELAB clip, and
    outside every clamp window (|d| > 0, where JAX's vjp is finite); the
    current colour has exact zeros at the border of the window."""
    rs = np.random.RandomState(5)
    f32 = np.float32
    h, w = 24, 32
    cur = (0.4 + 0.2 * rs.rand(h, w, 3)).astype(f32)
    prev = np.where(rs.rand(h, w, 3) > 0.5, 0.0, 1.0).astype(f32)
    arrays = [cur, prev, ((rs.rand(h, w, 2) * 2 - 1) * 3.0).astype(f32),
              (rs.rand(h, w) > 0.7).astype(f32), (rs.rand(h, w) > 0.9).astype(f32)]
    cts, got = _torch_grads(lambda *t: taa.resolve_tail(*t, 2.0, 0.1), arrays, 41)
    want = _jax_grads(lambda *a: jtaa.resolve_tail(*a, 2.0, 0.1), arrays, cts)
    _assert_grads_match(got, want, ("cur", "prev", "mv_d", "wide", "reset_mix"))


@pytest.mark.parametrize("fn,jfn", [
    (lambda x: geo.clip(x, 0.0, 1.0), lambda x: jnp.clip(x, 0.0, 1.0)),
    (lambda x: geo.clip_min(x, 0.0), lambda x: jnp.maximum(x, 0.0)),
    (lambda x: geo.clip_max(x, 1.0), lambda x: jnp.minimum(x, 1.0)),
    (geo.absolute, jnp.abs),
], ids=["clip", "clip_min", "clip_max", "absolute"])
def test_tie_helpers_match_jax(fn, jfn):
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0, np.nan, np.inf, -np.inf], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = fn(t)
    y.backward(torch.arange(1.0, 9.0))
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(vjp(jnp.arange(1.0, 9.0))[0]))
    # nothing requires grad: the torch op itself, the same bits
    plain = fn(torch.from_numpy(x))
    assert plain.grad_fn is None
    np.testing.assert_array_equal(plain.numpy(), y.detach().numpy())


def test_clip_with_tensor_bounds_matches_jax():
    x = np.array([0.0, 0.5, 1.0, -1.0, 2.0, 0.3], np.float32)
    lo = np.array([0.0, 0.5, 1.0, -1.0, 2.0, 0.0], np.float32)
    tx, tlo = torch.from_numpy(x).requires_grad_(), torch.from_numpy(lo).requires_grad_()
    torch.sum(geo.clip(tx, tlo, 1.0) * torch.arange(6.0)).backward()
    gx, glo = jax.grad(lambda a, b: jnp.sum(jnp.clip(a, b, 1.0) * jnp.arange(6.0)), (0, 1))(
        jnp.asarray(x), jnp.asarray(lo))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gx))
    np.testing.assert_array_equal(tlo.grad.numpy(), np.asarray(glo))


def _gather_inputs():
    """A (12, 16, 3) plane and sample positions: random ones, some off
    screen, and exact pixel centres (weight 0 on the far taps)."""
    rs = np.random.RandomState(8)
    img = rs.rand(12, 16, 3).astype(np.float32)
    pos = (rs.rand(10, 11, 2) * np.array([20.0, 16.0]) - 2.0).astype(np.float32)
    pos[0] = np.stack([np.arange(11) + 0.5, np.full(11, 3.5)], -1)
    return img, pos


def test_gather_backward_matches_jax():
    """The history gather's gradient with respect to the plane and the
    positions (REBLUR's specular gather position depends on the roughness):
    the plain version, which the card's dispatcher differentiates, against
    ``jax.vjp`` of the JAX package's XLA gather."""
    img, pos = _gather_inputs()
    cts, got = _torch_grads(reproject.sample_bilinear_auto, [img, pos], 51)
    want = _jax_grads(jfiltering.sample_bilinear, [img, pos], cts)
    _assert_grads_match(got, want, ("img", "pos"))
    assert np.abs(got[1]).max() > 0.0


# ---- the port on its own: finite differences, the recovery, checkpoints ----


@pytest.fixture(scope="module")
def grad_setup():
    """tests/test_grad.py's setup: the Cornell box with roughness[4] = 0.55
    (off the clamp bound), 32x32, REFERENCE, FULL_PROBABILISTIC, two
    bounces, four importance samples."""
    scene = procedural.cornell_box()
    rough = scene.materials.roughness.clone()
    rough[4] = 0.55
    scene = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                     roughness=rough))
    ctx, scene = traversal.build_context(scene, device="cpu")
    cam = look_at(*CORNELL_CAM[:2], fov_y_deg=CORNELL_CAM[2], device="cpu")
    cfg = RenderConfig(tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE,
                       **_cornell_cfg())
    settings = make_settings("cpu", sun_elevation=-30.0, disable_shadows=1)
    return ctx, scene, cam, cfg, settings


def _sum_loss_of(setup_t, field, idx):
    ctx, scene, cam, cfg, settings = setup_t

    def loss(v):
        arr = getattr(scene.materials, field).clone()
        arr[idx] = v
        mats = dataclasses.replace(scene.materials, **{field: arr})
        out, _ = frame.render_frame(ctx, dataclasses.replace(scene, materials=mats), cam, cfg,
                                    settings, frame.History.create(cfg, "cpu"))
        return torch.sum(out["color"])

    return loss


@pytest.mark.parametrize("field,idx", [("emission", (3, 0)), ("base_color", (1, 0)),
                                       ("roughness", (4,))])
def test_grad_matches_fd(grad_setup, field, idx):
    loss = _sum_loss_of(grad_setup, field, idx)
    v0 = getattr(grad_setup[1].materials, field)[idx].clone().requires_grad_()
    g_auto, = torch.autograd.grad(loss(v0), v0)
    eps = 3e-3
    with torch.no_grad():
        g_fd = float((loss(v0 + eps) - loss(v0 - eps)) / (2 * eps))
    assert float(g_auto) == pytest.approx(g_fd, rel=0.08, abs=0.6), (field, float(g_auto), g_fd)


def test_emission_grad_positive(grad_setup):
    loss = _sum_loss_of(grad_setup, "emission", (3, 1))
    v = grad_setup[1].materials.emission[3, 1].clone().requires_grad_()
    g, = torch.autograd.grad(loss(v), v)
    assert float(g) > 0.0


def test_sun_elevation_grad_flows(grad_setup):
    ctx, scene, cam, cfg, settings = grad_setup
    elev = torch.tensor(-30.0, requires_grad=True)
    st = dataclasses.replace(settings, sun_elevation=elev)
    out, _ = frame.render_frame(ctx, scene, cam, cfg, st, frame.History.create(cfg, "cpu"))
    g, = torch.autograd.grad(torch.sum(out["color"]), elev)
    assert bool(torch.isfinite(g))


@pytest.fixture(scope="module")
def albedo_run(grad_setup, tmp_path_factory):
    """tests/test_grad.py's recovery: 24 steps at lr 2e-4 from the red wall
    towards a target rendered with base_color[1] = (0.1, 0.2, 0.7), a fresh
    History each step; a checkpoint of (materials, history, step) is saved
    after step 12. Returns (losses, materials after each step, target,
    checkpoint path)."""
    ctx, scene, cam, cfg, settings = grad_setup
    bc = scene.materials.base_color.clone()
    bc[1] = torch.tensor([0.1, 0.2, 0.7])
    with torch.no_grad():
        target, _ = train.render_color(
            ctx, cfg, dataclasses.replace(scene.materials, base_color=bc), scene, cam, settings,
            frame.History.create(cfg, "cpu"))
    step = train.make_train_step(ctx, cfg, lr=LR)
    path = str(tmp_path_factory.mktemp("ckpt") / "step12.npz")
    mats, losses, states = scene.materials, [], []
    for i in range(24):
        hist = frame.History.create(cfg, "cpu")
        if i == 12:
            checkpoint.save(path, i, materials=mats, history=hist)
        loss, mats = step(mats, scene, cam, settings, hist, target)
        losses.append(float(loss))
        states.append(mats)
    return losses, states, target, path


def test_albedo_optimization_converges(albedo_run):
    losses, states, _, _ = albedo_run
    assert losses[-1] < losses[0] * 0.35, losses[::6]
    got = states[-1].base_color[1].numpy()
    want = np.array([0.1, 0.2, 0.7])
    start = np.array([0.611, 0.056, 0.062])
    assert np.abs(got - want).sum() < 0.6 * np.abs(start - want).sum()


def test_checkpoint_resume_is_bit_equal(grad_setup, albedo_run):
    ctx, scene, cam, cfg, settings = grad_setup
    losses, states, target, path = albedo_run
    like = {"materials": states[11], "history": frame.History.create(cfg, "cpu")}
    back = checkpoint.restore(path, like=like)
    assert back["step"] == 12
    for f in dataclasses.fields(states[11]):
        a, b = getattr(back["materials"], f.name), getattr(states[11], f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    step = train.make_train_step(ctx, cfg, lr=LR)
    mats, resumed = back["materials"], []
    for _ in range(back["step"], 24):
        loss, mats = step(mats, scene, cam, settings, back["history"], target)
        resumed.append(float(loss))
    assert resumed == losses[12:]
    for f in dataclasses.fields(mats):
        assert torch.equal(getattr(mats, f.name), getattr(states[-1], f.name)), f.name


def test_checkpoint_keeps_sharc_keys_and_refuses_bad_files(tmp_path):
    cfg = RenderConfig(width=8, height=8, denoiser=Denoiser.RELAX, use_taa=True, use_sharc=True,
                       use_confidence=True, sharc_capacity=64)
    h = frame.History.create(cfg, "cpu")
    keys = torch.from_numpy(np.random.RandomState(3).randint(0, 1 << 32, 64, dtype=np.int64))
    h.sharc.keys.copy_(keys)
    path = str(tmp_path / "h.npz")
    checkpoint.save(path, 7, history=h, materials=procedural.cornell_box().materials)
    back = checkpoint.restore(path, device="cpu")
    assert back["step"] == 7 and back["history"].sharc.keys.dtype == torch.int64
    assert torch.equal(back["history"].sharc.keys, keys)
    assert back["history"].reference is None and back["history"].relax_diff is not None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "missing.npz"), device="cpu")
    (tmp_path / "junk.npz").write_bytes(b"not a checkpoint")
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.restore(str(tmp_path / "junk.npz"), device="cpu")
    np.savez(tmp_path / "other.npz", a=np.zeros(3))
    with pytest.raises(checkpoint.CheckpointError):
        checkpoint.restore(str(tmp_path / "other.npz"), device="cpu")
    with pytest.raises(checkpoint.CheckpointError):   # a History of another RenderConfig
        checkpoint.restore(path, like={"history": frame.History.create(RenderConfig(
            width=8, height=8), "cpu"), "materials": procedural.cornell_box().materials})


def test_bench_backward_on_the_cpu():
    r = train.bench_backward(size=24, n_iter=1, device="cpu")
    assert set(r) >= {"grad_forward_ms", "grad_backward_ms", "backward_forward_ratio",
                      "grad_fd_rel_err", "grad_allclose_fd"}
    assert r["grad_forward_ms"] > 0.0 and np.isfinite(r["backward_forward_ratio"])
    assert r["grad_fd_rel_err"] < 0.08 and r["grad_allclose_fd"]
    assert r["grad_forward_busy_ms"] is None and r["peak_memory_bytes"] is None


def test_probe_inputs_are_detached_before_dispatch():
    """light_probe gives no gradient on either device: on the CPU its
    result is the plain probe's and needs no grad even where the rays and
    the intensities do (the CUDA path gets the same detached tensors, and
    the raw kernel wrapper still refuses an input that requires grad)."""
    scene = procedural.cornell_box()
    em_scale = torch.tensor(1.0, requires_grad=True)
    em = emissive_is.build_emissive_set(scene, em_scale)
    assert em["intensity"].requires_grad
    rs = np.random.RandomState(0)
    o = torch.from_numpy((rs.uniform(-0.3, 0.3, (256, 3)) + [0.0, 0.0, 1.0]).astype(np.float32))
    d = torch.from_numpy((rs.randn(256, 3) * 0.2 + [0.0, 0.0, 1.0]).astype(np.float32))
    d = (d / d.norm(dim=-1, keepdim=True)).requires_grad_()   # up, towards the ceiling light
    li = emissive_is.light_probe(em, o, d)
    assert not li.requires_grad and float(li.max()) > 0.0
    want = emissive_probe.light_probe_plain({k: v.detach() if torch.is_tensor(v) else v
                                             for k, v in em.items()}, o, d.detach())
    assert torch.equal(li, want)
    with pytest.raises(NotImplementedError):
        emissive_probe.light_probe_cuda(em, o, d)


# ---- on the card ----


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_step_runs_on_the_card(cuda_device):
    """All five fields require grad through the emitter's probe kernel."""
    ctx, scene = traversal.build_context(procedural.cornell_box(), device=cuda_device)
    cam = look_at(*CORNELL_CAM[:2], fov_y_deg=CORNELL_CAM[2], device=cuda_device)
    cfg = RenderConfig(width=64, height=64, bounce_num=2)
    settings = make_settings(cuda_device, sun_elevation=-30.0, disable_shadows=1)
    before = emissive_probe.LAUNCHES
    loss, mats = train.make_train_step(ctx, cfg, lr=1e-4)(
        scene.materials, scene, cam, settings, frame.History.create(cfg, cuda_device),
        torch.zeros((cfg.n_pixels, 3), device=cuda_device))
    assert emissive_probe.LAUNCHES > before and bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(getattr(mats, k)).all()) for k in FIELDS)


@pytest.mark.cuda
def test_gather_dispatcher_differentiates_on_the_card(cuda_device):
    """Positions that require grad: the gather kernel's forward (one launch,
    equal to the plain version), the plain version's gradient."""
    img, pos = (torch.from_numpy(a).to(cuda_device).requires_grad_() for a in _gather_inputs())
    before = reproject.LAUNCHES
    got = reproject.sample_bilinear_auto(img, pos)
    assert reproject.LAUNCHES == before + 1
    want = reproject.filtering.sample_bilinear(img, pos)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    ct = torch.randn(got.shape, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    for a, b in zip(torch.autograd.grad(got, [img, pos], ct),
                    torch.autograd.grad(want, [img, pos], ct)):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_reblur_train_step_runs_on_the_card(cuda_device):
    ctx, scene, cam, cfg, settings = bench_configs.setup("shaderballs512", cuda_device,
                                                         width=64, height=64)
    before = reproject.LAUNCHES
    loss, mats = train.make_train_step(ctx, cfg, lr=1e-4)(
        scene.materials, scene, cam, settings, frame.History.create(cfg, cuda_device),
        torch.zeros((cfg.n_pixels, 3), device=cuda_device))
    assert reproject.LAUNCHES > before and bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(getattr(mats, k)).all()) for k in FIELDS)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [
    ("kitchen1080", dict(width=80, height=48, sharc_capacity=1 << 16)),
    # REBLUR through the packet kernel; a sun highlight here amplified the
    # last bits of the card's rsqrt in the shading normal
    ("shaderballs512", dict(width=64, height=64)),
])
def test_card_gradients_match_the_cpu(cuda_device, name, kw):
    grads = {}
    for where in ("cpu", cuda_device):
        ctx, scene, cam, cfg, settings = bench_configs.setup(name, where, **kw)
        diff, rest = train.split_materials(scene.materials)
        grads[str(where)] = train.value_and_grad(
            train.make_loss_fn(ctx, cfg), diff, rest, scene, cam, settings,
            frame.History.create(cfg, where), torch.zeros((cfg.n_pixels, 3), device=where))[1]
    for k in FIELDS:
        _assert_entries_match(grads[str(cuda_device)][k].cpu(), grads["cpu"][k].numpy(),
                              f"{name}: card vs cpu {k}")
