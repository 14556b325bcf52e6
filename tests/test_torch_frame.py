"""The port's whole frame against the JAX package's, its golden gate, every
RenderConfig branch of the frame, the scene features left for later slices,
and its independence from JAX.

Two REFERENCE frames of the Cornell box at 32x32 go through both
render_frame functions from the same scene, camera and settings. Discrete
choices (lobe, reservoir take, edge hits) can flip on an ULP of a
transcendental, so per output plane at most 0.5% of pixels may differ by
more than 1e-3 * (1 + |ref|), and the image means agree within 1e-3
relative. The cornellbox-000 golden is checked at tests/test_golden.py's
tolerance (2% of the image's dynamic scale per 8x8 tile mean)."""

import ast
import dataclasses
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Settings as JSettings
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe, replay
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.config import Denoiser, NrdMode, OnScreen, RenderConfig, TracingMode
from nrdsample_tpu_torch.denoise import composition
from nrdsample_tpu_torch.ops import emissive_probe, intersect, traversal
from nrdsample_tpu_torch.pipeline import frame, records
from nrdsample_tpu_torch.render import emissive_is, stress
from nrdsample_tpu_torch.scene import procedural, textures
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import declare, session_cached, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
RES = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    bad = np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))
    return bad.reshape(bad.shape[0], -1).any(-1).mean()


@pytest.fixture(scope="module")
def two_frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_frame_cornell", _two_frames)


declare("torch_frame_cornell", lambda _: _two_frames())


def _two_frames():
    """[(JAX outputs, port outputs)] for frames 0 and 1, plus both histories."""
    jctx, jscene = jtraversal.build_context(jproc.cornell_box())
    jc = jlook_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0)
    js = JSettings(sun_elevation=jnp.float32(-30.0), disable_shadows=jnp.int32(1))
    jcfg = replay.cfg_from_render({}, res=RES)
    fn = jax.jit(lambda sc, c, st, h: jframe.render_frame(jctx, sc, c, jcfg, st, h))
    ctx, scene = traversal.build_context(convert.scene_from_numpy(_np_leaves(jscene), device="cpu"),
                                         device="cpu")
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    cfg = RenderConfig(width=RES, height=RES)
    jh, h = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    pairs = []
    for _ in range(2):
        jout, jh = fn(jscene, jc, js, jh)
        out, h = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        pairs.append((jax.tree.map(np.asarray, jout), out))
    return pairs, jh, h


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("plane", ["color", "view_z", "normal", "shadow", "diff_radiance",
                                   "spec_radiance"])
def test_frame_matches_jax(two_frames, index, plane):
    want, got = two_frames[0][index]
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert _outlier_frac(want[plane], g.numpy()) <= OUTLIER_FRAC


@pytest.mark.parametrize("index", [0, 1])
def test_frame_mean_matches_jax(two_frames, index):
    want, got = two_frames[0][index]
    w, g = float(want["color"].mean()), float(got["color"].mean())
    assert abs(g - w) <= MEAN_REL * abs(w)
    assert bool(torch.isfinite(got["color"]).all()) and g > 0.0


def test_history_matches_jax(two_frames):
    _, jh, h = two_frames
    assert h.frame_index.dtype == torch.int32 and int(h.frame_index) == int(jh.frame_index) == 2
    assert h.reference.frames.dtype == torch.int32 and int(h.reference.frames) == 2
    assert _outlier_frac(np.asarray(jh.reference.accum), h.reference.accum.numpy()) <= OUTLIER_FRAC


def test_cornellbox_golden_through_the_port():
    data = np.load(os.path.join(REPO, "Tests", "golden", "cornellbox-000.npz"))
    res = int(data["res"])
    settings, cam, render, animation = records.load_record_full(
        os.path.join(REPO, "Tests", "cornellbox.json"), 0, device="cpu")
    assert render == {} and animation is None
    cfg = RenderConfig(width=res, height=res)
    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    out, _ = frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, "cpu"),
                                reset_history=True)
    img = out["color"].numpy().reshape(res, res, 3)
    tiles = img.reshape(res // 8, 8, res // 8, 8, 3).mean(axis=(1, 3))
    scale = max(float(data["std"]), 0.05)
    np.testing.assert_allclose(tiles, data["tile_means"], atol=0.02 * scale + 1e-4)
    assert abs(float(img.mean()) - float(data["mean"])) < 0.02 * scale + 1e-4


def test_cam_fov_and_blink_settings():
    """camFov replaces the camera's FoV; blink only touches forced-emission
    materials, which the Cornell box has none of."""
    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    cfg = RenderConfig(width=16, height=16)
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device="cpu")
    base = config.make_settings("cpu", sun_elevation=-30.0, disable_shadows=1)
    ref, _ = frame.render_frame(ctx, scene, cam, cfg, base, frame.History.create(cfg, "cpu"))
    same_fov = dataclasses.replace(base, cam_fov=torch.tensor(39.0), blink=torch.tensor(1, dtype=torch.int32))
    out, _ = frame.render_frame(ctx, scene, cam, cfg, same_fov, frame.History.create(cfg, "cpu"))
    torch.testing.assert_close(out["color"], ref["color"], rtol=1e-5, atol=1e-5)
    wide = dataclasses.replace(base, cam_fov=torch.tensor(80.0))
    out, _ = frame.render_frame(ctx, scene, cam, cfg, wide, frame.History.create(cfg, "cpu"))
    assert not torch.allclose(out["view_z"], ref["view_z"])


BRANCH_CONFIGS = {
    "reblur": dict(denoiser=Denoiser.REBLUR),
    "relax": dict(denoiser=Denoiser.RELAX),
    "neural": dict(denoiser=Denoiser.NEURAL),
    "sharc": dict(use_sharc=True),
    "l1_cache": dict(use_l1_cache=True),
    "taa": dict(use_taa=True),
    "psr": dict(psr_bounce_num=1),
    "half": dict(tracing_mode=TracingMode.HALF),
    "nrd_sh": dict(nrd_mode=NrdMode.SH),
    "post": dict(enable_post=True),
    "on_screen": dict(on_screen=OnScreen.BASE_COLOR),
    "validation_overlay": dict(use_validation_overlay=True, denoiser=Denoiser.RELAX),
    "inf_stress": dict(use_inf_stress_test=True),
    "drs_stress": dict(use_drs_stress_test=True),
    "firefly": dict(use_firefly_test=True),
    "material_id": dict(use_material_id_test=True),
    "sanitization": dict(use_sanitization=True),
    "hair_sss": dict(use_hair_sss=True),
    "nrd_occlusion": dict(nrd_mode=NrdMode.OCCLUSION),
    "nrd_directional_occlusion": dict(nrd_mode=NrdMode.DIRECTIONAL_OCCLUSION, denoiser=Denoiser.RELAX),
}


@pytest.mark.parametrize("name", sorted(BRANCH_CONFIGS))
def test_config_branches_render(name):
    """Every RenderConfig branch renders: its 8x8 frame of the Cornell box is
    finite (under the inf stress test, NaN exactly where view-z is outside
    the denoising range) and its histories advance. The post chain's
    display image has the output shape and lies in [0, 1], a debug view is
    finite, the validation overlay blends the RELAX accumulation age over
    the final image, and the RR slot's history is valid after a frame. A
    History of another RenderConfig is refused."""
    cfg = RenderConfig(width=8, height=8, sharc_capacity=1 << 10, **BRANCH_CONFIGS[name])
    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    cam = look_at([0, -3, 1], [0, 0, 1], device="cpu")
    out, h = frame.render_frame(ctx, scene, cam, cfg, config.Settings(),
                                frame.History.create(cfg, "cpu"))
    far = out["view_z"].abs() > stress.DENOISING_RANGE if name == "inf_stress" else None
    for plane in ("color", "final"):
        if far is not None:
            assert torch.equal(~torch.isfinite(out[plane]).all(-1), far)
            assert float(out[plane][~far].mean()) > 0.0
            continue
        assert bool(torch.isfinite(out[plane]).all()) and float(out[plane].mean()) > 0.0
    assert int(h.frame_index) == 1
    assert (out["display"] is None) == (name != "post")
    assert (out["debug"] is None) == (name != "on_screen")
    if name == "l1_cache":
        assert int(h.l1.valid) == 1 and h.l1.packed.shape == (8, 8, 7)
    elif name == "material_id":
        stripes = out["gbuffer"]["material_id"].reshape(8, 8)
        assert bool((stripes == 0.0).all())   # rows 0-7: the first stripe
    elif name == "post":
        d = out["display"]
        assert tuple(d.shape) == (8, 8, 3) and 0.0 <= float(d.min()) <= float(d.max()) <= 1.0
    elif name == "on_screen":
        assert tuple(out["debug"].shape) == (64, 3) and bool(torch.isfinite(out["debug"]).all())
        assert torch.equal(out["debug"], out["gbuffer"]["base_color"])
    elif name == "validation_overlay":
        blended = composition.validation_overlay(out["color"], h.relax_diff.frames.reshape(-1),
                                                 frame._max_acc(config.Settings()))
        assert torch.equal(out["final"], blended) and not torch.equal(out["final"], out["color"])
    elif name == "neural":
        assert h.neural_rr.valid.dtype == torch.int32 and int(h.neural_rr.valid) == 1
        assert torch.equal(h.neural_rr.color.reshape(-1, 3), out["color"])
    if name in ("reblur", "relax"):
        # one frame accumulated (anti-lag may cut REBLUR's count below 1)
        assert h.reference is None
        assert float(h.sigma.frames.min()) == float(h.sigma.frames.max()) == 1.0
        frames = getattr(h, f"{name}_diff").frames
        assert 0.0 < float(frames.min()) and float(frames.max()) == 1.0
    elif name == "sharc":
        assert int((h.sharc.keys != 0).sum()) > 0
    elif name == "taa":
        assert int(h.taa.valid) == 1 and h.taa.color.shape == (8, 8, 3)
    if cfg.denoiser != Denoiser.REFERENCE:
        with pytest.raises(ValueError, match="History"):
            frame.render_frame(ctx, scene, cam, cfg, config.Settings(),
                               frame.History.create(RenderConfig(width=8, height=8), "cpu"))


def _scene_variant(name):
    scene = procedural.cornell_box()
    if name == "textures":
        return textures.textured_scene(scene, res=16)
    if name == "alpha_test":
        return textures.textured_scene(scene, res=64, alpha_materials=(0, 1, 2))
    if name == "instance_scales":
        # the two boxes (the last 24 triangles) are instance 1, at half
        # their base colour and roughness
        ids = torch.zeros(scene.num_tris, dtype=torch.int32)
        ids[-24:] = 1
        scales = torch.ones(2, 10)
        scales[1, 0:3] = 0.5
        scales[1, 7] = 0.5
        return dataclasses.replace(scene, tri_instance=ids, instance_scales=scales)
    if name == "transparent":
        flags = scene.materials.flags.clone()
        flags[4] = config.FLAG_TRANSPARENT
        return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, flags=flags))
    if name == "over_1024_tris":
        tris = scene.tris
        reps = 1025 // tris.count + 1
        big = type(tris)(**{f.name: getattr(tris, f.name).repeat(reps, *([1] * (getattr(tris, f.name).dim() - 1)))
                            for f in dataclasses.fields(tris)})
        return dataclasses.replace(scene, tris=big)
    if name == "over_512_emitters":
        ids = torch.arange(513, dtype=torch.int32) % scene.num_tris
        return dataclasses.replace(scene, emissive_tris=ids, emissive_count=torch.tensor(513, dtype=torch.int32))
    raise KeyError(name)


def _assert_hits_as_dense(ctx, scene):
    """The context's closest hits equal brute force over the unpadded
    scene's triangles: t bit for bit, hit/miss on every ray, and the
    triangle itself (through ``ctx.order``) except on exact ties between
    coincident or edge-sharing triangles."""
    rs = np.random.RandomState(0)
    o = torch.from_numpy(rs.uniform(-0.9, 0.9, (2000, 3)).astype(np.float32) + np.float32([0, 0, 1]))
    d = torch.from_numpy(rs.randn(2000, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    got = traversal.closest_hit(ctx, o, d)
    n = len(ctx.order)
    p0, e1, e2 = (getattr(scene.tris, k)[torch.from_numpy(np.argsort(ctx.order))] for k in ("p0", "e1", "e2"))
    want = intersect.intersect_dense(o, d, p0, e1, e2)
    assert scene.tris.count % 128 == 0 and scene.tris.count >= n
    assert torch.equal(got["t"], want["t"]) and torch.equal(got["tri"] >= 0, want["tri"] >= 0)
    hit = got["tri"] >= 0
    mapped = torch.from_numpy(ctx.order.astype(np.int32))[got["tri"][hit].long()]
    assert float((mapped != want["tri"][hit]).float().mean()) <= 0.05
    assert int(hit.sum()) > 1000


@pytest.mark.parametrize("name", ["textures", "alpha_test", "instance_scales", "transparent",
                                  "over_1024_tris", "over_512_emitters"])
def test_later_scene_branches_raise(name):
    """A scene feature of a later slice raises NotImplementedError from
    build_context. Ported since: scenes over 1024 triangles (cluster mode,
    with the hits of brute force), glass (build_scene_contexts splits off a
    transparent context after the opaque range), more than 512 emitters
    (on the CPU the dense plain probe; the emissive ClusterSet is built for
    the card only), textures and normal maps (an 8x8 frame renders finite
    and differs from the untextured one) and the alpha test (rays pass the
    cut-outs of the alpha-tested walls) and per-instance material scales
    (the boxes' instance row halves their colour: the frame differs from
    the plain one, and with unit rows equals it; in cluster mode the
    instance ids follow the triangles' order)."""
    if name == "over_1024_tris":
        ctx, scene = traversal.build_context(_scene_variant(name), device="cpu")
        assert ctx.mode == "cluster" and ctx.clusters.count == 9
        _assert_hits_as_dense(ctx, scene)
        return
    if name == "transparent":
        ctxs, scene = traversal.build_scene_contexts(_scene_variant(name), device="cpu")
        assert ctxs.transparent.mode == ctxs.opaque.mode == "dense"
        assert ctxs.transparent.tri_offset == ctxs.opaque.tris.count == 12
        assert ctxs.transparent.tris.count == scene.tris.count - 12 == 24
        assert bool((scene.materials.flags[scene.tris.material[12:].long()] == config.FLAG_TRANSPARENT).all())
        return
    if name == "over_512_emitters":
        ctx, scene = traversal.build_context(_scene_variant(name), device="cpu")
        assert ctx.emissive is None
        em = emissive_is.build_emissive_set(scene)
        o = torch.tensor([[0.0, 0.0, 1.0]]).expand(64, 3).contiguous()
        d = torch.nn.functional.normalize(torch.randn(64, 3, generator=torch.Generator().manual_seed(0)),
                                          dim=-1)
        assert em["p0"].shape[0] == 513
        assert torch.equal(emissive_is.light_probe(em, o, d), emissive_probe.light_probe_plain(em, o, d))
        return
    if name in ("textures", "alpha_test"):
        ctx, scene = traversal.build_context(_scene_variant(name), device="cpu")
        assert scene.textures is not None and scene.has_alpha_test == (name == "alpha_test")
        cfg = RenderConfig(width=8, height=8)
        cam = look_at([0, -3, 1], [0, 0, 1], device="cpu")
        out = frame.render_frame(ctx, scene, cam, cfg, config.Settings(),
                                 frame.History.create(cfg, "cpu"))[0]["color"]
        ctx0, scene0 = traversal.build_context(procedural.cornell_box(), device="cpu")
        plain = frame.render_frame(ctx0, scene0, cam, cfg, config.Settings(),
                                   frame.History.create(cfg, "cpu"))[0]["color"]
        assert bool(torch.isfinite(out).all()) and not torch.equal(out, plain)
        if name == "alpha_test":
            o = torch.tensor([[0.0, 0.0, 1.0]]).expand(512, 3).contiguous()
            d = torch.nn.functional.normalize(
                torch.randn(512, 3, generator=torch.Generator().manual_seed(1)), dim=-1)
            hit = traversal.closest_hit_alpha(ctx, scene, o, d)
            assert int((hit["tri"] != traversal.closest_hit(ctx, o, d)["tri"]).sum()) > 0
        return
    assert name == "instance_scales"
    variant = _scene_variant(name)
    cfg = RenderConfig(width=8, height=8)
    cam = look_at([0, -3, 1], [0, 0, 1], device="cpu")

    def render(sc):
        ctx, sc = traversal.build_context(sc, device="cpu")
        return frame.render_frame(ctx, sc, cam, cfg, config.Settings(),
                                  frame.History.create(cfg, "cpu"))[0]["color"]

    out, plain = render(variant), render(procedural.cornell_box())
    assert bool(torch.isfinite(out).all()) and not torch.equal(out, plain)
    unit = dataclasses.replace(variant, instance_scales=torch.ones(2, 10))
    assert torch.equal(render(unit), plain)
    ctx, scene = traversal.build_context(variant, mode="cluster", device="cpu")
    old_ids = variant.tri_instance.numpy()
    assert np.array_equal(scene.tri_instance.numpy()[:len(ctx.order)], old_ids[ctx.order])
    assert not scene.tri_instance[len(ctx.order):].any()


def test_cluster_mode_raises():
    """Cluster mode, once of a later slice, is ported now: the Cornell box
    forced into it (36 triangles padded to one cluster) traces as dense
    mode does."""
    ctx, scene = traversal.build_context(procedural.cornell_box(), mode="cluster", device="cpu")
    assert ctx.mode == "cluster" and ctx.clusters.count == 1 and scene.tris.count == 128
    _assert_hits_as_dense(ctx, scene)


def test_default_device_is_the_card(monkeypatch):
    """device=None means CUDA: without a card it fails at once, naming CUDA,
    instead of carrying on on the CPU."""
    from nrdsample_tpu_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: resolve(None), lambda: config.make_settings(),
                 lambda: look_at([0, -3, 1], [0, 0, 1]),
                 lambda: frame.History.create(RenderConfig(width=8, height=8)),
                 lambda: traversal.build_context(procedural.cornell_box())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_port_imports_no_jax():
    """An AST scan of every module of the port: no ``import jax`` and no
    ``from jax ...`` (nor of the JAX package)."""
    files = glob.glob(os.path.join(REPO, "nrdsample_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "nrdsample_tpu"), f"{path}: imports {n}"
