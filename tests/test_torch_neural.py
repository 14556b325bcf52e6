"""The learned networks of the SR and RR slots: the port's weight files are
byte copies of the JAX package's, ``neural_sr.apply``, ``neural_rr.apply``
and two recurrent ``neural_rr.denoise`` steps (the second after a reset)
match JAX within 1e-5 abs/rel on seeded inputs with the shipped weights, and
the RR slot's held-out quality gate (tests/test_neural_rr.py) holds on the
port alone: at 96x96 on the kitchen its NEURAL frame beats its RELAX frame
in PSNR against Tests/golden/neural_rr_holdout.npz."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.post import neural_rr as jrr, neural_sr as jsr
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.post import neural_rr, neural_sr
from nrdsample_tpu_torch.scene import procedural
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOLDOUT = os.path.join(REPO, "Tests", "golden", "neural_rr_holdout.npz")
MODULES = {"sr": (jsr, neural_sr), "rr": (jrr, neural_rr)}


def _rand(rs, *shape, hi=1.0):
    return (rs.rand(*shape) * hi).astype(np.float32)


@pytest.mark.parametrize("net", sorted(MODULES))
def test_weight_files_are_copies(net):
    jmod, mod = MODULES[net]
    with open(jmod.WEIGHTS_PATH, "rb") as a, open(mod.WEIGHTS_PATH, "rb") as b:
        assert a.read() == b.read()
    want = {k: np.asarray(v) for k, v in jmod.load_weights().items()}
    got = mod.load_weights(device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        # HWIO -> OIHW
        g = got[k].numpy()
        assert np.array_equal(g, v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
        assert got[k].is_contiguous()


def test_conv_params_from_numpy_layout():
    rs = np.random.RandomState(0)
    d = {"w0": _rand(rs, 3, 3, 5, 7), "b0": _rand(rs, 7)}
    p = convert.conv_params_from_numpy(d, device="cpu")
    assert p["w0"].shape == (7, 5, 3, 3) and p["b0"].shape == (7,)
    assert float(p["w0"][6, 4, 0, 2]) == float(d["w0"][0, 2, 4, 6])
    with pytest.raises(KeyError):
        convert.conv_params_from_numpy({"k0": d["b0"]}, device="cpu")


def test_missing_weights_raise(tmp_path):
    """The port ships its weights: a missing file raises instead of
    rendering another image."""
    for mod in (neural_sr, neural_rr):
        with pytest.raises(FileNotFoundError):
            mod.load_weights(str(tmp_path / "absent.npz"), device="cpu")


@pytest.mark.parametrize("out_hw", [(48, 80), (24, 40)], ids=["2x", "native"])
def test_neural_sr_apply(out_hw):
    rs = np.random.RandomState(1)
    color = _rand(rs, 24, 40, 3)
    n = rs.randn(24, 40, 3).astype(np.float32)
    g = {"normal": n / np.linalg.norm(n, axis=-1, keepdims=True),
         "roughness": _rand(rs, 24, 40), "depth": _rand(rs, 24, 40)}
    want = jsr.apply(jsr.load_weights(), jnp.asarray(color),
                     {k: jnp.asarray(v) for k, v in g.items()}, *out_hw)
    got = neural_sr.apply(neural_sr.load_weights(device="cpu"), torch.from_numpy(color),
                          {k: torch.from_numpy(v) for k, v in g.items()}, *out_hw)
    assert got.shape == out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _rr_inputs(seed, h=48, w=64):
    rs = np.random.RandomState(seed)
    g = {"diff_albedo": _rand(rs, h, w, 3), "spec_albedo": _rand(rs, h, w, 3),
         "normal_roughness": _rand(rs, h, w, 4), "depth": _rand(rs, h, w)}
    return _rand(rs, h, w, 3, hi=2.0), g, _rand(rs, h, w, 3), rs.randn(h, w, 2).astype(np.float32)


@pytest.mark.parametrize("prev_valid", [0, 1])
def test_neural_rr_apply(prev_valid):
    noisy, g, prev, _ = _rr_inputs(2)
    want = jrr.apply(jrr.load_weights(), jnp.asarray(noisy),
                     {k: jnp.asarray(v) for k, v in g.items()}, jnp.asarray(prev), prev_valid)
    got = neural_rr.apply(neural_rr.load_weights(device="cpu"), torch.from_numpy(noisy),
                          {k: torch.from_numpy(v) for k, v in g.items()}, torch.from_numpy(prev),
                          prev_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_neural_rr_denoise_recurrent():
    """Three recurrent steps, the third after a reset: the reprojected
    history, the valid flag and the outputs follow JAX."""
    jp, tp = jrr.load_weights(), neural_rr.load_weights(device="cpu")
    jh = jrr.NeuralRRHistory.create(48, 64)
    th = neural_rr.NeuralRRHistory.create(48, 64, device="cpu")
    for step, reset in enumerate((False, False, True)):
        noisy, g, _, mv = _rr_inputs(10 + step)
        want, jh = jrr.denoise(jp, jnp.asarray(noisy), {k: jnp.asarray(v) for k, v in g.items()},
                               jnp.asarray(mv), jh, reset=reset)
        got, th = neural_rr.denoise(tp, torch.from_numpy(noisy),
                                    {k: torch.from_numpy(v) for k, v in g.items()},
                                    torch.from_numpy(mv), th, reset=torch.tensor(reset))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(th.color.numpy(), np.asarray(jh.color), **TOL)
        assert th.valid.dtype == torch.int32 and int(th.valid) == int(jh.valid) == 1


def test_history_from_numpy_neural_rr():
    jh = jrr.NeuralRRHistory.create(8, 12)
    h = convert.history_from_numpy({"frame_index": np.int32(3),
                                    "neural_rr": {"color": np.asarray(jh.color) + 0.25,
                                                  "valid": np.int32(1)}}, device="cpu")
    assert isinstance(h.neural_rr, neural_rr.NeuralRRHistory)
    assert h.neural_rr.color.shape == (8, 12, 3) and float(h.neural_rr.color.min()) == 0.25
    assert h.neural_rr.valid.dtype == torch.int32 and int(h.neural_rr.valid) == 1


def _psnr(a, target):
    a = np.clip(np.asarray(a), 0, 4)
    t = np.clip(np.asarray(target), 0, 4)
    return -10 * np.log10(np.mean((a - t) ** 2) + 1e-12)


def test_neural_beats_relax_on_holdout():
    """tests/test_neural_rr.py's gate on the port: the same 2-frame sequence
    (1 rpp, 2 bounces) through NEURAL and RELAX, scored against the
    converged target of the held-out kitchen view."""
    res = 96
    target = np.load(HOLDOUT)["target"]
    ctx, scene = traversal.build_context(procedural.kitchen(), device="cpu")
    cam = look_at([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], fov_y_deg=65.0, device="cpu")
    settings = make_settings("cpu", sun_elevation=45.0)
    psnr = {}
    for d in (Denoiser.NEURAL, Denoiser.RELAX):
        cfg = RenderConfig(width=res, height=res, rpp=1, bounce_num=2,
                           tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=d)
        hist = frame.History.create(cfg, "cpu")
        for _ in range(2):
            out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
        img = out["color"].numpy().reshape(res, res, 3)
        assert np.isfinite(img).all()
        psnr[d.name] = _psnr(img, target)
    assert int(hist.relax_diff.frames.max()) == 2
    assert psnr["NEURAL"] > psnr["RELAX"], psnr
