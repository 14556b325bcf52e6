"""The port's ``render``, ``optimize`` and ``scenes`` commands on the CPU,
and what they need: ``optimize`` takes the JAX CLI's flags and defaults,
recovers the albedo at 16x16 and ends with the JAX command's JSON line and
exit code rule; ``render`` writes the PNG that ``utils.image.write_png`` makes of the
same ``render_frame`` output (the tonemapped final image, the post chain's
display image, a debug view); ``write_png``'s bytes and
``tonemap_for_display`` equal the JAX package's for the same array; the
scene list is the JAX CLI's, and the two scenes the port's CLI adds
(``glass_shell.add_inner_glass_surfaces`` over ``cornell_box_glass``, a
``random_soup``) equal the JAX builders' arrays."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nrdsample_tpu import cli as jcli
from nrdsample_tpu.scene import glass_shell as jglass, procedural as jproc
from nrdsample_tpu.utils import image as jimage
from nrdsample_tpu_torch import cli
from nrdsample_tpu_torch.config import Denoiser, OnScreen, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.scene import glass_shell, procedural
from nrdsample_tpu_torch.scene.types import TriangleSoA, look_at
from nrdsample_tpu_torch.utils import image
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

SIZE = 16
#: extra ``render`` arguments, and the RenderConfig fields and Settings they set
RENDERS = {
    "final": ([], {}, {}),
    "post": (["--denoiser", "relax", "--taa", "--upscale", "24", "--sr", "neural", "--nis",
              "--separator", "0.5", "--validation"],
             dict(denoiser=Denoiser.RELAX, use_taa=True, output_width=24, output_height=24,
                  use_nis=True, use_neural_sr=True, enable_post=True,
                  use_validation_overlay=True),
             dict(separator=0.5)),
    "debug_view": (["--on-screen", "normal"], dict(on_screen=OnScreen.NORMAL), {}),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_writes_the_frame(name, tmp_path, capsys):
    args, cfg_kw, settings_kw = RENDERS[name]
    path = tmp_path / "out.png"
    assert cli.main(["render", "--cpu", "--scene", "cornellbox", "--size", str(SIZE),
                     "--frames", "1", "--sun-elevation=-30", "--no-shadows",
                     "--out", str(path)] + args) == 0
    assert f"wrote {path}" in capsys.readouterr().out

    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, bounce_num=2,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, **cfg_kw)
    settings = make_settings("cpu", sun_azimuth=-147.0, sun_elevation=-30.0, disable_shadows=1,
                             exposure=35.0, **settings_kw)
    out, _ = frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, "cpu"))
    if name == "final":
        img = image.tonemap_for_display(out["final"].numpy().reshape(SIZE, SIZE, 3), 0.35)
    elif name == "post":
        img = (out["display"].numpy() * 255.0 + 0.5).astype(np.uint8)
        assert img.shape == (24, 24, 3)
    else:
        img = (np.clip(out["debug"].numpy().reshape(SIZE, SIZE, 3), 0.0, 1.0) * 255.0
               + 0.5).astype(np.uint8)
    want = tmp_path / "want.png"
    image.write_png(str(want), img)
    assert path.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("dtype", ["uint8", "float32", "grey"])
def test_write_png_bytes_equal_jax(dtype, tmp_path):
    rs = np.random.RandomState(0)
    img = rs.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    elif dtype == "grey":
        img = img[..., 0]
    image.write_png(str(tmp_path / "a.png"), img)
    jimage.write_png(str(tmp_path / "b.png"), img)
    a = (tmp_path / "a.png").read_bytes()
    assert a == (tmp_path / "b.png").read_bytes() and a[:8] == b"\x89PNG\r\n\x1a\n"


def test_tonemap_for_display_matches_jax():
    hdr = np.random.RandomState(1).uniform(0.0, 30.0, (16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(image.tonemap_for_display(hdr, 0.35),
                               np.asarray(jimage.tonemap_for_display(hdr, 0.35)),
                               rtol=1e-6, atol=1e-6)


def test_scenes_lists_the_jax_scenes(capsys):
    assert cli.main(["scenes"]) == 0
    names = capsys.readouterr().out.split()
    jcli._register_scenes()
    assert names == list(jcli.SCENES) == list(cli.DEFAULT_CAMERAS)
    assert cli.DEFAULT_CAMERAS == jcli.DEFAULT_CAMERAS


def _tri_arrays(tris):
    return {f.name: np.asarray(getattr(tris, f.name)) for f in dataclasses.fields(TriangleSoA)}


@pytest.mark.parametrize("name", ["cornellbox-glass", "soup"])
def test_cli_scenes_equal_jax(name):
    if name == "soup":
        want, got = jproc.random_soup(500, seed=3), procedural.random_soup(500, seed=3)
    else:
        want = jglass.add_inner_glass_surfaces(jproc.cornell_box_glass())
        got = glass_shell.add_inner_glass_surfaces(procedural.cornell_box_glass())
        assert got.num_tris > procedural.cornell_box_glass().num_tris
    w, g = _tri_arrays(want.tris), _tri_arrays(got.tris)
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    for f in dataclasses.fields(got.materials):
        assert np.array_equal(np.asarray(getattr(got.materials, f.name)),
                              np.asarray(getattr(want.materials, f.name))), f.name
    assert np.array_equal(got.emissive_tris.numpy(), np.asarray(want.emissive_tris))
    assert int(got.emissive_count) == int(want.emissive_count)


def test_glass_shell_leaves_opaque_scenes():
    scene = procedural.cornell_box()
    assert glass_shell.add_inner_glass_surfaces(scene) is scene


def test_render_without_a_card_names_cuda(monkeypatch, tmp_path):
    """Without --cpu the command runs on the card, and without one it fails
    naming CUDA rather than rendering on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["render", "--size", "8", "--frames", "1", "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


OPTIMIZE_KEYS = {"initial_albedo_error", "final_albedo_error", "final_loss", "recovered"}


def _parsed(main, module, monkeypatch, argv):
    """The argparse namespace ``main(argv)`` hands to ``cmd_optimize``."""
    seen = []
    monkeypatch.setattr(module, "cmd_optimize", lambda a: seen.append(vars(a)) or 0)
    assert main(argv) == 0
    return {k: v for k, v in seen[0].items() if k != "fn"}


@pytest.mark.parametrize("argv", [[], ["--scene", "kitchen", "--size", "24", "--iters", "5",
                                       "--lr", "1e-3", "--sun-elevation", "45", "--cpu"]])
def test_optimize_takes_the_jax_flags(monkeypatch, argv):
    want = _parsed(jcli.main, jcli, monkeypatch, ["optimize"] + argv)
    got = _parsed(cli.main, cli, monkeypatch, ["optimize"] + argv)
    assert got == want
    if not argv:
        assert got == {"cmd": "optimize", "scene": "cornellbox", "size": 48, "iters": 200,
                       "lr": 4e-4, "sun_elevation": -30.0, "cpu": False}


def _optimize(capsys, *argv):
    rc = cli.main(["optimize", "--cpu", *argv])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == OPTIMIZE_KEYS
    # the JAX command's rule: recovered, and exit 0, when the mean albedo
    # error fell below half of its start
    recovered = out["final_albedo_error"] < out["initial_albedo_error"] * 0.5
    assert out["recovered"] is recovered and rc == (0 if recovered else 1)
    return out


def test_optimize_recovers_the_albedo(capsys):
    # the default lr scaled to 16x16 (the loss sums over pixels)
    out = _optimize(capsys, "--size", "16", "--iters", "30", "--lr", str(4e-4 * 48 * 48 / 256))
    assert out["recovered"] and np.isfinite(out["final_loss"])
    assert 0.0 < out["final_albedo_error"] < out["initial_albedo_error"]


def test_optimize_without_steps_is_not_recovered(capsys):
    out = _optimize(capsys, "--size", "8", "--iters", "1", "--lr", "0")
    # float32 materials against the float64 perturbation
    assert not out["recovered"]
    assert out["final_albedo_error"] == pytest.approx(out["initial_albedo_error"], rel=1e-6)


def _parsed_animate(main, module, monkeypatch, argv):
    seen = []
    monkeypatch.setattr(module, "cmd_animate", lambda a: seen.append(vars(a)) or 0)
    assert main(["animate"] + argv) == 0
    return {k: v for k, v in seen[0].items() if k not in ("fn", "out")}


@pytest.mark.parametrize("argv", [[], ["--size", "64", "--frames", "3", "--cubes", "5",
                                       "--denoiser", "reblur", "--drs-target-ms", "8", "--cpu"]])
def test_animate_takes_the_jax_flags(monkeypatch, argv):
    """The JAX CLI's animate flags and defaults (its --out defaults to a
    path outside the checkout; the port's to animate.png)."""
    want = _parsed_animate(jcli.main, jcli, monkeypatch, argv)
    assert _parsed_animate(cli.main, cli, monkeypatch, argv) == want


@pytest.mark.parametrize("drs", [False, True], ids=["fixed", "drs"])
def test_animate_writes_the_last_frame(drs, tmp_path, capsys):
    """``animate --cpu --frames 2 --cubes 3`` writes the tonemapped last
    frame of ``pipeline/animate.render`` (the adaptive cap of the timer's
    start value in both frames: the timer takes its first time after frame
    1). With a DRS target no frame meets, the second frame renders at the
    next bucket (48 -> 40) and the PNG is the display image at 48x48."""
    from nrdsample_tpu_torch.pipeline import adaptive, animate, drs as drs_mod

    size = 48 if drs else 32
    path = tmp_path / "a.png"
    argv = ["animate", "--cpu", "--size", str(size), "--frames", "2", "--cubes", "3",
            "--out", str(path)] + (["--drs-target-ms", "0.001"] if drs else [])
    assert cli.main(argv) == 0
    out_text = capsys.readouterr()
    assert f"wrote {path}" in out_text.out
    assert ("frame 0: DRS -> 40x40" in out_text.err) == drs
    anim = animate.build(3, "cpu")
    cfg = animate.render_config(size)
    cfgs = [drs_mod.bucket_cfg(cfg, 1.0), drs_mod.bucket_cfg(cfg, 0.875)] if drs else [cfg, cfg]
    settings = adaptive.update(make_settings("cpu", sun_elevation=55.0), None,
                               adaptive.FrameTimer().smoothed_ms)
    hist = frame.History.create(cfgs[0], "cpu")
    for f in range(2):
        if f == 1 and drs:
            hist = drs_mod.resize_history(hist, cfgs[0], cfgs[1])
        out, hist = animate.render(anim, cfgs[f], settings, hist, *animate.frame_times(f))
    img = out["display"].numpy() if drs else out["final"].numpy().reshape(size, size, 3)
    assert img.shape == (size, size, 3) and np.isfinite(img).all()
    want = tmp_path / "want.png"
    image.write_png(str(want), image.tonemap_for_display(img, 0.6))
    assert path.read_bytes() == want.read_bytes()
