"""The golden gate through the port (``pipeline/replay.py``), as
tests/test_golden.py runs it through the JAX package.

Each of the 19 record goldens in Tests/golden is replayed on the CPU by the
port's ``replay.render_record`` at the golden's resolution (64x64), all its
animation frames, and held to the golden with test_golden.py's bound: every
8x8 tile mean within 0.02 * max(std, 0.05) + 1e-4 of the golden's, and the
image mean too. interior-night #147 is a "blink" record: its camera stays
put (only orbit records orbit, as the JAX replay's ``render_record`` has
it); with an orbiting camera it misses its golden by a tile error of 0.435.
The replay module's helpers are held to the JAX package's."""

import numpy as np
import pytest
import torch

from nrdsample_tpu.pipeline import records as jrecords, replay as jreplay
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch.pipeline import frame, records, replay
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

_CONTEXTS: dict = {}


def _contexts(name):
    """replay.build_contexts on the CPU, each scene built once per process."""
    if name not in _CONTEXTS:
        _CONTEXTS.update(replay.build_contexts([name], "cpu"))
    return _CONTEXTS


def test_goldens_are_the_jax_gates():
    """The port gates the same 19 records as test_golden.py, every CHECK_ME
    record among them, at the same paths."""
    ids = replay.golden_ids()
    assert len(ids) == 19
    want = {(s, i) for s, idxs in jrecords.CHECK_ME.items() for i in idxs}
    assert want == {(s, i) for s, idxs in records.CHECK_ME.items() for i in idxs} <= set(ids)
    for s, i in ids:
        assert replay.golden_path(s, i) == jreplay.golden_path(s, i)


@pytest.mark.parametrize("scene_name,index", replay.golden_ids())
def test_golden_match(scene_name, index):
    data = np.load(replay.golden_path(scene_name, index))
    res = int(data["res"])
    out, hist = replay.render_record(_contexts(scene_name), scene_name, index, res, "cpu")
    assert out["color"].shape == (res * res, 3) and bool(torch.isfinite(out["color"]).all())
    stats = replay.golden_stats(out["color"], res)
    limit = replay.golden_limit(data)
    assert limit == 0.02 * max(float(data["std"]), 0.05) + 1e-4
    np.testing.assert_allclose(stats["tile_means"], data["tile_means"], atol=limit,
                               err_msg=f"golden mismatch for {scene_name}[{index}]")
    assert abs(stats["mean"] - float(data["mean"])) < limit
    ok, tile_err, mean_err, _ = replay.check_golden(_contexts(scene_name), scene_name, index,
                                                    "cpu")
    assert ok and tile_err <= limit and mean_err < limit


def test_blink_record_keeps_its_camera():
    """#147's animation is {"mode": "blink"}: its last frame is rendered from
    the record's own camera, where an orbit record's last frame turns."""
    settings, cam, render, anim = records.load_record_full(
        records.record_path("interior-night"), 147, "cpu")
    assert anim["mode"] == "blink" and anim["frames"] > 1
    ctx, scene = _contexts("interior-night")["interior-night"]
    out, _, frames = records.replay_record(ctx, scene, "interior-night", 147, "cpu",
                                           width=16, height=16)
    cfg = replay.cfg_from_render(render, res=16)
    still, _ = frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, "cpu"),
                                  reset_history=True)
    assert frames == anim["frames"]
    torch.testing.assert_close(out["view_z"], still["view_z"], rtol=0, atol=0)


def test_replay_helpers_match_jax():
    """cfg_from_render, orbit_cam and golden_stats give the JAX replay's
    values (orbit_cam's matrices within 1e-6)."""
    rs = np.random.RandomState(3)
    color = rs.rand(64 * 64, 3).astype(np.float32)
    got, want = replay.golden_stats(torch.from_numpy(color), 64), jreplay.golden_stats(color, 64)
    for k in ("tile_means", "mean", "std"):
        np.testing.assert_array_equal(got[k], want[k])
    for render in ({}, {"denoiser": 1, "use_sharc": True}, {"tracing_mode": 1, "rpp": 2}):
        a, b = replay.cfg_from_render(render, res=48), jreplay.cfg_from_render(render, res=48)
        for k in ("width", "height", "rpp", "bounce_num", "use_sharc", "sharc_capacity"):
            assert getattr(a, k) == getattr(b, k), k
        assert int(a.denoiser) == int(b.denoiser) and int(a.tracing_mode) == int(b.tracing_mode)
    kw = dict(eye=[0.5, -3.0, 1.2], target=[0.0, 0.0, 1.0], fov_y_deg=45.0)
    for step in (0, 1, 3):
        a = replay.orbit_cam(look_at(**kw, device="cpu"), step, 4)
        b = jreplay.orbit_cam(jlook_at(**kw), step, 4)
        for k in ("view_to_world", "view_to_world_prev", "tan_half_fov_y", "aspect"):
            np.testing.assert_allclose(getattr(a, k).numpy(), np.asarray(getattr(b, k)),
                                       rtol=0, atol=1e-6)
