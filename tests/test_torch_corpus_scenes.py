"""The scenes, the fifth bench configuration and the replay helpers that the
record corpus needs, against the JAX package: ``interior_night``,
``cornell_box_glass`` and ``mirror_room`` give arrays equal to the JAX
builders' (at their defaults and at the replay test's reduced arguments);
``bench_configs``'s interior1440 is bench.py's; ``records.CHECK_ME``,
``count_records``, ``render_config`` and ``orbit_cam`` are the JAX
package's and the replay test's."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

from nrdsample_tpu.pipeline import records as jrecords, replay
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu_torch.config import Denoiser, TracingMode
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import bench_configs, records
from nrdsample_tpu_torch.scene import procedural
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_FILES = ("cornellbox", "cornellbox-glass", "kitchen", "shaderballs", "interior-night",
               "exterior")


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


SCENE_CASES = {
    "interior_night": {},
    "interior_night-replay": dict(n_lights=8, grid=2, sphere_res=10),
    "cornell_box_glass": {},
    "cornell_box_glass-dim": dict(light_intensity=5.0),
    "mirror_room": {},
    "mirror_room-emissive_box": dict(box_emission=3.0),
}


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_corpus_scene_arrays_equal(case):
    name = case.split("-")[0]
    kw = SCENE_CASES[case]
    _assert_leaves_equal(_np_leaves(getattr(procedural, name)(**kw)),
                         _np_leaves(getattr(jproc, name)(**kw)))


@pytest.mark.parametrize("scene_name", SCENE_FILES)
def test_replay_scenes_are_the_jax_replays(scene_name):
    """The replay harness's scene of each record file is the JAX replay's
    (nrdsample_tpu/pipeline/replay.py), array for array, with the same
    split into contexts."""
    assert (scene_name in records.GLASS_SCENES) == (scene_name in replay.GLASS_SCENES)
    _assert_leaves_equal(_np_leaves(records.REPLAY_SCENES[scene_name]()),
                         _np_leaves(replay.SCENES[scene_name]()))


def test_interior_night_at_the_bench_size():
    """15,494 triangles (cluster mode) and 24 emitters (the dense probe);
    its glass spheres carry FLAG_TRANSPARENT and stay in build_context's one
    context."""
    scene = procedural.interior_night()
    assert scene.tris.count == 15_494 and int(scene.emissive_count) == 24
    flags = scene.materials.flags[scene.tris.material.long()]
    assert int(((flags & 0x02) != 0).sum()) > 0
    ctx, _ = traversal.build_context(scene, device="cpu")
    assert ctx.mode == "cluster" and ctx.clusters.count == 122


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench_ladder", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_interior1440_is_the_bench_config():
    """bench_configs's interior1440 is bench.py:97-103's: the same
    RenderConfig fields (enums by value), camera, settings and scene."""
    want = _bench_module()._make_configs()["interior1440"]
    spec = bench_configs.CONFIGS["interior1440"]
    assert spec["cam"] == want["cam"] and spec["settings"] == want["settings"]
    assert not spec.get("glass") and not want.get("glass")
    ctx, scene, cam, cfg, settings = bench_configs.setup("interior1440", "cpu",
                                                         scene_kw=dict(n_lights=4, grid=2,
                                                                       sphere_res=8))
    for f in dataclasses.fields(want["cfg"]):
        if f.name != "dtype":
            assert int(getattr(cfg, f.name)) == int(getattr(want["cfg"], f.name)), f.name
    assert (cfg.width, cfg.height, cfg.denoiser) == (2560, 1440, Denoiser.RELAX)
    assert cfg.use_sharc and cfg.use_confidence and cfg.use_taa
    assert float(settings.sun_elevation) == -20.0
    assert bench_configs.rays_per_pixel(cfg) == pytest.approx(4.0 + 9.0 / 25.0)


def test_check_me_and_counts_are_the_jax_packages():
    assert records.CHECK_ME == jrecords.CHECK_ME
    counts = {s: records.count_records(os.path.join(REPO, "Tests", f"{s}.json")) for s in SCENE_FILES}
    assert counts == {s: jrecords.count_records(os.path.join(REPO, "Tests", f"{s}.json"))
                      for s in SCENE_FILES}
    assert sum(counts.values()) == 344
    assert records.count_records(os.path.join(REPO, "Tests", "no-such-scene.json")) == 0


@pytest.mark.parametrize("scene_name", SCENE_FILES)
def test_render_config_is_the_replays(scene_name):
    """Every record's RenderConfig equals the replay test's (field by field,
    enums by value), at 32x32 and at a base that replaces the size."""
    import json

    with open(os.path.join(REPO, "Tests", f"{scene_name}.json")) as f:
        blocks = [d.get("render", {}) for d in json.load(f)]
    for render in blocks:
        for size in (32, 48):
            want = replay.cfg_from_render(render, res=size)
            got = records.render_config(render, width=size, height=size)
            for fld in dataclasses.fields(want):
                if fld.name != "dtype":
                    assert int(getattr(got, fld.name)) == int(getattr(want, fld.name)), fld.name
    cfg = records.render_config({"use_sharc": True}, sharc_capacity=1 << 16)
    assert cfg.sharc_capacity == 1 << 16 and cfg.tracing_mode == TracingMode.FULL_PROBABILISTIC


@pytest.mark.parametrize("scene_name,index", [("cornellbox", 13), ("interior-night", 147),
                                              ("kitchen", 9), ("exterior", 41)])
def test_orbit_cam_is_the_replays(scene_name, index):
    path = os.path.join(REPO, "Tests", f"{scene_name}.json")
    _, jcam, _, anim = jrecords.load_record_full(path, index)
    _, cam, _, anim2 = records.load_record_full(path, index, device="cpu")
    assert anim is not None and anim == anim2
    for step in range(anim["frames"]):
        want = _np_leaves(replay.orbit_cam(jcam, step, anim["frames"]))
        got = _np_leaves(records.orbit_cam(cam, step))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
