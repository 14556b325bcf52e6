"""Whole frames of the record corpus's new branches, the port against a JAX
jit of the JAX package's frame: kitchen #3 (the PSR walk with 2 bounces,
RELAX), cornellbox #11 (HALF tracing), kitchen #7 (the L1 cache, two
frames, so that the second reads the first's history), cornellbox #49 (the
inf stress test with sanitization) and interior-night #8 (REBLUR with SHARC
and the history-confidence plane, at 64x40). Each record renders as the
replay test renders it (tests/test_records_replay.py: its scene at the
replay's reduced size, its own render block over 32x32, one path of one
bounce), over two frames with the history carried and reset at the first.

The tolerance is the frame tolerance of PERF.md §2: per plane at most 0.5%
of the pixels off by more than 1e-3 * (1 + |ref|), and the image means
within 1e-3 relative."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe, records as jrecords, replay
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame, records
from nrdsample_tpu_torch.scene import procedural
from torch_session_cache import (declare, jax_native_order_ready, session_cached,
                                 share_cores_between_workers)

share_cores_between_workers()

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
FRAMES = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANES = ["color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"]

#: (scene, record index, width, height), the costliest JAX compile first: a
#: worker that finds a record being computed computes the next free one
RECORDS = [("interior-night", 8, 64, 40), ("kitchen", 7, 32, 32), ("cornellbox", 49, 32, 32),
           ("cornellbox", 11, 32, 32), ("kitchen", 3, 32, 32)]
SCENE_ARGS = {"kitchen": {}, "cornellbox": {}, "interior-night": dict(n_lights=8, grid=2, sphere_res=10)}
BUILDERS = {"kitchen": "kitchen", "cornellbox": "cornell_box", "interior-night": "interior_night"}


def _ids(r):
    return f"{r[0]}-{r[1]}"


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


def _frames(scene_name, index, w, h, tmp_path_factory):
    """[(JAX planes, port planes)] per frame, and the record's render block."""
    path = os.path.join(REPO, "Tests", f"{scene_name}.json")
    builder, kw = BUILDERS[scene_name], SCENE_ARGS[scene_name]
    if scene_name == "interior-night":
        jax_native_order_ready(tmp_path_factory)
    jctx, jscene = jtraversal.build_context(getattr(jproc, builder)(**kw))
    ctx, scene = traversal.build_context(getattr(procedural, builder)(**kw), device="cpu")
    js, jc, render, _ = jrecords.load_record_full(path, index)
    settings, cam, render2, _ = records.load_record_full(path, index, device="cpu")
    assert render == render2
    jcfg = dataclasses.replace(replay.cfg_from_render(render, res=32), width=w, height=h)
    cfg = records.render_config(render, width=w, height=h)
    assert cfg.sharc_capacity == jcfg.sharc_capacity
    fn = jax.jit(lambda sc, c, st, hh, r: jframe.render_frame(jctx, sc, c, jcfg, st, hh,
                                                              reset_history=r))
    jh, hist = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    pairs = []
    for step in range(FRAMES):
        jout, jh = fn(jscene, jc, js, jh, jnp.bool_(step == 0))
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist,
                                       reset_history=torch.tensor(step == 0))
        pairs.append(({k: np.asarray(jout[k]) for k in PLANES},
                      {k: out[k] for k in PLANES}))
    extra = {"l1_valid": None if hist.l1 is None else int(hist.l1.valid)}
    return pairs, render, extra


def _cached(tmp_path_factory):
    """{session cache name: compute} of every record's frames."""
    return {f"torch_frame_record_{r[0]}_{r[1]}":
            (lambda r=r: _frames(*r, tmp_path_factory)) for r in RECORDS}


@pytest.fixture(scope="module", params=RECORDS, ids=_ids)
def record_frames(request, tmp_path_factory):
    scene_name, index, _, _ = request.param
    computes = _cached(tmp_path_factory)
    name = f"torch_frame_record_{scene_name}_{index}"
    return session_cached(tmp_path_factory, name, computes[name], others=computes)


for _r in RECORDS:
    declare(f"torch_frame_record_{_r[0]}_{_r[1]}", lambda tpf, r=_r: _frames(*r, tpf))


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_record_frame_matches_jax(record_frames, index, plane):
    want, got = record_frames[0][index]
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert bool(torch.isfinite(g).all())
    assert _outlier_frac(want[plane], g.numpy()) <= OUTLIER_FRAC


@pytest.mark.parametrize("index", range(FRAMES))
def test_record_frame_mean_matches_jax(record_frames, index):
    want, got = record_frames[0][index]
    for plane in ("color", "final"):
        w, g = float(want[plane].mean()), float(got[plane].mean())
        assert abs(g - w) <= MEAN_REL * abs(w) and g > 0.0


def test_record_pins_its_branch(record_frames):
    """Each record pins the branch it stands for, and the L1 record's
    history is valid after its frames."""
    _, render, extra = record_frames
    assert (render.get("psr_bounce_num", 0) == 2 or render.get("tracing_mode") == 2
            or render.get("use_l1_cache") or render.get("use_inf_stress_test")
            or render.get("use_confidence"))
    assert extra["l1_valid"] == (1 if render.get("use_l1_cache") else None)
