"""The whole record corpus (Tests/*.json, 344 records over six scenes)
replayed through the port on the CPU, as tests/test_records_replay.py
replays it through the JAX package (``records.replay_record``): each record
at the replay's scene sizes, under its own render block
(``records.render_config`` over 32x32, one path of one bounce), with the
history reset at its first frame; animated records advance the camera orbit
(``records.orbit_cam``) with the history carried across their frames. The
output must be finite with a positive maximum. The CHECK_ME records of
every scene replay bit-identically twice."""

import pytest
import torch

from nrdsample_tpu_torch.pipeline import records
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()


_CONTEXTS: dict = {}


def _replay(name, index):
    """records.replay_record on the CPU, each scene built once per process."""
    if name not in _CONTEXTS:
        _CONTEXTS[name] = records.build_replay_context(name, "cpu")
    return records.replay_record(*_CONTEXTS[name], name, index, "cpu")


def _record_ids():
    return [(name, i) for name in records.REPLAY_SCENES
            for i in range(records.count_records(records.record_path(name)))]


def test_corpus_is_the_replay_tests():
    ids = _record_ids()
    assert len(ids) == 344 and len({n for n, _ in ids}) == 6


@pytest.mark.parametrize("scene_name,index", _record_ids())
def test_record_renders(scene_name, index):
    out, hist, frames = _replay(scene_name, index)
    img = out["color"]
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0
    assert int(hist.frame_index) == frames


@pytest.mark.parametrize("scene_name,index",
                         [(n, i) for n, idx in records.CHECK_ME.items() for i in idx])
def test_check_me_deterministic(scene_name, index):
    a = _replay(scene_name, index)[0]
    b = _replay(scene_name, index)[0]
    for k in ("color", "final", "diff_radiance", "spec_radiance", "view_z"):
        assert torch.equal(a[k], b[k]), k
