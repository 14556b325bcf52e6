"""Record replay harness and the golden gate (counterpart of
``nrdsample_tpu/pipeline/replay.py``).

``render_record`` replays one record of ``Tests/<scene>.json`` end to end
through ``pipeline/records.py``'s loaders and ``records.replay_record``;
``golden_stats`` reduces its colour to the per-tile statistics that
``Tests/golden/<scene>-<index>.npz`` stores, and a golden matches where every
8x8 tile mean and the image mean are within 2% of the golden's dynamic scale
(``golden_limit``). To hold one record to its golden on a device::

    contexts = replay.build_contexts(["kitchen"], device)
    ok, tile_err, mean_err, limit = replay.check_golden(contexts, "kitchen", 2, device)
"""

from __future__ import annotations

import os

import numpy as np

from nrdsample_tpu_torch.config import RenderConfig
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.pipeline import records
from nrdsample_tpu_torch.scene.types import Camera

TESTS_DIR = records.TESTS_DIR
GOLDEN_DIR = os.path.join(TESTS_DIR, "golden")
SCENES = records.REPLAY_SCENES
GLASS_SCENES = records.GLASS_SCENES
TILE = 8


def build_contexts(scene_names=None, device=None) -> dict:
    """{scene name: (ctx, scene)} on ``device`` (the CUDA card when None),
    each scene built once and reused across its records."""
    device = resolve(device)
    return {name: records.build_replay_context(name, device) for name in scene_names or SCENES}


def cfg_from_render(render: dict, res: int = 32) -> RenderConfig:
    """A record's RenderConfig at ``res`` x ``res`` (``records.render_config``)."""
    return records.render_config(render, width=res, height=res)


def orbit_cam(cam: Camera, step: int, total: int) -> Camera:
    """Frame ``step`` of an orbiting record's camera (``records.orbit_cam``);
    ``total``, the record's frame count, is the JAX signature's and changes
    nothing."""
    del total
    return records.orbit_cam(cam, step)


def render_record(contexts: dict, scene_name: str, index: int, res: int = 32, device=None):
    """Replay record ``index`` of ``scene_name`` (all its animation frames) at
    ``res`` x ``res``. Returns (outputs of the last frame, history)."""
    ctx, scene = contexts[scene_name]
    out, hist, _ = records.replay_record(ctx, scene, scene_name, index, device,
                                         width=res, height=res)
    return out, hist


def golden_stats(color, res: int) -> dict:
    """Per-tile statistics of a flat (res*res, 3) colour image: the 8x8 tile
    means and the image's mean and standard deviation, in float32."""
    if not isinstance(color, np.ndarray):
        color = color.detach().cpu().numpy()
    img = np.asarray(color, np.float32).reshape(res, res, 3)
    nt = res // TILE
    tiles = img.reshape(nt, TILE, nt, TILE, 3).mean(axis=(1, 3))
    return {"tile_means": tiles.astype(np.float32), "mean": np.float32(img.mean()),
            "std": np.float32(img.std())}


def golden_path(scene_name: str, index: int) -> str:
    return os.path.join(GOLDEN_DIR, f"{scene_name}-{index:03d}.npz")


def golden_ids() -> list[tuple[str, int]]:
    """(scene, index) of every record golden in ``Tests/golden`` (other
    artefacts there, such as the held-out RR view, are left out)."""
    out = []
    for name in sorted(os.listdir(GOLDEN_DIR)):
        stem, ext = os.path.splitext(name)
        scene, _, idx = stem.rpartition("-")
        if ext == ".npz" and scene and idx.isdigit():
            out.append((scene, int(idx)))
    return out


def golden_limit(golden) -> float:
    """The gate's bound: 2% of the golden image's standard deviation (at least
    0.05), plus 1e-4."""
    return 0.02 * max(float(golden["std"]), 0.05) + 1e-4


def check_golden(contexts: dict, scene_name: str, index: int, device=None):
    """Replay one record at its golden's resolution and hold it to the golden.
    Returns (matches, largest tile-mean error, image-mean error, bound)."""
    golden = np.load(golden_path(scene_name, index))
    res = int(golden["res"])
    out, _ = render_record(contexts, scene_name, index, res, device)
    stats = golden_stats(out["color"], res)
    tile_err = float(np.abs(stats["tile_means"] - golden["tile_means"]).max())
    mean_err = abs(float(stats["mean"]) - float(golden["mean"]))
    limit = golden_limit(golden)
    return tile_err <= limit and mean_err < limit, tile_err, mean_err, limit
