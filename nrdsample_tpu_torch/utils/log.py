"""Structured logging and counters (counterpart of
``nrdsample_tpu/utils/log.py``): the scene build, frame and device-memory
reports, one JSON object a line."""

from __future__ import annotations

import json
import sys
import time
from typing import Any

import torch


class JsonLogger:
    """One JSON object per line to a stream (stderr by default)."""

    def __init__(self, stream=None, component: str = "nrdsample_tpu_torch"):
        self.stream = stream or sys.stderr
        self.component = component

    def log(self, event: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "component": self.component, "event": event}
        rec.update(fields)
        self.stream.write(json.dumps(rec, default=str) + "\n")
        self.stream.flush()


LOG = JsonLogger()


def log_scene_stats(scene, ctx=None) -> None:
    """The scene build report: triangles, emitters, materials, and with a
    context its traversal mode and cluster count."""
    fields = {
        "tris": int(scene.tris.count),
        "emissive": int(scene.emissive_count),
        "materials": int(scene.materials.base_color.shape[0]),
    }
    if ctx is not None:
        fields["traversal_mode"] = ctx.mode
        if ctx.clusters is not None:
            fields["clusters"] = int(ctx.clusters.count)
    LOG.log("scene_built", **fields)


def log_frame_stats(frame_idx: int, dt_s: float, cfg, rays_per_pixel: int) -> None:
    """Per-frame counters: ms, fps, Mpixel/s, rays/s."""
    n = cfg.n_pixels
    LOG.log(
        "frame",
        frame=frame_idx,
        ms=dt_s * 1e3,
        fps=1.0 / max(dt_s, 1e-9),
        mpix_s=n / dt_s / 1e6,
        rays_s=n * rays_per_pixel / dt_s,
        rpp=cfg.rpp,
        bounces=cfg.bounce_num,
    )


def memory_report() -> dict:
    """Device memory of each CUDA card (``torch.cuda.memory_stats``): bytes
    in use, their peak (``max_memory_allocated``) and the card's size; {}
    without a card."""
    out = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            }
    LOG.log("memory", devices=out)
    return out
