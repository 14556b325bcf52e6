"""Adaptive accumulation and the history-reset policy (counterpart of
``nrdsample_tpu/pipeline/adaptive.py``; NRDSample.cpp:2139-2189).

Once per frame, on the host: the accumulation-frame cap follows the smoothed
frame time, so that the history spans ACCUMULATION_TIME seconds rather than a
fixed number of frames, and an abrupt change of emission intensity
soft-resets the history at a rate independent of the frame rate. The cap
lands in ``Settings.max_accumulated_frame_num`` (an int32 tensor on the
settings' device), which ``pipeline.frame._max_acc`` reads.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from nrdsample_tpu_torch.config import Settings

# NRDSample.cpp:27: the history's length in seconds
ACCUMULATION_TIME = 0.5
# NRDSample.cpp:38: min(60, the REBLUR / RELAX history limit)
MAX_HISTORY_FRAME_NUM = 60
# NRDSample.cpp:2164: the frame rate the cap uses is clamped, so that very
# fast frames do not grow the history without bound
_MAX_FPS = 121.0
# the weight of a new frame time in FrameTimer's EMA
_TIMER_ALPHA = 0.03


@dataclasses.dataclass
class FrameTimer:
    """An exponentially smoothed frame time (Timer.GetVerySmoothedFrameTime;
    the reference smooths over ~32 frames)."""

    smoothed_ms: float = 16.7

    def update(self, frame_ms: float) -> float:
        self.smoothed_ms += (frame_ms - self.smoothed_ms) * _TIMER_ALPHA
        return self.smoothed_ms


def max_accumulated_frames(smoothed_frame_ms: float) -> int:
    """ACCUMULATION_TIME x fps frames, the fps capped (NRDSample.cpp:2161-2169)."""
    fps = min(1000.0 / max(smoothed_frame_ms, 1e-3), _MAX_FPS)
    frames = max(int(round(ACCUMULATION_TIME * fps)), 1)
    return min(frames, MAX_HISTORY_FRAME_NUM)


def emission_reset_factor(emission_now: float, emission_prev: float,
                          smoothed_frame_ms: float) -> float:
    """The soft history-reset factor in (0, 1] of an emission change
    (NRDSample.cpp:2150-2158): its log2 delta, scaled by the frame time so
    that the decay is the same in wall-clock time."""
    a = math.log2(1.0 + emission_now)
    b = math.log2(1.0 + emission_prev)
    d = abs(a - b) * 1000.0 / max(smoothed_frame_ms, 1e-3)
    return 1.0 / (1.0 + 0.2 * d)


def update(settings: Settings, settings_prev: Settings | None,
           smoothed_frame_ms: float) -> Settings:
    """One PrepareFrame step: ``settings`` with max_accumulated_frame_num =
    the adaptive cap x the emission reset factor (NRDSample.cpp:2139-2189).
    Hard resets (a denoiser change, frame 0) stay the caller's, through the
    frame's reset_history."""
    cap = max_accumulated_frames(smoothed_frame_ms)
    factor = 1.0
    if settings_prev is not None:
        factor = emission_reset_factor(float(settings.emission_intensity),
                                       float(settings_prev.emission_intensity),
                                       smoothed_frame_ms)
    frames = max(int(cap * factor + 0.5), 1)
    return dataclasses.replace(settings, max_accumulated_frame_num=torch.tensor(
        frames, dtype=torch.int32, device=settings.max_accumulated_frame_num.device))
