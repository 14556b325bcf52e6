"""SHARC — the spatial hash radiance cache (counterpart of
``nrdsample_tpu/ops/sharc.py``).

A hash grid over (quantized world position, LOD level, normal orientation)
with a per-frame accumulation buffer and a resolved buffer. Insertion is
gather (the stored key) -> claim -> scatter, accumulation a scatter-add, the
resolve a flat map over all entries.

Keys are uint32 checksums in the JAX package. torch's CPU uint32 lacks ``+``
and ``>>``, so they travel as int64 holding values below 2^32, masked after
every multiply, add and shift, as ``mathlib/rng.py`` does. The scatters that
write keys and last-seen frames pick their winner explicitly: where several
samples aim at one slot, the one of the largest flat index wins, which is
what XLA's serial scatter gives and is deterministic on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.mathlib import geometry as geo

_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class SharcState:
    """The cache's buffers."""

    keys: torch.Tensor        # (C,) int64 uint32 checksum; 0 = empty
    accum: torch.Tensor       # (C, 4) f32: sum(rgb), sample count (this frame)
    resolved: torch.Tensor    # (C, 4) f32: resolved rgb, accumulated count
    last_seen: torch.Tensor   # (C,) int32 frame index of the last touch

    @staticmethod
    def create(capacity: int = cfgmod.SHARC_CAPACITY, dtype=torch.float32,
               device=None) -> "SharcState":
        return SharcState(
            keys=torch.zeros((capacity,), dtype=torch.int64, device=device),
            accum=torch.zeros((capacity, 4), dtype=dtype, device=device),
            resolved=torch.zeros((capacity, 4), dtype=dtype, device=device),
            last_seen=torch.zeros((capacity,), dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def grid_level(pos, cam_pos, scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """Logarithmic LOD from the camera distance; ``dither`` (uniform in
    [0, 1) per sample) replaces the fixed 0.5 rounding offset."""
    d = geo.length(pos - cam_pos, eps=0.0)
    r = 0.5 if dither is None else dither
    lvl = torch.floor(torch.log2(geo.clip_min(d, 1e-3)) + r)
    return geo.clip(lvl, -4.0, 10.0)


def voxel_size(level, scene_scale: float = cfgmod.SHARC_SCENE_SCALE):
    """World-space voxel edge at a level."""
    return torch.exp2(level) * (4.0 / scene_scale)


def _mul(a, k: int):
    return (a * k) & _MASK


def _hash_u32x4(a, b, c, d):
    """xxhash-style avalanche over 4 int32 words -> uint32 (as int64)."""
    a, b, c, d = (x.to(torch.int64) & _MASK for x in (a, b, c, d))
    h = _mul(a, 0x9E3779B1)
    h = _mul(h ^ (h >> 15), 0x85EBCA77)
    h = (h + _mul(b, 0xC2B2AE3D)) & _MASK
    h = _mul(h ^ (h >> 13), 0x27D4EB2F)
    h = (h + _mul(c, 0x165667B1)) & _MASK
    h = _mul(h ^ (h >> 16), 0x9E3779B1)
    h = (h + d) & _MASK
    h = _mul(h ^ (h >> 15), 0x85EBCA77)
    return h ^ (h >> 13)


def cell_key(pos, normal, cam_pos, scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """Quantize (pos, normal) -> hash words (x, y, z, w) and the level; the
    normal contributes its dominant axis and sign (6 orientations)."""
    lvl = grid_level(pos, cam_pos, scene_scale, dither=dither)
    vs = voxel_size(lvl, scene_scale)
    q = torch.floor(pos / vs[..., None]).to(torch.int32)
    ax = torch.argmax(geo.absolute(normal), dim=-1)
    sgn = torch.gather(normal, -1, ax[..., None])[..., 0] < 0
    orient = ax.to(torch.int32) * 2 + sgn.to(torch.int32)
    w = orient + (lvl.to(torch.int32) + 8) * 8
    return q[..., 0], q[..., 1], q[..., 2], w, lvl


def slot_and_checksum(pos, normal, cam_pos, capacity: int,
                      scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """(slot int64, checksum int64 in [1, 2^32), level) per element."""
    x, y, z, w, lvl = cell_key(pos, normal, cam_pos, scene_scale, dither=dither)
    h1 = _hash_u32x4(x, y, z, w)
    h2 = _hash_u32x4(w, z, y, x)
    return h1 % capacity, torch.clamp_min(h2, 1), lvl


def query(state: SharcState, pos, normal, cam_pos,
          scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None):
    """SharcGetCachedRadiance: (radiance [..., 3], found [...])."""
    slot, checksum, _ = slot_and_checksum(pos, normal, cam_pos, state.capacity, scene_scale,
                                          dither=dither)
    key = state.keys[slot]
    res = state.resolved[slot]
    count = res[..., 3]
    found = (key == checksum) & (count > 0.0)
    radiance = res[..., :3] / geo.clip_min(count, 1.0)[..., None]
    return torch.where(found[..., None], radiance, 0.0), found


def _last_writer(slot: torch.Tensor, capacity: int):
    """(slots written, index of the sample that writes each): the largest
    flat index aimed at a slot wins, as in XLA's serial scatter."""
    idx = torch.arange(slot.shape[0], device=slot.device)
    last = torch.full((capacity,), -1, dtype=torch.int64, device=slot.device)
    last.scatter_reduce_(0, slot, idx, reduce="amax", include_self=True)
    written = torch.nonzero(last >= 0).flatten()
    return written, last[written]


def update(state: SharcState, pos, normal, radiance, cam_pos, frame, mask=None,
           scene_scale: float = cfgmod.SHARC_SCENE_SCALE, dither=None) -> SharcState:
    """SharcUpdateHit: claim empty slots, then scatter-add the samples whose
    checksum owns their slot. Every sample writes its slot's key and
    last-seen frame (the current value where it does not claim or own), and
    the last sample aimed at a slot decides it."""
    slot, checksum, _ = slot_and_checksum(pos, normal, cam_pos, state.capacity, scene_scale,
                                          dither=dither)
    slot_f = slot.reshape(-1)
    csum_f = checksum.reshape(-1)
    rad_f = radiance.reshape(-1, 3)
    mask_f = (torch.ones(slot_f.shape, dtype=torch.bool, device=slot_f.device) if mask is None
              else mask.reshape(-1))
    written, writer = _last_writer(slot_f, state.capacity)

    cur = state.keys[slot_f]
    claim = mask_f & (cur == 0)
    keys = state.keys.clone()
    keys[written] = torch.where(claim, csum_f, cur)[writer]

    owned = mask_f & (keys[slot_f] == csum_f)
    add = torch.cat([rad_f, torch.ones_like(rad_f[..., :1])], dim=-1)
    add = torch.where(owned[..., None], add, 0.0)
    # the CPU's index_add adds each slot's samples one after another in their
    # order, as XLA's serial scatter does; on the card index_add's float
    # atomics add in any order, so a frame's bits change from run to run, and
    # index_put's accumulation (a sort by slot, then a sum per slot) gives the
    # same bits on every run
    if add.is_cuda:
        accum = state.accum.index_put((slot_f,), add, accumulate=True)
    else:
        accum = state.accum.index_add(0, slot_f, add)
    frame_i = torch.as_tensor(frame, device=slot_f.device).to(torch.int32)
    seen = torch.where(owned, frame_i, state.last_seen[slot_f])
    last_seen = state.last_seen.clone()
    last_seen[written] = seen[writer]
    return dataclasses.replace(state, keys=keys, accum=accum, last_seen=last_seen)


def resolve(state: SharcState, frame,
            responsive_frames: int = cfgmod.SHARC_RESPONSIVE_FRAME_NUM,
            stale_frames: int = cfgmod.SHARC_STALE_FRAME_NUM_MIN * 4) -> SharcState:
    """SharcResolveEntry for every entry: fold this frame's accumulation into
    the resolved estimate with a history-capped running mean, and evict
    entries unseen for ``stale_frames``."""
    acc, res = state.accum, state.resolved
    n_new, n_old = acc[..., 3], res[..., 3]
    n_sum = n_old + n_new
    n_total = geo.clip_max(n_sum, float(responsive_frames * 4))
    scale = torch.where(n_sum > 0.0, n_total / geo.clip_min(n_sum, 1.0), 0.0)
    resolved = torch.cat([(res[..., :3] + acc[..., :3]) * scale[..., None], n_total[..., None]],
                         dim=-1)
    frame_i = torch.as_tensor(frame, device=acc.device).to(torch.int32)
    stale = (frame_i - state.last_seen) > stale_frames
    return SharcState(
        keys=torch.where(stale, 0, state.keys),
        accum=torch.zeros_like(acc),
        resolved=torch.where(stale[..., None], 0.0, resolved),
        last_seen=state.last_seen,
    )
