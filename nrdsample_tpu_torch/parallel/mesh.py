"""The pixel mesh and the two-phase sharded frame (counterpart of
``nrdsample_tpu/parallel/mesh.py``).

The image-space analogue of data parallelism: each rank traces a contiguous
block of the flat pixel indices, the scene is replicated, and the material
gradients are summed over the ranks. The JAX module's three
``jax.sharding`` specs have no PyTorch object of their own:

- ``pixel_sharding`` (``P("px")``, a leading pixel dim split over the mesh)
  is the block layout of ``shard_pixels`` / ``block_bounds``: rank r holds
  the flat indices [r * n_loc, (r + 1) * n_loc) cut at the image's end,
  n_loc = ceil(n / ranks), in rank order;
- ``replicated`` (``P()``) is replication by construction: every rank
  builds the same scene, camera, settings and History, and after phase 1
  the gathered planes and the phase-2 outputs are the same on every rank;
- ``pixel_specs_for`` (per History leaf) has nothing left to decide: the
  History is whole on every rank.

**A deliberate deviation from the JAX frame.** JAX keeps the image phase
(the denoisers, composition, TAA) on row-sharded arrays and lets GSPMD
insert the halo collectives. The port gathers the per-pixel G-buffer
planes after the trace and runs ``image_frame`` on the whole image in every
rank: the image phase is replicated. It is a small share of a frame
(kitchen1080: ~11.5 of ~140 busy ms on the H100), the trace is the costly
part and shards, and a replicated image phase equals the single-rank frame
exactly. A row-sharded image phase over ``halo.py`` is a later lever.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from nrdsample_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class PixelMesh:
    """The 1-D pixel mesh: ``size`` ranks over ``group`` (the default
    process group when None), this process's ``rank`` and ``device``."""

    size: int
    rank: int
    device: torch.device
    group: object = None


def make_mesh(n: int | None = None, device=None) -> PixelMesh:
    """The pixel mesh over the process group (one rank in a single
    process). ``n``, when given, must be the group's size; ``device`` is
    this rank's (``distributed.default_device``: the device ``init`` gave
    the rank, the CUDA card when None)."""
    size, rank = (dist.get_world_size(), dist.get_rank()) if dist.is_initialized() else (1, 0)
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} ranks over a process group of {size}")
    return PixelMesh(size, rank, distributed.default_device(device))


def block_bounds(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of rank ``rank``'s contiguous block of ``n`` items split
    over ``size`` ranks: ceil(n / size) each, the last blocks shorter."""
    n_loc = -(-n // size)
    lo = min(rank * n_loc, n)
    return lo, min(lo + n_loc, n)


def shard_pixels(mesh: PixelMesh, n_pixels: int) -> torch.Tensor:
    """This rank's block of flat pixel indices, (hi - lo,) int32."""
    lo, hi = block_bounds(n_pixels, mesh.size, mesh.rank)
    if hi <= lo:
        raise ValueError(f"{n_pixels} pixels over {mesh.size} ranks leave rank {mesh.rank} none")
    return torch.arange(lo, hi, dtype=torch.int32, device=mesh.device)


class _Gather(torch.autograd.Function):
    """All ranks' blocks of ``n`` items along ``dim``, concatenated in rank
    order. Backward: this rank's block of the incoming gradient, summed
    over the ranks first when ``sum_backward``."""

    @staticmethod
    def forward(ctx, x, mesh: PixelMesh, n: int, dim: int, sum_backward: bool):
        lo, hi = block_bounds(n, mesh.size, mesh.rank)
        if x.shape[dim] != hi - lo:
            raise ValueError(f"rank {mesh.rank}'s block has {x.shape[dim]} items along dim "
                             f"{dim}, its share of {n} is {hi - lo}")
        ctx.mesh, ctx.dim, ctx.block, ctx.sum_backward = mesh, dim, (lo, hi), sum_backward
        xm = x.movedim(dim, 0)
        pad = -(-n // mesh.size) - xm.shape[0]
        if pad:
            xm = torch.cat([xm, xm.new_zeros((pad,) + xm.shape[1:])])
        return distributed.collective("all_gather", xm, mesh.group)[:n].movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0)
        if ctx.sum_backward:
            g = distributed.collective("all_reduce", g.contiguous(), ctx.mesh.group)
        lo, hi = ctx.block
        return g[lo:hi].movedim(0, ctx.dim), None, None, None, None


def gather_rows(x: torch.Tensor, mesh: PixelMesh, n: int, dim: int = 0) -> torch.Tensor:
    """The whole of a per-pixel plane from each rank's block along ``dim``.
    Its backward hands each rank its own rows of the gradient, unsummed:
    after this gather every rank runs the same image phase and the same
    loss, so each holds the one gradient already (the reduce-scatter of
    ``torch.distributed.nn.functional.all_gather`` would count it ``size``
    times)."""
    return x if mesh.size == 1 else _Gather.apply(x, mesh, n, dim, False)


def gather_probes(x: torch.Tensor, mesh: PixelMesh, n: int, dim: int = 0) -> torch.Tensor:
    """The whole SHARC probe grid from each rank's block of probe ids along
    ``dim``. Its backward sums the gradient over the ranks before taking
    this rank's block: every rank's pixels read the whole cache, so each
    rank holds only its pixels' part of the gradient."""
    return x if mesh.size == 1 else _Gather.apply(x, mesh, n, dim, True)


def gather_planes(planes: dict, mesh: PixelMesh, n: int) -> dict:
    """``gather_rows`` of every per-pixel plane of ``planes`` (each with a
    leading dim of this rank's block), packed into one tensor per dtype so
    that each dtype takes one collective."""
    if mesh.size == 1:
        return dict(planes)
    out = {}
    by_dtype: dict = {}
    for k, v in planes.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = [planes[k].reshape(planes[k].shape[0], -1) for k in keys]
        whole = gather_rows(torch.cat(flat, dim=1), mesh, n)
        for k, part in zip(keys, torch.split(whole, [f.shape[1] for f in flat], dim=1)):
            out[k] = part.reshape((n,) + planes[k].shape[1:])
    return out


def sharded_render_fn(ctx, cfg, mesh: PixelMesh):
    """The two-phase sharded frame.

      phase 1  ``trace_frame`` on this rank's block of pixels, with the
               SHARC probe traces split over the ranks the same way;
      phase 2  the per-pixel G-buffer planes are gathered in rank order and
               every rank runs ``image_frame`` on the whole image, keeping
               the whole History (the module docstring says why).

    Returns fn(scene, cam, settings, history, pixel_idx=None,
    reset_history=False) -> (outputs, history'), equal to
    ``render_frame``'s on every rank; ``pixel_idx`` None is
    ``shard_pixels(mesh, cfg.n_pixels)``. Under autograd the gradient of a
    loss over the whole image, computed alike on every rank, reaches each
    rank's own trace; summing the material gradients over the ranks gives
    the single-rank gradient (``train.make_sharded_train_step``)."""
    from nrdsample_tpu_torch.pipeline import frame as frame_mod

    def frame_fn(scene, cam, settings, history, pixel_idx=None, reset_history=False):
        if pixel_idx is None:
            pixel_idx = shard_pixels(mesh, cfg.n_pixels)
        cam, settings = frame_mod.frame_inputs(cam, settings, history)
        with torch.profiler.record_function("trace_frame"):
            gb, aux = frame_mod.trace_frame(ctx, scene, cam, cfg, settings, history,
                                            pixel_idx=pixel_idx, probe_mesh=mesh)
        n_local = pixel_idx.shape[0]
        with torch.profiler.record_function("gather"):
            for k, v in gb.items():
                if not (isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n_local):
                    raise ValueError(f"G-buffer entry {k!r} is not a per-pixel plane of the "
                                     f"block's {n_local} pixels")
            gb = gather_planes(gb, mesh, cfg.n_pixels)
        with torch.profiler.record_function("image_frame"):
            return frame_mod.image_frame(cfg, settings, cam, history, gb, aux, reset_history)

    return frame_fn
