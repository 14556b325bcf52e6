"""The explicit row halo of a row-sharded image stencil (counterpart of
``nrdsample_tpu/parallel/halo.py``): each rank holds a block of rows
[h_local, W, ...], and a stencil of radius r needs r ghost rows from the
neighbouring ranks. ``exchange_rows`` fetches them, so stencil code written
against a local block is exact at the block edges.

Nothing on the port's main path uses it: the sharded frame runs its image
phase on the whole image (``mesh.py``), as the JAX frame lets GSPMD
partition its own. This is the explicit-halo API the JAX package offers.
The exchanged rows carry no gradient.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.parallel import distributed
from nrdsample_tpu_torch.parallel.mesh import PixelMesh


def exchange_rows(x: torch.Tensor, radius: int, mesh: PixelMesh) -> torch.Tensor:
    """[h_local + 2 * radius, W, ...]: ``x`` padded with ``radius`` rows of
    the rank above (rank - 1) and below (rank + 1); the outermost ranks
    repeat their own edge row, as the image edge clamps. One all_gather of
    every rank's first and last ``radius`` rows gives each rank its two
    neighbours' (every block needs at least ``radius`` rows)."""
    if radius == 0:
        return x
    if x.shape[0] < radius:
        raise ValueError(f"a block of {x.shape[0]} rows cannot lend a halo of {radius}")
    top = x[:1].expand((radius,) + x.shape[1:])
    bot = x[-1:].expand((radius,) + x.shape[1:])
    if mesh.size > 1:
        edges = distributed.collective("all_gather", torch.stack([x[:radius], x[-radius:]]),
                                       mesh.group)
        edges = edges.reshape((mesh.size, 2, radius) + x.shape[1:])
        if mesh.rank > 0:
            top = edges[mesh.rank - 1, 1]        # the last rows of the rank above
        if mesh.rank < mesh.size - 1:
            bot = edges[mesh.rank + 1, 0]        # the first rows of the rank below
    return torch.cat([top, x, bot])


def crop_rows(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Undo ``exchange_rows``'s padding after the stencil ran."""
    return x[radius:-radius] if radius else x


def stencil_with_halo(fn, radius: int, mesh: PixelMesh):
    """Wrap a stencil fn(local_rows) -> local_rows so it sees exact
    neighbour rows: pad, run, crop. ``fn`` must be shift-invariant and keep
    the row count."""

    def wrapped(x, *args, **kwargs):
        return crop_rows(fn(exchange_rows(x, radius, mesh), *args, **kwargs), radius)

    return wrapped
