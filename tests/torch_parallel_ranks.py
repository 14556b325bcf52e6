"""Rank functions of ``tests/test_torch_parallel.py``, which
``parallel.distributed.run_ranks`` spawns: a module that imports torch and
the port only, so that a spawned rank imports neither JAX nor a test
module."""

from __future__ import annotations

import numpy as np
import torch

from nrdsample_tpu_torch.parallel import distributed, dryrun, halo


def _blur3_rows(xp: torch.Tensor) -> torch.Tensor:
    """The 3-row box blur of an already padded block (radius 1)."""
    return (xp[:-2] + xp[1:-1] + xp[2:]) / 3.0


def blur3(x: torch.Tensor) -> torch.Tensor:
    """3-row vertical box blur with clamped edges (radius 1), as
    ``tests/test_halo.py``'s ``_blur3``."""
    up = torch.cat([x[:1], x[:-1]])
    dn = torch.cat([x[1:], x[-1:]])
    return (up + x + dn) / 3.0


def halo_rank(mesh, images: dict) -> dict:
    """This rank's rows of the three cases of ``tests/test_halo.py`` on its
    block of each image: the padded radius-1 blur, the radius-2 compound
    blur through ``stencil_with_halo``, and exchange then crop; with each
    case's exchanged block ("<case>.padded")."""
    out = {}
    for name, img in images.items():
        rows = img.shape[0] // mesh.size
        x = torch.from_numpy(img[mesh.rank * rows:(mesh.rank + 1) * rows])
        radius = 2 if name == "compound" else 1
        xp = halo.exchange_rows(x, radius, mesh)
        assert xp.shape[0] == x.shape[0] + 2 * radius
        out[f"{name}.padded"] = xp
        if name == "blur":
            out[name] = _blur3_rows(xp)
        elif name == "compound":
            out[name] = halo.stencil_with_halo(compound, 2, mesh)(x)
        else:
            out[name] = halo.crop_rows(xp, 1)
    return out


def compound(x: torch.Tensor) -> torch.Tensor:
    """``tests/test_halo.py``'s radius-2 compound stencil."""
    return blur3(blur3(x))


def distributed_rank(mesh) -> dict:
    """``tests/test_distributed.py``'s worker on the port: the process
    group is up, the (hosts, chips) mesh, rank 0's scene (a dict of
    tensors and arrays, and a Scene) on every rank, and a sum over the
    ranks. The scene broadcast without a device lands on the rank's own
    device, the pixel mesh's (the CPU: the ranks were started there)."""
    from nrdsample_tpu_torch.parallel import mesh as mesh_mod
    import torch.distributed as dist

    from nrdsample_tpu_torch.scene import procedural

    rank = mesh.rank
    gm = distributed.global_mesh()
    local = {"albedo": torch.full((4, 3), float(rank)), "ior": np.float32(1.5 + rank)}
    got = distributed.broadcast_scene(local)
    scene = procedural.cornell_box()
    scene.materials.base_color += rank
    got_scene = distributed.broadcast_scene(scene, device="cpu")
    n = mesh.size
    data = torch.arange(n * 8, dtype=torch.float32).reshape(n, 8)
    total = distributed.collective("all_reduce", data[rank].sum().reshape(1))
    return {"init_again": distributed.init(), "world": dist.get_world_size(),
            "backend": dist.get_backend(), "mesh": gm.shape,
            "device_mesh": tuple(gm.device_mesh.mesh.shape),
            "albedo": got["albedo"], "ior": float(got["ior"]),
            "base_color": got_scene.materials.base_color, "tris": got_scene.tris.p0,
            "total": float(total[0]),
            "devices": [str(d) for d in (got["albedo"].device, mesh.device,
                                         mesh_mod.make_mesh().device,
                                         distributed.default_device())]}


def frames_and_grads_rank(mesh, frame_specs: list, grad_spec: dict) -> dict:
    """Two sharded frames of each of ``frame_specs`` and the sharded
    gradients of ``grad_spec`` (``dryrun``'s rank functions)."""
    return {"frames": [dryrun.sharded_frames_rank(mesh, s, 2) for s in frame_specs],
            "grads": dryrun.sharded_grads_rank(mesh, grad_spec, step=False)}


def fail_on_rank_0(mesh):
    """Rank 0 raises; the others wait in a collective that rank 0 never
    joins, until ``run_ranks`` ends them."""
    if mesh.rank == 0:
        raise ZeroDivisionError("rank 0 fails")
    return distributed.collective("all_reduce", torch.ones(1))
