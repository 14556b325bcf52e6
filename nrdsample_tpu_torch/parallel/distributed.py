"""Process bring-up, the scene broadcast and the collectives' transport
(counterpart of ``nrdsample_tpu/parallel/distributed.py``).

One process per rank, as ``torchrun`` starts them or as ``run_ranks`` spawns
them::

    from nrdsample_tpu_torch.parallel import distributed, mesh
    distributed.init()                   # no-op (False) in a single process
    scene = distributed.broadcast_scene(scene)
    m = mesh.make_mesh()                 # the pixel mesh of the sharded frame

The backend follows what the ranks hold (``backend_for``): gloo for CPU
ranks; NCCL for one rank per card; gloo for several ranks on one card, since
NCCL refuses two ranks on one device. Every collective of the port goes
through ``collective``, which hands CUDA tensors to the backend as they
are: NCCL takes them, and so does gloo for all_gather, all_reduce and
broadcast (it copies through host memory itself), as ``python -m
nrdsample_tpu_torch.parallel.distributed --probe`` found on the H100 with
two ranks on the card. gloo's send/recv does not (it ends the process), so
the port uses none.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from nrdsample_tpu_torch.device import resolve

COLLECTIVES = ("all_gather", "all_reduce", "broadcast")

_rank_device: torch.device | None = None   # this process's rank device, set by ``init``


def backend_for(world_size: int, device) -> str:
    """gloo for CPU ranks and for several ranks on one card; NCCL where each
    rank has a card of its own (``device`` "cuda" without an index, and no
    more ranks than cards: ``rank_device``)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device=None) -> torch.device:
    """This rank's device: the CUDA card ``rank % device_count`` unless
    ``device`` names one (or the CPU)."""
    device = resolve(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def default_device(device=None) -> torch.device:
    """``device`` where the caller names one, else this rank's device as
    ``init`` set it up (the CPU only for ranks started on the CPU), else
    this rank's CUDA card (``rank_device``)."""
    if device is None and _rank_device is not None and dist.is_initialized():
        return _rank_device
    return rank_device(dist.get_rank() if dist.is_initialized() else 0, device)


def init(coordinator_address: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, backend: str | None = None, device=None,
         timeout_s: float = 600.0) -> bool:
    """Initialise ``torch.distributed`` when running multi-process; returns
    whether it is active. With ``coordinator_address`` ("host:port") the
    three arguments are explicit; without it the environment that
    ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) is read,
    and a single process (none of them set, or a world of 1) is a no-op
    that returns False. ``backend`` None picks ``backend_for`` this rank's
    ``device`` (the CUDA card when None); a CUDA rank's card becomes the
    current device. ``timeout_s`` bounds each collective."""
    if dist.is_initialized():
        return True
    env = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    if coordinator_address is None:
        if not all(os.environ.get(k) for k in env) or int(os.environ["WORLD_SIZE"]) <= 1:
            return False
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs num_processes and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    global _rank_device
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(world, resolve(device)),
                            init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _rank_device = dev
    return True


def collective(op: str, x: torch.Tensor, group=None, src: int = 0) -> torch.Tensor:
    """One collective over ``group`` (the default group when None), out of
    place: "all_gather" concatenates every rank's ``x`` (equal shapes) along
    dim 0 in rank order, "all_reduce" sums, "broadcast" returns rank
    ``src``'s ``x``. Booleans travel as uint8; a CUDA tensor goes to the
    backend as it is (the module docstring)."""
    if op not in COLLECTIVES:
        raise ValueError(f"unknown collective {op!r}; one of {COLLECTIVES}")
    dtype = x.dtype
    y = x.detach().to(torch.uint8) if dtype == torch.bool else x.detach().clone()
    y = y.contiguous()
    if op == "all_gather":
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        y = torch.cat(parts)
    elif op == "all_reduce":
        dist.all_reduce(y, group=group)
    else:
        dist.broadcast(y, src=src, group=group)
    return y.to(dtype)


def _to_device(obj, device):
    """A copy of ``obj`` with its tensors on ``device``: tensors, dicts,
    lists, tuples and objects with a ``to(device)`` method (Scene, Camera,
    Materials); everything else (numpy arrays, numbers) as it is."""
    if isinstance(obj, (torch.Tensor,)) or (hasattr(obj, "to") and not isinstance(obj, type)
                                           and not isinstance(obj, np.ndarray)):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


@dataclasses.dataclass
class GlobalMesh:
    """The (hosts, chips per host) layout of the ranks. ``device_mesh`` is
    the ``torch.distributed.device_mesh.DeviceMesh`` over ("host", "chip"),
    None in a single process."""

    hosts: int
    chips_per_host: int
    device_mesh: object = None

    @property
    def shape(self) -> tuple[int, int]:
        return self.hosts, self.chips_per_host


def global_mesh(axis_names: tuple = ("host", "chip")) -> GlobalMesh:
    """The (hosts, chips per host) mesh of the process group: the pixel and
    ray sharding rides the "chip" axis; the "host" axis should carry only
    reductions that are already small (the material gradients). Ranks are
    numbered host by host. A single process gives (1, 1) with no
    DeviceMesh."""
    if not dist.is_initialized():
        return GlobalMesh(1, 1)
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    hosts = len(dict.fromkeys(names))
    if world % hosts or names != [n for n in dict.fromkeys(names)
                                  for _ in range(world // hosts)]:
        raise RuntimeError(f"ranks are not numbered host by host with equal counts: {names}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (hosts, world // hosts), mesh_dim_names=axis_names)
    return GlobalMesh(hosts, world // hosts, mesh)


def broadcast_scene(scene, device=None):
    """Rank 0's scene on every rank (any Scene, dict or list of tensors and
    arrays): pickled on the host and broadcast through the backend; the
    receiving ranks put its tensors on ``device`` (``default_device``:
    this rank's device, the card unless the ranks were started on the
    CPU). In a single process the scene comes back unchanged."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return scene
    rank = dist.get_rank()
    device = default_device(device)
    obj = [_to_device(scene, "cpu") if rank == 0 else None]
    dist.broadcast_object_list(obj, src=0,
                               device=torch.device("cuda", torch.cuda.current_device())
                               if dist.get_backend() == "nccl" else None)
    return scene if rank == 0 else _to_device(obj[0], device)


# ---------------------------------------------------------------------------
# spawning ranks on one machine
# ---------------------------------------------------------------------------


class RankError(RuntimeError):
    """A spawned rank failed, died or ran out of time."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _rank_main(fn, rank: int, n: int, port: int, device, backend, args, results, threads,
               timeout_s):
    try:
        if threads:
            torch.set_num_threads(threads)
        init(f"127.0.0.1:{port}", n, rank, backend=backend, device=device, timeout_s=timeout_s)
        from nrdsample_tpu_torch.parallel import mesh

        out = fn(mesh.make_mesh(device=device), *args)
        results.put((rank, True, _numpy(out)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args: tuple = (), device=None, backend: str | None = None,
              timeout_s: float = 600.0, cpu_threads: int | None = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``n`` spawned processes that form one
    process group over 127.0.0.1 (a free port) and return their results in
    rank order (tensors as numpy arrays). ``fn`` must be importable (a
    module-level function); ``device`` is each rank's device
    (``rank_device``), ``backend`` None picks ``backend_for``. A rank that
    raises or dies, or a run longer than ``timeout_s``, ends every rank
    and raises RankError with the ranks' tracebacks. ``cpu_threads`` caps
    each rank's intra-op threads (None: torch's default)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, n, port, device, backend, args, results, cpu_threads,
                               timeout_s))
             for r in range(n)]
    for p in procs:
        p.start()
    done: dict[int, object] = {}
    errors: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) < n and not errors:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                errors[-1] = f"timed out after {timeout_s} s with ranks {sorted(done)} done"
                break
            try:
                rank, ok, value = results.get(timeout=min(remaining, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        errors[r] = f"rank {r} died with exit code {p.exitcode}"
                continue
            if ok:
                done[rank] = value
            else:
                errors[rank] = value
    finally:
        for p in procs:
            if p.is_alive() and (errors or len(done) < n):
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors:
        raise RankError("\n".join(f"[rank {r}] {e}" for r, e in sorted(errors.items())))
    return [done[r] for r in range(n)]


# ---------------------------------------------------------------------------
# which collectives gloo takes on CUDA tensors
# ---------------------------------------------------------------------------


def _probe_rank(mesh, ops: tuple):
    """Each of ``ops`` on a CUDA tensor handed to the backend as it is (no
    staging), its result checked: {op: "ok" | "wrong" | the error it
    raised}. A backend that cannot take the tensor may also end the process
    (gloo aborts on a device pointer it hands to its socket)."""
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((4,), float(rank + 1), device=dev)
    out = {}
    for op in ops:
        try:
            if op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x)
                got = torch.cat(parts)
                want = torch.arange(1, n + 1, device=dev).repeat_interleave(4)
            elif op == "all_reduce":
                got = x.clone()
                dist.all_reduce(got)
                want = torch.full_like(x, n * (n + 1) / 2)
            elif op == "broadcast":
                got = x.clone()
                dist.broadcast(got, src=0)
                want = torch.ones_like(x)
            else:   # send / recv around the ring
                got = torch.empty_like(x)
                reqs = [dist.isend(x, (rank + 1) % n), dist.irecv(got, (rank - 1) % n)]
                for r in reqs:
                    r.wait()
                want = torch.full_like(x, float((rank - 1) % n + 1))
            torch.cuda.synchronize()
            out[op] = "ok" if torch.equal(got.float(), want.float()) else "wrong"
        except Exception as e:  # noqa: BLE001 -- the probe reports each refusal
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def probe(n: int = 2, timeout_s: float = 120.0) -> dict:
    """On one card: which collectives gloo takes on CUDA tensors with ``n``
    ranks on the card, whether its send/recv does, and whether NCCL takes
    ``n`` ranks on one card; three spawns (send/recv in one of its own, as
    a refusal can end the ranks). Returns {"gloo": {op: result}, "nccl":
    {op: result}}; a spawn whose ranks died gives its ops "rank failed: ..."."""
    out: dict = {"gloo": {}, "nccl": {}}
    for backend, ops in (("gloo", COLLECTIVES), ("gloo", ("send_recv",)),
                         ("nccl", COLLECTIVES)):
        try:
            out[backend].update(run_ranks(_probe_rank, n, (ops,), device="cuda:0",
                                          backend=backend, timeout_s=timeout_s)[0])
        except RankError as e:
            lines = [ln.strip()[:160] for ln in str(e).splitlines() if ln.strip()]
            out[backend].update({op: "rank failed: " + " | ".join(lines[-2:]) for op in ops})
    return out


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="which collectives each backend takes on CUDA "
                                            "tensors with several ranks on one card")
    p.add_argument("--probe", action="store_true", required=True)
    p.add_argument("-n", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    print(json.dumps(probe(args.n)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
