"""Process groups, the cross-host mesh and local rank launch
(``hl_hgat_tpu/parallel/distributed.py``).

Every rank runs the same program.  ``init_distributed`` wires
``torch.distributed`` from torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or
from its arguments, and does nothing in a single-process run.  The backend
follows one rule, printed by rank 0 when the group starts:

* **NCCL** when every rank on a host has a card of its own;
* **gloo** when ranks share a card (NCCL refuses two ranks on one device)
  or run on the CPU.  gloo reduces and broadcasts CUDA tensors, but its
  point-to-point sends and ``all_gather`` take CPU tensors, so the graph
  path stages those blocks through host memory (``graph_parallel.py``).

``make_multihost_mesh`` keeps the graph axis inside one host, so halo
exchange stays on the host's links while data parallelism spans hosts.
``spawn_ranks`` starts N local ranks (one process each) for the CLI's
``--dp N`` and for tests, joins them with a timeout and returns what each
rank's function returned.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

_DEVICE: torch.device | None = None


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def choose_backend(device_type: str, local_world_size: int) -> tuple[str, str]:
    """(backend, reason) by the module's rule."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= local_world_size:
        return "nccl", f"{local_world_size} local rank(s), a card each of {cards}"
    return "gloo", (f"{local_world_size} local ranks share {cards} card(s); NCCL refuses "
                    "two ranks on one device")


def local_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device: its own card where there are enough, else the
    card it shares (local rank modulo the cards), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))


def rank_device() -> torch.device | None:
    """The device ``init_distributed`` chose for this rank (None before)."""
    return _DEVICE


def init_distributed(
    rank: int | None = None,
    world_size: int | None = None,
    *,
    local_rank: int | None = None,
    local_world_size: int | None = None,
    init_method: str | None = None,
    device_type: str = "cuda",
) -> bool:
    """Start this rank's default process group; True when one is running.

    Arguments win over torchrun's variables.  Without ``world_size`` and
    without ``WORLD_SIZE`` in the environment this is a single-process run
    and nothing happens (False)."""
    global _DEVICE
    env = os.environ
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" not in env:
        return False
    world = int(world_size if world_size is not None else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local_rank = int(local_rank if local_rank is not None else env.get("LOCAL_RANK", rank))
    local_world = int(local_world_size if local_world_size is not None
                      else env.get("LOCAL_WORLD_SIZE", world))
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env.get('MASTER_PORT', '29500')}")
    backend, reason = choose_backend(device_type, local_world)
    _DEVICE = local_device(device_type, local_rank)
    if _DEVICE.type == "cuda":
        torch.cuda.set_device(_DEVICE)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    if rank == 0:
        print(f"[dist] world {world}: backend {backend} ({reason}); rank 0 on {_DEVICE}",
              flush=True)
    return True


def make_multihost_mesh(graph: int = 1, *, device_type: str = "cuda"):
    """('data', 'graph') mesh over every rank, the graph axis inside one
    host: it must divide the host's local rank count."""
    from hl_hgat_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if graph > local or local % graph != 0:
        raise ValueError(f"graph axis {graph} must divide the local rank count {local} "
                         "to stay inside one host")
    return make_mesh(world // graph, graph, device_type=device_type)


def process_local_batch_slice(global_batch_size: int) -> tuple[int, int]:
    """(start, size) of this rank's share of a global batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch_size // n
    return i * per, per


def _rank_main(rank, fn, world, init_method, device_type, out_dir, args):
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(rank, world, local_rank=rank, local_world_size=world,
                     init_method=init_method, device_type=device_type)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn: Callable[..., Any], world: int, *args, device_type: str = "cuda",
                timeout: float | None = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each with
    the default process group up (``tcp://localhost`` on a free port), and
    return their results in rank order.  ``fn`` and ``args`` must pickle
    (``fn`` a module-level function).  A rank that raises, dies or outlives
    ``timeout`` seconds (None: no limit) stops every rank and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, f"tcp://localhost:{free_port()}", device_type, out_dir, args))
        deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
