"""The multi-process entry (port of qtpu/sharding/multihost.py).

`initialize_multihost` wires the processes of a run into one
torch.distributed world, from explicit arguments or from torchrun's
environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), after which the meshes of qtpu_torch.sharding.mesh span it.
One process is a no-op. The backend is chosen from what the ranks have,
printed, and never switched after a failure: NCCL when every rank of this
host has a card of its own, gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one card); under NCCL each rank takes the card
of its local rank.

`spawn` starts a world of local processes (torch.multiprocessing, forked
from a server process that has imported torch) that meet through a file,
for a test or a one-host run:
    spawn(fn, 2, args, init_file="/tmp/x/init")  # fn(rank, world, *args)
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def choose_backend(local_world: int, device: str | None = None) -> str:
    """'nccl' when the ranks run on cards and each has one of its own,
    else 'gloo'."""
    on_card = (device or ("cuda" if torch.cuda.is_available() else "cpu")).startswith("cuda")
    if on_card and torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         local_world: int | None = None, device: str | None = None,
                         timeout_s: float | None = None) -> dict:
    """Initialize torch.distributed for a multi-process run.

    coordinator_address: "host:port" (a TCP rendezvous) or an init URL
    ("file:///path", "tcp://host:port"); num_processes / process_id: the
    world size and this rank. With no arguments torchrun's environment is
    read; without either (and no address), one process and nothing to do. local_world: the
    ranks on this host (default LOCAL_WORLD_SIZE, else num_processes);
    device: "cuda" or "cpu", where the ranks run (default: the card when
    there is one); timeout_s: how long a collective may wait (torch's
    default otherwise). Returns qtpu's summary dict."""
    env = os.environ
    if not dist.is_initialized():
        world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
        if world > 1 or coordinator_address is not None:  # qtpu's rule: an address inits
            rank = process_id if process_id is not None else int(env.get("RANK", 0))
            if coordinator_address is None:
                init = "env://"
            elif "://" in coordinator_address:
                init = coordinator_address
            else:
                init = f"tcp://{coordinator_address}"
            local = local_world or int(env.get("LOCAL_WORLD_SIZE", world))
            backend = choose_backend(local, device)
            local_rank = int(env.get("LOCAL_RANK", rank % local))
            if backend == "nccl":
                torch.cuda.set_device(local_rank)
            print(f"qtpu_torch: rank {rank} of {world} on {backend}"
                  + (f" (cuda:{local_rank})" if backend == "nccl" else ""), flush=True)
            kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
            dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)
    n = dist.get_world_size() if dist.is_initialized() else 1
    local_devices = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": n,
        "local_devices": local_devices,
        "global_devices": n,
    }


def is_primary() -> bool:
    """True on the process that writes results and artifacts."""
    return not dist.is_initialized() or dist.get_rank() == 0


def device_of_rank() -> torch.device:
    """The device a rank runs on: its own card under NCCL, the one card
    that gloo ranks share when there is a card, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda", 0)


def _entry(rank, world, init_file, device, timeout_s, fn, args):
    initialize_multihost(f"file://{init_file}", world, rank, local_world=world, device=device,
                         timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), init_file: str | None = None, device: str = "cpu",
          timeout_s: float | None = None):
    """Run fn(rank, world, *args) in nprocs new processes joined in one
    world through `init_file` (which must not exist yet), on the backend
    choose_backend gives `device`; raises if a process fails. fn must be
    importable by name (a module-level function of a module that imports no
    jax for a test)."""
    import multiprocessing.forkserver
    import tempfile

    import torch.multiprocessing as mp

    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(), "init")
    # the ranks fork from a server that imported torch once (no card touched
    # there), not each a fresh interpreter importing it again
    multiprocessing.forkserver.set_forkserver_preload(["torch", "torch.distributed"])
    mp.start_processes(_entry,
                       args=(nprocs, init_file, device, timeout_s, fn, tuple(args)),
                       nprocs=nprocs, join=True, start_method="forkserver")
