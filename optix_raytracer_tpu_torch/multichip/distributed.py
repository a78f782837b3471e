"""Process-group bring-up over torch.distributed (counterpart of
`multichip/distributed.py`), and a launcher of local ranks.

The reference wraps `jax.distributed.initialize`: one process per host and
a global device view. Here one process is one rank and drives one device,
so a machine with N cards runs N ranks, and a test runs N ranks on the CPU.

    from optix_raytracer_tpu_torch.multichip import distributed as dist
    info = dist.initialize()              # from the environment; a no-op alone
    mesh = dist.pod_mesh(rows_per_slice=4)

The configuration comes from the arguments, then from the environment:
torch's MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK (in place of the
reference's JAX_* names) or COORDINATOR_ADDRESS, then the SLURM_* and
OMPI_* launchers' names, in the reference's order. With nothing
configured, `initialize` is a pure no-op: one process, rank 0.

The backend follows a stated rule (`choose_backend`), printed at bring-up:
NCCL when each rank has a card of its own; gloo when ranks share a card,
since NCCL refuses two ranks on one device; gloo on the CPU. A failed
NCCL bring-up is an error: nothing moves to gloo quietly.

`launch_local(fn, world_size)` starts the ranks of one machine from one
command with `torch.multiprocessing` (the apps and `chip_smoke.py` use it
where the reference drove N devices from one process), building the CUDA
kernels once in the parent first so that the ranks do not race N `nvcc`
builds.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import traceback
from typing import Optional

import torch

from .multislice import make_multislice_mesh


@dataclasses.dataclass
class ProcessInfo:
    """What bring-up resolved to."""
    initialized: bool          # True when this call made the process group
    process_id: int            # the global rank
    num_processes: int         # the world size
    coordinator: Optional[str]
    backend: Optional[str]     # None with one process
    device: torch.device       # the device this rank renders on
    local_world_size: int = 1  # ranks on this host

    @property
    def is_multi_host(self) -> bool:
        """More than one process (the reference's name: there a process is
        a host)."""
        return self.num_processes > 1


def _env(*names):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def detect_config(coordinator_address=None, num_processes=None,
                  process_id=None):
    """(coordinator, num_processes, process_id) from the arguments, else the
    environment (distributed.py:58-72); (None, 1, 0) when nothing is
    configured."""
    coordinator = coordinator_address
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr:
            port = os.environ.get("MASTER_PORT")
            coordinator = f"{addr}:{port}" if port else addr
        else:
            coordinator = _env("COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else _env(
        "WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
    pid = process_id if process_id is not None else _env(
        "RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
    if coordinator is None and nproc is None and pid is None:
        return None, 1, 0
    return (coordinator,
            int(nproc) if nproc is not None else 1,
            int(pid) if pid is not None else 0)


def _local_layout(nproc, pid):
    """(local rank, ranks on this host) from the launchers' names; one host
    when none says otherwise."""
    local = _env("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")
    size = _env("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE",
                "OMPI_COMM_WORLD_LOCAL_SIZE")
    return (int(local) if local is not None else pid,
            int(size) if size is not None else nproc)


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int) -> tuple:
    """The rule → (backend, reason): NCCL when each rank of this host has a
    card of its own, gloo when ranks share a card (NCCL refuses two ranks
    on one device) and gloo on the CPU."""
    if device_type != "cuda":
        return "gloo", "ranks on the CPU"
    if n_cards < 1:
        raise RuntimeError("a CUDA device was asked for and none is visible")
    if local_world_size <= n_cards:
        return "nccl", f"{local_world_size} ranks on {n_cards} cards, one each"
    return "gloo", (f"{local_world_size} ranks share {n_cards} card(s); NCCL "
                    f"refuses two ranks on one device")


_INFO: Optional[ProcessInfo] = None


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device=None) -> ProcessInfo:
    """Bring up the process group once (idempotent; distributed.py:78-111).

    device: "cuda" (the default) or "cpu"; a rank takes card local_rank mod
    the visible cards. With more than one process, or a coordinator,
    `torch.distributed.init_process_group` runs over tcp:// at the
    coordinator with the backend of `choose_backend`, whose choice is
    printed; alone it is a no-op."""
    global _INFO
    if _INFO is not None:
        return _INFO
    import torch.distributed as dist
    coordinator, nproc, pid = detect_config(coordinator_address,
                                            num_processes, process_id)
    local_rank, local_world = _local_layout(nproc, pid)
    dev_type = torch.device(device if device is not None else "cuda").type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    dev = (torch.device("cuda", local_rank % n_cards) if n_cards
           else torch.device(dev_type))
    did_init, backend = False, None
    if dist.is_available() and dist.is_initialized():
        # brought up by the caller: take its group as it is
        backend, nproc, pid = (dist.get_backend(), dist.get_world_size(),
                               dist.get_rank())
    elif nproc > 1 or coordinator is not None:
        if coordinator is None:
            raise ValueError("several processes need a coordinator address "
                             "(MASTER_ADDR and MASTER_PORT)")
        backend, reason = choose_backend(dev_type, local_world, n_cards)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if pid == 0:
            print(f"multichip: backend {backend} ({reason}); {nproc} ranks",
                  flush=True)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=nproc, rank=pid)
        did_init = True
    _INFO = ProcessInfo(initialized=did_init, process_id=pid,
                        num_processes=nproc, coordinator=coordinator,
                        backend=backend, device=dev,
                        local_world_size=local_world)
    return _INFO


def shutdown():
    """Tear down (test support); safe when never initialized."""
    global _INFO
    if _INFO is not None and _INFO.initialized:
        import torch.distributed as dist
        dist.destroy_process_group()
    _INFO = None


def pod_mesh(rows_per_slice: Optional[int] = None,
             samples_per_slice: int = 1, device=None):
    """A (slice, rows, samples) mesh with one slice per host
    (distributed.py:118-143): each host's ranks form its slice, so the
    sample mean and the slice's ray count never leave a host.
    rows_per_slice defaults to the host's ranks // samples_per_slice."""
    info = initialize(device=device)
    per_slice = info.local_world_size
    n_slices = max(info.num_processes // per_slice, 1)
    if rows_per_slice is None:
        rows_per_slice = per_slice // samples_per_slice
    if rows_per_slice * samples_per_slice != per_slice:
        raise ValueError(f"rows({rows_per_slice}) x samples"
                         f"({samples_per_slice}) != ranks per slice "
                         f"({per_slice})")
    return make_multislice_mesh(n_slices, rows_per_slice, samples_per_slice,
                                device=info.device)


# --- local launcher --------------------------------------------------------

def _free_port() -> int:
    """A free TCP port on localhost (the coordinator's)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, port, device, threads, args, queue):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world_size), RANK=str(rank),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world_size))
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        info = initialize(device=device)
        queue.put((rank, True, fn(info, *args)))
    except BaseException:   # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def launch_local(fn, world_size: int, *args, device="cuda",
                 timeout: float = 600.0, threads=None) -> list:
    """Run `fn(info, *args)` on `world_size` ranks of this machine, each a
    process started by `torch.multiprocessing`'s spawn method and brought up
    by `initialize` over localhost → the ranks' results in rank order. `fn`
    must be importable by name (it is pickled); its results are pickled
    back. A rank that raises, or fails to report within `timeout` seconds,
    fails the launch, and every rank is stopped. On CUDA the kernels are
    built here first. threads: torch's intra-op threads in each rank
    (default: torch's own), for ranks that share the CPU's cores."""
    import queue as queue_mod

    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda":
        from .. import kernels
        kernels.build()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, device, threads,
                               args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failed = {}, []
    try:
        for _ in range(world_size):
            try:
                rank, ok, value = results.get(timeout=timeout)
            except queue_mod.Empty:
                failed.append(f"no result within {timeout} s")
                break
            if ok:
                out[rank] = value
            else:
                failed.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if failed else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if failed:
        raise RuntimeError("launch_local: " + "\n".join(failed))
    return [out[r] for r in range(world_size)]
