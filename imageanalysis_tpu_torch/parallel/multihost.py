"""The pipeline across processes and cards: torch.distributed bootstrap.

Port of ``imageanalysis_tpu/parallel/multihost.py``. One process a rank;
the same command runs on 1 rank or N:

    torchrun --nproc-per-node 2 -m imageanalysis_tpu_torch.apps.process <dir>

torchrun sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK and
LOCAL_WORLD_SIZE; the reference's JAX_COORDINATOR (host:port) /
JAX_NUM_PROCESSES / JAX_PROCESS_ID are a second spelling of the same
(then LOCAL_RANK defaults to the process id and every rank is taken to
share the host). The pipeline's parallelism is data parallelism: images
for detection and rendering, pairs for matching, observations for BA;
the only collectives on the hot path are BA's (parallel/sharded.py).
Host stages run on rank 0, and the ranks share one filesystem.

Backend: NCCL where every rank of the host has a card of its own; gloo on
the CPU, and gloo on CUDA tensors where ranks share a card (NCCL refuses
two ranks on one device). A backend that fails to start raises: there is
no switch to another. init_process_group gets a finite timeout
(IMGTPU_DIST_TIMEOUT seconds, default 1800), so a rank that never arrives
fails the others instead of hanging them.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..io.logger import log, qlog

DEFAULT_TIMEOUT_S = 1800.0


def distributed_env():
    """The run across processes that the environment asks for, as a dict
    (rank, world, local_rank, local_world, addr, port), or None for one
    process. Raises ValueError when it asks for several ranks but leaves
    out a variable they need."""
    coord = os.environ.get("JAX_COORDINATOR")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if coord and nproc is not None and pid is not None:
        addr, _, port = coord.rpartition(":")
        world, rank = int(nproc), int(pid)
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return None
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(k)]
        if missing:
            raise ValueError(
                f"WORLD_SIZE={world} asks for {world} ranks, but "
                f"{', '.join(missing)} is not set (launch with torchrun, or "
                "set MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE)")
        addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        rank = int(os.environ["RANK"])
    if world <= 1:
        return None
    return dict(rank=rank, world=world,
                local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                addr=addr or "127.0.0.1", port=int(port))


def choose_backend(device, local_world):
    """NCCL when the ranks run on cards and each rank of the host has one
    of its own; gloo otherwise (the CPU, or ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device="cuda", local_rank=None):
    """This rank's device: cuda:(LOCAL_RANK mod the cards) when device is
    a card, the CPU when the CPU is asked for."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        env = distributed_env()
        local_rank = env["local_rank"] if env else 0
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(rank, world, addr, port, device="cuda", local_rank=None,
               local_world=None, backend=None, timeout_s=None):
    """init_process_group for one rank of world, over tcp://addr:port.
    On a card the rank's device becomes the current one first. backend
    None follows choose_backend. A one-element all-reduce proves the
    group up before this returns; any failure raises. Returns the
    backend."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    dev = rank_device(device, local_rank)
    backend = backend or choose_backend(dev, local_world)
    if timeout_s is None:
        timeout_s = float(os.environ.get("IMGTPU_DIST_TIMEOUT",
                                         DEFAULT_TIMEOUT_S))
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev      # eager start: a failure raises here
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    one = torch.ones(1, device=collective_device())
    dist.all_reduce(one)
    if int(one.item()) != world:
        raise RuntimeError(f"process group of {world} ranks counted "
                           f"{int(one.item())}")
    log(f"distributed: rank {rank}/{world}, backend {backend}, device {dev}")
    return backend


def maybe_initialize_distributed(device="cuda"):
    """Join the run across processes that the environment asks for
    (distributed_env), once per process. Returns True when there is more
    than one rank."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env = distributed_env()
    if env is None:
        return False
    initialize(env["rank"], env["world"], env["addr"], env["port"], device,
               local_rank=env["local_rank"], local_world=env["local_world"])
    return True


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_rank0():
    return rank() == 0


def backend():
    return dist.get_backend() if dist.is_initialized() else None


def collective_device():
    """The device of the small host-side collectives (flags, barriers):
    this rank's card under NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name="sync"):
    """Cross-process sync point; no-op in one process."""
    if world() > 1:
        qlog(f"barrier {name}")
        t = torch.zeros(1, device=collective_device())
        dist.all_reduce(t)
        t.item()


def agree(flag, name="decision"):
    """Rank 0's boolean decision, broadcast so that every rank branches
    alike. Ranks that read STEP marker files each for themselves can see
    different states (NFS attribute caches lag behind rank 0's touch of
    a marker; mtimes are coarse), and branches that differ reach the
    barriers in different orders and hang. One process: flag itself."""
    if world() <= 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=collective_device())
    dist.broadcast(t, src=0)
    qlog(f"agree {name}: {bool(t.item())}")
    return bool(t.item())


def process_shard(items, axis_index=None, axis_total=None):
    """This rank's contiguous slice of a host-side work list (images,
    pairs): ceil(n / world) items a rank, the last ranks' slices shorter
    or empty."""
    i = rank() if axis_index is None else axis_index
    n = world() if axis_total is None else axis_total
    per = (len(items) + n - 1) // n
    return items[i * per:(i + 1) * per]
