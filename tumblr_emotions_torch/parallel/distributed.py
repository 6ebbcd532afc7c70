"""Several processes on ``torch.distributed``: start-up and the collectives
the trainer uses.

Port of ``tumblr_emotions_tpu/parallel/distributed.py``.  The reference
calls ``jax.distributed.initialize`` on a multi-host run, after which the
same pjit programs run SPMD over every host's devices.  Here each process
drives one card (or, on a machine with fewer cards than processes, shares
one) and the processes form one ``torch.distributed`` group: the data axis
of ``parallel/mesh.py``.  Each process feeds its own shard of the input
(:func:`host_shard_options`).

The backend is chosen by a rule stated up front, not by a fallback: NCCL
when every process of the machine has a card of its own, gloo on the CPU
or when processes share a card (NCCL refuses two ranks on one device).  A
failed initialisation raises.  Collectives on gloo stage tensors of the
card through host memory (:func:`all_reduce_`).

Each all-reduce names its kind (:data:`KINDS`): ``batch_norm`` (the global
batch's statistics and their gradients, ``models/layers.SlimBatchNorm``),
``gradient`` (a train step's flat gradient), ``statistics`` (a step's loss
and accuracy, an eval batch's metric statistics) or ``other``.  Inside
:func:`counting` every all-reduce issued is counted with its bytes by kind:
the trainer counts each train step it runs op by op or records into a graph
(``Trainer.collectives``), so a captured step's counts are those of the
recording, which every replay repeats.  Under a profiler each all-reduce
issued from Python is the span ``dp.allreduce`` (``utils/summaries.span``):
an op-by-op step (gloo) shows every one; a captured step shows none, its
collectives being nodes of the graph.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from tumblr_emotions_torch.utils.summaries import span

log = logging.getLogger("tumblr_emotions_torch")

KINDS = ("batch_norm", "gradient", "statistics", "other")

# torchrun's rendezvous: a multi-process run sets MASTER_ADDR and a
# WORLD_SIZE above 1; a single-host run of one process has neither.
_CLUSTER_ENV_VARS = ("MASTER_ADDR",)


def detect_cluster_env() -> Optional[str]:
    """The cluster-environment marker present (``MASTER_ADDR`` with
    ``WORLD_SIZE`` > 1), else None."""
    for var in _CLUSTER_ENV_VARS:
        if os.environ.get(var) and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            return var
    return None


def local_world_size(num_processes: int) -> int:
    """The processes on this machine: torchrun's ``LOCAL_WORLD_SIZE``, else
    all of them (an explicit coordinator starts them on one machine)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def backend_for(device, local_world: int) -> str:
    """NCCL iff ``device`` is a card and each of the machine's
    ``local_world`` processes has a card of its own; gloo otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def process_device(device, rank: int, local_world: int) -> torch.device:
    """The card of process ``rank`` (its local rank's card when each
    process has one, else the one shared card) or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local_rank(rank) if n >= local_world else 0)


def init_group(address: str, num_processes: int, process_id: int,
               device="cuda", backend: Optional[str] = None) -> torch.device:
    """``init_process_group`` at ``tcp://address`` (``env://`` when address
    is ``"env"``; an address with a scheme, such as ``file:///shared/path``,
    is the init method itself) with the rule's backend; returns this
    process's device."""
    local = local_world_size(num_processes)
    dev = process_device(device, process_id, local)
    backend = backend or backend_for(dev, local)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    init = "env://" if address == "env" else address if "://" in address else \
        f"tcp://{address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    log.info("distributed: process %d/%d on %s over %s", process_id, num_processes,
             dev, backend)
    return dev


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> bool:
    """Join the process group of a multi-process run; a no-op otherwise.

    With a coordinator address and more than one process, initialise
    against it (``host:port``; process 0 listens there).  With no
    arguments, initialise from torchrun's environment iff
    :func:`detect_cluster_env` finds one, so a single process never waits
    for peers that do not exist.  Returns whether a group of more than one
    process is active."""
    if not dist.is_initialized():
        if coordinator_address and (num_processes or 1) > 1:
            init_group(coordinator_address, num_processes, process_id or 0, device)
        elif coordinator_address is None and detect_cluster_env() is not None:
            log.info("distributed: initialising from torchrun's environment")
            init_group("env", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                       device)
    return host_shard_options()[1] > 1


def host_shard_options() -> Tuple[int, int]:
    """(shard_index, shard_count): this process's slice of the input."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CollectiveCount:
    """All-reduces issued, and their bytes, by kind (:data:`KINDS`)."""

    def __init__(self):
        self.calls: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.bytes: Dict[str, int] = dict.fromkeys(KINDS, 0)

    def add(self, kind: str, t: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def total(self) -> int:
        return sum(self.calls.values())


_counting: Optional[CollectiveCount] = None


@contextlib.contextmanager
def counting() -> Iterator[CollectiveCount]:
    """Count the all-reduces issued inside the block (a nested block counts
    its own; the outer one resumes after it)."""
    global _counting
    outer, _counting = _counting, CollectiveCount()
    try:
        yield _counting
    finally:
        _counting = outer


def _stages_through_host(t: torch.Tensor, group) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None, kind: str = "other") -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (through host memory on gloo);
    ``kind`` (one of :data:`KINDS`) is what :func:`counting` files it
    under."""
    if _counting is not None:
        _counting.add(kind, t)
    with span("dp.allreduce"):
        if _stages_through_host(t, group):
            host = t.cpu()
            dist.all_reduce(host, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    """The sum over the group, whose backward is the sum of the gradients
    over the group (``torch.distributed.nn``'s all-reduce, staged through
    host memory on gloo)."""

    @staticmethod
    def forward(ctx, t, group, kind):
        ctx.group, ctx.kind = group, kind
        return all_reduce_(t.clone(memory_format=torch.contiguous_format), group, kind)

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.group, ctx.kind), None, None


def all_reduce(t: torch.Tensor, group=None, kind: str = "other") -> torch.Tensor:
    """Autograd-aware sum of ``t`` over ``group`` (its backward's all-reduce
    of the same ``kind``)."""
    return _AllReduce.apply(t, group, kind)


def collective_device(group, device) -> torch.device:
    """Where the group's collectives take small tensors: the card on NCCL,
    the host on gloo."""
    return torch.device(device) if dist.get_backend(group) == "nccl" else torch.device("cpu")


def all_gather_int(value: int, group=None, device="cpu") -> list:
    """``value`` of every process of the group, in rank order."""
    world = dist.get_world_size(group)
    dev = collective_device(group, device)
    out = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
    dist.all_gather(out, torch.tensor([value], dtype=torch.int64, device=dev), group=group)
    return [int(t.item()) for t in out]


def barrier(group=None, device="cpu") -> None:
    """Wait for every process of the group (an all-reduce of one number,
    which NCCL runs on the card and gloo on the host)."""
    all_reduce_(torch.zeros(1, device=collective_device(group, device)), group)
