"""The data-parallel mesh: the process group a trainer reduces over, and
which rows of each global batch this process holds.

Port of ``tumblr_emotions_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over its devices, replicates the state and splits the
batch along the ``data`` axis; XLA inserts the all-reduces.  Here the data
axis is the ``torch.distributed`` process group, one card per process: a
process holds the state whole and rows ``[r*b, (r+1)*b)`` of each global
batch of ``data * b`` rows (:meth:`Mesh.rows`), the order in which
``make_array_from_process_local_data`` assembles the reference's global
array.  The trainer writes the collectives out (``train/trainer.py``).
The port splits the batch only: ``MeshConfig.model`` other than 1 is
refused.

A mesh of one process has no group, so one process runs the plain step,
as the reference runs plain jit on a one-device mesh.  A :class:`Mesh`
built with a group takes the collective path at any size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from tumblr_emotions_torch.config import MeshConfig
from tumblr_emotions_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` processes; this process is ``rank`` of ``group`` (None: one
    process and no collectives)."""

    data: int = 1
    rank: int = 0
    group: Any = None

    def rows(self, local: int) -> slice:
        """The rows of the global batch this process holds, for ``local``
        rows per process."""
        return slice(self.rank * local, (self.rank + 1) * local)


def create_mesh(cfg: Optional[MeshConfig] = None, world_size: Optional[int] = None,
                rank: int = 0) -> Mesh:
    """The mesh of ``world_size`` processes (default: the active process
    group's size, 1 without one, and then its group when that is larger
    than 1).  ``data=-1`` takes every process; raises when ``data`` is not
    the number of processes, as the reference does for its devices, and
    when ``model`` is not 1."""
    cfg = cfg or MeshConfig()
    if cfg.model != 1:
        raise ValueError(f"MeshConfig.model={cfg.model}: the port splits the batch only "
                         "(model must be 1)")
    group = None
    if world_size is None:
        rank, world_size = distributed.host_shard_options()
        if world_size > 1:
            group = torch.distributed.group.WORLD
    data = cfg.data if cfg.data > 0 else world_size
    if data != world_size:
        raise ValueError(f"mesh {data}x1 != {world_size} processes; set MeshConfig.data")
    return Mesh(data, rank, group)
