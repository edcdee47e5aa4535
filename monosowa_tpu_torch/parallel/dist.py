"""Data parallelism over processes, one a card (or a CPU process).

The JAX trainer (``tools/train_val.py:164-186``, ``parallel/mesh.py``)
shards each global batch over a ``data`` mesh of the largest device count
that divides the batch, replicates the parameters, and lets GSPMD compute
the global batch's loss and gradients.  Here the launcher (``torchrun``'s
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``) starts one process a card:

* the training group is the first ``data_parallel_size(B, world)`` ranks,
  the JAX rule; ranks past it take no part, and rank 0 says so;
* every rank draws the same epoch permutation, and rank r takes positions
  ``[r*B/n, (r+1)*B/n)`` of each global batch (``shard_slice``), as
  ``shard_batch`` lays the batch over the mesh;
* the losses' batch normalisers are summed over the group (``global_sum``
  in ``models/criterion.py`` and ``models/dn_components.py``), so each
  rank's loss is its share of the global batch's loss, and the gradients
  are summed over the group before AdamW (``all_reduce_grads``): the step
  is the one a single process would take on the whole batch;
* each dropout draws the whole batch's mask and keeps the rank's slice
  (``layers.Dropout.batch_shard``), so the draws are those of one process.

Without a launcher the world is one process and nothing changes: no
process group, no collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Iterable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

# seconds a collective waits for the other ranks
TIMEOUT_S = 3 * 3600


def launcher_ranks(env: Mapping[str, str] = os.environ
                   ) -> Tuple[int, int, int]:
    """(rank, world size, local rank) as ``torchrun`` sets them; (0, 1, 0)
    without a launcher."""
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", 0)))


def data_parallel_size(batch_size: int, world_size: int) -> int:
    """The JAX trainer's data-mesh size: the largest count of at most
    ``world_size`` processes that divides the batch."""
    if batch_size < 1 or world_size < 1:
        raise ValueError(f"batch {batch_size}, world {world_size}")
    return max(d for d in range(1, world_size + 1) if batch_size % d == 0)


def shard_slice(batch_size: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s positions of a global batch of ``batch_size``."""
    if batch_size % size or not 0 <= rank < size:
        raise ValueError(f"rank {rank} of {size} on a batch of "
                         f"{batch_size}")
    per = batch_size // size
    return slice(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's part in data-parallel training.

    ``rank``: its place among the launched processes; ``size``: the
    processes that train (the first ``size`` ranks); ``group``: their
    process group, None without one; ``device``: this process's device."""

    rank: int
    size: int
    group: Optional[dist.ProcessGroup]
    device: torch.device

    @property
    def trains(self) -> bool:
        return self.rank < self.size

    @property
    def batch_shard(self) -> Optional[Tuple[int, int]]:
        """(rank, size) for the model's dropout, None for one process."""
        return None if self.group is None else (self.rank, self.size)

    def shard(self, batch_size: int) -> slice:
        return shard_slice(batch_size, self.rank, self.size)


def from_process_group(batch_size: int, device: torch.device,
                       logger: Callable[[str], None] = print
                       ) -> DataParallel:
    """The training group over an initialised default process group, or
    one process without any.  Every launched rank must call it (the
    subgroup is made collectively)."""
    if not dist.is_initialized():
        return DataParallel(0, 1, None, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    size = data_parallel_size(batch_size, world)
    group = dist.group.WORLD
    if size < world:
        group = dist.new_group(list(range(size)))
        if rank == 0:
            logger(f"data parallel over {size} of {world} processes: the "
                   f"largest count that divides the batch of {batch_size}; "
                   f"ranks {size}..{world - 1} take no part")
    return DataParallel(rank, size, group if rank < size else None, device)


def setup(batch_size: int, device=None,
          logger: Callable[[str], None] = print) -> DataParallel:
    """From the launcher's environment: with more than one process, join
    the default process group (``nccl`` for CUDA devices, ``gloo`` for the
    CPU; the launcher's ``MASTER_ADDR`` / ``MASTER_PORT``), each rank on
    ``cuda:LOCAL_RANK`` unless ``device`` is "cpu"; with one, the
    resolved ``device`` and no group."""
    from monosowa_tpu_torch.device import resolve_device

    rank, world, local = launcher_ranks()
    if world == 1:
        return DataParallel(0, 1, None, resolve_device(device))
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local))
        torch.cuda.set_device(dev)
    # the other ranks wait in their next step's collectives while rank 0
    # evaluates: a KITTI val split takes minutes
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return from_process_group(batch_size, dev, logger)


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """The number of ranks in ``group`` (no communication); 1 without
    one."""
    return 1 if group is None else dist.get_world_size(group)


def global_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]
               ) -> torch.Tensor:
    """``t`` summed over the group's ranks (a new tensor, no gradient);
    ``t`` itself without a group."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group: Optional[dist.ProcessGroup]) -> None:
    """Each parameter's gradient summed over the group, in one buffer.  A
    parameter with a gradient on some rank gets the sum on every rank (a
    zero where its own was None); one with none anywhere keeps None, as
    in a single process, so AdamW skips it everywhere."""
    if group is None:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=dev)
    has = global_sum(has, group).tolist()
    live = [p for p, h in zip(params, has) if h > 0]
    for p in live:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in live]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, s in zip(grads, torch._utils._unflatten_dense_tensors(flat,
                                                                 grads)):
        g.copy_(s)
