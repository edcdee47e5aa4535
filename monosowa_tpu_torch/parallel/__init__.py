"""Data-parallel training across processes (``torch.distributed``), the
port's counterpart of the JAX package's ``parallel/`` mesh."""

from monosowa_tpu_torch.parallel.dist import (  # noqa: F401
    DataParallel, all_reduce_grads, data_parallel_size, from_process_group,
    global_sum, group_size, launcher_ranks, setup, shard_slice)
