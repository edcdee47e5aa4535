"""Shuffled epoch iterator with a thread pool assembling batches ahead of
the device step.

Counterpart of the JAX package's ``tools/train_val.py`` ``build_loader``
(the reference's torch DataLoader(num_workers=4) role, train_val.py:60-66):
the same ``default_rng(seed)`` shuffle, so both packages visit the same
indices in the same order, and a partial last batch is dropped.  Under data
parallelism every rank draws the same permutation and assembles only its
positions of each global batch (``shard``).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator

import numpy as np

from monosowa_tpu_torch.data.kitti_dataset import collate


def build_loader(ds, batch_size: int, shuffle: bool, seed: int = 444,
                 prefetch: int = 4, workers: int = 4,
                 shard: slice = slice(None)
                 ) -> Callable[[], Iterator[Dict[str, np.ndarray]]]:
    """``epoch_iter()`` yields one epoch of collated batches; each call
    draws the next permutation from one generator seeded with ``seed``.
    ``batch_size`` is the global batch; each yielded batch holds its
    ``shard`` positions (``parallel.DataParallel.shard``), all of them by
    default."""
    rng = np.random.default_rng(seed)

    def make_batch(idxs):
        return collate([ds[int(j)] for j in idxs[shard]])

    def epoch_iter():
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        starts = list(range(0, len(order) - batch_size + 1, batch_size))
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        pool = ThreadPoolExecutor(max_workers=workers)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # sliding window: at most `prefetch` batches in flight/buffered;
            # a failed batch travels to the consumer as its exception
            window: deque = deque()
            it = iter(starts)
            try:
                for _ in range(prefetch):
                    s = next(it, None)
                    if s is None:
                        break
                    window.append(
                        pool.submit(make_batch, order[s:s + batch_size]))
                while window:
                    if not put(window.popleft().result()):
                        return
                    s = next(it, None)
                    if s is not None:
                        window.append(
                            pool.submit(make_batch, order[s:s + batch_size]))
                put(None)
            except BaseException as exc:   # raised again by the consumer
                put(exc)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    break
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            t.join()

    return epoch_iter
