"""Device time of a call on a CUDA device."""

from __future__ import annotations


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` in ms: ``reps`` calls captured into one
    CUDA graph and replayed, between two events.  A call of a few
    microseconds enqueued from Python is bounded by the host's launch rate,
    not by the device; a replayed graph is not."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launched_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time in ms of ``reps`` calls of ``fn()`` enqueued back to back
    from Python, between two events: the device's time or the host's launch
    rate, whichever is slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
