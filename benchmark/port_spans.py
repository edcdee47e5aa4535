"""What the port's own tracer (``monosowa_tpu_torch/utils/timing.py``)
recorded of a run's window, for the readers of the metrics whose source is
``program_span``: the window's units, in order (the last ``steps`` records
of the unit), less those the profiler traced, as ``untraced_mean`` leaves
them out of the benchmark's own spans.  A port without the tracer, or a
ring that holds fewer records than the window, gives nothing to read."""

from typing import Any, Callable, Dict, Optional


def unit_mean(ctx: Dict[str, Any], unit: str,
              value: Callable[[Any], float]) -> Optional[float]:
    """The mean of ``value(record)`` over the window's untraced ``unit``
    records, or None."""
    try:
        from monosowa_tpu_torch.utils import timing
    except ImportError:
        return None
    tracer = getattr(timing, "TRACER", None)
    if tracer is None:
        return None
    recs = tracer.window(unit, int(ctx["steps"]),
                         ctx.get("traced_steps", ()))
    if not recs:
        return None
    return sum(value(r) for r in recs) / len(recs)


def frame_host_ms(ctx: Dict[str, Any], span: str) -> Optional[float]:
    """Mean ms a mask frame spent in ``span`` less its waits on the card
    (the ``sync.*`` spans inside it)."""
    return unit_mean(ctx, "masks.frame",
                     lambda r: 1e3 * r.host_seconds(span))
