"""CUDA graphs of a network's stages: one capture of a stage's launches,
replayed on every later call with the same inputs' layout, so that the host
issues one graph launch where it issued hundreds of kernels.

``StageGraphs.run(stage, *args)`` is ``stage(*args)``.  It replays a graph
only where that gives the same result, which it decides from what it can
observe alone:

* every input is a CUDA tensor, the call is not inside another capture;
* no gradient is recorded (``torch.is_grad_enabled()`` is false) and
  autocast is off;
* every module of the stage is in eval mode and carries no forward hook or
  pre-hook, and no global forward hook is set: a replay calls no Python.

Elsewhere (the CPU, gradients, training, a hooked stage) the stage runs
eagerly, as a plain call.

A graph's key is the inputs' structure, shapes, strides, dtypes and device;
the stage's modules, parameters and buffers (a module, parameter or buffer
set anew is seen through torch's global registration hooks); the storage
of its parameters and buffers (a parameter given new storage, as
``param.data = ...`` gives it, is captured anew; weights copied into in
place reach the replay as they are); and the flags that choose the kernels
(TF32, cuDNN, deterministic algorithms).  The first call with a key runs
eagerly: it fills the stage's caches, builds the kernels and sets up the
libraries' handles.  The second captures the stage on a side stream into
the object's one memory pool and replays it.  Every later call copies its
inputs into the graph's static inputs and replays.  An input that is a
static output of another graph of the same object (one stage feeding the
next) is read where it is, with no copy.  The outputs are the graph's
static outputs: the next replay of the graph rewrites them, in stream
order after every kernel enqueued before it.

What the captured region reads from a process-wide cache stays alive: a
function that hands out such a tensor (``zoo_layers.constant``, the MSDA
kernels' ``msda_plan``) calls ``note``, and the graph holds what was noted
while it was captured.

The launches the tracer counts inside the captured region
(``utils/timing.py``; ``msda.fwd_launches``) are kept at capture and
counted again on each replay; ``graph.captures`` and ``graph.replays``
count the mechanism's own work.

A stage's code is taken as it is at capture: a function swapped into the
stage later runs only where the stage runs eagerly (a forward hook on one
of its modules makes it so).
"""

from __future__ import annotations

import operator
import threading
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.nn.modules import module as _nn_module

from monosowa_tpu_torch.utils import timing

_TRAINING = operator.attrgetter("training")
_DATA_PTR = torch.Tensor.data_ptr


class _Notes(threading.local):
    notes: Optional[List[Any]] = None


_NOTES = _Notes()


def note(obj: Any) -> None:
    """``obj`` (a device tensor or what holds some), taken from a cache that
    may drop it, is read by the stage being captured, whose graph keeps it.
    Outside a capture nothing is kept."""
    notes = _NOTES.notes
    if notes is not None:
        notes.append(obj)


# modules, parameters and buffers registered anywhere in the process since
# the first stage was read (torch's global registration hooks count them)
_REGISTRATIONS = [0]


def _registered(*_) -> None:
    _REGISTRATIONS[0] += 1


def _watch_registrations() -> None:
    if not _REGISTRATIONS[0]:
        _REGISTRATIONS[0] = 1
        _nn_module.register_module_module_registration_hook(_registered)
        _nn_module.register_module_parameter_registration_hook(_registered)
        _nn_module.register_module_buffer_registration_hook(_registered)


class _Stage:
    """What a call reads of a stage: its modules, their hook tables, their
    parameters and buffers, as of ``registrations``."""

    __slots__ = ("registrations", "mods", "hooks", "tensors", "structure")

    def __init__(self, stage: nn.Module):
        self.registrations = _REGISTRATIONS[0]
        self.mods = tuple(stage.modules())
        self.hooks = tuple(d for m in self.mods
                           for d in (m._forward_hooks, m._forward_pre_hooks))
        self.tensors = tuple(t for m in self.mods
                             for d in (m._parameters, m._buffers)
                             for t in d.values() if t is not None)
        self.structure = (tuple(map(id, self.mods)),
                          tuple(map(id, self.tensors)))


def _blocked(s: _Stage) -> bool:
    """A module of the stage is in training mode or carries a forward hook
    or pre-hook."""
    return any(map(_TRAINING, s.mods)) or any(map(len, s.hooks))


def _on_card(flat) -> bool:
    """Every input is a CUDA tensor, and no capture is under way."""
    return bool(flat) and all(isinstance(t, torch.Tensor) and t.is_cuda
                              for t in flat) \
        and not torch.cuda.is_current_stream_capturing()


def _replay_allowed() -> bool:
    """No process-wide state that a replay would pass over: gradients
    recorded, autocast, a global forward hook or pre-hook."""
    return not (torch.is_grad_enabled() or torch.is_autocast_enabled("cuda")
                or _nn_module._global_forward_hooks
                or _nn_module._global_forward_pre_hooks)


def _flags() -> tuple:
    """The process-wide settings that choose the kernels a stage runs."""
    cudnn = torch.backends.cudnn
    return (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
            cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())


def _flatten(obj, leaves: list):
    """Appends the leaves of ``obj`` (a tensor, or a list or tuple of such)
    to ``leaves``; -> its layout: None for a leaf, else (type, the
    children's layouts)."""
    if isinstance(obj, (list, tuple)):
        return type(obj), tuple(_flatten(o, leaves) for o in obj)
    leaves.append(obj)
    return None


def _unflatten(layout, leaves):
    """``obj`` of ``_flatten`` from its layout and an iterator of leaves."""
    if layout is None:
        return next(leaves)
    kind, children = layout
    return kind(_unflatten(c, leaves) for c in children)


class _Graph:
    __slots__ = ("graph", "weights", "inputs", "outputs", "out_layout",
                 "counts", "keep")


class StageGraphs:
    """The CUDA graphs of one network's stages (module docstring)."""

    def __init__(self):
        self._stages: Dict[nn.Module, _Stage] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        # key -> the weights of its one eager call
        self._seen: Dict[tuple, tuple] = {}
        self._outputs: set = set()              # static outputs' data_ptr
        self._pool = self._stream = None        # made at the first capture

    def __reduce__(self):
        # a copy of the network (deepcopy, pickle) starts without graphs
        return StageGraphs, ()

    def _stage(self, stage: nn.Module) -> _Stage:
        """The stage as a call reads it, read anew where anything was
        registered since; a stage whose modules or tensors changed drops
        its graphs."""
        s = self._stages.get(stage)
        if s is None or s.registrations != _REGISTRATIONS[0]:
            _watch_registrations()
            new = _Stage(stage)
            if s is not None and s.structure != new.structure:
                for key in [k for k in self._graphs if k[0] == id(stage)]:
                    self._drop(key)
            s = self._stages[stage] = new
        return s

    def _drop(self, key: tuple) -> None:
        g = self._graphs.pop(key, None)
        if g is not None:
            self._outputs.difference_update(t.data_ptr() for t in g.outputs)

    def run(self, stage: nn.Module, *args):
        flat = []
        layout = _flatten(args, flat)
        if not (_on_card(flat) and _replay_allowed()):
            return stage(*args)
        s = self._stage(stage)
        if _blocked(s):
            return stage(*args)
        weights = tuple(map(_DATA_PTR, s.tensors))
        key = (id(stage), layout, _flags(),
               tuple((t.shape, t.stride(), t.dtype, t.device) for t in flat))
        g = self._graphs.get(key)
        if g is not None and g.weights == weights:
            return self._replay(g, flat)
        if self._seen.get(key) != weights:
            self._seen[key] = weights
            return stage(*args)
        del self._seen[key]
        self._drop(key)             # a graph of the weights' old storage
        return self._replay(self._capture(stage, key, weights, flat, layout),
                            flat)

    def _replay(self, g: _Graph, flat):
        for x, s in zip(flat, g.inputs):
            if x.data_ptr() != s.data_ptr():
                s.copy_(x)
        g.graph.replay()
        for name, n in g.counts.items():
            timing.count(name, n)
        timing.count("graph.replays")
        return _unflatten(g.out_layout, iter(g.outputs))

    def _capture(self, stage: nn.Module, key: tuple, weights: tuple, flat,
                 layout) -> _Graph:
        dev = flat[0].device
        g = _Graph()
        g.weights = weights
        g.inputs = [x if x.data_ptr() in self._outputs
                    else torch.empty_like(x).copy_(x) for x in flat]
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(dev)
            side = self._stream
            side.wait_stream(torch.cuda.current_stream(dev))
            notes = []
            _NOTES.notes, before = notes, _NOTES.notes
            try:
                with torch.cuda.stream(side), \
                        timing.TRACER.counts_kept() as counts:
                    g.graph.capture_begin(pool=self._pool,
                                          capture_error_mode="thread_local")
                    try:
                        out = stage(*_unflatten(layout, iter(g.inputs)))
                    finally:
                        g.graph.capture_end()
            finally:
                _NOTES.notes = before
            torch.cuda.current_stream(dev).wait_stream(side)
        g.outputs = []
        g.out_layout = _flatten(out, g.outputs)
        g.counts = counts
        g.keep = notes
        self._outputs.update(t.data_ptr() for t in g.outputs)
        self._graphs[key] = g
        timing.count("graph.captures")
        return g
