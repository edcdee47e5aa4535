"""The port's tracer (``monosowa_tpu_torch/utils/timing.py``): spans, units
and counters on a fake clock; the window of unit records a benchmark
reader takes; the mask frame's unit from a tiny ``Mask2FormerBackend`` on
the CPU; the kernels' launch counters read through the registry; the
``WaymoSegmentDriver``'s stages as spans; profiler ranges inside
``StageTimer.trace`` alone.  The card's waits are held to the frame's
``sync`` count in ``tests/test_torch_cuda.py``."""

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

from monosowa_tpu_torch.config import Config, PipelineFlags
from monosowa_tpu_torch.convert import zoo_params
from monosowa_tpu_torch.models import mask2former, swin
from monosowa_tpu_torch.ops import lap, msda, row_fetch, tfl
from monosowa_tpu_torch.sowa import cli
from monosowa_tpu_torch.sowa.masks import Mask2FormerBackend
from monosowa_tpu_torch.utils import timing

torch.set_num_threads(1)    # the suite runs six worker processes at once

CUDA = torch.device("cuda")     # a device to wait on (none is used here)
STAGES = ("masks.encode", "m2f.backbone", "m2f.pixel_decoder",
          "m2f.decoder", "masks.keep")


def fake_clock(*ticks):
    it = iter(ticks)
    return lambda: next(it)


def test_nesting_and_self_time_on_a_fake_clock():
    # a [0, 10] holds b [1, 4] and c [5, 9]; c holds d [6, 8]
    tr = timing.Tracer(clock=fake_clock(0.0, 1.0, 4.0, 5.0, 6.0, 8.0, 9.0,
                                        10.0))
    with tr.span("a") as a:
        with tr.span("b") as b:
            pass
        with tr.span("c") as c:
            with tr.span("d") as d:
                pass
    assert [s.name for s in tr.spans] == ["b", "d", "c", "a"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a, a, c)
    assert (a.start, a.end, d.start, d.end) == (0.0, 10.0, 6.0, 8.0)
    assert a.seconds == 10.0 and a.unit_id is None
    # outside a unit: running totals alone, [calls, seconds, self, wait]
    assert tr.totals == {"a": [1, 10.0, 3.0, 0.0], "b": [1, 3.0, 3.0, 0.0],
                         "c": [1, 4.0, 2.0, 0.0], "d": [1, 2.0, 2.0, 0.0]}
    assert not tr.records


def test_sync_spans_and_counters_land_in_the_open_unit():
    # u [0, 20] holds s [1, 9] holding sync.x [2, 7]; sync.y [10, 11]
    tr = timing.Tracer(clock=fake_clock(0.0, 1.0, 2.0, 7.0, 9.0, 10.0,
                                        11.0, 20.0, 30.0, 33.0))
    with tr.unit("u") as u:
        with tr.span("s"):
            with tr.sync("x", CUDA) as x:
                tr.count("launches", 3)
        with tr.sync("y", CUDA):
            pass
    rec = tr.records[-1]
    assert (rec.name, rec.id, rec.start, rec.end) == ("u", u.unit_id, 0.0,
                                                      20.0)
    assert x.unit_id == rec.id and x.parent.name == "s"
    assert rec.spans == {"sync.x": [1, 5.0, 5.0, 5.0],
                         "s": [1, 8.0, 3.0, 5.0],
                         "sync.y": [1, 1.0, 1.0, 1.0],
                         "u": [1, 20.0, 11.0, 6.0]}
    assert rec.counts == {"sync": 2, "launches": 3}
    assert rec.host_seconds("s") == 3.0 and rec.wait_seconds() == 6.0
    assert rec.seconds("absent") == rec.host_seconds("absent") == 0.0
    # the process totals; a wait outside any unit is in the running totals
    # alone, which hold nothing of the unit's
    with tr.sync("z", CUDA):
        pass
    assert tr.counter("sync") == 3 and tr.counter("launches") == 3
    assert tr.totals == {"sync.z": [1, 3.0, 3.0, 3.0]}
    assert len(tr.records) == 1
    tr.reset_counters("sync")
    assert tr.counter("sync") == 0 and tr.counter("launches") == 3


def test_no_wait_where_the_device_is_no_card():
    tr = timing.Tracer()
    with tr.unit("u"):
        with tr.sync("upload", torch.device("cpu")):
            pass
    assert "sync.upload" not in tr.records[-1].spans
    assert tr.counter("sync") == 0 and tr.records[-1].counts == {}


def test_a_unit_inside_a_unit_keeps_its_own_record():
    # outer [0, 5] holds inner [1, 4] holding s [2, 3]
    tr = timing.Tracer(clock=fake_clock(*map(float, range(6))))
    with tr.unit("outer"):
        with tr.unit("inner"):
            with tr.span("s"):
                tr.count("c")
    inner, outer = tr.records
    assert set(inner.spans) == {"inner", "s"} and inner.counts == {"c": 1}
    assert set(outer.spans) == {"outer"} and outer.counts == {}
    # the inner unit is a child of the outer's span
    assert outer.spans["outer"] == [1, 5.0, 2.0, 0.0]


def test_the_ring_is_bounded():
    assert timing.RING >= 4096
    tr = timing.Tracer()
    n = timing.SPANS_KEPT // 2 + 3
    for _ in range(n):
        with tr.unit("f"):
            with tr.span("s"):
                pass
    assert [r.id for r in tr.records] == list(range(n - timing.RING, n))
    assert len(tr.spans) == timing.SPANS_KEPT
    assert tr.totals == {}


def test_the_window_takes_the_last_steps_less_the_traced_ones():
    tr = timing.Tracer()
    for k in range(9):
        with tr.unit("other" if k == 4 else "frame"):
            pass
    ids = [r.id for r in tr.window("frame", 6)]
    assert ids == [2, 3, 5, 6, 7, 8]
    assert [r.id for r in tr.window("frame", 6, skip=[0, 4, 5])] == [3, 5,
                                                                     6]
    assert tr.window("frame", 9) is None and tr.window("frame", 0) is None


TINY = mask2former.Mask2FormerConfig(
    backbone=swin.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                             num_heads=(1, 2, 4, 8), window_size=4),
    feature_size=32, mask_feature_size=32, hidden_dim=32, encoder_layers=1,
    decoder_layers=2, num_attention_heads=2, encoder_feedforward_dim=32,
    dim_feedforward=32, num_queries=6, num_labels=3)


def test_one_mask_frame_is_one_record_of_the_five_stages():
    tree = zoo_params(mask2former.Mask2Former(TINY, device="cpu"))
    backend = Mask2FormerBackend(tree, TINY, score_threshold=0.0,
                                 input_hw=(64, 96), device="cpu")
    image = np.random.default_rng(1).integers(0, 256, (40, 60, 3), np.uint8)
    seen = {r.id for r in timing.TRACER.records}
    out = backend.predict_masks_multi(image, [(0,), (1, 2)])
    (rec,) = [r for r in timing.TRACER.records if r.id not in seen]
    assert rec.name == "masks.frame"
    assert set(rec.spans) == {"masks.frame", *STAGES}
    assert all(rec.spans[s][0] == 1 for s in STAGES)
    # the stages lie inside the frame, one after another
    frame = rec.seconds("masks.frame")
    assert 0 < sum(rec.seconds(s) for s in STAGES) <= frame
    # nothing waits on a card here, and the CPU launches no kernel
    assert rec.wait_seconds() == 0.0 and rec.counts == {}
    assert sum(len(m) for m, _ in out) > 0
    # a forward alone is no unit
    n = len(timing.TRACER.records)
    backend.forward(image)
    assert len(timing.TRACER.records) == n


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


def _launch_msda(monkeypatch, dtype):
    monkeypatch.setattr(msda, "_launch", lambda *a: None)
    value = torch.zeros(1, 5, 2, 4, dtype=dtype)
    loc = torch.zeros(1, 3, 2, 2, 1, 2)
    aw = torch.zeros(1, 3, 2, 2, 1)
    shapes = ((2, 2), (1, 1))
    msda._launch_fwd(value, shapes, loc, aw)
    msda._launch_bwd(value, shapes, loc, aw, torch.zeros(1, 3, 8))


def _launch_lap(monkeypatch, form):
    _no_cuda(monkeypatch)
    monkeypatch.setattr(lap, "_kernels", lambda: types.SimpleNamespace(
        lap_jv_warp=lambda *a: 0, lap_jv_cluster=lambda *a: 0,
        lap_jv_tall=lambda *a: 0, lap_auction=lambda *a: 0))
    cost = torch.zeros(2, 8, 8)
    n_valid = torch.full((2,), 8)
    lap._launch_jv(cost, n_valid, lap.jv_plan(8, 8, form))
    lap._launch_auction(cost, n_valid, lap.AUCTION_PHASES,
                        lap.AUCTION_ROUNDS)


def _launch_tfl(monkeypatch):
    _no_cuda(monkeypatch)
    monkeypatch.setattr(tfl, "_kernel", lambda: lambda *a: 0)
    tfl._launch_counts(torch.zeros(1, 16, 3), torch.ones(1, 16),
                       torch.zeros(1, 2, 8, 3), 0.2)


def _launch_row_fetch(monkeypatch):
    _no_cuda(monkeypatch)
    monkeypatch.setattr(row_fetch, "_kernels",
                        lambda: {"direct": lambda *a: 0})
    row_fetch._launch(torch.zeros(64, 8), torch.zeros(4, dtype=torch.int32),
                      4, 16, 4, "direct")


# each kernel's wrapper with its library (and the card's stream) stubbed:
# the counters it moves, in the process and in the open unit
@pytest.mark.parametrize("launch,moved", [
    (lambda mp: _launch_msda(mp, torch.float32),
     {"msda.fwd_launches": 1, "msda.bwd_launches": 1}),
    (lambda mp: _launch_msda(mp, torch.bfloat16),
     {"msda.fwd_launches_bf16": 1, "msda.bwd_launches_bf16": 1}),
    (lambda mp: _launch_lap(mp, "warp"),
     {"lap.jv_launches": 1, "lap.jv_warp_launches": 1,
      "lap.auction_launches": 1}),
    (lambda mp: _launch_lap(mp, "cluster"),
     {"lap.jv_launches": 1, "lap.jv_cluster_launches": 1,
      "lap.auction_launches": 1}),
    (lambda mp: _launch_lap(mp, "tall"),
     {"lap.jv_launches": 1, "lap.jv_tall_launches": 1,
      "lap.auction_launches": 1}),
    (_launch_tfl, {"tfl.launches": 1}),
    (_launch_row_fetch, {"row_fetch.launches": 1}),
], ids=["msda", "msda_bf16", "lap_warp", "lap_cluster", "lap_tall", "tfl",
        "row_fetch"])
def test_launch_counters_count_in_the_registry(monkeypatch, launch, moved):
    before = dict(timing.TRACER.counters)
    with timing.unit("launches"):
        launch(monkeypatch)
    after = timing.TRACER.counters
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == moved
    assert timing.TRACER.records[-1].counts == moved


@pytest.mark.parametrize("module", [msda, lap, tfl, row_fetch])
def test_one_counter_system(module):
    assert not [k for k, v in vars(module).items()
                if "launches" in k and isinstance(v, int)]


def test_waymo_stages_are_spans():
    drv = cli.WaymoSegmentDriver(Config({}), PipelineFlags("homographies"),
                                 device=torch.device("cpu"))
    with drv._stage("masks"):
        with timing.unit("masks.frame"):
            pass
    with pytest.raises(KeyError):
        with drv._stage("masks"):
            raise KeyError("a stage that fails still counts")
    spans = [s for s in timing.TRACER.spans if s.name == "waymo.masks"]
    assert drv.stage_seconds["masks"] == pytest.approx(
        spans[-1].seconds + spans[-2].seconds)
    frame = [s for s in timing.TRACER.spans if s.name == "masks.frame"][-1]
    assert frame.parent is spans[-2]
    assert set(drv.stage_seconds) == {"masks"}


def test_ranges_inside_the_port_profile_alone(tmp_path):
    timer = timing.StageTimer()
    assert timing.TRACER._range_fn is None
    with timer.trace(str(tmp_path)):
        with timing.span("port.traced"):
            torch.ones(8).sum()
    assert timing.TRACER._range_fn is None
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port.traced" for e in events)
    # a stage is a span as well
    with timer.stage("port.stage"):
        pass
    assert timing.TRACER.spans[-1].name == "port.stage"
    assert timer.stats["port.stage"].n == 1
