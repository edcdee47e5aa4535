"""The benchmark's operation and byte counts: the counters against a hand
count, and the analytic counts of both networks against
``torch.utils.flop_counter.FlopCounterMode`` over the plain references at
a small size (MSDA's bilinear samples, which the counter does not see,
are counted apart)."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_flops as bf
import bench_harness as bh

HERE = os.path.dirname(os.path.abspath(__file__))


def test_counters_by_hand():
    assert bf.conv(2, 3, 4, 3, 5, 6) == 2 * 2 * 3 * 4 * 9 * 5 * 6
    assert bf.dense(7, 8, 9) == 2 * 7 * 8 * 9
    assert bf.attention(2, 3, 5, 16) == 2 * (2 * 2 * 3 * 5 * 16)
    # one image, 2 queries, 3 value rows, 1 head, 2 levels, 2 points, 4
    # channels: 8 samples of 4 corners x 4 channels
    flops, nbytes = bf.msda_fwd(1, 2, 3, 1, 2, 2, 4)
    assert flops == 2 * 8 * 4 * 4
    assert nbytes == 4 * (3 * 4 + 8 * 3 + 2 * 4)
    flops, nbytes = bf.msda_bwd(1, 2, 3, 1, 2, 2, 4)
    assert flops == 2 * 2 * 8 * 4 * 4
    assert nbytes == 4 * (2 * 3 * 4 + 2 * 8 * 3 + 2 * 4)
    peaks = {"float32_flops": 1e3, "hbm_bytes_per_s": 1e3}
    assert bf.bound_seconds(5000, 2000, peaks) == 5.0
    assert bf.bound_seconds(1000, 2000, peaks) == 2.0
    assert bf.conv_out(384, 7, 2, 3) == 192
    assert bf.monodetr_shapes(384, 1280) == [(48, 160), (24, 80), (12, 40),
                                             (6, 20)]


def _reference(name):
    return bh.load_module(os.path.join(HERE, "references", name + ".py"))


def test_monodetr_flops_match_the_counter():
    torch.manual_seed(0)
    cfg = json.load(open(os.path.join(HERE, "configs",
                                      "monodetr-kitti.json")))
    ref = _reference("monodetr-kitti")
    model = ref.build(cfg, "cpu")
    b, h, w = 1, 64, 192
    img = torch.randn(b, h, w, 3)
    calib = torch.tensor([[[700.0, 0, 96, 0], [0, 700, 32, 0],
                           [0, 0, 1, 0]]])
    size = torch.tensor([[w, h]], dtype=torch.float32)
    m = cfg["model"]
    want = bf.monodetr_step(m, b, h, w, 550)
    with FlopCounterMode(display=False) as fwd:
        layers, dlogits = model(img, calib, size)
    assert fwd.get_total_flops() == want["gemm"] + want["conv1"]
    loss = dlogits.sum() + sum(v.sum() for o in layers for v in o.values())
    with FlopCounterMode(display=False) as bwd:
        loss.backward()
    assert fwd.get_total_flops() + bwd.get_total_flops() == \
        bf.monodetr_train_flops(m, b, h, w, 550) - 3 * want["msda"]


def test_mask2former_flops_match_the_counter():
    torch.manual_seed(0)
    cfg = json.load(open(os.path.join(HERE, "configs",
                                      "mask2former-swinb.json")))
    model = _reference("mask2former-swinb").Mask2Former(cfg).eval() \
        .requires_grad_(False)
    h, w = 64, 160
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(torch.randn(1, h, w, 3))
    assert fc.get_total_flops() == bf.mask2former_frame(cfg, h, w)["gemm"]


@pytest.mark.parametrize("cell", ["monodetr-kitti-train-b16",
                                  "mask2former-swinb-masks"])
def test_msda_calls_are_the_networks(cell):
    """The MSDA launches the counts assume: six a unit, at the shapes the
    networks make."""
    bench = bh.Bench(pending=True)
    c = bench.cell(cell)
    cfg = bench.config(c["config"])
    if cell.startswith("monodetr"):
        calls = bf.monodetr_step(cfg["model"], 16, 384,
                                 1280, 550)["msda_calls"]
        assert calls[:3] == [(16, 10200, 10200, 8, 4, 4, 32)] * 3
        assert calls[3:] == [(16, 550, 10200, 8, 4, 4, 32)] * 3
    else:
        calls = bf.mask2former_frame(cfg, 384, 1280)["msda_calls"]
        assert calls == [(1, 10080, 10080, 8, 3, 4, 32)] * 6
