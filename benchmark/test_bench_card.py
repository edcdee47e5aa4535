"""On the card: the controls at a size a test run holds, the train cell's
its own (batch 16 at 384 x 1280 on KITTI's rows, about a minute a seed),
where TF32 moves its numbers past the limits; the mask cell's smaller.
The plain reference computed in TF32 in the program's place, and a
training step on half of each batch, fail the cell's limits; the float32
reference against itself passes them.  Run with ``python3 -m pytest
benchmark -m cuda`` on a machine with a card; skipped without one."""

import copy
import os

import pytest
import torch

import bench_harness as bh
import bench_tiny

HERE = os.path.dirname(os.path.abspath(__file__))
pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the controls run on the card")
    return torch.device("cuda")


def _cell(bench, cell):
    c = bench.cell(cell)
    config = copy.deepcopy(bench.config(c["config"]))
    traffic = bench.traffic(c["traffic"])
    limits = bh.load_json(os.path.join(HERE, "checks",
                                       cell + ".json"))["limits"]
    return c, config, traffic, limits


def _fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_train_controls_fail(seed):
    dev = _card()
    bench = bh.Bench(pending=True)
    cell, config, traffic, limits = _cell(bench, "monodetr-kitti-train-b16")
    drv = bench.driver(traffic)
    res = drv.controls(bench, cell, seed, dev, config, traffic)
    assert _fails(res["tf32"], limits), res
    assert _fails(res["half_batch"], limits), res
    assert res["altered_match"] > limits["match_gap"], res


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_mask_control_fails(seed):
    dev = _card()
    bench = bh.Bench()
    cell, config, traffic, limits = _cell(bench, "mask2former-swinb-masks")
    ov = bench_tiny.overrides(bench, cell["name"])
    config.update(ov["config"])
    traffic.update(ov["traffic"])
    config["input_hw"] = [192, 640]
    traffic["frame_hw"] = [188, 621]
    drv = bench.driver(traffic)
    res = drv.controls(bench, cell, seed, dev, config, traffic)
    assert _fails(res["tf32"], limits), res
