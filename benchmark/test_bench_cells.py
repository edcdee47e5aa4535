"""Each cell's run on the CPU at a tiny size (the same widths, small
images and batch): the port against the plain reference comes out
correct, and with the timed path broken underneath, as each fault the cell
can have breaks it, ``correct`` comes out false.  The harness's look for a
card is skipped; everything else of a run is driven."""

import os

import pytest
import torch

import bench_harness as bh
import bench_tiny

HERE = os.path.dirname(os.path.abspath(__file__))
RUN = bh.load_module(os.path.join(HERE, "run.py"), "bench_run_module")

# (cell, fault, label files of clear Cars alone, correct)
CASES = [("monodetr-kitti-train-b16", None, True, True),
         ("monodetr-kitti-train-b16", "unchanged", True, False),
         ("monodetr-kitti-train-b16", "half_batch", True, False),
         ("monodetr-kitti-train-b16", "altered", True, False),
         ("monodetr-kitti-train-b16", "altered_match", True, False),
         ("mask2former-swinb-masks", None, False, True),
         ("mask2former-swinb-masks", "altered", False, False),
         ("mask2former-swinb-masks", "inverted_attention", False, False)]


@pytest.mark.parametrize("cell,fault,kept_cars_only,correct", CASES)
def test_cell_on_cpu(cell, fault, kept_cars_only, correct):
    torch.set_num_threads(4)
    bench = bh.Bench(pending=True)
    # a window long enough for the sampled frames under a loaded CPU
    res = RUN.run_cell(bench, cell, 2 ** 40 + 17, 5.0, trace=True,
                       device="cpu",
                       overrides=bench_tiny.overrides(bench, cell, fault,
                                                      kept_cars_only))
    assert res["correct"] is correct, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in bench.metrics(cell, trace=True)}
    # the device's readers find nothing to read on the CPU
    assert set(res["metrics"]) <= names
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert res["setup"]["first_run_of_checkout"] == bool(
        res["setup"]["kernels_built"])


@pytest.mark.parametrize("seed", [2 ** 40 + 17, 5])
@pytest.mark.parametrize("fault", ["altered_match", "half_batch"])
def test_train_cell_on_kitti_rows_fails_each_fault(fault, seed):
    """On KITTI's row mix (every class and Car state, a kept Car not always
    first), an altered assignment and a step on half of each batch each
    make the run not correct: the check holds whatever the port's own
    matching does on these rows."""
    torch.set_num_threads(4)
    bench = bh.Bench(pending=True)
    cell = "monodetr-kitti-train-b16"
    res = RUN.run_cell(bench, cell, seed, 2.0, trace=False, device="cpu",
                       overrides=bench_tiny.overrides(bench, cell, fault))
    assert res["correct"] is False, res["checks"]


def test_kitti_rows_hold_the_mix():
    """The split's label files: KITTI's classes and Car states at the
    traffic's rates, the same counts for every seed, a kept Car not always
    first, the DontCare rows last."""
    import numpy as np

    bench = bh.Bench(pending=True)
    drv = bench.driver(bench.traffic("train-b16"))
    tr = bench.traffic("train-b16")
    n = int(tr["split_images"])
    a = drv.split_rows(tr, n, 1)
    b = drv.split_rows(tr, n, 2 ** 40 + 17)

    def tally(rows):
        out = {}
        for r in rows:
            for cls, st in r:
                out[cls, st] = out.get((cls, st), 0) + 1
        return out

    assert tally(a) == tally(b) and a != b
    cars = sum(v for (c, _), v in tally(a).items() if c == "Car")
    assert abs(cars / n - np.mean(tr["cars_per_image"])) < 0.01
    for st, share in tr["car_states"].items():
        assert abs(tally(a)[("Car", st)] / cars - share) < 1e-3
    for cls, rate in tr["others_per_image"].items():
        assert tally(a)[(cls, "")] == round(rate * n)
    assert tally(a)[("DontCare", "")] == round(tr["dontcare_per_image"] * n)
    kept = ("clear", "occluded")
    gaps = sum(1 for r in a if any(
        c == "Car" and s in kept for c, s in r) and not (
        r[0][0] == "Car" and r[0][1] in kept))
    assert gaps > n // 4
    for r in a:
        dc = [c == "DontCare" for c, _ in r]
        assert dc == sorted(dc)
