"""The harness: it finds what BENCHMARK.json names by file, so that a cell,
a configuration and a metric are added by adding files and entries; it
refuses JAX and the JAX package by whole top-level names; and a run on a
machine without a card fails and prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_harness as bh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def test_added_files_are_found(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bdir = tmp_path / "benchmark"
    # a configuration, its reference, a traffic mix and a metric, added as
    # files of their own
    cfg = json.load(open(bdir / "configs" / "mask2former-swinb.json"))
    cfg["name"] = "mask2former-swinb-copy"
    json.dump(cfg, open(bdir / "configs" / "mask2former-swinb-copy.json",
                        "w"))
    shutil.copy(bdir / "references" / "mask2former-swinb.py",
                bdir / "references" / "mask2former-swinb-copy.py")
    traffic = json.load(open(bdir / "workloads" / "frames-kitti.json"))
    traffic["distinct_frames"] = 64
    json.dump(traffic, open(bdir / "workloads" / "frames-kitti-64.json",
                            "w"))
    (bdir / "metrics" / "masks.units_per_s.py").write_text(
        "def read(ctx):\n    return ctx['steps'] / ctx['window_s']\n")
    spec["configs"].append(dict(spec["configs"][0],
                                name="mask2former-swinb-copy",
                                file="benchmark/configs/"
                                     "mask2former-swinb-copy.json"))
    spec["workloads"].append({"name": "mask2former-swinb-copy-64",
                              "config": "mask2former-swinb-copy",
                              "traffic": "frames-kitti-64", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "masks.units_per_s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "zoo networks",
                              "moves": "mask_frames_per_s",
                              "workloads": ["mask2former-swinb-copy-64"]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))

    bench = bh.Bench(str(tmp_path))
    cell = bench.cell("mask2former-swinb-copy-64")
    assert bench.config(cell["config"])["name"] == "mask2former-swinb-copy"
    tr = bench.traffic(cell["traffic"])
    assert tr["distinct_frames"] == 64
    assert hasattr(bench.driver(tr), "Cell")
    assert hasattr(bench.reference(cell["config"]), "mask_reference")
    names = [m["name"] for m in bench.metrics(cell["name"], trace=True)]
    assert names == ["masks.units_per_s"]
    assert bench.reader("masks.units_per_s")(
        {"steps": 10, "window_s": 4.0}) == 2.5
    e2e = [m["name"] for m in bench.metrics(cell["name"], trace=False)]
    assert e2e == ["setup_s"]


TRAIN = "monodetr-kitti-train-b16"
TRAIN_LAYERS = ["train.loader_wait_ms", "train.mfu_pct",
                "train.msda_fwd_roofline", "train.msda_bwd_roofline",
                "train.device_idle_pct"]


def test_pending_cells_enter_by_entries_alone(tmp_path):
    """The hand-off of a held-back cell, rehearsed on a copy: its
    configuration, cell, end-to-end and per-layer entries copied from
    ``pending/`` into BENCHMARK.json, with no benchmark file edited and the
    pending file left in place, give a benchmark that keeps the contract, finds every file it
    names, finds the cell without ``pending`` and reports its metrics; the
    pending file then adds nothing."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert bh.pending_entries(str(tmp_path / "benchmark"))
    json.dump(bh.Bench(pending=True).spec,
              open(tmp_path / "BENCHMARK.json", "w"), indent=1)
    root = str(tmp_path)

    _keeps_the_contract(root)
    bench = bh.Bench(root)
    _names_existing_files(bench, root)
    assert bh.Bench(root, pending=True).spec == bench.spec
    _names_once(bench.spec)
    assert bench.cell(TRAIN)["chips"] == 1
    assert [m["name"] for m in bench.metrics(TRAIN, False)] == \
        ["setup_s", "train_images_per_s"]
    assert [m["name"] for m in bench.metrics(TRAIN, True)] == TRAIN_LAYERS
    assert [m["name"] for m in bench.metrics("mask2former-swinb-masks",
                                             False)] == \
        ["mask_frames_per_s", "setup_s"]


def test_a_metric_naming_a_held_back_cell_breaks_the_contract(tmp_path):
    """A metric may name only cells of its own BENCHMARK.json: the train
    cell's rate copied in without its cell is refused."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = bh.Bench().spec
    spec["end_to_end"] += bh.Bench(pending=True).spec["end_to_end"][
        len(spec["end_to_end"]):]
    assert spec["end_to_end"][-1]["workloads"] == [TRAIN]
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"), indent=1)
    with pytest.raises(AssertionError):
        _keeps_the_contract(str(tmp_path))


def test_pending_merge_names_each_entry_once():
    """``Bench(pending=True)`` lists each configuration, cell and metric
    once, whichever side holds the held-back cell; ``pending=False`` reads
    BENCHMARK.json alone, and the mask cell never reports the train
    cell's rate."""
    merged = bh.Bench(pending=True)
    _names_once(merged.spec)
    assert merged.cell(TRAIN)["config"] == "monodetr-kitti"
    assert bh.Bench().spec == json.load(open(os.path.join(ROOT,
                                                          "BENCHMARK.json")))
    for bench in (bh.Bench(), merged):
        names = [m["name"] for m in
                 bench.metrics("mask2former-swinb-masks", False)]
        assert names == ["mask_frames_per_s", "setup_s"]
    assert [m["name"] for m in merged.metrics(TRAIN, False)] == \
        ["setup_s", "train_images_per_s"]
    assert [m["name"] for m in merged.metrics(TRAIN, True)] == TRAIN_LAYERS


def test_control_resolves_the_pending_train_cell():
    """``control.py --pending 1`` finds the train cell's configuration,
    traffic and controls, then, on a machine without a card, stops."""
    control = bh.load_module(os.path.join(HERE, "control.py"),
                             "bench_control_module")
    cell, config, traffic, controls = control.resolve(
        bh.Bench(pending=True), TRAIN)
    assert cell["name"] == TRAIN and config["name"] == cell["config"]
    assert traffic["driver"] == "detector_train" and callable(controls)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "control.py"), "--workload",
         TRAIN, "--seeds", "1", "--pending", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "no CUDA card" in out.stderr and out.stdout.strip() == ""


def _names_once(spec):
    for key in bh.SPEC_LISTS:
        names = [e["name"] for e in spec[key]]
        assert len(set(names)) == len(names), (key, names)
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_every_named_file_exists():
    _names_existing_files(bh.Bench(pending=True), ROOT)


def _names_existing_files(bench, root):
    spec = bench.spec
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(root, c["file"]))
        assert os.path.isfile(os.path.join(bench.dir, "references",
                                           c["name"] + ".py"))
    for w in spec["workloads"]:
        tr = bench.traffic(w["traffic"])
        assert os.path.isfile(os.path.join(bench.dir, "drivers",
                                           tr["driver"] + ".py"))
        assert os.path.isfile(os.path.join(bench.dir, "checks",
                                           w["name"] + ".json"))
        assert any(m["name"] == "setup_s"
                   for m in bench.metrics(w["name"], False))
        assert len(bench.metrics(w["name"], False)) >= 2
        assert bench.metrics(w["name"], True)
        assert callable(bench.driver(tr).controls)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_forbidden_modules_compare_whole_names():
    names = ["monosowa_tpu_torch", "monosowa_tpu_torch.ops.msda", "numpy",
             "jaxtyping", "flaxen", "jax", "jax.numpy", "jaxlib.xla",
             "flax.linen", "optax", "monosowa_tpu", "monosowa_tpu.models"]
    assert bh.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "optax",
         "monosowa_tpu", "monosowa_tpu.models"])


def test_a_run_loads_no_jax():
    """Importing the harness, the drivers, the references and the port's
    modules a run uses loads none of the forbidden modules."""
    code = (
        "import sys; sys.path[:0] = [{h!r}, {r!r}]\n"
        "import bench_harness as bh\n"
        "b = bh.Bench(pending=True)\n"
        "for w in b.spec['workloads']:\n"
        "    b.driver(b.traffic(w['traffic'])); b.reference(w['config'])\n"
        "import monosowa_tpu_torch.train.trainer, "
        "monosowa_tpu_torch.data.loader, "
        "monosowa_tpu_torch.data.kitti_dataset, "
        "monosowa_tpu_torch.models.monodetr, "
        "monosowa_tpu_torch.sowa.masks, "
        "monosowa_tpu_torch.models.mask2former, monosowa_tpu_torch.convert\n"
        "print(bh.forbidden_modules())\n").format(h=HERE, r=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "mask2former-swinb-masks", "--seed", "3000000000123",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_benchmark_json_keeps_the_contract():
    _keeps_the_contract(ROOT)


def _keeps_the_contract(root):
    import re

    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) < 64 * 1024
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(spec["paths"][0] + "/")
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert name.match(w["traffic"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and unit.match(m["unit"])
        for w in m.get("workloads", cells):
            assert w in e2e[m["moves"]].get("workloads", cells)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names) and all(map(name.match, names))
    # every cell a metric names is a cell of this BENCHMARK.json: a cell
    # held in pending/ is no cell of it, so its metrics wait there with it
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells), m
