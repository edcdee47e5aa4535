"""The port's KITTI AP stack against the JAX package's: the native library
(the port's own copy of the source, built at first use), the torch polygon
clipping of the python route, AP_R40 / AP11 by difficulty and by distance,
and the ``evaluate`` CLI.

Tolerances: the two native libraries come from one source, so their
results are equal; rotated intersections in float32, torch against JAX,
1e-5 (the 3D-IoU bar of tests/test_torch_geometry_box3d.py) and against
the float64 native overlap 1e-4 (tests/test_native_eval.py:26); AP 1e-6
(tests/test_eval_reference_parity.py:155)."""

import json
import os

import numpy as np
import pytest

from monosowa_tpu.evalkitti import eval as jax_eval
from monosowa_tpu.evalkitti import evaluate as jax_evaluate
from monosowa_tpu.evalkitti import native as jax_native
from monosowa_tpu_torch.evalkitti import eval as port_eval
from monosowa_tpu_torch.evalkitti import evaluate as port_evaluate
from monosowa_tpu_torch.evalkitti import native as port_native
from monosowa_tpu_torch.ops import _build

NAMES = np.array(["Car", "Car", "Car", "Van", "Pedestrian", "Cyclist",
                  "Person_sitting", "Truck", "DontCare"])
THRESHOLDS = (0.7, 0.5, 0.25)


def _boxes5(n, rng):
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(5, 50, n),
                     rng.uniform(2, 5, n), rng.uniform(1, 2.5, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


def _boxes7(n, rng):
    return np.stack([rng.uniform(-20, 20, n), rng.uniform(0.5, 2, n),
                     rng.uniform(5, 50, n), rng.uniform(2, 5, n),
                     rng.uniform(1.2, 2, n), rng.uniform(1, 2.5, n),
                     rng.uniform(-np.pi, np.pi, n)], 1)


def _near(boxes, rng, scale=0.5):
    out = boxes.copy()
    out[:, :2] += rng.normal(0, scale, (len(boxes), 2))
    out[:, -1] += rng.normal(0, 0.1, len(boxes))
    return out


def _gt_obj(rng):
    name = str(NAMES[rng.integers(len(NAMES))])
    h_px = rng.uniform(12.0, 140.0)              # straddles MIN_HEIGHT 40/25
    x1, y1 = rng.uniform(0, 1100), rng.uniform(0, 300)
    big = name in ("Car", "Van", "Truck")
    dims = (rng.uniform([3.2, 1.4, 1.5], [5.2, 2.0, 1.9]) if big
            else rng.uniform([0.4, 1.5, 0.4], [1.8, 1.9, 0.9]))   # (l, h, w)
    return {"name": name, "trunc": float(rng.uniform(0.0, 0.65)),
            "occ": int(rng.integers(0, 4)),
            "alpha": float(rng.uniform(-np.pi, np.pi)),
            "bbox": np.array([x1, y1, x1 + h_px * rng.uniform(0.6, 2.2),
                              y1 + h_px]),
            "dims": dims,
            "loc": np.array([rng.uniform(-20, 20), rng.uniform(0.5, 2.5),
                             rng.uniform(5, 68)]),
            "rot": float(rng.uniform(-np.pi, np.pi)), "score": 0.0}


def _det_of(rng, gt):
    o = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in gt.items()}
    s = 0.2 if rng.uniform() < 0.5 else 1.0      # near-exact and loose
    o["bbox"] = gt["bbox"] + rng.normal(0, 6.0 * s, 4)
    o["loc"] = gt["loc"] + rng.normal(0, 0.35 * s, 3)
    o["dims"] = gt["dims"] * rng.uniform(1 - 0.08 * s, 1 + 0.08 * s, 3)
    o["rot"] = gt["rot"] + float(rng.normal(0, 0.12 * s))
    o["alpha"] = gt["alpha"] + float(rng.normal(0, 0.15 * s))
    o["trunc"], o["occ"] = -1.0, -1.0
    o["score"] = float(rng.uniform(0.05, 1.0))
    if rng.uniform() < 0.08:                     # class confusions
        o["name"] = str(NAMES[rng.integers(len(NAMES) - 1)])
    return o


def _line(o, with_score):
    l, h, w = o["dims"]
    vals = [o["trunc"], o["occ"], o["alpha"], *o["bbox"], h, w, l, *o["loc"],
            o["rot"]] + ([o["score"]] if with_score else [])
    return o["name"] + " " + " ".join(f"{v:.4f}" for v in vals)


def write_annos(root, n_frames, seed, same_counts=False):
    """``gt`` and ``pred`` label dirs under ``root``: perturbed GT with
    scores, class confusions, pure false positives, DontCare, Van, small
    boxes; frame 0 has no GT, frame 1 no detections, frame 2 no file.
    ``same_counts`` gives every frame 5 GT rows (one of them DontCare) and
    5 detections instead, so that the JAX package's python route compiles
    its overlap for one shape."""
    rng = np.random.default_rng(seed)
    gt_dir, dt_dir = os.path.join(root, "gt"), os.path.join(root, "pred")
    os.makedirs(gt_dir), os.makedirs(dt_dir)
    for f in range(n_frames):
        if same_counts:
            gts = []
            while len(gts) < 4:
                gts += [g for g in [_gt_obj(rng)] if g["name"] != "DontCare"]
            gts.append({**_gt_obj(rng), "name": "DontCare"})
        else:
            gts = [] if f == 0 else [_gt_obj(rng)
                                     for _ in range(rng.integers(1, 8))]
        dts = []
        if f != 1 or same_counts:
            dts = [_det_of(rng, g) for g in gts
                   if g["name"] != "DontCare"
                   and (same_counts or rng.uniform() < 0.8)]
            for _ in range(1 if same_counts else rng.integers(0, 3)):
                fp = _gt_obj(rng)
                fp["name"] = "Car" if fp["name"] == "DontCare" else fp["name"]
                fp["score"] = float(rng.uniform(0.05, 1.0))
                dts.append(fp)
        with open(os.path.join(gt_dir, f"{f:06d}.txt"), "w") as fh:
            fh.write("".join(_line(o, False) + "\n" for o in gts))
        if f != 2 or same_counts:
            with open(os.path.join(dt_dir, f"{f:06d}.txt"), "w") as fh:
                fh.write("".join(_line(o, True) + "\n" for o in dts))
    ids = [f"{f:06d}" for f in range(n_frames)]
    return gt_dir, dt_dir, ids


@pytest.fixture(scope="module")
def label_dirs(tmp_path_factory):
    return write_annos(str(tmp_path_factory.mktemp("annos")), 60, 20240816)


def _assert_same_ap(got, want, atol=1e-6):
    assert list(got) == list(want)
    worst = 0.0
    for key in want:
        for kind in ("ap40", "ap11"):
            np.testing.assert_allclose(got[key][kind], want[key][kind],
                                       rtol=0, atol=atol, err_msg=key)
            worst = max(worst, float(np.abs(
                np.subtract(got[key][kind], want[key][kind])).max()))
        assert got[key]["min_overlap"] == want[key]["min_overlap"]
    return worst


def test_library_is_built_from_the_ports_own_source():
    port_native.build()
    path = _build._lib_path(port_native.LIBRARY, port_native.CSRC)
    assert os.path.isfile(path)
    assert os.path.join("build", "monosowa_tpu_torch") in path
    assert port_native.CSRC.endswith(
        os.path.join("monosowa_tpu_torch", "evalkitti", "csrc"))
    # the same algorithms as the JAX package's source: equal but for comments
    def code(p):
        with open(p) as f:
            return [ln.split("//")[0].rstrip() for ln in f
                    if ln.split("//")[0].strip()]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert code(os.path.join(port_native.CSRC, "eval_kernels.cpp")) == code(
        os.path.join(root, "native", "eval_kernels.cpp"))


def test_build_failure_raises_with_the_compilers_output(tmp_path):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="error"):
        _build.build("broken", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _build.build("absent", str(tmp_path))


def test_a_built_library_keeps_its_compilers_output(tmp_path):
    # the output (for nvcc the ptxas register and spill counts) is given
    # again by a later call that finds the library built
    (tmp_path / "noisy_lib.cpp").write_text(
        '#warning "built from noisy_lib"\nextern "C" int f() { return 1; }\n')
    first = _build.build("noisy_lib", str(tmp_path))
    assert "built from noisy_lib" in first
    assert _build.build("noisy_lib", str(tmp_path)) == first
    path = _build._lib_path("noisy_lib", str(tmp_path))
    assert os.path.isfile(path) and os.path.isfile(path + ".log")
    assert _build.load_library("noisy_lib", str(tmp_path)).f() == 1


@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_native_overlaps_equal_the_jax_packages(criterion):
    rng = np.random.default_rng(criterion + 5)
    a5, a7 = _boxes5(14, rng), _boxes7(11, rng)
    b5, b7 = _near(a5, rng)[:9], _near(a7, rng)
    np.testing.assert_array_equal(
        port_native.rotated_overlap(a5, b5, criterion),
        jax_native.rotated_overlap(a5, b5, criterion))
    np.testing.assert_array_equal(
        port_native.d3_overlap(a7, b7, criterion),
        jax_native.d3_overlap(a7, b7, criterion))
    assert port_native.rotated_overlap(a5, b5, criterion).max() > 0.3
    assert port_native.d3_overlap(a7[:0], b7).shape == (0, 11)


def _stat_case(rng, num_gt=8, num_dt=12):
    overlaps = rng.uniform(0, 1, (num_dt, num_gt))
    gt_datas = np.concatenate([rng.uniform(0, 300, (num_gt, 4)),
                               rng.uniform(-np.pi, np.pi, (num_gt, 1))], 1)
    dt_datas = np.concatenate([rng.uniform(0, 300, (num_dt, 4)),
                               rng.uniform(-np.pi, np.pi, (num_dt, 1)),
                               rng.uniform(0, 1, (num_dt, 1))], 1)
    ignored_gt = rng.choice([-1, 0, 1], num_gt).astype(np.int64)
    ignored_det = rng.choice([-1, 0, 1], num_dt).astype(np.int64)
    dc = rng.uniform(0, 300, (2, 4))
    dc[:, 2:] = dc[:, :2] + rng.uniform(10, 100, (2, 2))
    return overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("compute_fp", [False, True])
def test_native_statistics_equal_the_jax_packages_and_the_oracle(seed,
                                                                 compute_fp):
    case = _stat_case(np.random.default_rng(seed))
    for thresh in (0.0, 0.5):
        kw = dict(metric=0, min_overlap=0.5, thresh=thresh,
                  compute_fp=compute_fp, compute_aos=True)
        got = port_native.compute_statistics(*case, **kw)
        want = jax_native.compute_statistics(*case, **kw)
        oracle = port_eval.compute_statistics(*case, **kw)
        assert got[:4] == want[:4]
        np.testing.assert_array_equal(got[4], want[4])
        assert got[:3] == oracle[:3]
        assert got[3] == pytest.approx(oracle[3], abs=1e-9)
        np.testing.assert_allclose(got[4], oracle[4])


def test_native_accumulate_pr_equals_the_jax_packages():
    case = _stat_case(np.random.default_rng(42), num_gt=10, num_dt=15)
    thresholds = np.linspace(0.1, 0.9, 7)
    got, want = np.zeros((7, 4)), np.zeros((7, 4))
    port_native.accumulate_pr(*case, metric=0, min_overlap=0.5,
                              thresholds=thresholds, compute_aos=True, pr=got)
    jax_native.accumulate_pr(*case, metric=0, min_overlap=0.5,
                             thresholds=thresholds, compute_aos=True, pr=want)
    np.testing.assert_array_equal(got, want)
    assert got[:, 0].sum() > 0
    with pytest.raises(ValueError):
        port_native.accumulate_pr(*case, metric=0, min_overlap=0.5,
                                  thresholds=thresholds, compute_aos=True,
                                  pr=np.zeros((7, 4), np.float32))


def test_torch_bev_inter_matches_jax_and_native():
    rng = np.random.default_rng(0)
    a = _boxes5(12, rng)
    b = np.concatenate([_near(a, rng)[:7], _boxes5(3, rng), a[:1]])
    got = port_eval._torch_bev_inter(a, b)
    want = jax_eval._jax_bev_inter(a, b)
    err = float(np.abs(got - want).max())
    print(json.dumps({"test": "torch_bev_inter", "max_abs_diff_vs_jax": err,
                      "max_area": float(want.max())}))
    assert got.dtype == np.float64 and got.shape == (12, 11)
    assert want.max() > 3 and err <= 1e-5 * max(1.0, float(want.max()))
    np.testing.assert_allclose(port_eval.bev_box_overlap(a, b),
                               port_native.rotated_overlap(a, b), atol=1e-4)
    a7 = _boxes7(10, rng)
    b7 = _near(a7, rng)
    np.testing.assert_allclose(port_eval.d3_box_overlap(a7, b7),
                               jax_eval.d3_box_overlap(a7, b7), atol=1e-5)
    np.testing.assert_allclose(port_eval.d3_box_overlap(a7, b7),
                               port_native.d3_overlap(a7, b7), atol=1e-4)
    assert port_eval._torch_bev_inter(a[:0], b).shape == (0, 11)


@pytest.mark.parametrize("by_distance", [False, True],
                         ids=["official", "distance"])
def test_ap_matches_jax_on_the_native_route(label_dirs, by_distance):
    gt_dir, dt_dir, ids = label_dirs
    gt = port_eval.annos_from_label_dir(gt_dir, ids)
    dt = port_eval.annos_from_label_dir(dt_dir, ids)
    jgt = jax_eval.annos_from_label_dir(gt_dir, ids)
    jdt = jax_eval.annos_from_label_dir(dt_dir, ids)
    for a, b in zip(gt + dt, jgt + jdt):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert jax_native.available()
    if by_distance:
        got = port_eval.get_distance_eval_result(gt, dt, (0, 1, 2), True)
        want = jax_eval.get_distance_eval_result(jgt, jdt, (0, 1, 2), True)
    else:
        got = port_eval.get_official_eval_result(gt, dt, (0, 1, 2), True)
        want = jax_eval.get_official_eval_result(jgt, jdt, (0, 1, 2), True)
    worst = _assert_same_ap(got, want)
    aps = np.array([v["ap40"] for v in want.values()])
    print(json.dumps({"test": f"ap_native[distance={by_distance}]",
                      "max_abs_diff_vs_jax": worst,
                      "ap40_range": [float(aps.min()), float(aps.max())]}))
    assert 1 < aps.max() < 99           # mid-range APs, not all 0 or 100


def test_ap_matches_jax_on_the_python_route(tmp_path, monkeypatch):
    """``use_native=False`` against the JAX package with its library
    switched off: float32 polygon clipping in both, so a pair of boxes
    whose overlap lies within rounding of a threshold could be matched in
    one and not in the other; the set keeps every overlap 1e-3 clear."""
    gt_dir, dt_dir, ids = write_annos(str(tmp_path), 6, 7, same_counts=True)
    gt = port_eval.annos_from_label_dir(gt_dir, ids)
    dt = port_eval.annos_from_label_dir(dt_dir, ids)
    for metric in (1, 2):
        for ov in port_eval._overlaps(gt, dt, metric):
            gaps = np.abs(ov[..., None] - np.array(THRESHOLDS))
            assert gaps.min(initial=1.0) > 1e-3
    monkeypatch.setattr(jax_native, "available", lambda: False)
    want = jax_eval.get_official_eval_result(gt, dt, (0,))
    monkeypatch.undo()

    def no_native(*a, **k):
        raise AssertionError("the python route reached the native library")

    for name in ("rotated_overlap", "d3_overlap", "compute_statistics",
                 "accumulate_pr"):
        monkeypatch.setattr(port_native, name, no_native)
    got = port_eval.get_official_eval_result(gt, dt, (0,), use_native=False)
    monkeypatch.undo()
    worst = _assert_same_ap(got, want)
    native = port_eval.get_official_eval_result(gt, dt, (0,))
    print(json.dumps({"test": "ap_python_route", "max_abs_diff_vs_jax": worst,
                      "max_abs_diff_vs_native_route":
                          _assert_same_ap(got, native)}))
    assert max(max(v["ap40"]) for v in want.values()) > 1


def test_native_route_never_takes_the_python_route(label_dirs, monkeypatch):
    gt_dir, dt_dir, ids = label_dirs
    gt = port_eval.annos_from_label_dir(gt_dir, ids[:10])
    dt = port_eval.annos_from_label_dir(dt_dir, ids[:10])

    def no_python(*a, **k):
        raise AssertionError("the native route fell back to python")

    monkeypatch.setattr(port_eval, "compute_statistics", no_python)
    monkeypatch.setattr(port_eval, "_torch_bev_inter", no_python)
    res = port_eval.get_official_eval_result(gt, dt, (0,))
    assert set(res) == {f"car_{m}_{s}" for m in ("bbox", "bev", "3d")
                        for s in ("strict", "loose")}


@pytest.mark.parametrize("distance", [False, True])
def test_evaluate_cli_prints_the_jax_packages_block(label_dirs, capsys,
                                                    distance):
    gt_dir, dt_dir, _ = label_dirs
    argv = [gt_dir, dt_dir, "--classes", "0", "1"] + (
        ["--distance"] if distance else [])
    port_evaluate.main(argv)
    got = capsys.readouterr().out
    jax_evaluate.main(argv)
    want = capsys.readouterr().out
    assert got == want
    assert got.count("AP_R40") == 12 and "car_3d_strict AP@0.70" in got
