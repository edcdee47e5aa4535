"""The cell list of the coverage kernel (``csrc/tfl_counts.cu``) through its
numpy mirror in ``monosowa_tpu_torch/ops/tfl.py``: the grid rule
(``tfl_cell_plan``, ``cell_grid``) never puts a pair with float32
d2 < r^2 in cells that are not neighbours, and the walk (``cell_walk``)
counts what the plain version counts, and what the JAX package's function
and its Pallas kernel in interpret mode count.  Runs on the CPU."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from monosowa_tpu.ops import tfl as jtfl
from monosowa_tpu.ops.tfl_pallas import binary_both_way_counts_pallas
from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.sowa.templates import TemplateBank

R = 0.2


def _d2(t, q):
    """(T, S) float32 squared distances in the plain version's order."""
    d = t[:, None, :] - q[None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _plain_counts(scan, mask, templates):
    t_count, s_count = tfl.binary_both_way_counts_plain(
        torch.from_numpy(scan), torch.from_numpy(mask),
        torch.from_numpy(templates), R)
    return t_count.numpy().astype(np.int64), s_count.numpy().astype(np.int64)


def _car(seed, s=512, t=300, p=3, spread=0.0):
    """A noisy posed template and ground points as the fit sees them, and
    poses around it: scan (1, S, 3), mask (1, S), templates (1, P, T, 3)."""
    rng = np.random.default_rng(seed)
    tmpl = TemplateBank.default(num_points=t).points[0]
    n_car = min(t, s // 2)
    car = tmpl[:n_car] + rng.normal(scale=0.03, size=(n_car, 3))
    n_ground = s - n_car - 20
    ground = np.stack([rng.uniform(-4, 4, n_ground),
                       np.full(n_ground, 0.76),
                       rng.uniform(-4, 4, n_ground)], 1)
    scan = np.zeros((1, s, 3), np.float32)
    scan[0, :n_car + n_ground] = np.concatenate([car, ground])
    mask = np.zeros((1, s), bool)
    mask[0, :n_car + n_ground] = True
    mask[0, 5::31] = False
    poses = []
    for k in range(p):
        th = 0.2 * k
        c, sn = np.cos(th), np.sin(th)
        rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
        poses.append(tmpl @ rot.T + [0.05 * k, 0.0, -0.04 * k]
                     + rng.normal(scale=spread, size=tmpl.shape))
    return scan, mask, np.asarray(poses, np.float32)[None]


CASES = ["cell faces", "pairs at r", "coordinates near 1e3",
         "nan and 1e9 template rows", "scan in one cell",
         "box at the cell cap", "beyond the magnitude limit",
         "nan and inf scan points"]


def _adversarial(name):
    """(scan, mask, templates) of one adversarial case."""
    rng = np.random.default_rng(CASES.index(name))
    scan, mask, templates = _car(1)
    plan = tfl.tfl_cell_plan(scan.shape[1], R)
    if name == "cell faces":
        # scan and template points exactly on the grid's cell faces
        mode, lo, inv, n = tfl.cell_grid(templates, plan)
        c = np.float32(1) / inv[0, 0]
        k = rng.integers(1, 8, (200, 3)).astype(np.float32)
        faces = (lo[0, 0] + k * c).astype(np.float32)
        scan[0, :200] = faces
        templates[0, 0, :100] = faces[:100]
        templates[0, 1, :100] = faces[100:] + np.float32(c) * np.float32(
            0.5) * (rng.integers(0, 2, (100, 3)))
    elif name == "pairs at r":
        # scan points r away along one axis, and one float32 step nearer
        # or farther
        t = templates[0, 0, :150]
        q = t.copy()
        rows, axis = np.arange(150), rng.integers(0, 3, 150)
        sign = np.where(rng.random(150) < 0.5, 1, -1).astype(np.float32)
        q[rows, axis] += sign * np.float32(R)
        inward = t[rows, axis]
        outward = q[rows, axis] + sign
        q[rows[50:100], axis[50:100]] = np.nextafter(
            q[rows[50:100], axis[50:100]], inward[50:100])
        q[rows[100:], axis[100:]] = np.nextafter(
            q[rows[100:], axis[100:]], outward[100:])
        scan[0, :150] = q
        mask[0, :150] = True
    elif name == "coordinates near 1e3":
        shift = np.float32([-997.5, 1000.0, 999.25])
        scan = (scan + shift).astype(np.float32)
        templates = (templates + shift).astype(np.float32)
    elif name == "nan and 1e9 template rows":
        templates[0, 0, ::7] = np.nan
        templates[0, 1, 3, 1] = np.inf
        templates[0, 1, 10] = 1e9
        templates[0, 2, 11] = [-1e9, 0.0, 1e9]
    elif name == "scan in one cell":
        centre = templates[0, 0, 17]
        scan[0] = centre + rng.uniform(-0.05, 0.05, (scan.shape[1], 3))
        mask[0] = True
    elif name == "box at the cell cap":
        # a template 60 m across: c grows past c_min until the grid fits
        templates[0, 0] = rng.uniform(-30, 30, templates.shape[2:])
        scan[0, :256] = templates[0, 0, :256] + rng.normal(
            scale=0.1, size=(256, 3))
        templates[0, 1] = templates[0, 0] * np.float32([1, 0.01, 1])
    elif name == "beyond the magnitude limit":
        # one cell, every pair tested: coincident points at 1e35
        templates[0, 0, :5] = np.float32(1e35) * (1 + np.arange(5))[:, None]
        scan[0, :3] = templates[0, 0, :3]
        scan[0, 3] = [np.inf, 0.0, 0.0]
        mask[0, :4] = True
    elif name == "nan and inf scan points":
        scan[0, :40:3] = np.nan
        scan[0, 1:40:3, 2] = np.inf
    return scan.astype(np.float32), mask, templates.astype(np.float32)


@pytest.mark.parametrize("name", CASES)
def test_no_pair_within_r_leaves_the_neighbouring_cells(name):
    scan, mask, templates = _adversarial(name)
    plan = tfl.tfl_cell_plan(scan.shape[1], R)
    modes, los, invs, ns = tfl.cell_grid(templates, plan)
    r2 = np.float32(plan.r2)
    hits_seen = 0
    for p in range(templates.shape[1]):
        mode, lo, inv, n = modes[0, p], los[0, p], invs[0, p], ns[0, p]
        tmpl = templates[0, p]
        with np.errstate(invalid="ignore", over="ignore"):
            hit = (_d2(tmpl, scan[0]) < r2) & mask[0][None, :]
        ti, qi = np.nonzero(hit)
        hits_seen += len(ti)
        assert np.isfinite(tmpl[ti]).all() and np.isfinite(scan[0, qi]).all()
        cells = tfl.scan_cells(scan[0], mode, lo, inv, n)
        assert (cells[qi] >= 0).all(), f"{name}: a hit scan point unstaged"
        if mode == 2:
            continue
        assert mode == 1
        assert int(n.prod()) <= plan.cell_cap and (n <= plan.axis_max).all()
        fin = np.isfinite(tmpl).all(-1)
        tc = tfl.template_cells(tmpl, mode, lo, inv)
        assert (tc[fin] >= 1).all() and (tc[fin] <= n - 2).all()
        qc = np.floor(tfl.cell_coords(scan[0, qi], lo, inv)).astype(np.int64)
        assert (np.abs(tc[ti] - qc) <= 1).all(), f"{name}: pair dropped"
    assert hits_seen > 0
    t_count, s_count, pairs = tfl.cell_walk(scan, mask, templates, R)
    want_t, want_s = _plain_counts(scan, mask, templates)
    np.testing.assert_array_equal(t_count, want_t)
    np.testing.assert_array_equal(s_count, want_s)
    assert (pairs <= mask.sum() * templates.shape[2]).all()


def test_the_cases_reach_what_they_name():
    plan = tfl.tfl_cell_plan(512, R)
    modes, _, invs, ns = tfl.cell_grid(
        _adversarial("box at the cell cap")[2], plan)
    c = 1 / invs[0, 0]
    assert modes[0, 0] == 1 and c > 1.2 * plan.c_min
    assert ns[0, 0].prod() <= plan.cell_cap < ns[0, 0].prod() * 1.25 ** 3
    modes, _, _, _ = tfl.cell_grid(
        _adversarial("beyond the magnitude limit")[2], plan)
    assert list(modes[0]) == [2, 1, 1]
    scan, mask, templates = _adversarial("beyond the magnitude limit")
    t_count, s_count, _ = tfl.cell_walk(scan, mask, templates, R)
    assert t_count[0, 0] >= 3 and s_count[0, 0] >= 3
    # nothing finite: no grid, zero counts
    templates[0, 2] = np.nan
    modes, _, _, _ = tfl.cell_grid(templates, plan)
    assert modes[0, 2] == 0
    t_count, s_count, pairs = tfl.cell_walk(scan, mask, templates, R)
    assert t_count[0, 2] == s_count[0, 2] == pairs[0, 2] == 0


def test_plan_numbers():
    for s in (0, 512, 2048, tfl.S_MAX):
        plan = tfl.tfl_cell_plan(s, R)
        assert plan.r2 == np.float32(R * R)
        assert np.float32(plan.c_min) == plan.c_min
        assert plan.c_min >= np.sqrt(plan.r2) * (1 + tfl.CELL_EPS)
        assert 27 <= plan.cell_cap <= tfl.CELL_CAP
        assert 16 * s + 4 * (plan.cell_cap + 2) + tfl.SMEM_STATIC \
            <= tfl.SMEM_LIMIT
    assert tfl.tfl_cell_plan(2048, R).cell_cap == tfl.CELL_CAP
    with pytest.raises(ValueError, match="at most"):
        tfl.tfl_cell_plan(tfl.S_MAX + 1, R)
    # the structure the kernel takes by value, in its field order
    assert [f for f, _ in tfl.TflCellPlan._fields_] == [
        "r2", "c_min", "margin", "grow", "mag", "mag_limit", "cell_cap",
        "axis_max"]
    assert ctypes.sizeof(tfl.TflCellPlan) == 32


@pytest.mark.parametrize("seed", [0, 1])
def test_cell_walk_on_random_clouds_equals_plain(seed):
    rng = np.random.default_rng(seed)
    scan = rng.normal(scale=0.7, size=(2, 300, 3)).astype(np.float32)
    mask = rng.random((2, 300)) < 0.9
    templates = rng.normal(scale=0.7, size=(2, 4, 130, 3)).astype(np.float32)
    templates[:, 0, :60] = scan[:, :60] + rng.normal(scale=0.05,
                                                     size=(2, 60, 3))
    t_count, s_count, pairs = tfl.cell_walk(scan, mask, templates, R)
    want_t, want_s = _plain_counts(scan, mask, templates)
    np.testing.assert_array_equal(t_count, want_t)
    np.testing.assert_array_equal(s_count, want_s)
    assert (t_count[:, 0] > 40).all()
    assert (pairs < mask.sum(1)[:, None] * 130).all()


@pytest.mark.parametrize("b,p", [(2, 10), (1, 360)])
def test_cell_walk_on_the_smokes_inputs_matches_jax_and_pallas(b, p):
    """Cars as chip_smoke.py's check_tfl makes them (rescore-like and fine
    pass-like poses), at a small size: the walk, the plain version, the
    JAX package's function and K5 in interpret mode count alike, and the
    walk tests a small share of the pairs."""
    rng = np.random.default_rng(3)
    scan, mask, posed = (x.numpy() for x in chip_smoke.tfl_inputs(
        rng, b, p, torch.device("cpu"), t=200, s=512))
    t_count, s_count, pairs = tfl.cell_walk(scan, mask, posed, R)
    want_t, want_s = _plain_counts(scan, mask, posed)
    np.testing.assert_array_equal(t_count, want_t)
    np.testing.assert_array_equal(s_count, want_s)
    n_scan = np.maximum(mask.sum(1), 1)[:, None]
    for i in range(b):
        tf_x, sf_x = jtfl.binary_both_way_counts(
            jnp.asarray(scan[i]), jnp.asarray(mask[i]), jnp.asarray(posed[i]),
            R)
        np.testing.assert_allclose(t_count[i] / 200, np.asarray(tf_x),
                                   atol=1e-6)
        np.testing.assert_allclose(s_count[i] / n_scan[i], np.asarray(sf_x),
                                   atol=1e-6)
    k = min(p, 20)
    tf_p, sf_p = binary_both_way_counts_pallas(
        jnp.asarray(scan[0]), jnp.asarray(mask[0]), jnp.asarray(posed[0, :k]),
        R, interpret=True)
    np.testing.assert_allclose(t_count[0, :k] / 200, np.asarray(tf_p),
                               atol=1e-6)
    np.testing.assert_allclose(s_count[0, :k] / n_scan[0], np.asarray(sf_p),
                               atol=1e-6)
    assert t_count.max() > 100
    assert pairs.sum() * 5 < mask.sum(1)[:, None].sum() * p * 200
