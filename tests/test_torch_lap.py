"""The port's assignment solvers (``monosowa_tpu_torch/ops/lap.py``) and the
matcher's backends against the JAX package's.

The plain JV and auction solvers must give the JAX solvers' assignments
exactly, problem for problem, on the matrices of
tests/test_matcher_criterion.py and on tie cases (duplicated rows and
columns, constant matrices, all-BIG padding columns); JV's total cost must
equal scipy's optimum within rel 1e-6 / abs 1e-5
(tests/test_matcher_criterion.py:46-47).  The CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from monosowa_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from monosowa_tpu.models.matcher import hungarian_match as jax_match
from monosowa_tpu.ops import lap as jax_lap
from monosowa_tpu_torch.models import matcher
from monosowa_tpu_torch.models.matcher import MatcherConfig, hungarian_match
from monosowa_tpu_torch.ops import lap
from monosowa_tpu_torch.utils import timing

PAD = 1e6         # the matcher's cost of an invalid target column


def _matcher_test_cases():
    """(cost, m) pairs: the JV matrices of tests/test_matcher_criterion.py
    (25 draws of seed 5, 50 x 50, m in 1..50, scales 1e-2..1e2)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(25):
        m = int(rng.integers(1, 51))
        scale = 10 ** rng.uniform(-2, 2)
        out.append(((rng.normal(size=(50, 50)) * scale).astype(np.float32),
                    m))
    return out


def _tie_cases():
    """50 x 50 problems built to tie: duplicated columns and rows, a
    constant matrix, a zero matrix, costs rounded to one decimal, padding
    columns of the matcher's BIG, and m = 0 and m = M."""
    rng = np.random.default_rng(7)
    c = rng.normal(size=(50, 50)).astype(np.float32)
    dup = c.copy()
    dup[:, 10] = dup[:, 3]
    dup[:, 11] = dup[:, 3]
    dup[7] = dup[2]
    dup[40] = dup[2]
    padded = rng.normal(size=(50, 50)).astype(np.float32)
    padded[:, 12:] = PAD
    groups = np.tile(rng.normal(size=(10, 50)).astype(np.float32), (5, 1))
    return [(dup, 30), (np.ones((50, 50), np.float32), 50),
            (np.zeros((50, 50), np.float32), 17),
            (np.round(rng.normal(size=(50, 50)), 1).astype(np.float32), 50),
            (padded, 12), (groups, 20), (c, 0), (c, 50)]


def _batch(cases):
    cost = torch.from_numpy(np.stack([c for c, _ in cases]))
    return cost, torch.tensor([m for _, m in cases])


def _jax_each(solve, cases):
    return np.stack([np.asarray(solve(jnp.asarray(c), jnp.int32(m)))
                     for c, m in cases])


@pytest.fixture(scope="module")
def jv_cases():
    return _matcher_test_cases() + _tie_cases()


def test_plain_jv_equals_jax_jv(jv_cases):
    got = lap.solve_lap_jv(*_batch(jv_cases)).numpy()
    want = _jax_each(jax_lap.solve_lap_jv, jv_cases)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_plain_jv_reaches_scipys_optimum(jv_cases):
    got = lap.solve_lap_jv(*_batch(jv_cases)).numpy()
    for k, (cost, m) in enumerate(jv_cases):
        assert (got[k] >= 0).sum() == m, k
        assert set(got[k][got[k] >= 0]) == set(range(m)), k
        if m == 0:
            continue
        rows, cols = linear_sum_assignment(cost[:, :m].astype(np.float64))
        sel = np.where(got[k] >= 0)[0]
        val = cost[sel, got[k][sel]].astype(np.float64).sum()
        opt = cost[rows, cols].astype(np.float64).sum()
        assert val == pytest.approx(opt, rel=1e-6, abs=1e-5), k


def test_plain_auction_equals_jax_auction():
    """The near-optimality matrices of tests/test_matcher_criterion.py
    (12 x 7, seed 2), DETR-sized problems and the tie cases."""
    rng = np.random.default_rng(2)
    small = [(rng.normal(size=(12, 7)).astype(np.float32), 7)
             for _ in range(3)]
    got = lap.solve_lap_auction(*_batch(small)).numpy()
    np.testing.assert_array_equal(
        got, _jax_each(jax_lap.solve_lap_auction, small))
    for k, (cost, m) in enumerate(small):
        rows, cols = linear_sum_assignment(cost)
        sel = np.where(got[k] >= 0)[0]
        assert len(sel) == m
        opt = cost[rows, cols].sum()
        assert cost[sel, got[k][sel]].sum() <= opt + 0.05 * max(1.0,
                                                                abs(opt))
    big = _matcher_test_cases()[:8] + _tie_cases()
    np.testing.assert_array_equal(
        lap.solve_lap_auction(*_batch(big)).numpy(),
        _jax_each(jax_lap.solve_lap_auction, big))


def test_host_solver_equals_scipy_and_jax():
    rng = np.random.default_rng(0)
    cases = [(rng.normal(size=(10, 6)).astype(np.float32), m)
             for m in (6, 3, 0)]
    got = lap.solve_lap_host(*_batch(cases)).numpy()
    np.testing.assert_array_equal(
        got, _jax_each(jax_lap.solve_lap_host, cases))
    rows, cols = linear_sum_assignment(cases[0][0])
    np.testing.assert_array_equal(got[0, rows], cols)


@pytest.mark.parametrize("solve", [lap.solve_lap_jv, lap.solve_lap_auction],
                         ids=["jv", "auction"])
def test_batched_call_equals_per_problem_calls(solve):
    """A problem's answer does not depend on the others of its batch (a
    batch runs until its slowest problem stops; the others are frozen)."""
    cases = _matcher_test_cases()[:6] + _tie_cases()[:4]
    cost, m = _batch(cases)
    batched = solve(cost, m)
    for k in range(len(cases)):
        np.testing.assert_array_equal(batched[k:k + 1].numpy(),
                                      solve(cost[k:k + 1], m[k:k + 1]))


@pytest.mark.parametrize("m", [0, 8])
def test_no_column_and_every_column(m):
    rng = np.random.default_rng(3)
    cost = torch.from_numpy(rng.normal(size=(3, 10, 8)).astype(np.float32))
    counts = torch.full((3,), m)
    for solve in (lap.solve_lap_jv, lap.solve_lap_auction,
                  lap.solve_lap_host):
        got = solve(cost, counts).numpy()
        assert ((got >= 0).sum(1) == m).all()
        for row in got:
            assert sorted(row[row >= 0]) == list(range(m))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    cases = _tie_cases()
    cost, m = _batch(cases)
    names = ("lap.jv_launches", "lap.auction_launches")
    before = [timing.counter(n) for n in names]
    np.testing.assert_array_equal(lap.lap_jv(cost, m),
                                  lap.solve_lap_jv(cost, m))
    np.testing.assert_array_equal(lap.lap_auction(cost, m),
                                  lap.solve_lap_auction(cost, m))
    assert [timing.counter(n) for n in names] == before


def test_solvers_reject_what_they_do_not_take():
    cost = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError):
        lap.lap_jv(cost[0], torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        lap.lap_jv(cost.double(), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        lap.lap_jv(cost, torch.zeros(2))
    with pytest.raises(ValueError):
        lap.lap_auction(torch.zeros(2, 4, 5), torch.zeros(2, dtype=int))
    with pytest.raises(ValueError):
        MatcherConfig(backend="hungarian")


def test_more_valid_columns_than_rows_solves_the_first_q():
    """The one departure (ops/lap.py docstring): m > Q is solved over the
    first Q columns, as every valid row then holds one of them."""
    rng = np.random.default_rng(4)
    cost = torch.from_numpy(rng.normal(size=(1, 4, 6)).astype(np.float32))
    got = lap.solve_lap_jv(cost, torch.tensor([6]))
    want = lap.solve_lap_jv(cost, torch.tensor([4]))
    np.testing.assert_array_equal(got, want)
    assert sorted(got[0].tolist()) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# the matcher's backends
# ---------------------------------------------------------------------------

def _match_inputs(seed, b=2, q=20, g=3, m=8):
    """Random predictions of g groups of q queries against m padded targets
    (the first 2-5 valid, one hole), and a planted duplicate group, so that
    Group-DETR's near-equal queries tie."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, g * q, 3)).astype(np.float32)
    boxes = (1 / (1 + np.exp(-rng.normal(size=(b, g * q, 6))))).astype(
        np.float32)
    logits[:, q:2 * q] = logits[:, :q]
    boxes[:, q:2 * q] = boxes[:, :q]
    tboxes = np.zeros((b, m, 6), np.float32)
    tboxes[..., :2] = rng.uniform(0.2, 0.8, (b, m, 2))
    tboxes[..., 2:] = rng.uniform(0.02, 0.15, (b, m, 4))
    labels = rng.integers(0, 3, (b, m)).astype(np.int32)
    valid = np.zeros((b, m), bool)
    valid[0, :5] = True
    valid[1, :2] = True
    valid[1, 3] = True                      # a hole: counts, not positions
    return logits, boxes, labels, tboxes, valid, q


@pytest.mark.parametrize("backend", ["host", "jv", "auction"])
@pytest.mark.parametrize("seed", [0, 1])
def test_hungarian_match_backends_equal_jax(backend, seed):
    logits, boxes, labels, tboxes, valid, q = _match_inputs(seed)
    g = logits.shape[1] // q
    want = np.asarray(jax_match(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(tboxes), jnp.asarray(valid),
        JaxMatcherConfig(backend=backend), g, q))
    got = hungarian_match(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(tboxes),
        torch.from_numpy(valid), MatcherConfig(backend=backend), q)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


_HOST_CALLS = {"cpu", "numpy", "item", "tolist", "solve_lap_host"}


def _calls(fn):
    """Names of the attributes and functions ``fn``'s body calls."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            out.add(f.attr if isinstance(f, ast.Attribute) else
                    getattr(f, "id", ""))
    return out


def test_device_route_copies_nothing_to_the_host():
    """With ``jv`` and ``auction`` the match stays on the predictions'
    device: neither ``hungarian_match``'s own body, the cost matrix, the
    wrappers nor their launches call ``.cpu()``, ``.numpy()``, ``.item()``
    or ``.tolist()`` (the host route is a separate function that the
    backend table names, not calls).  On the card the smoke runs the match
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    for fn in (matcher.hungarian_match, matcher.cost_matrix, lap.lap_jv,
               lap.lap_auction, lap._launch_jv, lap._launch_auction,
               lap.auction_eps, lap._check_args):
        assert not _calls(fn) & _HOST_CALLS, fn.__name__
    assert {"cpu", "numpy"} <= _calls(lap.solve_lap_host)

