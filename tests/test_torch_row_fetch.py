"""The port's windowed row fetch (plain version, the CPU route of
``row_fetch``) against the two TPU kernel bodies of the JAX package's
``tools/bench_gather_micro.py`` in interpret mode, and against the numpy
oracle of the tools.  bf16 -> f32 is exact and nothing is summed but zeros,
so the bar is equality."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from monosowa_tpu_torch.ops import row_fetch as rf          # noqa: E402
from tools import bench_gather_micro as jax_tool             # noqa: E402
from tools import bench_gather_micro_torch as tool           # noqa: E402

KERNELS = {"direct": jax_tool._kernel_gather,
           "staged": jax_tool._kernel_onehot}


def _jax_fetch(form, idx, bank_bf16, bq, block, k_win):
    """The TPU kernel body of ``form`` through ``pl.pallas_call`` in
    interpret mode, set up as ``tools/bench_gather_micro.py`` ``run`` does;
    idx (N,) is spread over the 128 lanes the TPU layout wants."""
    n, (t_total, d4) = len(idx), bank_bf16.shape
    nb = n // bq
    idx128 = np.broadcast_to(idx.reshape(n, 1), (n, 128)).copy()
    f = pl.pallas_call(
        functools.partial(KERNELS[form], bq=bq, d4=d4, k_win=k_win,
                          block=block),
        grid=(nb,),
        in_specs=[pl.BlockSpec((bq, 128), lambda i: (i, 0)),
                  pl.BlockSpec((t_total, d4), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((bq, d4), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * bq, d4), jnp.float32),
        interpret=True)
    return np.asarray(jax.jit(f)(idx128, bank_bf16))


def _case(name, t_total=2048, bq=64, n_blocks=6, d4=128):
    """idx (N,) int32 and bank (T, D) float32 for one case."""
    rng = np.random.default_rng(7)
    idx, bank = tool.make_inputs(bq, d4, t_total, n_blocks * bq, seed=3)
    if name == "outside":            # a quarter of the rows far from the rest
        far = rng.random(len(idx)) < 0.25
        idx[far] = rng.integers(0, t_total, int(far.sum()))
    elif name == "negative":         # negatives, also as a block's first row
        idx[rng.random(len(idx)) < 0.2] = -1
        idx[::bq] = -7
    elif name == "empty_block":      # block 2 holds no valid index
        idx[2 * bq:3 * bq] = -1
    return idx, bank


CASES = [
    # (case, t_total, block, k_win) for (direct, staged)
    ("full", 2048, (256, 4), (512, 2)),
    ("outside", 2048, (128, 2), (256, 2)),
    ("negative", 2048, (256, 4), (512, 2)),
    ("empty_block", 2048, (256, 4), (512, 2)),
    ("narrow_bank", 1024, (512, 4), (1024, 2)),   # T // block < k_win
]


@pytest.mark.parametrize("form", rf.FORMS)
@pytest.mark.parametrize("case,t_total,direct,staged", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_equals_jax_kernels_and_oracle(form, case, t_total, direct,
                                             staged):
    bq = 64
    block, k_win = direct if form == "direct" else staged
    idx, bank = _case(case, t_total, bq)
    bank_t = torch.from_numpy(bank).to(torch.bfloat16)
    got = rf.row_fetch(bank_t, torch.from_numpy(idx), bq, block, k_win,
                       form).numpy()
    want_jax = _jax_fetch(form, idx, jnp.asarray(bank).astype(jnp.bfloat16),
                          bq, block, k_win)
    want_np, cov = tool.oracle(idx, bank_t.float().numpy(), bq, block, k_win)
    assert got.dtype == np.float32 and got.shape == want_jax.shape
    print(json.dumps({"test": f"row_fetch[{form}-{case}]",
                      "coverage": float(cov.mean()),
                      "max_abs_diff_vs_jax":
                          float(np.abs(got - want_jax).max())}))
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    if case == "full":
        assert cov.all()
    elif case == "empty_block":
        assert not got[2 * bq:3 * bq].any() and cov.mean() > 0.8
    else:
        assert 0.05 < 1 - cov.mean() < 0.95 or case == "narrow_bank"


@pytest.mark.parametrize("form", rf.FORMS)
def test_float32_bank_and_default_windows(form):
    """An f32 bank comes back as it is; ``block`` and ``k_win`` default to
    the JAX tool's per form."""
    idx, bank = _case("outside", 4096, 256, 4)
    got = rf.row_fetch(torch.from_numpy(bank), torch.from_numpy(idx),
                       form=form).numpy()
    block, k_win = rf.window_params(form)
    assert (block, k_win) == ((256, 4) if form == "direct" else (512, 2))
    want_jax = _jax_fetch(form, idx, jnp.asarray(bank), 256, block, k_win)
    want_np, cov = tool.oracle(idx, bank, 256, block, k_win)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    assert 0 < cov.mean() < 1


def test_ragged_last_block_and_argument_checks():
    idx, bank = _case("outside", 1024, 64, 3)
    bank_t, idx_t = torch.from_numpy(bank), torch.from_numpy(idx)
    # 150 rows: two blocks of 64 and one of 22, whose window is its own
    got = rf.row_fetch(bank_t, idx_t[:150], 64, 128, 2).numpy()
    want, _ = tool.oracle(idx[:150], bank, 64, 128, 2)
    np.testing.assert_array_equal(got, want)
    assert rf.row_fetch(bank_t, idx_t[:0], 64).shape == (0, 128)
    # an index at or past T is in no window
    big = torch.tensor([1000, 1024, 5000], dtype=torch.int32)
    out = rf.row_fetch(bank_t, big, 4, 256, 4)
    assert out[0].equal(bank_t[1000]) and not out[1:].any()
    with pytest.raises(TypeError):
        rf.row_fetch(bank_t, idx_t.long(), 64)
    with pytest.raises(TypeError):
        rf.row_fetch(bank_t.double(), idx_t, 64)
    with pytest.raises(ValueError):
        rf.row_fetch(bank_t, idx_t, 64, form="onehot")
    with pytest.raises(ValueError):
        rf.row_fetch(bank_t[None], idx_t, 64)
    assert rf.launches == 0          # the CPU route launches nothing


@pytest.mark.parametrize("form", rf.FORMS)
def test_bank_that_is_no_multiple_of_block_follows_the_oracle(form):
    """T = 768 with chunks of 512 rows: the window's second chunk passes the
    end of the bank.  The port fetches bank[idx] there, as the oracle says;
    the TPU bodies slice ``block`` rows at a start that the interpreter
    clamps to T - block and so return other rows (printed, not held)."""
    t_total, bq, block, k_win = 768, 64, 512, 2
    rng = np.random.default_rng(0)
    idx = rng.integers(0, t_total, 4 * bq).astype(np.int32)
    bank = rng.standard_normal((t_total, 128)).astype(np.float32)
    bank_t = torch.from_numpy(bank).to(torch.bfloat16)
    got = rf.row_fetch(bank_t, torch.from_numpy(idx), bq, block, k_win,
                       form).numpy()
    want, cov = tool.oracle(idx, bank_t.float().numpy(), bq, block, k_win)
    np.testing.assert_array_equal(got, want)
    assert cov.all()
    jax_out = _jax_fetch(form, idx, jnp.asarray(bank).astype(jnp.bfloat16),
                         bq, block, k_win)
    print(json.dumps({"test": f"row_fetch[{form}-T768]",
                      "jax_rows_that_differ":
                          float((np.abs(jax_out - got).max(1) > 0).mean())}))


def test_tool_inputs_are_the_jax_tools():
    """``make_inputs`` repeats the draws of ``tools/bench_gather_micro.py``
    ``run`` (:68-74) at its shape."""
    bq, d4, t_total = 256, 128, 10240
    nb = t_total // bq
    rng = np.random.default_rng(0)
    centers = rng.integers(0, t_total - 600, nb)
    idx = (centers[:, None] + rng.integers(0, 500, (nb, bq))).astype(np.int32)
    idx = np.minimum(idx, t_total - 1).reshape(nb * bq)
    quad = rng.standard_normal((t_total, d4))
    got_idx, got_bank = tool.make_inputs(bq, d4, t_total)
    np.testing.assert_array_equal(got_idx, idx)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(got_bank).astype(jnp.bfloat16), np.float32),
        np.asarray(quad.astype(jnp.bfloat16), np.float32))
    assert np.array_equal(
        torch.from_numpy(got_bank).to(torch.bfloat16).float().numpy(),
        np.asarray(quad.astype(jnp.bfloat16), np.float32))


def test_tool_runs_the_plain_version_on_the_cpu(capsys):
    res = tool.main(["staged", "--cpu", "--t_total", "2048", "--reps", "1"])
    out = capsys.readouterr().out
    assert res["max_err"] == 0.0 and res["coverage"] == 1.0
    assert not res["on_card"] and res["block"] == 512 and res["k_win"] == 2
    assert res["bound_ms"] == pytest.approx(
        (2048 * 4 + 2048 * 128 * 2 + 2048 * 128 * 4) / 3.35e12 * 1e3)
    assert "staged: max err 0.0" in out and "host time" in out


@pytest.mark.parametrize("n,bq", [(10240, 256), (163200, 256), (1000, 100),
                                  (333, 7), (5, 256), (257, 256)])
def test_each_group_of_bq_rows_takes_its_own_window(n, bq):
    """``in_window`` and the CPU route of both forms at N that is and is
    not a multiple of bq: each group's window is reduced from that group's
    indices alone, as a loop over the groups computes it, and the rows are
    the numpy oracle's."""
    rng = np.random.default_rng(n)
    t_total, block, k_win = 4096, 256, 4
    idx = rng.integers(-50, t_total + 50, n).astype(np.int32)
    keep = np.zeros(n, bool)
    for g0 in range(0, n, bq):
        g = idx[g0:g0 + bq]
        lo = g[g >= 0].min() if (g >= 0).any() else rf.NO_INDEX
        base = min(max(lo // block, 0), max(t_total // block - k_win, 0))
        keep[g0:g0 + bq] = (g >= base * block) & (
            g < min((base + k_win) * block, t_total))
    want = rf.in_window(torch.from_numpy(idx), t_total, bq, block, k_win)
    np.testing.assert_array_equal(keep, want.numpy())
    bank = rng.standard_normal((t_total, 8)).astype(np.float32)
    oracle, _ = tool.oracle(idx, bank, bq, block, k_win)
    for form in rf.FORMS:
        got = rf.row_fetch(torch.from_numpy(bank), torch.from_numpy(idx), bq,
                           block, k_win, form)
        np.testing.assert_array_equal(got.numpy(), oracle)
