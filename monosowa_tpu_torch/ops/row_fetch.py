"""Windowed row fetch: the row gathers of deformable attention as a
micro-benchmark, in two forms of one function.

Counterpart of the TPU kernels of the JAX package's
``tools/bench_gather_micro.py`` (``_kernel_gather``, ``_kernel_onehot``).
For block i of ``bq`` consecutive output rows:

    lo     = the least index of the block that is >= 0 (2^30 if none)
    base   = clip(lo // block, 0, max(T // block - k_win, 0))
    window = bank rows [base * block, (base + k_win) * block)
    out[n] = float32(bank[idx[n]]) if idx[n] is in its block's window
             (and below T), else 0; a negative index is in no window.

``row_fetch`` launches the hand-written kernel ``csrc/row_fetch.cu`` for
CUDA tensors (``direct``: rows straight from global memory / L2; ``staged``:
the window staged through shared memory chunk by chunk) and runs the plain
version ``row_fetch_plain`` for CPU tensors.  There is no other path.
``launches`` counts kernel launches.

The TPU tool carries idx as (N, 128) int32 with 128 equal columns, a lane
layout of that machine; here idx is one int32 per row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

FORMS = ("direct", "staged")
# (block, k_win) of the TPU tool's gather and onehot bodies: the same
# 1024-row window, cut into other chunks
FORM_DEFAULTS = {"direct": (256, 4), "staged": (512, 2)}
NO_INDEX = 2 ** 30
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a Hopper block may have

# kernel launches of row_fetch (read and reset by callers that must show a
# run went through the kernel)
launches = 0


def window_params(form: str, block: Optional[int] = None,
                  k_win: Optional[int] = None) -> Tuple[int, int]:
    """(block, k_win) with the form's defaults filled in."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: want one of {FORMS}")
    d_block, d_k = FORM_DEFAULTS[form]
    return int(block or d_block), int(k_win or d_k)


def in_window(idx: torch.Tensor, t_total: int, bq: int, block: int,
              k_win: int) -> torch.Tensor:
    """(N,) bool: idx[n] lies in the window of its block of ``bq`` rows."""
    n = idx.shape[0]
    nb = -(-n // bq)
    padded = idx.new_full((nb * bq,), -1)
    padded[:n] = idx
    ii = padded.view(nb, bq).long()
    lo = torch.where(ii < 0, torch.full_like(ii, NO_INDEX), ii).min(1).values
    base = torch.div(lo, block, rounding_mode="floor").clamp(
        0, max(t_total // block - k_win, 0))
    w_lo = (base * block)[:, None]
    w_hi = ((base + k_win) * block)[:, None]
    return ((ii >= w_lo) & (ii < w_hi) & (ii < t_total)).view(-1)[:n]


def row_fetch_plain(bank: torch.Tensor, idx: torch.Tensor, bq: int,
                    block: int, k_win: int) -> torch.Tensor:
    """The plain version: bank (T, D), idx (N,) -> (N, D) float32.  Both
    forms compute this function."""
    t_total = bank.shape[0]
    keep = in_window(idx, t_total, bq, block, k_win)
    rows = bank.float()[idx.clamp(0, t_total - 1).long()]
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


def row_fetch(bank: torch.Tensor, idx: torch.Tensor, bq: int = 256,
              block: Optional[int] = None, k_win: Optional[int] = None,
              form: str = "direct") -> torch.Tensor:
    """bank (T, D) bfloat16 or float32, idx (N,) int32 -> (N, D) float32.

    ``form`` chooses the kernel (``direct`` or ``staged``) and the defaults
    of ``block`` and ``k_win``; the result does not depend on the form
    beyond that.  The CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    block, k_win = window_params(form, block, k_win)
    _check_args(bank, idx, bq, block, k_win)
    if bank.device.type == "cpu":
        return row_fetch_plain(bank, idx, bq, block, k_win)
    return _launch(bank.contiguous(), idx.contiguous(), bq, block, k_win,
                   form)


def _check_args(bank, idx, bq, block, k_win):
    if bank.dim() != 2 or idx.dim() != 1 or bank.shape[0] < 1:
        raise ValueError(f"bank {tuple(bank.shape)}, idx {tuple(idx.shape)}: "
                         "want (T, D) with T >= 1 and (N,)")
    if min(bq, block, k_win) < 1:
        raise ValueError(f"bq {bq}, block {block}, k_win {k_win}: want "
                         "positive sizes")
    if bank.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no row fetch for device {bank.device}")
    if idx.device != bank.device:
        raise ValueError(f"idx is on {idx.device}, bank on {bank.device}")
    if bank.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bank is {bank.dtype}: want bfloat16 or float32")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx is {idx.dtype}: want int32")


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/row_fetch.cu), bound with ctypes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """The bound C entry points of ``csrc/row_fetch.cu`` by form, built at
    first use."""
    from monosowa_tpu_torch.ops._build import load_library

    lib = load_library("row_fetch")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"direct": lib.row_fetch_direct, "staged": lib.row_fetch_staged}
    for fn in fns.values():
        # bank, idx, out, N, T, D, bq, block, k_win, bank_is_bf16, stream
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fns


def _launch(bank, idx, bq, block, k_win, form):
    """One launch of the form's kernel."""
    global launches
    t_total, d = bank.shape
    n = idx.shape[0]
    if d % 8:
        raise ValueError(f"D = {d}: the kernel takes a multiple of 8 "
                         "channels (rows that start on 16 bytes)")
    if bq * 4 > 48 * 1024:
        raise ValueError(f"bq = {bq}: the kernel holds a block's indices in "
                         "48 KB of shared memory")
    smem = block * d * bank.element_size() + bq * 4
    if form == "staged" and smem > SMEM_LIMIT:
        raise ValueError(
            f"staged: a chunk of {block} rows x {d} channels of "
            f"{bank.dtype} and {bq} indices take {smem} bytes of shared "
            f"memory, a block may have {SMEM_LIMIT}")
    out = torch.empty(n, d, device=bank.device, dtype=torch.float32)
    if n == 0:
        return out
    with torch.cuda.device(bank.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[form](
            bank.data_ptr(), idx.data_ptr(), out.data_ptr(), n, t_total, d,
            bq, block, k_win, int(bank.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"row_fetch {form} launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
