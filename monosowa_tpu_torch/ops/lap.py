"""Linear assignment (Hungarian) solvers for the set matcher, batched.

Counterpart of the JAX package's ``ops/lap.py``.  Every solver takes a
batch of padded problems, cost ``(N, Q, M)`` float32 (Q rows, M target
columns) and valid-column counts ``(N,)``, and returns ``(N, Q)`` int64: the
column assigned to each row, or -1.  Only the first ``n_valid`` columns take
part; each of them is assigned (Q >= M, the reference's use of
``scipy.optimize.linear_sum_assignment`` in matcher.py:95-112).  The batch
is what ``jax.vmap`` runs in the JAX package's ``hungarian_match``: one
problem per (image, Group-DETR group).

* ``solve_lap_host`` — scipy's exact solver on the host (one copy each way).
* ``solve_lap_jv`` — exact shortest augmenting paths with potentials
  (Jonker-Volgenant style, JAX ``solve_lap_jv`` :54).
* ``solve_lap_auction`` — Jacobi auction with epsilon scaling on the
  squared problem (JAX ``solve_lap_auction`` :219), near-optimal.
* ``solve_lap_auction_fast`` — the asymmetric forward auction (JAX
  ``solve_lap_auction_fast`` :133); plain torch, no caller.

``lap_jv`` has three forms, hand-written kernels of ``csrc/lap.cu``, and
``jv_plan`` picks one from the shape alone (never from the counts or the
costs, so a match waits for nothing): ``warp``, one warp a problem with its
state in registers and its cost in shared memory (the decoder's 50 x 50
matches, up to 512 rows); ``cluster``, a cluster of up to 16 blocks a
problem, each holding a slice of the cost in its shared memory (the
two-stage encoder match, 10,200 tokens x 50 targets); ``tall``, one block of
1,024 threads a problem with the cost in device memory, past what a
cluster holds.  ``auction_plan`` sizes ``lap_auction``'s block: a warp a
real column, and the rounds in which only the zero-benefit columns bid
run in one warp on the rows held sorted by price in its registers.

``solve_lap_jv`` and ``solve_lap_auction`` are the plain versions: they
follow the JAX functions step by step (the same float32 operations in the
same order, first index on ties as ``jnp.argmin`` / ``jnp.argmax`` take it,
and a per-problem mask that freezes a problem where its ``while_loop`` would
have stopped), so they give the JAX solvers' assignments, not merely
assignments of the same cost.  ``lap_jv`` and ``lap_auction`` launch the
hand-written kernels of ``csrc/lap.cu`` for CUDA tensors and run the plain
versions for CPU tensors; there is no other path.  The tracer's counters
(``utils/timing.py``) ``lap.jv_launches`` and ``lap.auction_launches``
count kernel launches, ``lap.jv_warp_launches``, ``lap.jv_cluster_launches``
and ``lap.jv_tall_launches`` those of each JV form.

One departure: a problem with more valid columns than rows is solved over
its first Q columns.  The JAX solvers never end on such a problem (JV) or
fail to trace it (the auction's squared benefit needs M <= Q); scipy
assigns Q of the columns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from monosowa_tpu_torch.utils import timing

AUCTION_PHASES = 10
AUCTION_ROUNDS = 200
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a Hopper block may have
AUCTION_MAX_Q = 1024          # one thread a row
SLOTS = (1, 2, 4, 8, 16)      # objects a lane (JV warp) or thread (cluster)
AUCTION_SLOTS = SLOTS + (32,)  # rows a lane of the auction's zero rounds
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks a problem of the cluster form
CLUSTER_THREADS = 256         # a cluster form block
CLUSTER_MAX_Q = 65534         # its candidates' indices: 16 bits
WARP_THREADS = 128            # the warp form's block (one warp past the load)
TALL_THREADS = 1024
TALL_STATIC_BYTES = 4 * 66    # the tall form's reduction partials
JV_FORMS = ("warp", "cluster", "tall")


def _check_args(cost: torch.Tensor, n_valid: torch.Tensor) -> None:
    if cost.dim() != 3 or n_valid.shape != cost.shape[:1]:
        raise ValueError(f"cost {tuple(cost.shape)}, n_valid "
                         f"{tuple(n_valid.shape)}: want (N, Q, M) and (N,)")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost is {cost.dtype}: want float32")
    if n_valid.dtype.is_floating_point or n_valid.dtype == torch.bool:
        raise TypeError(f"n_valid is {n_valid.dtype}: want an integer type")
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no assignment solver for device {cost.device}")
    if n_valid.device != cost.device:
        raise ValueError(f"n_valid is on {n_valid.device}, cost on "
                         f"{cost.device}")


def _valid_counts(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(N,) int64 counts clipped to [0, min(Q, M)]."""
    q, mmax = cost.shape[1], cost.shape[2]
    return n_valid.long().clamp(0, min(q, mmax))


# ---------------------------------------------------------------------------
# scipy on the host
# ---------------------------------------------------------------------------

def solve_lap_host(cost: torch.Tensor, n_valid: torch.Tensor
                   ) -> torch.Tensor:
    """scipy's ``linear_sum_assignment`` on each problem's first
    ``n_valid`` columns (the JAX package's ``_scipy_solve``): one copy of
    the costs and counts to the host, the result copied back to the cost's
    device."""
    from scipy.optimize import linear_sum_assignment

    _check_args(cost, n_valid)
    costs = cost.detach().cpu().numpy()
    counts = n_valid.cpu().numpy()
    out = np.full(costs.shape[:2], -1, np.int64)
    for k, (c, m) in enumerate(zip(costs, counts)):
        if m > 0:
            rows, cols = linear_sum_assignment(c[:, :int(m)])
            out[k, rows] = cols
    return torch.from_numpy(out).to(cost.device)


# ---------------------------------------------------------------------------
# plain versions (the JAX solvers, batched)
# ---------------------------------------------------------------------------

def solve_lap_jv(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Exact assignment by shortest augmenting paths, the JAX package's
    ``solve_lap_jv`` batched over problems.

    The transposed cost is a (M persons, Q objects) matrix; person i < m is
    augmented in order: a dense Dijkstra over the objects with reduced
    costs ``c[i, j] - u[i] - v[j]`` that stops at the first unassigned
    object it pops, then the potentials' updates and the path flipped back
    to its root."""
    _check_args(cost, n_valid)
    n, q, mmax = cost.shape
    dev = cost.device
    c = cost.transpose(1, 2)                                 # (N, M, Q)
    m = _valid_counts(cost, n_valid)
    rows = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    u = cost.new_zeros(n, mmax)
    v = cost.new_zeros(n, q)
    p = torch.full((n, q), -1, dtype=torch.long, device=dev)
    for i in range(mmax):
        active = i < m
        if not bool(active.any()):
            break
        minv = c[:, i] - u[:, i:i + 1] - v
        way = torch.full_like(p, -1)
        used = torch.zeros(n, q, dtype=torch.bool, device=dev)
        j_end = torch.full((n,), -1, dtype=torch.long, device=dev)
        run = active.clone()
        while bool(run.any()):
            mv = torch.where(used, inf, minv)
            j1 = mv.argmin(1)
            delta = mv.gather(1, j1[:, None])
            # the potentials; a virtual start column keeps u[i] in every step
            # (a frozen problem's last column has no person: its result is
            # not kept)
            owners = torch.where(used & (p >= 0), p, mmax)
            u_pad = torch.cat([u, u.new_zeros(n, 1)], 1).scatter_add(
                1, owners, torch.where(used, delta, 0.0))
            u_new = u_pad[:, :mmax].clone()
            u_new[:, i] = u_new[:, i] + delta[:, 0]
            v_new = torch.where(used, v - delta, v)
            minv_new = torch.where(used, minv, minv - delta)
            used_new = used.scatter(1, j1[:, None], True)
            p_j1 = p.gather(1, j1[:, None])[:, 0]
            done = p_j1 < 0
            # extend the search tree through j1's current person
            i2 = p_j1.clamp(min=0)
            cur = c[rows, i2] - u_new[rows, i2][:, None] - v_new
            better = (cur < minv_new) & ~used_new & ~done[:, None]
            minv_new = torch.where(better, cur, minv_new)
            way_new = torch.where(better, j1[:, None], way)
            r = run[:, None]
            u = torch.where(r, u_new, u)
            v = torch.where(r, v_new, v)
            minv = torch.where(r, minv_new, minv)
            way = torch.where(r, way_new, way)
            used = torch.where(r, used_new, used)
            j_end = torch.where(run, j1, j_end)
            run = run & ~done
        # flip each augmenting path back to its root
        j = j_end
        while bool((j >= 0).any()):
            live = j >= 0
            js = j.clamp(min=0)
            jprev = way.gather(1, js[:, None])[:, 0]
            newp = torch.where(jprev < 0, i,
                               p.gather(1, jprev.clamp(min=0)[:, None])[:, 0])
            p = torch.where(live[:, None], p.scatter(1, js[:, None],
                                                     newp[:, None]), p)
            j = torch.where(live, jprev, j)
    return p


def auction_eps(cost: torch.Tensor, num_phases: int = AUCTION_PHASES,
                final: float = 1e-4) -> torch.Tensor:
    """(N, num_phases) float32: each problem's epsilon in each phase, from
    the spread of its whole padded cost, as the JAX package's
    ``solve_lap_auction`` computes it (``eps0 * shrink ** phase``, the last
    ``final`` times the spread; 1e-5 for ``solve_lap_auction_fast``).  The
    kernel takes these values from here, so that it and the plain version
    bid with the same epsilons."""
    spread = (cost.amax((1, 2)) - cost.amin((1, 2))).clamp(min=1.0)
    eps_final = spread * final
    eps0 = spread / 2.0
    shrink = (eps_final / eps0) ** (1.0 / max(num_phases - 1, 1))
    phase = torch.arange(num_phases, dtype=torch.float32, device=cost.device)
    return eps0[:, None] * shrink[:, None] ** phase


def solve_lap_auction(cost: torch.Tensor, n_valid: torch.Tensor,
                      num_phases: int = AUCTION_PHASES,
                      rounds_per_phase: int = AUCTION_ROUNDS) -> torch.Tensor:
    """Jacobi (parallel-bidding) auction with epsilon scaling, the JAX
    package's ``solve_lap_auction`` batched over problems.

    The problem is squared to Q x Q: column j < n_valid has benefit
    ``-cost[:, j]``, every other column a uniform 0.  Each round every
    unassigned column bids for its best row (the price it offers: the
    row's price plus the margin over its second-best row plus eps), each
    row takes its highest bid (the first column on ties), displaced
    columns lose their row.  A phase ends when every column holds a row or
    after ``rounds_per_phase`` rounds; prices persist across phases,
    assignments do not."""
    _check_args(cost, n_valid)
    n, q, mmax = cost.shape
    if mmax > q:
        raise ValueError(f"auction: M = {mmax} target columns for Q = {q} "
                         "rows; the squared problem needs M <= Q")
    dev = cost.device
    m = _valid_counts(cost, n_valid)
    col_ids = torch.arange(q, device=dev)
    real = col_ids[None, :mmax, None] < m[:, None, None]     # (N, M, 1)
    benefit = cost.new_zeros(n, q, q)                        # (N, cols, rows)
    benefit[:, :mmax] = torch.where(real, -cost.transpose(1, 2), 0.0)
    is_real = col_ids[None, :] < m[:, None]                  # (N, cols)
    eps_all = auction_eps(cost, num_phases)
    ninf = torch.tensor(float("-inf"), device=dev)
    row_ids = col_ids

    prices = cost.new_zeros(n, q)
    assigned = torch.full((n, q), -1, dtype=torch.long, device=dev)
    for phase in range(num_phases):
        eps = eps_all[:, phase:phase + 1]
        owner = torch.full((n, q), -1, dtype=torch.long, device=dev)
        assigned = torch.full((n, q), -1, dtype=torch.long, device=dev)
        run = torch.ones(n, dtype=torch.bool, device=dev)
        for _ in range(rounds_per_phase):
            unassigned = assigned < 0                        # (N, cols)
            vals = benefit - prices[:, None, :]              # (N, cols, rows)
            best = vals.argmax(2)
            best_val = vals.amax(2)
            second_val = vals.scatter(2, best[..., None], float("-inf")).amax(2)
            bid = prices.gather(1, best) + best_val - second_val + eps
            # rows take the highest bid among the bidding columns
            bids_on = ((row_ids[None, :, None] == best[:, None, :])
                       & unassigned[:, None, :])             # (N, rows, cols)
            bid_mat = torch.where(bids_on, bid[:, None, :], ninf)
            win_val = bid_mat.amax(2)
            win_col = bid_mat.argmax(2)
            has_bid = torch.isfinite(win_val)
            # columns displaced by a new winner lose their row
            disp = (has_bid[:, :, None]
                    & (owner[:, :, None] == col_ids[None, None, :])
                    & (win_col[:, :, None] != col_ids[None, None, :])
                    ).any(1)
            new_assigned = torch.where(disp, -1, assigned)
            padded = torch.cat([new_assigned,
                                new_assigned.new_full((n, 1), -1)], 1)
            idx = torch.where(has_bid, win_col, q)
            padded = padded.scatter(
                1, idx, torch.where(has_bid, row_ids[None, :], -1))
            r = run[:, None]
            assigned = torch.where(r, padded[:, :q], assigned)
            owner = torch.where(r & has_bid, win_col, owner)
            prices = torch.where(r & has_bid, win_val, prices)
            run = run & (assigned < 0).any(1)
            if not bool(run.any()):
                break
    rows = torch.where(assigned >= 0, assigned, 0)
    vals = torch.where((assigned >= 0) & is_real, col_ids[None, :], -1)
    return torch.full((n, q), -1, dtype=torch.long, device=dev).scatter_reduce(
        1, rows, vals, "amax")


def solve_lap_auction_fast(cost: torch.Tensor, n_valid: torch.Tensor,
                           num_phases: int = 6,
                           rounds_per_phase: int = 100) -> torch.Tensor:
    """Asymmetric forward auction, the JAX package's
    ``solve_lap_auction_fast`` (:133) batched over problems: only the
    ``n_valid`` real columns bid (for rows), with no dummy columns.

    Each round every unassigned valid column bids for its best row (the
    row's price plus the margin over its second-best row plus eps), each
    row takes its highest bid (the first column on ties), a column
    displaced by a new winner loses its row.  A phase ends when every valid
    column holds a row or after ``rounds_per_phase`` rounds; prices persist
    across phases (epsilon from the spread down to 1e-5 of it), assignments
    do not.  Plain torch: no caller in either package (the matcher's
    backends are JV, the squared auction and scipy), so no kernel; one
    would come with a matcher backend that reaches it."""
    _check_args(cost, n_valid)
    n, q, mmax = cost.shape
    dev = cost.device
    m = _valid_counts(cost, n_valid)
    benefit = -cost.transpose(1, 2)                          # (N, M, Q)
    person_ids = torch.arange(mmax, device=dev)
    person_valid = person_ids[None, :] < m[:, None]          # (N, M)
    row_ids = torch.arange(q, device=dev)
    eps_all = auction_eps(cost, num_phases, final=1e-5)
    ninf = torch.tensor(float("-inf"), device=dev)

    prices = cost.new_zeros(n, q)
    assigned = torch.full((n, mmax), -1, dtype=torch.long, device=dev)
    for phase in range(num_phases):
        eps = eps_all[:, phase:phase + 1]
        owner = torch.full((n, q), -1, dtype=torch.long, device=dev)
        assigned = torch.full((n, mmax), -1, dtype=torch.long, device=dev)
        run = ((assigned < 0) & person_valid).any(1)
        for _ in range(rounds_per_phase):
            if not bool(run.any()):
                break
            unassigned = (assigned < 0) & person_valid       # (N, M)
            vals = benefit - prices[:, None, :]              # (N, M, Q)
            best = vals.argmax(2)
            best_val = vals.amax(2)
            second_val = vals.scatter(2, best[..., None],
                                      float("-inf")).amax(2)
            bid = prices.gather(1, best) + best_val - second_val + eps
            bids_on = ((row_ids[None, :, None] == best[:, None, :])
                       & unassigned[:, None, :])             # (N, Q, M)
            bid_mat = torch.where(bids_on, bid[:, None, :], ninf)
            win_val = bid_mat.amax(2)
            win_person = bid_mat.argmax(2)
            has_bid = torch.isfinite(win_val)
            disp = (has_bid[:, :, None]
                    & (owner[:, :, None] == person_ids[None, None, :])
                    & (win_person[:, :, None] != person_ids[None, None, :])
                    ).any(1)
            new_assigned = torch.where(disp, -1, assigned)
            padded = torch.cat([new_assigned,
                                new_assigned.new_full((n, 1), -1)], 1)
            idx = torch.where(has_bid, win_person, mmax)
            padded = padded.scatter(
                1, idx, torch.where(has_bid, row_ids[None, :], -1))
            r = run[:, None]
            assigned = torch.where(r, padded[:, :mmax], assigned)
            owner = torch.where(r & has_bid, win_person, owner)
            prices = torch.where(r & has_bid, win_val, prices)
            run = run & ((assigned < 0) & person_valid).any(1)
    rows = torch.where((assigned >= 0) & person_valid, assigned, q)
    vals = torch.where(person_valid, person_ids[None, :], -1)
    out = torch.full((n, q + 1), -1, dtype=torch.long, device=dev)
    return out.scatter_reduce(1, rows, vals, "amax")[:, :q]


# ---------------------------------------------------------------------------
# the wrappers: the CUDA kernels (csrc/lap.cu) for CUDA tensors
# ---------------------------------------------------------------------------

def lap_jv(cost: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """``solve_lap_jv``'s function: the kernel ``lap_jv`` of ``csrc/lap.cu``
    for CUDA tensors, the plain version for CPU tensors."""
    _check_args(cost, n_valid)
    if cost.device.type == "cpu":
        return solve_lap_jv(cost, n_valid)
    return _launch_jv(cost.contiguous(), n_valid)


def lap_auction(cost: torch.Tensor, n_valid: torch.Tensor,
                num_phases: int = AUCTION_PHASES,
                rounds_per_phase: int = AUCTION_ROUNDS) -> torch.Tensor:
    """``solve_lap_auction``'s function: the kernel ``lap_auction`` of
    ``csrc/lap.cu`` for CUDA tensors, the plain version for CPU tensors."""
    _check_args(cost, n_valid)
    if cost.device.type == "cpu":
        return solve_lap_auction(cost, n_valid, num_phases, rounds_per_phase)
    return _launch_auction(cost.contiguous(), n_valid, num_phases,
                           rounds_per_phase)


@dataclasses.dataclass(frozen=True)
class LapPlan:
    """One launch's shape: the form, a block's threads, blocks a problem
    (the cluster), objects a lane or thread (``slots``; the auction's rows
    a lane in its zero rounds), dynamic shared memory a block, and for the
    tall form whether its state fits shared memory."""
    form: str
    threads: int
    cluster: int
    slots: int
    smem_bytes: int
    state_in_smem: bool = True


def _slots(objects: int, lanes: int, slots=SLOTS) -> int:
    """The least of ``slots`` that gives ``objects`` a place over
    ``lanes`` lanes, else 0."""
    return next((k for k in slots if k * lanes >= objects), 0)


def _cost_stride(q: int, mmax: int) -> int:
    """A cost row's words in shared memory: the min(Q, M) persons that can
    take part, at an odd stride (32 lanes on 32 banks)."""
    return min(q, mmax) | 1


def jv_warp_smem_bytes(q: int, mmax: int) -> int:
    """The warp form's block: the cost (Q rows) and the owners'
    potentials, persons and path links, a word each an object."""
    return 4 * (q * _cost_stride(q, mmax) + 3 * q)


def jv_cluster_smem_bytes(q: int, mmax: int, cluster: int) -> int:
    """A cluster form block: two buffers of the cluster's candidates (16
    bytes a warp), the cost of the block's ceil(Q / cluster) objects as in
    the warp form, and an augmentation's steps (at most min(Q, M): the
    object, its way, its owner and the owner's potential, a word each)."""
    qc = -(-q // cluster)
    return 16 * 2 * cluster * (CLUSTER_THREADS // 32) \
        + 4 * (qc * _cost_stride(q, mmax) + 4 * min(q, mmax))


def jv_tall_smem_bytes(q: int, mmax: int, state_in_smem: bool) -> int:
    """The tall form's dynamic shared memory: u, and with
    ``state_in_smem`` v, minv, p, way, used (its reduction's partials,
    ``TALL_STATIC_BYTES``, are static)."""
    return 4 * (mmax + (5 * q if state_in_smem else 0))


def jv_forms(q: int, mmax: int) -> dict:
    """{form: LapPlan} of every JV form that can take a (Q, M) problem."""
    forms = {}
    slots = _slots(q, 32)
    if slots and jv_warp_smem_bytes(q, mmax) <= SMEM_LIMIT:
        forms["warp"] = LapPlan("warp", WARP_THREADS, 1, slots,
                                jv_warp_smem_bytes(q, mmax))
    for cluster in CLUSTER_SIZES:
        slots = _slots(-(-q // cluster), CLUSTER_THREADS)
        smem = jv_cluster_smem_bytes(q, mmax, cluster)
        if slots and smem <= SMEM_LIMIT and q <= CLUSTER_MAX_Q:
            forms["cluster"] = LapPlan("cluster", CLUSTER_THREADS, cluster,
                                       slots, smem)
            break
    for in_smem in (True, False):
        smem = jv_tall_smem_bytes(q, mmax, in_smem)
        if smem + TALL_STATIC_BYTES <= SMEM_LIMIT:
            forms["tall"] = LapPlan("tall", TALL_THREADS, 1, 0, smem,
                                    in_smem)
            break
    return forms


def jv_plan(q: int, mmax: int, form: str | None = None) -> LapPlan:
    """The JV launch for a (Q, M) problem, from its shape alone: the first
    of warp, cluster, tall that can take it, or ``form`` where the caller
    names one (to hold each form against the plain version).  Raises where
    no form, or not the named one, can take it."""
    forms = jv_forms(int(q), int(mmax))
    name = form or next((f for f in JV_FORMS if f in forms), None)
    if name not in forms:
        raise ValueError(f"lap_jv: no {form or 'form'} takes Q = {q}, "
                         f"M = {mmax}")
    return forms[name]


def auction_smem_bytes(q: int, mmax: int) -> int:
    """``lap_auction``'s block: a row's best real bid (8 bytes), the
    negated cost of the min(Q, M) real columns, prices, owners, the real
    columns' rows, the zero columns' bitmask (32 words), the round's
    zero-column bid (3 words) and the round's counts (5 words)."""
    persons = min(q, mmax)
    return 8 * q + 4 * (persons * q + 2 * q + persons + 40)


def auction_plan(q: int, mmax: int) -> LapPlan:
    """``lap_auction``'s launch for a (Q, M) problem: one block, a warp a
    real column and one for the zero columns (at most 32), at least a
    thread a row, and the rows a lane of the zero columns' warp holds in
    its rounds alone (``slots``).  Raises where the kernel cannot take the
    shape."""
    if mmax > q:
        raise ValueError(f"auction: M = {mmax} target columns for Q = {q} "
                         "rows; the squared problem needs M <= Q")
    smem = auction_smem_bytes(q, mmax)
    if q > AUCTION_MAX_Q or smem > SMEM_LIMIT:
        raise ValueError(f"lap_auction: Q = {q}, M = {mmax}; the kernel "
                         f"takes at most {AUCTION_MAX_Q} rows and "
                         f"{SMEM_LIMIT} bytes of shared memory")
    warps = max(-(-q // 32), min(32, min(q, mmax) + 1))
    return LapPlan("auction", 32 * warps, 1, _slots(q, 32, AUCTION_SLOTS),
                   smem)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The bound C entry points of ``csrc/lap.cu``, built at first use."""
    from monosowa_tpu_torch.ops._build import load_library

    lib = load_library("lap")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # cost, n_valid, out, N, Q, M, slots, smem, stream
    lib.lap_jv_warp.argtypes = [p, p, p, i, i, i, i, ll, p]
    # cost, n_valid, out, N, Q, M, cluster, slots, smem, stream
    lib.lap_jv_cluster.argtypes = [p, p, p, i, i, i, i, i, ll, p]
    # costT, n_valid, out, scratch, N, Q, M, smem, stream
    lib.lap_jv_tall.argtypes = [p, p, p, p, i, i, i, ll, p]
    # cost, n_valid, eps, out, N, Q, M, phases, rounds, threads, slots,
    # smem, stream
    lib.lap_auction.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ll, p]
    for fn in (lib.lap_jv_warp, lib.lap_jv_cluster, lib.lap_jv_tall,
               lib.lap_auction):
        fn.restype = ctypes.c_int
    return lib


def _launch_jv(cost, n_valid, plan: LapPlan | None = None):
    """One launch of the form ``jv_plan`` gives the shape, or of ``plan``."""
    n, q, mmax = cost.shape
    plan = plan or jv_plan(q, mmax)
    counts = n_valid.to(torch.int32).contiguous()
    out = torch.empty(n, q, dtype=torch.int64, device=cost.device)
    if n == 0:
        return out
    if plan.form == "tall":
        # a person's row of objects contiguous; the state in shared memory
        # where it fits, else in a scratch of device memory
        cost_t = cost.transpose(1, 2).contiguous()
        scratch = None if plan.state_in_smem else torch.empty(
            n * 5 * q, dtype=torch.float32, device=cost.device)
    lib = _kernels()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.form == "warp":
            err = lib.lap_jv_warp(cost.data_ptr(), counts.data_ptr(),
                                  out.data_ptr(), n, q, mmax, plan.slots,
                                  plan.smem_bytes, stream)
        elif plan.form == "cluster":
            err = lib.lap_jv_cluster(cost.data_ptr(), counts.data_ptr(),
                                     out.data_ptr(), n, q, mmax,
                                     plan.cluster, plan.slots,
                                     plan.smem_bytes, stream)
        else:
            err = lib.lap_jv_tall(
                cost_t.data_ptr(), counts.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, q, mmax,
                plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"lap_jv ({plan.form} form) launch failed: CUDA "
                           f"error {err}")
    timing.count("lap.jv_launches")
    timing.count(f"lap.jv_{plan.form}_launches")
    return out


def _launch_auction(cost, n_valid, num_phases, rounds_per_phase):
    n, q, mmax = cost.shape
    plan = auction_plan(q, mmax)
    counts = n_valid.to(torch.int32).contiguous()
    eps = auction_eps(cost, num_phases).contiguous()
    out = torch.empty(n, q, dtype=torch.int64, device=cost.device)
    if n == 0:
        return out
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels().lap_auction(
            cost.data_ptr(), counts.data_ptr(), eps.data_ptr(),
            out.data_ptr(), n, q, mmax, num_phases, rounds_per_phase,
            plan.threads, plan.slots, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"lap_auction launch failed: CUDA error {err}")
    timing.count("lap.auction_launches")
    return out
