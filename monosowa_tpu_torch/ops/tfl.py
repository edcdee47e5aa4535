"""Template Fitting Loss (TFL): the exact two-way coverage and the
convolutional coarse grid.

The reference's hottest path is the binary two-way TFL evaluated over a
64 000-pose grid per car (pseudo_label_generator/3d/scripts/loss.py:70-75,
optimizer.py:53-112).  Two evaluators, as in the JAX package's
``ops/tfl.py``:

1. ``binary_both_way_counts``: exact, for a batch of posed templates per
   car.  For CUDA tensors it launches the hand-written kernel
   ``csrc/tfl_counts.cu`` (which replaces the TPU kernel
   ``binary_both_way_counts_pallas``); for CPU tensors it runs the plain
   version ``binary_both_way_counts_plain``.  There is no other path.
   ``launches`` counts kernel launches.  Used to rescore the coarse grid's
   best translations and for the fine theta pass.

2. ``grid_pose_losses_conv``: the whole (theta x dx x dz) grid as two
   cross-correlations between voxel fields of the scan and per-theta rotated
   template kernels.  Voxel quantisation is bounded by one voxel diagonal
   and the exact passes re-anchor the pose.  The fields hold integer counts
   in float32 and the selection downstream depends on exact ties, so the
   convolutions run in full float32 (TF32 off) and their sums are rounded
   to whole numbers (``_count_conv``).

``tfl_loss`` dispatches the reference's seven loss kinds: ``binary2way``
and ``binary1way`` through the coverage counts, the other five (chamfer,
the two medians, the trimmed means, the sigmoid) in plain torch over
chunks of poses whose (chunk, T, S) distance tensor stays near 128 MB.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e9

# kernel launches of binary_both_way_counts (read and reset by callers that
# must show a run went through the kernel)
launches = 0

# elements of the plain version's (chunk, T, S) distance tensor
_PLAIN_CHUNK_ELEMS = 1 << 25


# ---------------------------------------------------------------------------
# Exact evaluator
# ---------------------------------------------------------------------------

def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, K) x (..., M, K) -> (..., N, M) squared Euclidean distances.

    For K <= 4 (3-D point clouds) the sum runs over the components in
    order, ``((0 + d0^2) + d1^2) + d2^2``, each product and sum rounded to
    float32 on its own: the order the CUDA kernel repeats.  Without
    autograd the sums run in place (two (..., N, M) temporaries, not
    five), with the same roundings.  Larger K uses the |a|^2 + |b|^2 - 2ab
    matrix form."""
    k = a.shape[-1]
    if k <= 4:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            d2 = None
            for i in range(k):
                diff = a[..., :, None, i] - b[..., None, :, i]
                sq = diff * diff
                d2 = sq if d2 is None else d2 + sq
            return d2
        d2 = a[..., :, None, 0] - b[..., None, :, 0]
        d2.mul_(d2)
        for i in range(1, k):
            t = a[..., :, None, i] - b[..., None, :, i]
            d2.add_(t.mul_(t))
        return d2
    aa = (a * a).sum(-1)[..., :, None]
    bb = (b * b).sum(-1)[..., None, :]
    return (aa + bb - 2.0 * (a @ b.transpose(-1, -2))).clamp_min(0.0)


def _radius_sq(radius: float) -> float:
    """radius^2 as the float32 value both versions compare against (the
    product is taken in double and rounded once, as a Python-float radius
    is in the JAX package)."""
    return float(np.float32(radius * radius))


def binary_both_way_counts_plain(scan: torch.Tensor, scan_mask: torch.Tensor,
                                 templates: torch.Tensor, radius: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the two-way coverage counts: scan (B, S, 3),
    scan_mask (B, S) bool, templates (B, P, T, 3) -> (t_count, s_count),
    each (B, P) float32.  t_count = template points with a valid scan point
    at squared distance < r^2, s_count = valid scan points with a template
    point at < r^2; masked scan points count as far away.  Chunked over
    poses so the (chunk, T, S) distance tensor stays small."""
    b, p, t, _ = templates.shape
    s = scan.shape[1]
    r2 = _radius_sq(radius)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(t * s, 1))
    t_count = templates.new_zeros(b, p)
    s_count = templates.new_zeros(b, p)
    big = templates.new_tensor(BIG)
    for bi in range(b):
        valid = scan_mask[bi]
        for p0 in range(0, p, chunk):
            d2 = pairwise_sq_dists(templates[bi, p0:p0 + chunk], scan[bi])
            d2 = torch.where(valid[None, None, :], d2, big)
            t_hit = d2.amin(-1) < r2                         # (chunk, T)
            s_hit = (d2.amin(-2) < r2) & valid               # (chunk, S)
            t_count[bi, p0:p0 + chunk] = t_hit.sum(-1).to(t_count.dtype)
            s_count[bi, p0:p0 + chunk] = s_hit.sum(-1).to(s_count.dtype)
    return t_count, s_count


def binary_both_way_counts(scan: torch.Tensor, scan_mask: torch.Tensor,
                           templates: torch.Tensor, radius: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-way coverage fractions.

    scan (B, S, 3) padded, scan_mask (B, S) bool, templates (B, P, T, 3)
    posed -> (t_frac, s_frac), each (B, P); without the leading car
    dimension, scan (S, 3), scan_mask (S,), templates (P, T, 3) -> (P,).
      t_frac = share of the T template points with a valid scan point
               within radius,
      s_frac = share of the valid scan points with a template point within
               radius (zero for an all-masked scan):
    the two terms of loss.py:70-75's binary2way loss.  The CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if scan.dim() == 2:
        t_frac, s_frac = binary_both_way_counts(
            scan[None], scan_mask[None], templates[None], radius)
        return t_frac[0], s_frac[0]
    _check_counts_args(scan, scan_mask, templates)
    scan_mask = scan_mask.bool()
    if scan.device.type == "cpu":
        t_count, s_count = binary_both_way_counts_plain(
            scan, scan_mask, templates, radius)
    else:
        t_count, s_count = _launch_counts(
            scan.contiguous(), scan_mask.contiguous(),
            templates.contiguous(), radius)
    return _fractions(t_count, s_count, scan_mask, templates.shape[2])


def _fractions(t_count, s_count, scan_mask, n_template: int):
    """Counts -> fractions, the same float32 divisions for both versions
    (by tensors: a division by a host scalar may be turned into a product
    with its reciprocal)."""
    n_scan = scan_mask.sum(-1).clamp_min(1).to(t_count.dtype)[:, None]
    return t_count / t_count.new_tensor(float(n_template)), s_count / n_scan


def _check_counts_args(scan, scan_mask, templates):
    if scan.dim() != 3 or scan.shape[-1] != 3 or templates.dim() != 4 \
            or templates.shape[-1] != 3 \
            or templates.shape[0] != scan.shape[0] \
            or tuple(scan_mask.shape) != tuple(scan.shape[:2]):
        raise ValueError(
            f"scan {tuple(scan.shape)}, scan_mask {tuple(scan_mask.shape)}, "
            f"templates {tuple(templates.shape)}: want (B, S, 3), (B, S), "
            "(B, P, T, 3)")
    if scan.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no TFL counts for device {scan.device}")
    for name, t in (("scan_mask", scan_mask), ("templates", templates)):
        if t.device != scan.device:
            raise ValueError(f"{name} is on {t.device}, scan on "
                             f"{scan.device}")
    if scan.dtype != templates.dtype or (
            scan.device.type == "cuda" and scan.dtype != torch.float32):
        raise TypeError(f"scan is {scan.dtype}, templates {templates.dtype}:"
                        " the kernel takes float32")


def binary_both_way_loss(scan, scan_mask, templates, radius) -> torch.Tensor:
    t_frac, s_frac = binary_both_way_counts(scan, scan_mask, templates,
                                            radius)
    return -(t_frac + s_frac)


def binary_one_way_loss(scan, scan_mask, templates, radius) -> torch.Tensor:
    """'binary1way' (loss.py:62-69): -(template points within radius of the
    scan) / |T|, one directional count only: the coverage counts' first
    fraction."""
    return -binary_both_way_counts(scan, scan_mask, templates, radius)[0]


def _per_pose_chunks(fn, scan, scan_mask, templates) -> torch.Tensor:
    """``fn(scan (S, 3), mask (S,) bool, posed (c, T, 3)) -> (c,)`` over
    every car and chunk of poses: scan (B, S, 3), scan_mask (B, S),
    templates (B, P, T, 3) -> (B, P); without the car dimension (S, 3),
    (S,), (P, T, 3) -> (P,).  A chunk's (c, T, S) distance tensor holds
    at most ``_PLAIN_CHUNK_ELEMS`` elements."""
    if scan.dim() == 2:
        return _per_pose_chunks(fn, scan[None], scan_mask[None],
                                templates[None])[0]
    _check_counts_args(scan, scan_mask, templates)
    b, p, t, _ = templates.shape
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(t * scan.shape[1], 1))
    mask = scan_mask.bool()
    out = templates.new_empty(b, p)
    for bi in range(b):
        for p0 in range(0, p, chunk):
            out[bi, p0:p0 + chunk] = fn(scan[bi], mask[bi],
                                        templates[bi, p0:p0 + chunk])
    return out


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """x / n in float32 with n a count (int or tensor): a true division by
    a tensor, as the JAX package divides (a division by a host scalar may
    become a product with its reciprocal on the card)."""
    if not torch.is_tensor(n):
        n = x.new_full((), float(n))
    return x / n.to(x.dtype)


def _scan_distances(scan, mask, posed):
    """(d2 (c, T, S), d2 with the masked scan points at BIG)."""
    d2 = pairwise_sq_dists(posed, scan)
    return d2, torch.where(mask, d2, d2.new_full((), BIG))


def _n_scan(mask) -> torch.Tensor:
    return mask.sum(-1).clamp_min(1)


def _median_last(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle
    values for an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def _masked_median(vals, valid) -> torch.Tensor:
    """Median over the VALID entries only (numpy semantics: mean of the two
    middle order statistics for even counts).  vals (..., N), valid (..., N)
    boolean; invalid entries sort to the end."""
    s = torch.sort(torch.where(valid, vals, vals.new_full((), BIG)),
                   dim=-1).values
    n = valid.sum(-1).clamp_min(1)
    lo = torch.gather(s, -1, ((n - 1) // 2)[..., None])[..., 0]
    hi = torch.gather(s, -1, (n // 2)[..., None])[..., 0]
    return 0.5 * (lo + hi)


def _trim_mean(vals, valid, proportion_cut_high) -> torch.Tensor:
    """custom_trim_mean (loss.py:56-60): sort ascending, mean of the first
    int((1 - p) * n) entries; masked entries sort to the end.  The share
    is taken in float32, as the JAX package takes it."""
    s = torch.sort(torch.where(valid, vals, vals.new_full((), BIG)),
                   dim=-1).values
    share = vals.new_full((), 1.0 - proportion_cut_high)
    n_use = (share * valid.sum(-1).to(vals.dtype)).long().clamp_min(1)
    keep = torch.arange(s.shape[-1], device=s.device) < n_use[..., None]
    return _div(torch.where(keep, s, 0.0).sum(-1), n_use)


def _chamfer(scan, mask, posed):
    d2, d2s = _scan_distances(scan, mask, posed)
    t_term = _div(d2s.amin(-1).sum(-1), posed.shape[-2])
    s_term = _div(torch.where(mask, d2.amin(-2), 0.0).sum(-1),
                  _n_scan(mask))
    return torch.sqrt(t_term + s_term)


def _median_one_way(scan, mask, posed):
    d2s = pairwise_sq_dists(posed, scan).masked_fill_(~mask, BIG)
    return _div(_median_last(d2s.amin(-1)), posed.shape[-2])


def _median_both(scan, mask, posed):
    d2, d2s = _scan_distances(scan, mask, posed)
    t_med = _median_last(d2s.amin(-1))
    s_min = d2.amin(-2)
    s_med = _masked_median(s_min, mask.expand_as(s_min))
    return torch.sqrt(_div(s_med, _n_scan(mask))
                      + _div(t_med, posed.shape[-2]))


def _trimmed(scan, mask, posed, trim):
    d = pairwise_sq_dists(posed, scan).add_(1e-12).sqrt_()
    t_min = torch.where(mask, d, d.new_full((), BIG)).amin(-1)
    s_min = d.amin(-2)
    return (_trim_mean(s_min, mask.expand_as(s_min), trim)
            + _trim_mean(t_min, torch.ones_like(t_min, dtype=torch.bool),
                         trim))


def _sigmoid_binary(scan, mask, posed, steepness):
    d = pairwise_sq_dists(posed, scan).add_(1e-12).sqrt_()
    d = d.masked_fill_(~mask, BIG)
    t_term = torch.sigmoid(steepness * d.amin(-1)) - 0.5
    s_term = torch.where(
        mask, torch.sigmoid(steepness * d.amin(-2)) - 0.5, 0.0)
    return (_div(t_term.sum(-1), posed.shape[-2])
            + _div(s_term.sum(-1), _n_scan(mask)))


def chamfer_loss(scan, scan_mask, templates) -> torch.Tensor:
    """'chamfer' (avg_chamfer_distance, loss.py:24-33):
    sqrt(sum(min d2 scan->temp)/|S| + sum(min d2 temp->scan)/|T|), each
    direction normalized by ITS OWN cloud size."""
    return _per_pose_chunks(_chamfer, scan, scan_mask, templates)


def median_one_way_loss(scan, scan_mask, templates) -> torch.Tensor:
    """'med1way' (avg_med_distance_only_temp_to_scan, loss.py:35-42):
    median(min d2 temp->scan) / |T| (a median divided by a count: the
    reference's exact formula)."""
    return _per_pose_chunks(_median_one_way, scan, scan_mask, templates)


def median_both_loss(scan, scan_mask, templates) -> torch.Tensor:
    """'medboth' (avg_med_distance, loss.py:13-22):
    sqrt(median(min d2 scan->temp)/|S| + median(min d2 temp->scan)/|T|)."""
    return _per_pose_chunks(_median_both, scan, scan_mask, templates)


def trimmed_loss(scan, scan_mask, templates, trim) -> torch.Tensor:
    """'trimmed' (avg_trim_distance, loss.py:44-54): EUCLIDEAN distances,
    high-trimmed means of both directions, unnormalized sum."""
    return _per_pose_chunks(
        lambda s, m, p: _trimmed(s, m, p, trim), scan, scan_mask, templates)


def sigmoid_binary_loss(scan, scan_mask, templates, steepness=10.0
                        ) -> torch.Tensor:
    """Differentiable TFL variant ('diffbin', loss.py:77-87)."""
    return _per_pose_chunks(
        lambda s, m, p: _sigmoid_binary(s, m, p, steepness), scan,
        scan_mask, templates)


def tfl_loss(scan, scan_mask, templates, kind: str, radius: float = 0.2,
             steepness: float = 10.0, trim: float = 0.2) -> torch.Tensor:
    """The reference's ``loss_function`` config dispatch (compute_loss,
    loss.py:98-116).  scan (S, 3) or (B, S, 3), scan_mask to match,
    templates (P, T, 3) or (B, P, T, 3) posed -> (P,) or (B, P)."""
    if kind == "binary2way":
        return binary_both_way_loss(scan, scan_mask, templates, radius)
    if kind == "binary1way":
        return binary_one_way_loss(scan, scan_mask, templates, radius)
    if kind == "chamfer":
        return chamfer_loss(scan, scan_mask, templates)
    if kind == "diffbin":
        return sigmoid_binary_loss(scan, scan_mask, templates, steepness)
    if kind == "med1way":
        return median_one_way_loss(scan, scan_mask, templates)
    if kind == "medboth":
        return median_both_loss(scan, scan_mask, templates)
    if kind == "trimmed":
        return trimmed_loss(scan, scan_mask, templates, trim)
    raise ValueError(f"unknown loss_function {kind!r} "
                     "(loss.py:98-116 dispatch)")


# ---------------------------------------------------------------------------
# The cell list of the CUDA kernel: its launch numbers, and a numpy mirror
# of its grid rule and its walk
# ---------------------------------------------------------------------------

CELL_EPS = 2.0 ** -9          # cell edge >= sqrt(r2) (1 + CELL_EPS)
CELL_MARGIN = 1.5             # grid origin lo = min - 1.5 c
CELL_GROW = 1.25              # c grows by this factor until the grid fits
CELL_MAG = 2.0 ** -18         # c >= M * CELL_MAG: lo's rounding <= c / 64
CELL_MAG_LIMIT = 2.0 ** 100   # a template box beyond: one cell, all pairs
CELL_AXIS_MAX = 1024          # cells along one axis (the rounding bound)
CELL_CAP = 8192               # cells a block holds at most
SMEM_LIMIT = 227 * 1024       # shared memory a Hopper block may have
SMEM_STATIC = 1024            # the kernel's static shared memory, rounded up
# scan points a launch takes: 16 bytes of point and one of flag each, the
# limit of the all-pairs kernel this one replaced
S_MAX = SMEM_LIMIT // 17


class TflCellPlan(ctypes.Structure):
    """The launch numbers of ``csrc/tfl_counts.cu`` (its ``TflCellPlan``,
    the same fields in the same order), passed by value: float32 values as
    the kernel receives them."""

    _fields_ = [("r2", ctypes.c_float), ("c_min", ctypes.c_float),
                ("margin", ctypes.c_float), ("grow", ctypes.c_float),
                ("mag", ctypes.c_float), ("mag_limit", ctypes.c_float),
                ("cell_cap", ctypes.c_int), ("axis_max", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def tfl_cell_plan(s: int, radius: float) -> TflCellPlan:
    """The kernel's numbers for scans of ``s`` points: r2, the least cell
    edge sqrt(r2) (1 + CELL_EPS) rounded up to float32, and as many cells
    as the shared memory beside ``s`` float4 points holds, at most
    CELL_CAP.  Raises beyond S_MAX points."""
    if not 0 <= s <= S_MAX:
        raise ValueError(f"S = {s} scan points: the coverage kernel takes "
                         f"at most {S_MAX}")
    r2 = np.float32(_radius_sq(radius))
    want = float(np.sqrt(np.float64(r2))) * (1.0 + CELL_EPS)
    c_min = np.float32(want)
    if float(c_min) < want:
        c_min = np.nextafter(c_min, np.float32(np.inf))
    # the kernel's dynamic shared memory: s float4 points, cap + 2 ints
    cap = min(CELL_CAP, (SMEM_LIMIT - SMEM_STATIC - 16 * s) // 4 - 2)
    return TflCellPlan(float(r2), float(c_min), CELL_MARGIN, CELL_GROW,
                       CELL_MAG, CELL_MAG_LIMIT, cap, CELL_AXIS_MAX)


def cell_grid(templates: np.ndarray, plan: TflCellPlan):
    """The grid the kernel builds for each block, bit for bit: templates
    (..., T, 3) float32 -> (mode (...,) 0 no finite point / 1 cell grid /
    2 one cell, lo (..., 3) float32, inv (...,) float32 = fl(1 / c),
    n (..., 3) int64 cells per axis).  ``csrc/tfl_counts.cu`` states the
    rule and why it loses no pair."""
    f32 = np.float32
    t = np.asarray(templates, f32)
    fin = np.isfinite(t).all(-1)[..., None]
    mn = np.where(fin, t, f32(np.inf)).min(-2)
    mx = np.where(fin, t, f32(-np.inf)).max(-2)
    anyf = mn[..., 0] <= mx[..., 0]
    mn = np.where(anyf[..., None], mn, f32(0))
    mx = np.where(anyf[..., None], mx, f32(0))
    m = np.maximum(np.abs(mn), np.abs(mx)).max(-1)
    grid = anyf & (m <= f32(plan.mag_limit))
    mode = np.where(grid, 1, np.where(anyf, 2, 0))
    lo = np.zeros(mn.shape, f32)
    inv = np.zeros(m.shape, f32)
    n = np.ones(mn.shape, np.int64)
    mn_g, mx_g = mn[grid], mx[grid]
    c = np.maximum(f32(plan.c_min), m[grid] * f32(plan.mag))
    c = np.maximum(c, (mx_g - mn_g).max(-1) / f32(plan.axis_max - 4))
    lo_g, inv_g = np.zeros_like(mn_g), np.zeros_like(c)
    n_g = np.ones(mn_g.shape, np.int64)
    todo = np.ones(c.shape, bool)
    while todo.any():
        off = c[todo] * f32(plan.margin)
        iv = f32(1) / c[todo]
        lo_k = mn_g[todo] - off[:, None]
        n_k = ((mx_g[todo] - lo_k) * iv[:, None]).astype(np.int64) + 2
        fits = (n_k <= plan.axis_max).all(-1) \
            & (n_k.prod(-1) <= plan.cell_cap)
        rows = np.nonzero(todo)[0]
        lo_g[rows], inv_g[rows], n_g[rows] = lo_k, iv, n_k
        c[rows[~fits]] *= f32(plan.grow)
        todo[rows[fits]] = False
    lo[grid], inv[grid], n[grid] = lo_g, inv_g, n_g
    return mode, lo, inv, n


def cell_coords(points: np.ndarray, lo: np.ndarray, inv) -> np.ndarray:
    """u = fl(fl(x - lo) * inv) per axis, the kernel's cell coordinate:
    points (N, 3), lo (3,), inv a float32 scalar -> (N, 3) float32."""
    with np.errstate(invalid="ignore", over="ignore"):
        return (np.asarray(points, np.float32) - lo) * np.float32(inv)


def scan_cells(points: np.ndarray, mode, lo, inv, n) -> np.ndarray:
    """The flat cell of each point as the kernel stages scan points, -1
    outside the grid, not finite, or in a grid of mode 0: points (N, 3) and
    the grids of ``cell_grid`` (mode (...,), lo (..., 3), inv (...,), n
    (..., 3)) -> (..., N)."""
    mode = np.asarray(mode)[..., None]
    n = np.asarray(n)[..., None, :]
    u = cell_coords(points, np.asarray(lo, np.float32)[..., None, :],
                    np.asarray(inv, np.float32)[..., None, None])
    with np.errstate(invalid="ignore"):
        inside = ((u >= 0) & (u < n)).all(-1)
    iu = np.where(inside[..., None], u, 0).astype(np.int64)
    flat = (iu[..., 0] * n[..., 1] + iu[..., 1]) * n[..., 2] + iu[..., 2]
    one = np.where(np.isfinite(points).all(-1), 0, -1)
    return np.where(mode == 2, one,
                    np.where((mode == 1) & inside, flat, -1))


def template_cells(points: np.ndarray, mode, lo, inv) -> np.ndarray:
    """(..., T, 3) the cell of each template point as the kernel walks it,
    points (..., T, 3) under the grids of ``cell_grid`` (rows that are not
    finite are not walked; their value means nothing)."""
    mode = np.asarray(mode)[..., None, None]
    u = cell_coords(points, np.asarray(lo, np.float32)[..., None, :],
                    np.asarray(inv, np.float32)[..., None, None])
    cells = np.where(np.isfinite(u), u, 0).astype(np.int64)
    return np.where(mode == 2, 0, cells)


def cell_walk(scan: np.ndarray, scan_mask: np.ndarray,
              templates: np.ndarray, radius: float, hits: bool = True):
    """The kernel's algorithm in numpy, car by car with all poses of a car
    at once: scan (B, S, 3), scan_mask (B, S), templates (B, P, T, 3) ->
    (t_count, s_count, cell_pairs), each (B, P) int64.  cell_pairs counts
    the pairs the walk tests (template point x staged scan point in its
    3 x 3 x 3 cells); with ``hits`` False only those are counted and the
    counts are zero.  As in the plain version's minima, a NaN template
    coordinate zeroes its pose's s_count and a valid NaN scan coordinate
    its car's t_count."""
    scan = np.asarray(scan, np.float32)
    scan_mask = np.asarray(scan_mask, bool)
    templates = np.asarray(templates, np.float32)
    b_n, p_n, t_n, _ = templates.shape
    s_n = scan.shape[1]
    plan = tfl_cell_plan(s_n, radius)
    r2 = np.float32(plan.r2)
    modes, los, invs, ns = cell_grid(templates, plan)
    out = np.zeros((3, b_n, p_n), np.int64)
    for b in range(b_n):
        n = ns[b]
        cells = np.where(scan_mask[b],
                         scan_cells(scan[b], modes[b], los[b], invs[b], n),
                         -1)
        # the poses' sorted slots one after another: key = pose * width +
        # cell, ends[key] the first slot of the key, ends[-1] the count
        width = int(n.prod(-1).max())
        pose, point = np.nonzero(cells >= 0)
        key = pose * width + cells[pose, point]
        src = point[np.argsort(key, kind="stable")]
        ends = np.concatenate([[0], np.cumsum(np.bincount(
            key, minlength=p_n * width))])
        tmpl = templates[b]
        fin = np.isfinite(tmpl).all(-1)
        tc = np.where(fin[..., None],
                      template_cells(tmpl, modes[b], los[b], invs[b]), 0)
        base = (np.arange(p_n) * width)[:, None]
        ny, nz = n[:, 1:2], n[:, 2:3]
        z0 = np.maximum(tc[..., 2] - 1, 0)
        z1 = np.minimum(tc[..., 2] + 1, nz - 1)
        t_hit = np.zeros(p_n * t_n, bool)
        s_hit = np.zeros(p_n * s_n, bool)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                cx, cy = tc[..., 0] + dx, tc[..., 1] + dy
                ok = fin & (cx >= 0) & (cx < n[:, :1]) & (cy >= 0) \
                    & (cy < ny)
                row = base + np.where(ok, (cx * ny + cy) * nz, 0)
                j0 = ends[row + z0]
                lens = np.where(ok, ends[row + z1 + 1] - j0, 0)
                out[2, b] += lens.sum(-1)
                if not hits or not lens.any():
                    continue
                lens, j0 = lens.ravel(), j0.ravel()
                ti = np.repeat(np.arange(p_n * t_n), lens)
                first = np.repeat(np.cumsum(lens) - lens, lens)
                qi = src[np.arange(len(ti)) - first + np.repeat(j0, lens)]
                with np.errstate(over="ignore", invalid="ignore"):
                    d = tmpl.reshape(-1, 3)[ti] - scan[b, qi]
                    d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
                        + d[:, 2] * d[:, 2]
                hit = d2 < r2
                t_hit[ti[hit]] = True
                s_hit[ti[hit] // t_n * s_n + qi[hit]] = True
        nan_t = np.isnan(tmpl).any((1, 2))
        nan_s = (np.isnan(scan[b]).any(-1) & scan_mask[b]).any()
        out[0, b] = 0 if nan_s else t_hit.reshape(p_n, t_n).sum(1)
        out[1, b] = np.where(nan_t, 0, s_hit.reshape(p_n, s_n).sum(1))
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/tfl_counts.cu), bound with ctypes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel():
    """The bound C entry point of ``csrc/tfl_counts.cu``, built at first
    use."""
    from monosowa_tpu_torch.ops._build import load_library

    fn = load_library("tfl_counts").tfl_counts
    p, i = ctypes.c_void_p, ctypes.c_int
    # scan, mask, templates, t_count, s_count, B, S, P, T, plan, stream
    fn.argtypes = [p, p, p, p, p, i, i, i, i, TflCellPlan, p]
    fn.restype = ctypes.c_int
    return fn


def _launch_counts(scan, scan_mask, templates, radius):
    """(t_count, s_count), each (B, P) float32, from one launch of
    ``csrc/tfl_counts.cu``."""
    global launches
    b, p, t, _ = templates.shape
    s = scan.shape[1]
    plan = tfl_cell_plan(s, radius)
    if b > 65535:
        raise ValueError(f"B = {b} cars: the kernel takes at most 65,535")
    kernel = _kernel()
    t_count = torch.empty(b, p, device=scan.device, dtype=torch.float32)
    s_count = torch.empty(b, p, device=scan.device, dtype=torch.float32)
    if b * p == 0:
        return t_count, s_count
    with torch.cuda.device(scan.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(scan.data_ptr(), scan_mask.data_ptr(),
                     templates.data_ptr(), t_count.data_ptr(),
                     s_count.data_ptr(), b, s, p, t, plan,
                     stream)
    if err != 0:
        raise RuntimeError(f"tfl_counts launch failed: CUDA error {err}")
    launches += 1
    return t_count, s_count


# ---------------------------------------------------------------------------
# Voxel fields
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static geometry of a voxel field (local coordinates)."""

    origin: Tuple[float, float, float]
    voxel: float
    shape: Tuple[int, int, int]


def _ball_kernel(radius: float, voxel: float) -> np.ndarray:
    """Odd-sized (K, K, K) 0/1 mask of voxel offsets whose center-to-center
    distance is within ``radius``."""
    k = int(np.ceil(radius / voxel))
    r = np.arange(-k, k + 1)
    dx, dy, dz = np.meshgrid(r, r, r, indexing="ij")
    d2 = (dx * dx + dy * dy + dz * dz) * voxel * voxel
    return (d2 <= radius * radius).astype(np.float32)


def occupancy_histogram(pts: torch.Tensor, mask: torch.Tensor,
                        spec: FieldSpec) -> torch.Tensor:
    """(B, N, 3) points, (B, N) mask -> (B, X, Y, Z) per-voxel counts of the
    valid in-bounds points, float32, by one ``index_add_``.

    The origin and the voxel size are rounded to float32 before
    ``(pts - origin) / voxel``, and the division is a true division by a
    tensor, so a point on a voxel face lands in the same voxel as in the
    JAX package."""
    sx, sy, sz = spec.shape
    b = pts.shape[0]
    origin = pts.new_tensor(spec.origin)
    idx = torch.floor((pts - origin) / pts.new_tensor(spec.voxel)).long()
    in_b = ((idx >= 0) & (idx < idx.new_tensor(spec.shape))).all(-1)
    valid = in_b & mask
    cells = sx * sy * sz
    flat = (idx[..., 0] * sy + idx[..., 1]) * sz + idx[..., 2]
    flat = flat + torch.arange(b, device=pts.device)[:, None] * cells
    # invalid points go to one spare cell past the end
    flat = torch.where(valid, flat, flat.new_tensor(b * cells))
    counts = pts.new_zeros(b * cells + 1)
    counts.index_add_(0, flat.reshape(-1), pts.new_ones(flat.numel()))
    return counts[:-1].reshape(b, sx, sy, sz)


# ---------------------------------------------------------------------------
# Membership fields and the gather grid (the JAX package's first coarse
# pass, before the convolutional one; ``sowa/fitting.fit_cars``)
# ---------------------------------------------------------------------------

# Field covering the coarse pose grid around a car's median center:
# x: +-(l/2 + |dx|max + r), z: dz in [-1,3] plus reach, y: template half-height.
CAR_FIELD = FieldSpec(origin=(-4.48, -1.28, -3.52), voxel=0.08,
                      shape=(112, 32, 116))
# Canonical-frame template field (x=width, y=height, z=length).
TEMPLATE_FIELD = FieldSpec(origin=(-1.28, -1.28, -2.24), voxel=0.08,
                           shape=(32, 32, 56))


def _neighbor_offsets(radius: float, voxel: float) -> np.ndarray:
    k = int(np.ceil(radius / voxel)) + 1
    r = np.arange(-k, k + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    # keep offsets whose voxel could possibly be within radius of the point
    min_d = np.maximum(np.abs(offs) - 1.0, 0.0) * voxel
    keep = (min_d ** 2).sum(-1) <= radius * radius
    return offs[keep].astype(np.int32)


def build_membership_field(pts: torch.Tensor, mask: torch.Tensor,
                           spec: FieldSpec, radius: float) -> torch.Tensor:
    """int8 field[v] = 1 iff some valid point lies within ~``radius`` of the
    center of voxel v; pts in the field's local frame.  (B, N, 3), (B, N)
    -> (B, X*Y*Z) flat in (x, y, z) order; (N, 3), (N,) -> (X*Y*Z,).

    The occupancy counts (``occupancy_histogram``) dilated by the voxel
    ball: one 3-D cross-correlation, its sums rounded (``_count_conv``),
    then > 0.5; the JAX package's sum of 2-D convolutions over shifted y
    slices gives the same whole numbers."""
    if pts.dim() == 2:
        return build_membership_field(pts[None], mask[None], spec,
                                      radius)[0]
    counts = occupancy_histogram(pts, mask.bool(), spec)    # (B, X, Y, Z)
    kern = torch.as_tensor(_ball_kernel(radius, spec.voxel),
                           device=pts.device)[None, None]   # [dx, dy, dz]
    acc = _count_conv(F.conv3d, counts[:, None], kern,
                      padding=kern.shape[-1] // 2)[:, 0]
    return (acc.reshape(acc.shape[0], -1) > 0.5).to(torch.int8)


def _take_field(field_flat: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """field (F,) or (B, F) at flat indices (...) or (B, ...)."""
    if field_flat.dim() == 1:
        return field_flat[flat]
    b = field_flat.shape[0]
    return torch.gather(field_flat, 1, flat.reshape(b, -1)).reshape(
        flat.shape)


def sample_membership(field_flat: torch.Tensor, spec: FieldSpec,
                      pts: torch.Tensor) -> torch.Tensor:
    """Nearest-voxel membership lookup; (..., 3) -> (...,) int8 (0 outside).
    A field (B, F) takes points (B, ..., 3).  The voxel index is a true
    division by the voxel size as a tensor, as in the JAX function."""
    origin = pts.new_tensor(spec.origin)
    idx = torch.floor((pts - origin) / pts.new_tensor(spec.voxel)).long()
    shape = idx.new_tensor(spec.shape)
    in_bounds = ((idx >= 0) & (idx < shape)).all(-1)
    cidx = torch.minimum(idx.clamp_min(0), shape - 1)
    flat = (cidx[..., 0] * (spec.shape[1] * spec.shape[2])
            + cidx[..., 1] * spec.shape[2] + cidx[..., 2])
    return torch.where(in_bounds, _take_field(field_flat, flat),
                       torch.zeros((), dtype=field_flat.dtype,
                                   device=field_flat.device))


def build_template_field(template_pts: np.ndarray, radius: float,
                         spec: FieldSpec = TEMPLATE_FIELD,
                         device=None) -> torch.Tensor:
    """Precompute (once per template model) the canonical-frame field,
    (X*Y*Z,) int8 on ``device`` (the CPU when None)."""
    pts = torch.as_tensor(np.asarray(template_pts, np.float32),
                          device=device)
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    return build_membership_field(pts, mask, spec, radius)


def _sample_membership_xyz(field_flat: torch.Tensor, spec: FieldSpec,
                           x: torch.Tensor, y: torch.Tensor,
                           z: torch.Tensor) -> torch.Tensor:
    """Component-wise membership lookup, coordinates as separate planes.
    The voxel index is ``(x - origin) * float32(1 / voxel)``, a product,
    as in the JAX function (``sample_membership`` divides)."""
    ox, oy, oz = (float(np.float32(o)) for o in spec.origin)
    inv = float(np.float32(1.0 / spec.voxel))
    ix = torch.floor((x - ox) * inv).long()
    iy = torch.floor((y - oy) * inv).long()
    iz = torch.floor((z - oz) * inv).long()
    sx, sy, sz = spec.shape
    inb = ((ix >= 0) & (ix < sx) & (iy >= 0) & (iy < sy)
           & (iz >= 0) & (iz < sz))
    flat = (ix.clamp(0, sx - 1) * (sy * sz) + iy.clamp(0, sy - 1) * sz
            + iz.clamp(0, sz - 1))
    return torch.where(inb, _take_field(field_flat, flat),
                       torch.zeros((), dtype=field_flat.dtype,
                                   device=field_flat.device))


def grid_pose_losses(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                     template: torch.Tensor, template_field: torch.Tensor,
                     thetas: torch.Tensor, trans: torch.Tensor,
                     radius: float, car_spec: FieldSpec = CAR_FIELD,
                     tmpl_spec: FieldSpec = TEMPLATE_FIELD) -> torch.Tensor:
    """Approximate binary2way TFL over a (theta x translation) pose grid by
    membership fields, per car.

    scan_local (B, S, 3) relative to each car's center, scan_mask (B, S);
    template (T, 3) canonical and template_field its flat int8 field;
    thetas (NT,) or per car (B, NT); trans (P, 3).  Returns losses
    (B, NT, P) = -(t_frac + s_frac), a theta at a time (the JAX
    ``lax.map``).  The cosines and sines are computed once on the CPU, so
    the card and the CPU pose the same points."""
    b = scan_local.shape[0]
    dev = scan_local.device
    scan_field = build_membership_field(scan_local, scan_mask, car_spec,
                                        radius)              # (B, F)
    maskf = scan_mask.to(torch.float32)
    n_scan = scan_mask.sum(-1).clamp_min(1).to(torch.float32)  # (B,)
    n_t = template.new_tensor(float(template.shape[0]))
    th = thetas.expand(b, -1) if thetas.dim() == 1 else thetas
    th_cpu = th.detach().cpu()
    cos_all = torch.cos(th_cpu).to(dev)
    sin_all = torch.sin(th_cpu).to(dev)
    px, py, pz = template[:, 0], template[:, 1], template[:, 2]   # (T,)
    sx_, sy_, sz_ = (scan_local[..., k][:, None, :] for k in range(3))
    tx, ty, tz = (trans[:, k][None, :, None] for k in range(3))   # (1,P,1)
    out = []
    for j in range(th.shape[1]):
        c = cos_all[:, j, None, None]                       # (B, 1, 1)
        s = sin_all[:, j, None, None]
        # posed template: R_y @ p + t  (rows: x' = c x + s z; z' = -s x + c z)
        rx = c * px + s * pz                                # (B, 1, T)
        rz = -s * px + c * pz
        t_hits = _sample_membership_xyz(
            scan_field, car_spec, rx + tx, py + ty, rz + tz)   # (B, P, T)
        t_frac = t_hits.to(torch.float32).sum(-1) / n_t
        # scan -> canonical frame: q = R^T (s - t)
        dx = sx_ - tx                                       # (B, P, S)
        dz = sz_ - tz
        qx = c * dx - s * dz
        qz = s * dx + c * dz
        s_hits = _sample_membership_xyz(
            template_field, tmpl_spec, qx, sy_ - ty, qz)    # (B, P, S)
        s_frac = (s_hits.to(torch.float32) * maskf[:, None, :]).sum(-1) \
            / n_scan[:, None]
        out.append(-(t_frac + s_frac))
    return torch.stack(out, 1)


# ---------------------------------------------------------------------------
# Convolutional coarse-grid evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvGridSpec:
    """Static geometry tying the translation grid to a voxel lattice.

    The translation steps equal the voxel size and the grid endpoints are
    integer multiples of it (n_dx / n_dz are bumped by
    ``ConvGridSpec.aligned``: the reference's 40-step 4 m range becomes 41
    steps of 0.10 m), so evaluating the TFL over the whole
    (theta x dx x dz) grid becomes, per theta, one VALID cross-correlation
    between a scan field and a precomputed rotated template kernel.
    Voxel-center quantisation error is bounded by one voxel diagonal and
    the exact fine pass re-anchors theta.
    """

    @staticmethod
    def aligned(dx_min, dx_max, dz_min, dz_max, n_dx, n_dz, n_theta, radius,
                reach=2.3):
        """Bump the step counts until the endpoints sit on the step lattice
        (finer grid = strict superset quality-wise)."""
        def fix(lo, hi, n):
            for nn in range(n, n + 8):
                h = (hi - lo) / (nn - 1)
                if abs(lo / h - round(lo / h)) < 1e-6:
                    return nn
            return n
        return ConvGridSpec(dx_min=dx_min, dx_max=dx_max, dz_min=dz_min,
                            dz_max=dz_max, n_dx=fix(dx_min, dx_max, n_dx),
                            n_dz=fix(dz_min, dz_max, n_dz),
                            n_theta=n_theta, radius=radius, reach=reach)

    dx_min: float = -2.0
    dx_max: float = 2.0
    dz_min: float = -1.0
    dz_max: float = 3.0
    n_dx: int = 40
    n_dz: int = 40
    n_theta: int = 40
    radius: float = 0.2
    reach: float = 2.3          # template circumradius + radius margin

    @property
    def h(self) -> float:
        return (self.dx_max - self.dx_min) / (self.n_dx - 1)

    @property
    def k_half(self) -> int:
        return int(np.ceil(self.reach / self.h))

    @property
    def k_size(self) -> int:
        return 2 * self.k_half + 1

    @property
    def y_half(self) -> int:
        # template half-height + radius
        return int(np.ceil(1.0 / self.h))

    @property
    def y_size(self) -> int:
        return 2 * self.y_half + 1

    @property
    def x_size(self) -> int:
        return self.n_dx - 1 + self.k_size

    @property
    def z_size(self) -> int:
        return self.n_dz - 1 + self.k_size

    @property
    def origin(self):
        return (self.dx_min - (self.k_half + 0.5) * self.h,
                -(self.y_half + 0.5) * self.h,
                self.dz_min - (self.k_half + 0.5) * self.h)


def conv_translations(spec: "ConvGridSpec") -> np.ndarray:
    """(n_dx * n_dz, 3) translation table in the conv output's x-major
    order."""
    tx = spec.dx_min + np.arange(spec.n_dx) * spec.h
    tz = spec.dz_min + np.arange(spec.n_dz) * spec.h
    gx, gz = np.meshgrid(tx, tz, indexing="ij")
    return np.stack([gx.reshape(-1), np.zeros(gx.size), gz.reshape(-1)],
                    -1).astype(np.float32)


def rotated_template_kernels(template: np.ndarray,
                             spec: ConvGridSpec) -> tuple:
    """Precompute, per theta, the occupancy-count kernel (for the
    template->scan coverage term) and the ball-dilated membership kernel
    (for the scan->template term).  Host-side numpy, once per template.

    Returns (occ (NT, Y, K, K) float32, memb (NT, Y, K, K) float32).
    """
    import scipy.ndimage

    h = spec.h
    k = spec.k_half
    ky = spec.y_half
    ksz, ysz = spec.k_size, spec.y_size
    thetas = np.linspace(0.0, 2 * np.pi - 2 * np.pi / spec.n_theta,
                         spec.n_theta)

    ball = _ball_kernel(spec.radius, h).astype(bool)
    occ_all = np.zeros((spec.n_theta, ysz, ksz, ksz), np.float32)
    memb_all = np.zeros_like(occ_all)
    for ti, th in enumerate(thetas):
        c, s = np.cos(th), np.sin(th)
        rx = c * template[:, 0] + s * template[:, 2]
        rz = -s * template[:, 0] + c * template[:, 2]
        ay = np.floor(template[:, 1] / h + 0.5).astype(int) + ky
        ax = np.floor(rx / h + 0.5).astype(int) + k
        az = np.floor(rz / h + 0.5).astype(int) + k
        ok = ((ay >= 0) & (ay < ysz) & (ax >= 0) & (ax < ksz)
              & (az >= 0) & (az < ksz))
        np.add.at(occ_all[ti], (ay[ok], ax[ok], az[ok]), 1.0)
        memb_all[ti] = scipy.ndimage.binary_dilation(
            occ_all[ti] > 0, structure=np.transpose(ball, (1, 0, 2))
        ).astype(np.float32)
    return occ_all, memb_all


def _count_conv(fn, field: torch.Tensor, kernel: torch.Tensor, **kwargs
                ) -> torch.Tensor:
    """A float32 cross-correlation of two whole-number fields (sums far
    below 2^24), rounded to the nearest whole number.  TF32 is off whatever
    the process-wide setting.  On an H100 cuDNN answers kernels this large
    with an FFT algorithm whose sums come out about 2e-4 off whole
    numbers, also with ``deterministic`` set; the rounding undoes that,
    and changes nothing where the sums were exact already, as on the CPU.
    The selection downstream depends on exact ties between counts."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        return torch.round(fn(field, kernel, **kwargs))


def _conv_fields(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                 spec: ConvGridSpec):
    """Scan counts and ball-dilated membership on the conv lattice, each
    (B, Y, X, Z).  The dilation is one 3-D cross-correlation of the counts
    with the voxel ball, thresholded at 0.5."""
    fspec = FieldSpec(origin=spec.origin, voxel=spec.h,
                      shape=(spec.x_size, spec.y_size, spec.z_size))
    counts = occupancy_histogram(scan_local, scan_mask, fspec)  # (B,X,Y,Z)
    counts_yxz = counts.permute(0, 2, 1, 3).contiguous()
    kern = _ball_kernel(spec.radius, spec.h)                    # [dx,dy,dz]
    half = kern.shape[0] // 2
    k3 = torch.as_tensor(np.ascontiguousarray(kern.transpose(1, 0, 2)),
                         device=counts.device)[None, None]      # [dy,dx,dz]
    acc = _count_conv(F.conv3d, counts_yxz[:, None], k3, padding=half)[:, 0]
    return counts_yxz, (acc > 0.5).to(counts.dtype)


def grid_pose_counts_conv(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                          occ_kernels: torch.Tensor,
                          memb_kernels: torch.Tensor, spec: ConvGridSpec):
    """The two coverage counts over the full pose grid, each
    (B, NT, n_dx, n_dz): template points in a scan-occupied voxel ball, and
    scan points in a template-occupied voxel ball.  Integer values in
    float32."""
    counts_yxz, memb_yxz = _conv_fields(scan_local, scan_mask, spec)
    count_t = _count_conv(F.conv2d, memb_yxz, occ_kernels)
    count_s = _count_conv(F.conv2d, counts_yxz, memb_kernels)
    return count_t, count_s


def grid_pose_losses_conv(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                          occ_kernels: torch.Tensor,
                          memb_kernels: torch.Tensor, spec: ConvGridSpec,
                          n_template: int) -> torch.Tensor:
    """binary2way TFL over the full pose grid as two convolutions.

    scan_local (B, S, 3) relative to each car's center, scan_mask (B, S),
    occ_kernels / memb_kernels (NT, Y, K, K).  Returns losses
    (B, NT, n_dx * n_dz), translations ordered x-major
    (``conv_translations``)."""
    count_t, count_s = grid_pose_counts_conv(scan_local, scan_mask,
                                             occ_kernels, memb_kernels, spec)
    n_scan = scan_mask.sum(-1).clamp_min(1).to(count_t.dtype)
    t_frac = count_t / count_t.new_tensor(float(n_template))
    s_frac = count_s / n_scan[:, None, None, None]
    loss = -(t_frac + s_frac)
    return loss.reshape(loss.shape[0], loss.shape[1], -1)
