"""Multi-scale deformable attention (MSDA): forward and backward.

Contract (MonoDETR ops/functions/ms_deform_attn_func.py:41-61, the JAX
package's ``ops/msda.py`` ``ms_deform_attn`` and its custom VJP
``_msda_bwd``): per level, bilinear samples of ``value`` at locations given
in [0, 1] with grid_sample semantics (align_corners=False, zero padding:
pixel x = loc_x * W - 0.5), weighted by the attention weights and summed
over levels x points.

    value (B, S, M, D)          S = sum of H_l * W_l over the levels
    loc   (B, Q, M, L, P, 2)    (x, y) in [0, 1]
    aw    (B, Q, M, L, P)
    ->    (B, Q, M * D)

Types: value is float32 or bfloat16 (float64 too on the CPU); loc and aw
are float32 (float64 with a float64 value).  The output is float32 (float64
with a float64 value): bfloat16 value rows are read as they are and every
product and sum is float32, as K1 reads bf16 quad rows into float32 sums
(JAX package ``ops/msda_mxu.py:235``) and as jnp promotes bf16 x f32.  The
value gradient comes back in value's dtype, summed in float32 and rounded
once (``ops/msda.py:474``, ``msda_mxu.py:635``).

``ms_deform_attn`` goes through ``MSDAFunction`` on every device.  For CUDA
tensors its forward launches ``csrc/msda_fwd.cu`` and its backward
``csrc/msda_bwd.cu`` (entry points ``msda_fwd`` / ``msda_bwd`` for a float32
value, ``msda_fwd_bf16`` / ``msda_bwd_bf16`` for a bfloat16 one); for CPU
tensors it runs the plain versions (``ms_deform_attn_plain``,
``msda_grad_loc_aw_plain``, ``msda_grad_value_plain``).  There is no other
path.  ``launches`` and ``bwd_launches`` count the float32 kernels'
launches, ``launches_bf16`` and ``bwd_launches_bf16`` the bfloat16 ones.

The kernels take their block map from ``msda_plan``: the order in which
queries are walked (image tiles where the queries are the pyramid's own
tokens), each block's run of it, and the coarse levels a block keeps whole
in shared memory.  It is built once per shape and device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

SpatialShapes = Sequence[Tuple[int, int]]
# value's dtypes on every device (the kernels' two forms)
VALUE_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches made by the forward and the backward, float32 and
# bfloat16 value (read and reset by callers that must show a run went
# through the kernels)
launches = 0
bwd_launches = 0
launches_bf16 = 0
bwd_launches_bf16 = 0


def _corner_geometry(loc: torch.Tensor, h: int, w: int):
    """The four bilinear corners of each sample: (flat_index, weight,
    dweight/dx, dweight/dy, in_bounds) with grid_sample(align_corners=False)
    semantics."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    corners = []
    for cx, cy, cw, dwx, dwy in (
            (x0, y0, (1 - dx) * (1 - dy), -(1 - dy), -(1 - dx)),
            (x0 + 1, y0, dx * (1 - dy), (1 - dy), -dx),
            (x0, y0 + 1, (1 - dx) * dy, -dy, (1 - dx)),
            (x0 + 1, y0 + 1, dx * dy, dy, dx)):
        inb = ((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).to(loc.dtype)
        xi = cx.clamp(0, w - 1).long()
        yi = cy.clamp(0, h - 1).long()
        corners.append((yi * w + xi, cw, dwx, dwy, inb))
    return corners


def _levels(spatial_shapes: SpatialShapes):
    """(level, h, w, first token) of each level."""
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        yield lvl, h, w, start
        start += h * w


def _rows(flat: torch.Tensor, b_first: torch.Tensor, m: int) -> torch.Tensor:
    """Row of each corner in value viewed as (B * S * M, D): flat is the
    level-local token (B, Q, M, P), b_first the (B, 1, 1, 1) index of each
    image's first row of the level."""
    head = torch.arange(m, device=flat.device).view(1, 1, m, 1)
    return (b_first + flat) * m + head


def _first_rows(b: int, s: int, start: int, dev) -> torch.Tensor:
    return (torch.arange(b, device=dev) * s + start).view(b, 1, 1, 1)


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: SpatialShapes,
                         loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch MSDA forward: explicit per-corner row gathers, in
    loc's dtype (bfloat16 rows are upcast as they are gathered).
    Differentiable by torch.autograd through its gathers."""
    b, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    vflat = value.reshape(b * s * m, d)
    out = loc.new_zeros(b, q, m, d)
    for lvl, h, w, start in _levels(spatial_shapes):
        first = _first_rows(b, s, start, value.device)
        sampled = None
        for flat, cw, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            v = vflat[_rows(flat, first, m)].to(loc.dtype)   # (B,Q,M,P,D)
            term = v * (cw * inb)[..., None]
            sampled = term if sampled is None else sampled + term
        out = out + torch.einsum("bqmpd,bqmp->bqmd", sampled,
                                 aw[:, :, :, lvl])
    return out.reshape(b, q, m * d)


def msda_grad_loc_aw_plain(value: torch.Tensor,
                           spatial_shapes: SpatialShapes, loc: torch.Tensor,
                           aw: torch.Tensor, dout: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain MSDA backward for loc and aw (K2's contract, folded), in
    dout's dtype (bfloat16 value rows are upcast as they are gathered).

    For each sample and in-bounds corner, gdot = <value corner row,
    dout[b, q, m, :]>; then, as the JAX package's ``ops/msda.py:311-324``
    folds them, dAttn = sum over corners of w_corner * gdot and
    dLoc = aw * (W, H) * sum over corners of (dw/dx, dw/dy) * gdot.
    dout is (B, Q, M * D); returns dloc (B, Q, M, L, P, 2), daw (B, Q, M,
    L, P)."""
    b, s, m, d = value.shape
    q = loc.shape[1]
    vflat = value.reshape(b * s * m, d)
    do = dout.reshape(b, q, m, 1, d)
    dls, dws = [], []
    for lvl, h, w, start in _levels(spatial_shapes):
        first = _first_rows(b, s, start, value.device)
        dw_l = dx_l = dy_l = 0.0
        for flat, cw, dwx, dwy, inb in _corner_geometry(loc[:, :, :, lvl],
                                                         h, w):
            g = (vflat[_rows(flat, first, m)].to(do.dtype) * do).sum(-1) \
                * inb
            dw_l = dw_l + cw * g
            dx_l = dx_l + dwx * g
            dy_l = dy_l + dwy * g
        aw_l = aw[:, :, :, lvl]
        dls.append(torch.stack([aw_l * w * dx_l, aw_l * h * dy_l], -1))
        dws.append(dw_l)
    return torch.stack(dls, 3), torch.stack(dws, 3)


def msda_grad_value_plain(value_shape: Sequence[int],
                          spatial_shapes: SpatialShapes, loc: torch.Tensor,
                          aw: torch.Tensor, dout: torch.Tensor,
                          dtype: torch.dtype = None) -> torch.Tensor:
    """The plain MSDA backward for value (K3's contract): for each sample
    and in-bounds corner, dValue[b, token, m, :] += aw * w_corner *
    dout[b, q, m, :], as one ``index_add_`` scatter per level and corner.
    dout is (B, Q, M * D); returns dvalue of ``value_shape`` (B, S, M, D),
    summed in dout's dtype and rounded once to ``dtype`` (value's; None:
    dout's)."""
    b, s, m, d = value_shape
    q = loc.shape[1]
    do = dout.reshape(b, q, m, 1, d)
    dvalue = dout.new_zeros(b * s * m, d)
    for lvl, h, w, start in _levels(spatial_shapes):
        first = _first_rows(b, s, start, loc.device)
        aw_l = aw[:, :, :, lvl]
        for flat, cw, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            coef = aw_l * cw * inb                           # (B,Q,M,P)
            dvalue.index_add_(0, _rows(flat, first, m).reshape(-1),
                              (coef[..., None] * do).reshape(-1, d))
    return dvalue.reshape(b, s, m, d).to(dtype or dout.dtype)


class MSDAFunction(torch.autograd.Function):
    """MSDA with its backward: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, value, loc, aw, spatial_shapes):
        shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        ctx.spatial_shapes = shapes
        ctx.save_for_backward(value, loc, aw)
        if value.device.type == "cpu":
            return ms_deform_attn_plain(value, shapes, loc, aw)
        return _launch_fwd(value, shapes, loc, aw)

    @staticmethod
    def backward(ctx, dout):
        value, loc, aw = ctx.saved_tensors
        shapes = ctx.spatial_shapes
        dout = dout.contiguous()
        if value.device.type == "cpu":
            dloc, daw = msda_grad_loc_aw_plain(value, shapes, loc, aw, dout)
            dvalue = msda_grad_value_plain(value.shape, shapes, loc, aw,
                                           dout, value.dtype)
        else:
            dvalue, dloc, daw = _launch_bwd(value, shapes, loc, aw, dout)
        need = ctx.needs_input_grad
        return (dvalue if need[0] else None, dloc if need[1] else None,
                daw if need[2] else None, None)


def _check(value, spatial_shapes, loc, aw):
    b, s, m, d = value.shape
    q = loc.shape[1]
    n_levels = len(spatial_shapes)
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not sum to "
                         f"the {s} value tokens")
    if loc.dim() != 6 or tuple(loc.shape[:4]) != (b, q, m, n_levels) \
            or loc.shape[5] != 2:
        raise ValueError(f"loc shape {tuple(loc.shape)} does not match "
                         f"value {tuple(value.shape)} and {n_levels} levels")
    if tuple(aw.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"aw shape {tuple(aw.shape)} != "
                         f"{tuple(loc.shape[:5])}")
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no MSDA for device {value.device}")
    # value float32 or bfloat16, loc and aw float32; all float64 on the CPU,
    # where the plain version runs
    dtypes = VALUE_DTYPES + ((torch.float64,) if value.device.type == "cpu"
                             else ())
    if value.dtype not in dtypes:
        raise TypeError(f"value is {value.dtype}: MSDA on "
                        f"{value.device.type} takes one of {dtypes}")
    want = torch.promote_types(value.dtype, torch.float32)
    for name, t in (("value", value), ("loc", loc), ("aw", aw)):
        if name != "value" and t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}: with a {value.dtype} "
                            f"value MSDA takes {want}")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on "
                             f"{value.device}")


def ms_deform_attn(value: torch.Tensor, spatial_shapes: SpatialShapes,
                   loc: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """MSDA with a gradient for value, loc and aw: the CUDA kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    _check(value, spatial_shapes, loc, aw)
    return MSDAFunction.apply(value.contiguous(), loc.contiguous(),
                              aw.contiguous(), spatial_shapes)


# ---------------------------------------------------------------------------
# the block map of the CUDA kernels: which queries a block takes, in which
# order, and which levels it keeps in shared memory.  Plain Python and numpy,
# so the CPU tests reach it; csrc/msda_common.cuh says how the kernels read it
# ---------------------------------------------------------------------------

# where the queries are the pyramid's own tokens (Q == S) they are walked in
# tiles of TILE_H x TILE_W tokens of their level, and a block takes RUN_TILES
# consecutive tiles of one level; other queries go in index order,
# RUN_QUERIES a block
TILE_H, TILE_W = 8, 8
RUN_TILES = 2
RUN_QUERIES = 16
# whole levels, coarsest first, are resident in shared memory while they fit
# RESIDENT_BUDGET bytes (two forward blocks share an SM's 227 KB; the
# backward's block adds a copy of the grad levels below for dvalue) and while a
# block's longest run reads at least RESIDENT_MIN_READS corner rows of the
# level for each row it would copy
RESIDENT_BUDGET = 100 * 1024
RESIDENT_MIN_READS = 12
# the backward sums dvalue of a resident level in shared memory too where a
# launch adds into each of its rows at least GRAD_MIN_ADDS times (per image
# and head), and by vector atomics in global memory otherwise: measured,
# shared-memory atomics pay only for the hottest rows
GRAD_MIN_ADDS = 512


def query_order(spatial_shapes: SpatialShapes, q: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(order (Q,) int32, runs (R, 2) int32): a permutation of the queries
    and, per block, the first place and the length of its run in it.

    Any order gives the same result; this one decides locality.  Where Q is
    the pyramid's token count the queries are taken for its tokens
    (level-major, row-major, as the encoder's reference points): tile after
    tile of each level, row-major inside a tile, and no run crosses from one
    level into the next.  Otherwise the order is the identity."""
    if q != sum(h * w for h, w in spatial_shapes):
        order = np.arange(q, dtype=np.int32)
        first = np.arange(0, q, RUN_QUERIES, dtype=np.int32)
        return order, np.stack([first, np.minimum(RUN_QUERIES, q - first)],
                               1).astype(np.int32)
    order, runs, at = [], [], 0
    for _, h, w, start in _levels(spatial_shapes):
        ys, xs = np.divmod(np.arange(h * w), w)
        tile = (ys // TILE_H) * -(-w // TILE_W) + xs // TILE_W
        order.append(start + np.lexsort((xs, ys, tile)))
        lengths = np.bincount(tile // RUN_TILES)
        runs.append(np.stack([at + np.cumsum(lengths) - lengths, lengths], 1))
        at += h * w
    return (np.concatenate(order).astype(np.int32),
            np.concatenate(runs).astype(np.int32))


def resident_levels(spatial_shapes: SpatialShapes, run_len: int,
                    n_points: int, d: int, elem_size: int = 4
                    ) -> Tuple[int, ...]:
    """The levels a block keeps whole in shared memory, a function of the
    shapes alone: coarsest first while the rows (``d`` channels of one
    head, ``elem_size`` bytes each: 4 for float32 value, 2 for bfloat16) fit
    RESIDENT_BUDGET, each only where a run of ``run_len`` queries, four
    corners to each of its ``n_points`` samples of the level, reads
    RESIDENT_MIN_READS corner rows for each row copied."""
    taken, nbytes = [], 0
    by_size = sorted(enumerate(spatial_shapes),
                     key=lambda it: (it[1][0] * it[1][1], -it[0]))
    for lvl, (h, w) in by_size:
        nbytes += h * w * d * elem_size
        if nbytes > RESIDENT_BUDGET or \
                h * w * RESIDENT_MIN_READS > run_len * n_points * 4:
            break
        taken.append(lvl)
    return tuple(sorted(taken))


def grad_levels(spatial_shapes: SpatialShapes, resident: Sequence[int],
                q: int, n_points: int) -> Tuple[int, ...]:
    """The resident levels whose share of dvalue the backward sums in shared
    memory: those whose rows get GRAD_MIN_ADDS adds or more (``q`` queries,
    four corners to each of ``n_points`` samples, over the level's rows)."""
    return tuple(lvl for lvl in resident if q * n_points * 4 >= GRAD_MIN_ADDS
                 * spatial_shapes[lvl][0] * spatial_shapes[lvl][1])


@dataclasses.dataclass(frozen=True)
class MSDAPlan:
    """What a launch hands the kernels beside the tensors."""
    order: torch.Tensor           # (Q,) int32 on the device
    runs: torch.Tensor            # (R, 2) int32 on the device
    n_runs: int
    max_run: int                  # the longest run's length
    identity: bool                # index order in runs of max_run
    resident: Tuple[int, ...]     # levels kept in shared memory
    resident_mask: int            # the same as bits
    resident_bytes: int           # value's rows, in its own dtype
    grad: Tuple[int, ...]         # of those, dvalue in shared memory too
    grad_mask: int
    grad_bytes: int               # float32 whatever value's dtype
    level_hw: ctypes.Array        # host array of (H, W) pairs


@functools.lru_cache(maxsize=None)
def msda_plan(spatial_shapes: Tuple[Tuple[int, int], ...], q: int,
              n_points: int, d: int, device: torch.device,
              elem_size: int = 4) -> MSDAPlan:
    """The block map for one shape, value element size (bytes) and device,
    built once."""
    order, runs = query_order(spatial_shapes, q)
    run_len = int(runs[:, 1].max()) if len(runs) else 0
    resident = resident_levels(spatial_shapes, run_len, n_points, d,
                               elem_size)
    grad = grad_levels(spatial_shapes, resident, q, n_points)
    hw = (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(v) for hw_l in spatial_shapes for v in hw_l])

    def mask(levels):
        return sum(1 << lvl for lvl in levels)

    def nbytes(levels, size):
        return sum(spatial_shapes[lvl][0] * spatial_shapes[lvl][1]
                   for lvl in levels) * d * size

    return MSDAPlan(
        order=torch.from_numpy(order).to(device),
        runs=torch.from_numpy(runs).to(device), n_runs=len(runs),
        max_run=run_len,
        identity=q != sum(h * w for h, w in spatial_shapes),
        resident=resident, resident_mask=mask(resident),
        resident_bytes=nbytes(resident, elem_size), grad=grad,
        grad_mask=mask(grad), grad_bytes=nbytes(grad, 4), level_hw=hw)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/msda_fwd.cu, csrc/msda_bwd.cu), bound with ctypes
# ---------------------------------------------------------------------------

# the entry point of each source for each value dtype
ENTRY = {("msda_fwd", torch.float32): "msda_fwd",
         ("msda_fwd", torch.bfloat16): "msda_fwd_bf16",
         ("msda_bwd", torch.float32): "msda_bwd",
         ("msda_bwd", torch.bfloat16): "msda_bwd_bf16"}


@functools.lru_cache(maxsize=None)
def _kernel(source: str, entry: str):
    """The bound C entry point ``entry`` of ``csrc/<source>.cu``, built at
    first use."""
    from monosowa_tpu_torch.ops._build import load_library

    fn = getattr(load_library(source), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    # the tensors (value, loc, aw, out for the forward; value, loc, aw,
    # dout, dvalue, dloc, daw for the backward), then order, runs, level_hw
    # (host), n_levels, n_runs, max_run, resident_mask, (the backward:
    # grad_mask,) B, S, Q, M, D, P, stream
    n_tensors, n_ints = (4, 10) if source == "msda_fwd" else (7, 11)
    fn.argtypes = [p] * (n_tensors + 3) + [i] * n_ints + [p]
    fn.restype = ctypes.c_int
    return fn


def _launch(source: str, tensors, out_tensors, spatial_shapes):
    """One call of a kernel's entry point for value's dtype on the tensors'
    device and PyTorch's current stream; raises where the launch is
    refused.  value is float32 or bfloat16, every other tensor float32, all
    contiguous."""
    value, loc = tensors[0], tensors[1]
    entry = ENTRY.get((source, value.dtype))
    for t in tensors + out_tensors:
        want = value.dtype if t is value else torch.float32
        if entry is None or t.dtype != want or not t.is_contiguous():
            raise TypeError(f"the MSDA kernels take a contiguous float32 or "
                            f"bfloat16 value and contiguous float32 "
                            f"otherwise, got {t.dtype} with value "
                            f"{value.dtype}, contiguous={t.is_contiguous()}")
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    plan = msda_plan(tuple((int(h), int(w)) for h, w in spatial_shapes), q,
                     p, d, value.device, value.element_size())
    kernel = _kernel(source, entry)
    # index order needs no arrays: the kernels then count for themselves
    order_runs = (None, None) if plan.identity else \
        (plan.order.data_ptr(), plan.runs.data_ptr())
    masks = (plan.resident_mask,) if source == "msda_fwd" else \
        (plan.resident_mask, plan.grad_mask)
    with torch.cuda.device(value.device):
        err = kernel(*[t.data_ptr() for t in (*tensors, *out_tensors)],
                     *order_runs,
                     ctypes.addressof(plan.level_hw), n_levels, plan.n_runs,
                     plan.max_run, *masks, b, s, q, m, d, p,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _launch_fwd(value, spatial_shapes, loc, aw):
    """out (B, Q, M * D) float32 from one call of ``csrc/msda_fwd.cu``."""
    global launches, launches_bf16
    b, _, m, d = value.shape
    out = torch.empty(b, loc.shape[1], m * d, device=value.device,
                      dtype=torch.float32)
    _launch("msda_fwd", (value, loc, aw), (out,), spatial_shapes)
    if value.dtype == torch.bfloat16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def _launch_bwd(value, spatial_shapes, loc, aw, dout):
    """dvalue (value's dtype), dloc, daw from one call of
    ``csrc/msda_bwd.cu``.  dvalue is summed in a float32 scratch (zeroed by
    the call) and, for a bfloat16 value, rounded to bfloat16 once after it,
    as the JAX package casts K3's float32 sums (``msda_mxu.py:635``)."""
    global bwd_launches, bwd_launches_bf16
    dvalue = torch.empty(value.shape, device=value.device,
                         dtype=torch.float32)
    dloc = torch.empty_like(loc)
    daw = torch.empty_like(aw)
    _launch("msda_bwd", (value, loc, aw, dout), (dvalue, dloc, daw),
            spatial_shapes)
    if value.dtype == torch.bfloat16:
        bwd_launches_bf16 += 1
        return dvalue.to(torch.bfloat16), dloc, daw
    bwd_launches += 1
    return dvalue, dloc, daw
