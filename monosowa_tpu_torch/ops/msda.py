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

``ms_deform_attn`` goes through ``MSDAFunction`` on every device.  For CUDA
tensors its forward launches ``csrc/msda_fwd.cu`` and its backward
``csrc/msda_bwd.cu``; for CPU tensors it runs the plain versions
(``ms_deform_attn_plain``, ``msda_grad_loc_aw_plain``,
``msda_grad_value_plain``).  There is no other path.  ``launches`` counts
forward kernel launches and ``bwd_launches`` backward ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

SpatialShapes = Sequence[Tuple[int, int]]

# kernel launches made by the forward and the backward (read and reset by
# callers that must show a run went through the kernels)
launches = 0
bwd_launches = 0


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
    """The plain PyTorch MSDA forward: explicit per-corner row gathers.
    Differentiable by torch.autograd through its gathers."""
    b, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    vflat = value.reshape(b * s * m, d)
    out = value.new_zeros(b, q, m, d)
    for lvl, h, w, start in _levels(spatial_shapes):
        first = _first_rows(b, s, start, value.device)
        sampled = None
        for flat, cw, _, _, inb in _corner_geometry(loc[:, :, :, lvl], h, w):
            v = vflat[_rows(flat, first, m)]                 # (B,Q,M,P,D)
            term = v * (cw * inb)[..., None]
            sampled = term if sampled is None else sampled + term
        out = out + torch.einsum("bqmpd,bqmp->bqmd", sampled,
                                 aw[:, :, :, lvl])
    return out.reshape(b, q, m * d)


def msda_grad_loc_aw_plain(value: torch.Tensor,
                           spatial_shapes: SpatialShapes, loc: torch.Tensor,
                           aw: torch.Tensor, dout: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain MSDA backward for loc and aw (K2's contract, folded).

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
            g = (vflat[_rows(flat, first, m)] * do).sum(-1) * inb
            dw_l = dw_l + cw * g
            dx_l = dx_l + dwx * g
            dy_l = dy_l + dwy * g
        aw_l = aw[:, :, :, lvl]
        dls.append(torch.stack([aw_l * w * dx_l, aw_l * h * dy_l], -1))
        dws.append(dw_l)
    return torch.stack(dls, 3), torch.stack(dws, 3)


def msda_grad_value_plain(value_shape: Sequence[int],
                          spatial_shapes: SpatialShapes, loc: torch.Tensor,
                          aw: torch.Tensor, dout: torch.Tensor
                          ) -> torch.Tensor:
    """The plain MSDA backward for value (K3's contract): for each sample
    and in-bounds corner, dValue[b, token, m, :] += aw * w_corner *
    dout[b, q, m, :], as one ``index_add_`` scatter per level and corner.
    dout is (B, Q, M * D); returns dvalue of ``value_shape`` (B, S, M, D)."""
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
    return dvalue.reshape(b, s, m, d)


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
                                           dout)
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
    # float32 everywhere; float64 too on the CPU, where the plain version
    # runs (the kernels take float32 only)
    dtypes = (torch.float32, torch.float64) if value.device.type == "cpu" \
        else (torch.float32,)
    for name, t in (("value", value), ("loc", loc), ("aw", aw)):
        if t.dtype != value.dtype or t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}, value {value.dtype}: "
                            f"MSDA on {value.device.type} takes one of "
                            f"{dtypes}")
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
# the CUDA kernels (csrc/msda_fwd.cu, csrc/msda_bwd.cu), bound with ctypes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    """The bound C entry point of ``csrc/<name>.cu``, built at first use."""
    from monosowa_tpu_torch.ops._build import load_library

    fn = getattr(load_library(name), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "msda_fwd":
        # value, loc, aw, out, level_hw (host), n_levels, B, S, Q, M, D, P,
        # stream
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    else:
        # value, loc, aw, dout, dvalue, dloc, daw, level_hw (host),
        # n_levels, B, S, Q, M, D, P, stream
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _cuda_args(tensors, spatial_shapes):
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"the MSDA kernels take contiguous float32, got "
                            f"{t.dtype}, contiguous={t.is_contiguous()}")
    hw = (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[int(v) for hw_l in spatial_shapes for v in hw_l])
    return hw


def _launch_fwd(value, spatial_shapes, loc, aw):
    global launches
    hw = _cuda_args((value, loc, aw), spatial_shapes)
    kernel = _kernel("msda_fwd")
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    out = torch.empty(b, q, m * d, device=value.device, dtype=torch.float32)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                     out.data_ptr(), ctypes.addressof(hw), n_levels,
                     b, s, q, m, d, p, stream)
    if err != 0:
        raise RuntimeError(f"msda_fwd launch failed: CUDA error {err}")
    launches += 1
    return out


def _launch_bwd(value, spatial_shapes, loc, aw, dout):
    """dvalue, dloc, daw from one launch of ``csrc/msda_bwd.cu``."""
    global bwd_launches
    hw = _cuda_args((value, loc, aw, dout), spatial_shapes)
    kernel = _kernel("msda_bwd")
    b, s, m, d = value.shape
    q, n_levels, p = loc.shape[1], loc.shape[3], loc.shape[4]
    dvalue = torch.empty_like(value)      # zeroed by the launch
    dloc = torch.empty_like(loc)
    daw = torch.empty_like(aw)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(value.data_ptr(), loc.data_ptr(), aw.data_ptr(),
                     dout.data_ptr(), dvalue.data_ptr(), dloc.data_ptr(),
                     daw.data_ptr(), ctypes.addressof(hw), n_levels,
                     b, s, q, m, d, p, stream)
    if err != 0:
        raise RuntimeError(f"msda_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return dvalue, dloc, daw
