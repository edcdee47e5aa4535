"""Whole-window candidate extraction on the device, in torch.

The host implementation (``candidates.py``) walks masks with numpy, about
0.15-0.25 s a KITTI frame on one core.  This module moves the per-frame
geometry onto the card, one call per chunk of frames:

  depth maps (F, H, W) + bit-packed instance masks  ->  per-mask camera-
  frame centres, validity, and member points.

Each point IS a back-projected pixel, so mask membership is pixel indexing.

Semantics follow get_car_locations_from_img (loader.py:2802-2922) with two
documented approximations:
* erosion depth is an iterated 4-neighbourhood AND capped at ``K_MAX``
  steps (struct = 2 + sqrt(area)//10 needs more than K_MAX = 40 only for
  masks over ~144k px, beyond any car);
* medians are value-space bisections (``N_BISECT`` steps, averaging the two
  middle order statistics like np.median).

Counterpart of the JAX package's ``sowa/candidates_device.py``; the same
operations in the same order, so the bisections compare bit-equal inputs.
Every function takes torch tensors on any device; ``DeviceExtractor``
works on the card unless it is given another device.  Nothing here
synchronises with the card before the results are pulled: uploads go
through pinned memory without blocking, constants are scalars (a tensor
made from a Python number is a blocking copy), and the one metadata copy
of the bank path is enqueued with the work and waited for in
``extract_frames_banked_finish_chunks``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.sowa.candidates import CandidateConfig

K_MAX = 40          # erosion-depth cap (see module docstring)
N_BISECT = 18       # median bisection steps (~300 m / 2^18 = 1.1 mm)
# fixed-point depth transport: 300 m (the reference's metric3d clamp) over
# the uint16 range = 4.58 mm quantum, 2.29 mm max round-to-nearest error
DEPTH_U16_SCALE = 300.0 / 65536.0
BIG = 1e9


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device`` without waiting for the card: through
    pinned memory and a non-blocking copy (torch's host allocator keeps
    the pinned block until the copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _shifts(device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def _unpack_masks(packed: torch.Tensor, w: int) -> torch.Tensor:
    """(..., W//8) uint8 -> (..., W) bool (np.packbits bit order)."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)
                        )[..., :w] != 0


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., N) bool -> (..., N//8) uint8 (np.packbits bit order); N % 8 == 0."""
    n = bits.shape[-1]
    b = bits.reshape(bits.shape[:-1] + (n // 8, 8)).to(torch.uint8)
    return (b << _shifts(bits.device)).sum(-1).to(torch.uint8)


def _erosion_depth(masks: torch.Tensor) -> torch.Tensor:
    """(F, M, H, W) bool -> (F, M, H, W) int32 erosion survival depth
    (city-block distance to background, capped at K_MAX): a pixel survives
    k erosion steps iff depth > k."""
    m = masks
    acc = torch.zeros(masks.shape, dtype=torch.int8, device=masks.device)
    for _ in range(K_MAX):
        # edge replication: beyond the image there is no background to
        # erode from (binary_dilation border_value=0 in the reference)
        up = torch.cat([m[:, :, 1:], m[:, :, -1:]], 2)
        dn = torch.cat([m[:, :, :1], m[:, :, :-1]], 2)
        lf = torch.cat([m[..., 1:], m[..., -1:]], 3)
        rt = torch.cat([m[..., :1], m[..., :-1]], 3)
        m = m & up & dn & lf & rt
        acc += m.to(torch.int8)
    return (masks.to(torch.int8) + acc).to(torch.int32)


def _masked_rank_value(vals: torch.Tensor, member: torch.Tensor,
                       rank: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor) -> torch.Tensor:
    """Smallest v such that count(vals <= v among member) >= rank + 1,
    via N_BISECT value bisections.  vals (..., N); member (..., N) bool;
    rank (...,) int; lo/hi (...,) bracket."""
    # a non-member compares as +inf: (vm <= mid) == (vals <= mid) & member
    vm = torch.where(member, vals, float("inf"))
    for _ in range(N_BISECT):
        mid = (lo + hi) * 0.5
        cnt = (vm <= mid[..., None]).sum(-1, dtype=torch.int32)
        ge = cnt >= rank + 1
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def _masked_median(vals: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """np.median semantics over masked values (bisect the LOWER middle
    order statistic, then derive the upper middle in two extra passes: it
    is either the same value, where duplicates straddle the split, or the
    smallest member value above it).  Exact to the bisection resolution
    (~1 mm)."""
    n = member.sum(-1, dtype=torch.int32).clamp_min(1)
    v = torch.where(member, vals, BIG)
    lo = v.amin(-1)
    hi = torch.where(member, vals, -BIG).amax(-1)
    lo = torch.minimum(lo, hi)
    a = _masked_rank_value(v, member, (n - 1) // 2, lo, hi)
    cnt_le = ((v <= a[..., None]) & member).sum(-1, dtype=torch.int32)
    min_gt = torch.where(member & (vals > a[..., None]), vals,
                         BIG).amin(-1)
    upper = torch.where(cnt_le >= n // 2 + 1, a, torch.minimum(min_gt, hi))
    return torch.where(n % 2 == 1, a, (a + upper) * 0.5)


def _median3(pts: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3), member (..., N) -> (..., 3)."""
    return torch.stack([_masked_median(pts[..., i], member)
                        for i in range(3)], -1)


def _hypot(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot``'s formula, so that a circle test ``d < diameter``
    decides as the JAX package does: max * sqrt(1 + (min / max)^2)."""
    x1, x2 = x1.abs(), x2.abs()
    inf = torch.isposinf(x1) | torch.isposinf(x2)
    big, small = torch.maximum(x1, x2), torch.minimum(x1, x2)
    zero = big == 0
    q = small / torch.where(zero, torch.ones_like(big), big)
    x = torch.where(zero, big, big * torch.sqrt(1 + q * q))
    return torch.where(inf, torch.full_like(x, float("inf")), x)


def _norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


# ---------------------------------------------------------------------------
# Bit-packed stages (bank mode)
#
# The bank-mode extraction keeps every membership plane as np.packbits-
# layout uint8 words end to end: the erosion chain, the membership selects
# and the compaction read 8x fewer bytes than bool planes, and the
# compaction routes output slots to pixels with row/byte prefix sums
# instead of a sort over every pixel.
# ---------------------------------------------------------------------------


def _col_bit_mask(w: int, wb: int, cols) -> np.ndarray:
    """(WB,) uint8 with the bits of the given pixel COLUMNS set."""
    out = np.zeros(wb, np.uint8)
    for c in cols:
        out[c // 8] |= np.uint8(1 << (7 - (c % 8)))
    return out


def _erode_once_packed(m: torch.Tensor, first_mask: torch.Tensor,
                       last_mask: torch.Tensor) -> torch.Tensor:
    """One 4-neighbourhood binary erosion on packed rows (F, M, H, WB)
    uint8, MSB-first.  Edge replication on all four sides (the reference's
    binary_dilation border semantics, see _erosion_depth).  uint8 shifts
    drop the bits shifted out, as the JAX package's do."""
    up = torch.cat([m[:, :, 1:], m[:, :, -1:]], 2)
    dn = torch.cat([m[:, :, :1], m[:, :, :-1]], 2)
    nxtb = torch.cat([m[..., 1:], torch.zeros_like(m[..., :1])], -1)
    prvb = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], -1)
    # lf[x] = m[x+1] (replicate at x = W-1); rt[x] = m[x-1] (replicate at 0)
    lf = ((m << 1) | (nxtb >> 7)) | (m & last_mask)
    rt = ((m >> 1) | (prvb << 7)) | (m & first_mask)
    return m & up & dn & lf & rt


def _erosion_members_packed(mp: torch.Tensor, struct: torch.Tensor, w: int):
    """mp (F, M, H, WB) packed masks; struct (F, M) int32 erosion depths
    (>= 1) -> (mem1_p, mems_p): packed planes after 1 and after ``struct``
    erosion steps (survival is monotone, so these equal the reference's
    dist>1 / dist>struct tests on the iterated-AND depth map)."""
    wb = mp.shape[-1]
    first = to_device(_col_bit_mask(w, wb, [0]), mp.device)
    last = to_device(_col_bit_mask(w, wb, [w - 1]), mp.device)
    cur = _erode_once_packed(mp, first, last)
    mem1 = cur
    snap = torch.where((struct == 1)[..., None, None], cur,
                       torch.zeros_like(cur))
    for k in range(2, K_MAX + 1):
        cur = _erode_once_packed(cur, first, last)
        snap = torch.where((struct == k)[..., None, None], cur, snap)
    return mem1, snap


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 (torch has no popcount): the SWAR sequence,
    which never leaves the byte."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def _popcount_sum(plane: torch.Tensor) -> torch.Tensor:
    """(..., H, WB) packed -> (...,) int32 set-bit count."""
    return _popcount_u8(plane).sum(dim=(-2, -1), dtype=torch.int32)


def _bits_of(planes: torch.Tensor) -> torch.Tensor:
    """(..., WB) uint8 -> (..., WB*8) bool, np.packbits bit order."""
    b = (planes[..., None] >> _shifts(planes.device)) & 1
    return b.reshape(planes.shape[:-1] + (planes.shape[-1] * 8,)) != 0


def _multi_median_packed(vals: torch.Tensor, planes: torch.Tensor
                         ) -> torch.Tensor:
    """np.median over packed member planes.

    vals (F, H, Wp, C) padded per-pixel values; planes (P, F, M, H, WB)
    packed members -> (P, F, M, C) medians (same semantics and resolution
    as _masked_median).  The JAX package fuses all (plane, coordinate)
    bisections into one loop and regenerates the unpacked plane inside
    each reduction; eager torch would materialise a (P, F, M, H, Wp, C)
    comparison per step, so this walks one plane and one coordinate at a
    time: the peak is one (F, M, H, Wp) float32 plane."""
    n = _popcount_sum(planes).clamp_min(1)                   # (P, F, M)
    rank = (n - 1) // 2
    out = []
    for p in range(planes.shape[0]):
        bits = _bits_of(planes[p])                           # (F, M, H, Wp)
        cols = []
        for c in range(vals.shape[-1]):
            v = vals[:, None, :, :, c]                       # (F, 1, H, Wp)
            lo = torch.where(bits, v, BIG).amin((2, 3))
            hi_all = torch.where(bits, v, -BIG).amax((2, 3))
            lo = torch.minimum(lo, hi_all)
            hi = hi_all
            vm = torch.where(bits, v, float("inf"))
            for _ in range(N_BISECT):
                mid = (lo + hi) * 0.5
                cnt = (vm <= mid[..., None, None]).sum((2, 3),
                                                       dtype=torch.int32)
                ge = cnt >= rank[p] + 1
                lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
            a = hi                                   # lower-middle statistic
            ax = a[..., None, None]
            cnt_le = (vm <= ax).sum((2, 3), dtype=torch.int32)
            del vm
            min_gt = torch.where(bits & (v > ax), v, BIG).amin((2, 3))
            upper = torch.where(cnt_le >= n[p] // 2 + 1, a,
                                torch.minimum(min_gt, hi_all))
            cols.append(torch.where(n[p] % 2 == 1, a, (a + upper) * 0.5))
        out.append(torch.stack(cols, -1))
    return torch.stack(out)


def _compact_bank_packed(pts_flat: torch.Tensor, full_p: torch.Tensor,
                         cap: int, wp: int):
    """Route the first ``cap`` member pixels (ascending order) of each
    packed plane to bank slots with prefix sums, no sort over the pixels.

    pts_flat (F, H*Wp, 3); full_p (F, M, H, WB) packed members ->
    (F, M, cap, 3) bank + (F, M, cap) valid.  A count of prefix sums at
    or below j is a right-sided ``searchsorted`` (the sums never fall)."""
    f, m, h, wb = full_p.shape
    dev = full_p.device
    row_cnt = _popcount_u8(full_p).sum(-1, dtype=torch.int32)   # (F, M, H)
    row_cum = torch.cumsum(row_cnt, -1, dtype=torch.int32)      # inclusive
    total = row_cum[..., -1]                                    # (F, M)

    j = torch.arange(cap, dtype=torch.int32, device=dev)
    # first row whose inclusive cumsum exceeds j
    row_id = torch.searchsorted(row_cum, j.expand(f, m, cap).contiguous(),
                                right=True).clamp_max(h - 1)    # (F, M, cap)
    row_excl = row_cum - row_cnt
    rank_row = j - torch.gather(row_excl, 2, row_id)

    row_bytes = torch.gather(
        full_p, 2, row_id[..., None].expand(f, m, cap, wb))    # (F,M,cap,WB)
    byte_cnt = _popcount_u8(row_bytes).to(torch.int32)
    byte_cum = torch.cumsum(byte_cnt, -1, dtype=torch.int32)
    byte_id = torch.searchsorted(byte_cum, rank_row[..., None],
                                 right=True).clamp_max(wb - 1)  # (F,M,cap,1)
    byte_excl = byte_cum - byte_cnt
    rank_byte = rank_row - torch.gather(byte_excl, -1, byte_id)[..., 0]

    byte_val = torch.gather(row_bytes, -1, byte_id)[..., 0]    # (F,M,cap) u8
    bit8 = ((byte_val[..., None] >> _shifts(dev)) & 1).to(torch.int32)
    bit_cum = torch.cumsum(bit8, -1, dtype=torch.int32)
    bit_id = (bit_cum <= rank_byte[..., None]).sum(
        -1, dtype=torch.int32).clamp_max(7)

    pix = row_id * wp + byte_id[..., 0] * 8 + bit_id          # (F, M, cap)
    valid = j < torch.clamp_max(total, cap)[..., None]
    frame = torch.arange(f, device=dev)[:, None, None]
    bank = pts_flat[frame, pix]
    return torch.where(valid[..., None], bank, torch.zeros_like(bank)), valid


def _backproject_padded(depth: torch.Tensor, p2: torch.Tensor, h: int,
                        wp: int):
    """depth (F, H, Wp) -> px, py: ``(x - c) * depth / f`` in this order
    and with a true division by a device scalar, as the JAX package
    rounds it (a division by a host scalar may become a product with the
    reciprocal on the card)."""
    fu, fv = p2[0, 0], p2[1, 1]
    cu, cv = p2[0, 2], p2[1, 2]
    xs = torch.arange(wp, dtype=torch.float32, device=depth.device)
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    return (xs - cu) * depth / fu, (ys - cv) * depth / fv


def _extract_window(depth: torch.Tensor, masks_packed: torch.Tensor,
                    mask_valid: torch.Tensor, p2: torch.Tensor,
                    h: int, w: int, thr: int, diameter: float,
                    max_dist: float, use_pseudo_lidar: bool):
    """depth (F, H, W) f32; masks_packed (F, M, H, W//8pad) uint8;
    mask_valid (F, M) bool; p2 (3, 4) f32, all on one device.

    Returns meta (F, M, 4) [centre xyz, ok] and member_packed (F, M, H,
    W//8pad) uint8 (member = full-mask & circle-filtered point set)."""
    f, m = masks_packed.shape[0], masks_packed.shape[1]
    n = h * w
    masks = _unpack_masks(masks_packed, w)               # (F, M, H, W)

    # back-project every pixel (metric3d.py:280-345 contract)
    px, py = _backproject_padded(depth, p2, h, w)
    px, py = px.reshape(f, n), py.reshape(f, n)
    pz = depth.reshape(f, n)
    pvalid = pz > 1e-6                                    # (F, N)
    pts = torch.stack([px, py, pz], -1)                   # (F, N, 3)

    area = masks.sum((2, 3), dtype=torch.int32)           # (F, M)
    struct = torch.clamp_max(
        2 + torch.sqrt(area.to(torch.float32)).to(torch.int32) // 10, K_MAX)
    dist = _erosion_depth(masks).reshape(f, m, n)         # (F, M, N)
    mask_flat = masks.reshape(f, m, n)

    pv = pvalid[:, None]
    mem_s = (dist > struct[..., None]) & pv               # struct erosion
    mem_1 = (dist > 1) & pv                               # 1-step erosion
    mem_0 = mask_flat & pv                                # raw
    del dist
    c_s = mem_s.sum(-1, dtype=torch.int32)
    c_1 = mem_1.sum(-1, dtype=torch.int32)
    c_0 = mem_0.sum(-1, dtype=torch.int32)
    core = torch.where((c_s >= thr)[..., None], mem_s,
                       torch.where((c_1 >= thr)[..., None], mem_1, mem_0))
    ok = mask_valid & (area > 0) & (c_0 >= thr)

    pts_b = pts[:, None].expand(f, m, n, 3)               # (F, M, N, 3)
    center = _median3(pts_b, core)
    # ground-plane circle filter + re-median (loader.py:2850-2866)
    d_xz = _hypot(pts_b[..., 0] - center[..., 0:1],
                  pts_b[..., 2] - center[..., 2:3])
    core_f = core & (d_xz < diameter)
    has_f = core_f.sum(-1) > 0
    center2 = _median3(pts_b, core_f)
    center = torch.where(has_f[..., None], center2, center)
    if use_pseudo_lidar:
        ok = ok & (_norm3(center) <= max_dist)

    # stored point set: FULL mask, circle-filtered about ITS median
    # (loader.py:2878-2896)
    fc = _median3(pts_b, mem_0)
    d_full = _hypot(pts_b[..., 0] - fc[..., 0:1],
                    pts_b[..., 2] - fc[..., 2:3])
    full = mem_0 & (d_full < diameter)
    n_full = full.sum(-1, dtype=torch.int32)
    ok = ok & (n_full >= thr)

    # pack per image ROW: (F, M, H, W/8) rows
    wpad = (-w) % 8
    full_img = full.reshape(f, m, h, w)
    if wpad:
        full_img = F.pad(full_img, (0, wpad))
    meta = torch.cat([center, ok[..., None].to(torch.float32)], -1)
    return meta, _pack_bits(full_img)


def _extract_window_bank(depth: torch.Tensor, masks_packed: torch.Tensor,
                         mask_valid: torch.Tensor, p2: torch.Tensor,
                         h: int, w: int, thr: int, diameter: float,
                         max_dist: float, use_pseudo_lidar: bool,
                         cap: int = 2048):
    """Bank-mode extraction: same candidate semantics as _extract_window,
    but instead of member BITMAPS it emits a compacted per-mask POINT BANK
    that stays on the device for the window aggregation and the fit
    (sowa/bank.py): the host never touches per-point data.

    ``depth`` is (F, H, W) float32, or the uint16 fixed-point transport
    (DEPTH_U16_SCALE) carried as int16 (torch's uint16 has few
    operations): its bits are read back as unsigned.

    Returns meta (F, M, 6) [centre xyz, ok, count, truncated] (the one
    small host download) and bank (F, M, cap, 3) camera-frame points
    (device-resident).  ``truncated`` = the full mask touches the first or
    last 10 pixel COLUMNS (the reference's (W,H)-layout ``[:10,:]``
    check, loader.py:794), the clever-aggregation distance penalty."""
    f, m, _, wb = masks_packed.shape
    wp = wb * 8
    dev = masks_packed.device

    if depth.dtype == torch.int16:
        depth = (depth.to(torch.int32) & 0xFFFF).to(torch.float32) \
            * DEPTH_U16_SCALE
    dpad = F.pad(depth, (0, wp - w))
    px, py = _backproject_padded(dpad, p2, h, wp)
    pz = dpad                                          # (F, H, Wp)
    vals = torch.stack([px, py, pz], -1)               # (F, H, Wp, 3)
    pvalid_p = _pack_bits(pz > 1e-6)                   # (F, H, WB)

    area = _popcount_sum(masks_packed)                 # (F, M)
    struct = torch.clamp_max(
        2 + torch.sqrt(area.to(torch.float32)).to(torch.int32) // 10, K_MAX)
    mem1_p, mems_p = _erosion_members_packed(masks_packed, struct, w)
    pv = pvalid_p[:, None]
    mem0_p = masks_packed & pv
    mem1_p = mem1_p & pv
    mems_p = mems_p & pv
    c_0 = _popcount_sum(mem0_p)
    c_1 = _popcount_sum(mem1_p)
    c_s = _popcount_sum(mems_p)
    core_p = torch.where((c_s >= thr)[..., None, None], mems_p,
                         torch.where((c_1 >= thr)[..., None, None],
                                     mem1_p, mem0_p))
    ok = mask_valid & (area > 0) & (c_0 >= thr)

    # round 1: centre over the eroded core + full-mask median
    med1 = _multi_median_packed(vals, torch.stack([core_p, mem0_p]))
    center, fc = med1[0], med1[1]                      # (F, M, 3)

    # ground-plane circle filters about the two medians (packed planes)
    d_core = _hypot(px[:, None] - center[..., 0:1, None],
                    pz[:, None] - center[..., 2:3, None])   # (F,M,H,Wp)
    core_f_p = core_p & _pack_bits(d_core < diameter)
    del d_core
    d_full = _hypot(px[:, None] - fc[..., 0:1, None],
                    pz[:, None] - fc[..., 2:3, None])
    full_p = mem0_p & _pack_bits(d_full < diameter)
    del d_full

    has_f = _popcount_sum(core_f_p) > 0
    # round 2: re-median over the circle-filtered core
    center2 = _multi_median_packed(vals, core_f_p[None])[0]
    center = torch.where(has_f[..., None], center2, center)
    if use_pseudo_lidar:
        ok = ok & (_norm3(center) <= max_dist)

    n_full = _popcount_sum(full_p)
    ok = ok & (n_full >= thr)

    first10 = to_device(_col_bit_mask(w, wb, range(10)), dev)
    last10 = to_device(_col_bit_mask(w, wb, range(w - 10, w)), dev)
    trunc = (((masks_packed & first10) != 0).any(3).any(2)
             | ((masks_packed & last10) != 0).any(3).any(2))

    bank, _bank_valid = _compact_bank_packed(
        vals.reshape(f, h * wp, 3), full_p, cap, wp)
    meta = torch.cat(
        [center, ok[..., None].to(torch.float32),
         torch.clamp_max(n_full, cap)[..., None].to(torch.float32),
         trunc[..., None].to(torch.float32)], -1)
    return meta, bank


@dataclasses.dataclass
class DeviceExtractor:
    """Host wrapper: batches windows of depth maps + masks through
    _extract_window(_bank) and converts results into the candidate dicts
    the tracker consumes (the contract of candidates.extract_candidates_cam).
    ``device`` None means the card."""

    p2: np.ndarray
    img_hw: tuple
    cfg: CandidateConfig = dataclasses.field(default_factory=CandidateConfig)
    max_masks: int = 16
    frame_bucket: int = 10
    # quantize the depth upload to uint16 fixed point (DEPTH_U16_SCALE):
    # half the bytes at 2.3 mm max error; part of the result
    depth_u16: bool = True
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._p2_dev = None

    def _p2(self) -> torch.Tensor:
        if self._p2_dev is None:
            self._p2_dev = to_device(np.asarray(self.p2, np.float32),
                                     self.device)
        return self._p2_dev

    def _geometry(self):
        c = self.cfg
        return (c.moving_detection_threshold, c.filter_diameter,
                c.max_distance_pseudo_lidar, c.use_pseudo_lidar)

    def extract_frames_banked(self, depths: Sequence[np.ndarray],
                              masks_per_frame: Sequence[Sequence[np.ndarray]],
                              cap: int = 2048):
        """Bank-mode extraction: returns (cands, bank) where ``cands`` is a
        per-frame candidate dict whose "points" entries are
        ``bank.BankRef`` descriptors (no per-point host data) and ``bank``
        is the device-resident (F_rows, M, cap, 3) camera-frame point bank
        (row order = the dispatch order of frames with any mask)."""
        return self.extract_frames_banked_finish(
            self.extract_frames_banked_begin(depths, masks_per_frame, cap))

    def extract_frames_banked_begin(
            self, depths: Sequence[np.ndarray],
            masks_per_frame: Sequence[Sequence[np.ndarray]],
            cap: int = 2048):
        """Dispatch half of :meth:`extract_frames_banked`: uploads the
        depth/mask chunks, enqueues the extraction and the copy of every
        chunk's metadata to the host WITHOUT waiting for any of it, so a
        caller can overlap the device work with host stages
        (pipeline.label_frames_stream).  Returns an opaque state for
        :meth:`extract_frames_banked_finish`."""
        h, w = self.img_hw
        f_total = len(depths)
        results: List[Optional[dict]] = [None] * f_total
        todo = [i for i in range(f_total)
                if depths[i] is not None and masks_per_frame[i]]
        if not todo:
            return (results, None, masks_per_frame, 0, 0, None)

        # bucket the mask-slot axis to the batch's real need: the upload
        # and the whole extraction scale with M, and most frames carry far
        # fewer masks than max_masks
        need = max(len(masks_per_frame[i]) for i in todo)
        mcap = self.max_masks
        for b in (4, 8, 16):
            if need <= b <= self.max_masks:
                mcap = b
                break

        g = self.frame_bucket
        dev = self.device
        pending = []
        for c0 in range(0, len(todo), g):
            chunk = todo[c0:c0 + g]
            if self.depth_u16:
                depth_b = np.zeros((g, h, w), np.uint16)
            else:
                depth_b = np.zeros((g, h, w), np.float32)
            packed_b = np.zeros((g, mcap, h, -(-w // 8)), np.uint8)
            valid_b = np.zeros((g, mcap), bool)
            for k, fi in enumerate(chunk):
                if self.depth_u16:
                    depth_b[k] = np.clip(
                        np.rint(depths[fi] * (1.0 / DEPTH_U16_SCALE)),
                        0, 65535).astype(np.uint16)
                else:
                    depth_b[k] = depths[fi]
                for mi, mask in enumerate(masks_per_frame[fi][:mcap]):
                    # np.packbits zero-pads the trailing bits itself
                    packed_b[k, mi] = np.packbits(mask, axis=-1)
                    valid_b[k, mi] = True
            if self.depth_u16:
                depth_b = depth_b.view(np.int16)
            meta_dev, bank_dev = _extract_window_bank(
                to_device(depth_b, dev), to_device(packed_b, dev),
                to_device(valid_b, dev), self._p2(), h, w,
                *self._geometry(), cap)
            pending.append((chunk, meta_dev, bank_dev))
        # every chunk's metadata in ONE copy, enqueued behind the work
        meta_all = torch.cat([p[1] for p in pending], 0)
        if dev.type == "cuda":
            host = torch.empty(meta_all.shape, dtype=meta_all.dtype,
                               pin_memory=True)
            host.copy_(meta_all, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            meta_pull = (host, done)
        else:
            meta_pull = (meta_all, None)
        return (results, pending, masks_per_frame, mcap, g, meta_pull)

    def extract_frames_banked_finish(self, state):
        """Pull half of :meth:`extract_frames_banked`: waits for the one
        metadata copy, then assembles the per-frame candidate dicts and the
        concatenated device bank on the host."""
        from monosowa_tpu_torch.sowa.bank import BankRef

        results, chunk_refs = self.extract_frames_banked_finish_chunks(state)
        if chunk_refs is None:
            return results, None
        banks = [b for b, _ in chunk_refs]
        off = {id(b): i * banks[0].shape[0] for i, b in enumerate(banks)}
        for r in results:
            if r is None:
                continue
            r["points"] = [BankRef(row=off[id(b)] + k, mi=mi, count=c,
                                   trunc=t)
                           for (b, k, mi, c, t) in r.pop("chunk_refs")]
        return results, torch.cat(banks, 0)

    def extract_frames_banked_finish_chunks(self, state):
        """Like :meth:`extract_frames_banked_finish` but chunk-granular:
        per-frame dicts carry ``chunk_refs`` = [(bank_dev, k, mi, count,
        trunc)] referencing each chunk's OWN device bank (frame_bucket rows
        each) instead of a concatenated one, so a caller can cache
        extractions across label_frames groups
        (pipeline.label_frames_stream).  Returns (results, [(bank_dev,
        fids)] or None)."""
        results, pending, masks_per_frame, mcap, g, meta_pull = state
        if pending is None:
            return results, None

        host, done = meta_pull
        if done is not None:
            done.synchronize()
        meta_all = host.numpy()
        chunk_refs = []
        for ci, (chunk, _meta_dev, bank_dev) in enumerate(pending):
            meta = meta_all[ci * g:(ci + 1) * g]
            chunk_refs.append((bank_dev, list(chunk)))
            for k, fi in enumerate(chunk):
                locs, refs, masks_out = [], [], []
                for mi, mask in enumerate(masks_per_frame[fi][:mcap]):
                    if meta[k, mi, 3] <= 0.5:
                        continue
                    locs.append(meta[k, mi, :3])
                    refs.append((bank_dev, k, mi, int(meta[k, mi, 4]),
                                 bool(meta[k, mi, 5] > 0.5)))
                    masks_out.append(mask)
                if locs:
                    results[fi] = {"locations": np.stack(locs),
                                   "chunk_refs": refs, "masks": masks_out}
                else:
                    results[fi] = {"locations": np.zeros((0, 3), np.float32),
                                   "chunk_refs": [], "masks": []}
        return results, chunk_refs

    def extract_frames(self, depths: Sequence[np.ndarray],
                       masks_per_frame: Sequence[Sequence[np.ndarray]]
                       ) -> List[Optional[dict]]:
        """The device extraction without the bank.  depths: list of (H, W)
        float32; masks_per_frame: list of mask lists.  Returns one
        candidate dict (or None) per frame, with member points on the
        host."""
        h, w = self.img_hw
        wpad = (-w) % 8
        f_total = len(depths)
        results: List[Optional[dict]] = [None] * f_total

        todo = [i for i in range(f_total)
                if depths[i] is not None and masks_per_frame[i]]
        if not todo:
            return results

        g = self.frame_bucket
        dev = self.device
        # dispatch EVERY chunk before pulling any result: chunk k's host
        # unpacking then overlaps chunk k+1's device work
        pending = []
        for c0 in range(0, len(todo), g):
            chunk = todo[c0:c0 + g]
            depth_b = np.zeros((g, h, w), np.float32)
            packed_b = np.zeros((g, self.max_masks, h, (w + wpad) // 8),
                                np.uint8)
            valid_b = np.zeros((g, self.max_masks), bool)
            for k, fi in enumerate(chunk):
                depth_b[k] = depths[fi]
                ms = masks_per_frame[fi][:self.max_masks]
                for mi, mask in enumerate(ms):
                    packed_b[k, mi] = np.packbits(
                        np.pad(mask, ((0, 0), (0, wpad))), axis=-1)
                    valid_b[k, mi] = True
            out = _extract_window(
                to_device(depth_b, dev), to_device(packed_b, dev),
                to_device(valid_b, dev), self._p2(), h, w,
                *self._geometry())
            pending.append((chunk, depth_b, out))

        p2 = np.asarray(self.p2)
        for chunk, depth_b, (meta_dev, member_dev) in pending:
            meta = meta_dev.cpu().numpy()
            centers = meta[..., :3]
            ok = meta[..., 3] > 0.5
            member = member_dev.cpu().numpy()

            for k, fi in enumerate(chunk):
                locs, pts_out, masks_out = [], [], []
                depth_flat = depth_b[k].reshape(-1)
                for mi, mask in enumerate(masks_per_frame[fi]
                                          [:self.max_masks]):
                    if not ok[k, mi]:
                        continue
                    mem = np.unpackbits(
                        member[k, mi], axis=-1)[:, :w].reshape(-1) \
                        .astype(bool)
                    idx = np.nonzero(mem)[0]
                    zz = depth_flat[idx]
                    xx = (idx % w - p2[0, 2]) * zz / p2[0, 0]
                    yy = (idx // w - p2[1, 2]) * zz / p2[1, 1]
                    locs.append(centers[k, mi])
                    pts_out.append(
                        np.stack([xx, yy, zz], -1).astype(np.float32))
                    masks_out.append(mask)
                if locs:
                    results[fi] = {"locations": np.stack(locs),
                                   "points": pts_out, "masks": masks_out}
                else:
                    results[fi] = {"locations": np.zeros((0, 3), np.float32),
                                   "points": [], "masks": []}
        return results
