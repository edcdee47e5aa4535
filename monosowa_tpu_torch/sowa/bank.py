"""Device-resident window aggregation: fit cars straight from the per-mask
point BANK that candidate extraction leaves on the device.

The host path moves every candidate's points to the host, tracks,
concatenates clouds per car, and uploads a padded batch again.  Bank mode
keeps per-point data on the card end to end:

  device: extraction -> (F_rows, M, cap, 3) camera-frame point bank
  host:   tracking / moving classification / frame selection on candidate
          CENTRES only (small arrays; counts and truncation flags ride the
          extraction metadata)
  device: one gather-from-bank -> ref-frame CarBatch -> conv fit -> NMS ->
          merge re-fit, then one copy to the host

Per car the fit consumes ``n_slots`` observation slots of ``quota`` points
each, selected evenly over each observation's compacted points; a moving
car's single reference observation is spread across all slots with
disjoint offsets (slot j covers stride positions j*quota..(j+1)*quota of
the full range).  This replaces the host path's cap-10000-then-subsample
with a deterministic even subsample.

Behavioural contracts mirrored from the reference:
* clever frame selection = standing_concatenate_lidar_clever
  (loader.py:783-810): keep_k closest untruncated-penalised frames;
* moving cars keep only reference-frame points (loader.py:756-771);
* standing cars below lidar_threshold_during_optim points are dropped
  (filtering.py:21-22); moving cars seen < 3 times are dropped
  (filtering.py:62-65).

Counterpart of the JAX package's ``sowa/bank.py``: the host half
(``BankRef``, ``transform_candidates_bank``, ``CarSlots``,
``select_car_slots``, ``merge_slots``) is a numpy copy; the device half is
plain torch on the bank's device, whose fit reaches the coverage kernel
through ``fitting.fit_cars_conv``.  Indices are computed in int32 as the
JAX package computes them and widened only to gather; scatters route
invalid rows to a spare column instead of relying on out-of-range drops.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from monosowa_tpu_torch.ops import box3d
from monosowa_tpu_torch.sowa.candidates_device import to_device
from monosowa_tpu_torch.sowa.fitting import (CarBatch, FitConfig,
                                             estimate_angle_from_track,
                                             fit_cars_conv)
from monosowa_tpu_torch.sowa.lomm import Track


class BankRef(NamedTuple):
    """A candidate's point payload in bank mode: WHERE its points live."""
    row: int        # bank row (frame dispatch order)
    mi: int         # mask slot within the row
    count: int      # compacted point count (<= cap)
    trunc: bool     # full mask touches the left/right image border


class BankArena:
    """Fixed-capacity device-resident pool of extraction-chunk banks.

    label_frames_stream shares per-frame extractions across overlapping
    window groups.  The arena keeps ONE device buffer of ``n_blocks``
    g-row blocks: each chunk is copied into a free block, BankRef rows are
    global arena rows (stable for a frame's whole lifetime), and every
    group's fit gathers from the same buffer.

    Blocks are freed when every frame id they carry has been evicted from
    the extraction cache; the lowest free block is taken first (so the
    rows equal the JAX package's), and the buffer doubles, rows preserved,
    when none is free."""

    def __init__(self, block_rows: int, mask_cap: int, point_cap: int,
                 n_blocks: int, device=None):
        self.g = int(block_rows)
        self.mask_cap = int(mask_cap)
        self.cap = int(point_cap)
        self.n_blocks = max(1, int(n_blocks))
        self.buf = torch.zeros(
            (self.n_blocks * self.g, self.mask_cap, self.cap, 3),
            dtype=torch.float32, device=device)
        self.free = list(range(self.n_blocks))
        self.live: dict = {}        # block -> set of fids
        self.fid_block: dict = {}   # fid -> block

    def _grow(self) -> None:
        self.free.extend(range(self.n_blocks, 2 * self.n_blocks))
        self.n_blocks *= 2
        buf = self.buf.new_zeros(
            (self.n_blocks * self.g, self.mask_cap, self.cap, 3))
        buf[:self.buf.shape[0]] = self.buf
        self.buf = buf

    def write(self, chunk_bank: torch.Tensor, fids: Sequence) -> int:
        """Copy one chunk (g, m <= mask_cap, cap, 3) into a free block,
        padding the mask axis with zeros; returns the block's row0.
        ``fids`` are the frame ids whose rows live in this chunk (row
        row0+k belongs to fids[k])."""
        if not self.free:
            self._grow()
        blk = min(self.free)
        self.free.remove(blk)
        row0 = blk * self.g
        rows, m = chunk_bank.shape[0], chunk_bank.shape[1]
        self.buf[row0:row0 + rows, :m] = chunk_bank
        self.buf[row0:row0 + rows, m:] = 0.0
        self.live[blk] = set(fids)
        for f in fids:
            self.fid_block[f] = blk
        return row0

    def release(self, fid) -> None:
        """Mark ``fid``'s arena row dead; frees its block when the whole
        chunk is dead."""
        blk = self.fid_block.pop(fid, None)
        if blk is None:
            return
        s = self.live[blk]
        s.discard(fid)
        if not s:
            del self.live[blk]
            self.free.append(blk)


def transform_candidates_bank(cand: dict, t_cur_to_ref: np.ndarray,
                              thr: int) -> Optional[dict]:
    """Window transform for bank candidates: centres move, BankRefs don't.
    Applies the ref-frame gates (centre in front; enough points)."""
    if cand is None:
        return None
    rot = np.asarray(t_cur_to_ref[:3, :3], np.float32)
    tr = np.asarray(t_cur_to_ref[:3, 3], np.float32)
    locs, refs, masks = [], [], []
    for center, ref, mask in zip(cand["locations"], cand["points"],
                                 cand["masks"]):
        c = rot @ np.asarray(center) + tr
        if c[2] <= 0.0 or ref.count < thr:
            continue
        locs.append(c)
        refs.append(ref)
        masks.append(mask)
    if not locs:
        return {"locations": np.zeros((0, 3), np.float32), "points": [],
                "masks": []}
    return {"locations": np.stack(locs), "points": refs, "masks": masks}


@dataclasses.dataclass
class CarSlots:
    """Per-car slot spec feeding the fit from the bank."""
    fm: np.ndarray        # (S, 2) int32 bank (row, mask)
    rt: np.ndarray        # (S, 3, 4) per-slot cur->ref rotation|translation
    off: np.ndarray       # (S,) int32 position offset
    denom: np.ndarray     # (S,) int32 stride denominator
    cnt: np.ndarray       # (S,) int32 obs point count
    valid: np.ndarray     # (S,) bool
    npts: int             # aggregated point count (for NMS priority)


def select_car_slots(tracks: Sequence[Track], transforms: np.ndarray,
                     window: Sequence[int], keep_k: int, min_points: int,
                     n_slots: int, quota: int,
                     use_pseudo_lidar: bool = True,
                     max_distance: float = 75.0):
    """Aggregation selection on centres/counts only.  Returns
    (kept_tracks, ref_masks, [CarSlots]).

    The pseudo-lidar distant-car filter (loader.py:3944-3954) is applied
    on the median of the selected observations' ref-frame centres (the
    aggregated cloud itself never reaches the host in bank mode)."""
    base = window[0]
    inv = np.linalg.inv(np.asarray(transforms))
    kept, masks_out, slots_out = [], [], []
    for t in tracks:
        ref_mask = None
        for fr, mk in zip(t.frames, t.masks):
            if fr == 0:
                ref_mask = mk
                break
        if t.moving:
            if 0 not in t.frames or len(t.frames) < 3:
                continue
        elif ref_mask is None:      # hidden standing (pseudo-lidar branch)
            continue

        fm = np.zeros((n_slots, 2), np.int32)
        rt = np.zeros((n_slots, 3, 4), np.float32)
        off = np.zeros(n_slots, np.int32)
        denom = np.full(n_slots, max(quota, 1), np.int32)
        cnt = np.zeros(n_slots, np.int32)
        valid = np.zeros(n_slots, bool)

        if t.moving:
            k = t.frames.index(0)
            ref: BankRef = t.points[k]
            for j in range(n_slots):
                fm[j] = (ref.row, ref.mi)
                rt[j] = np.asarray(transforms[0 - base][:3, :4], np.float32)
                off[j] = j * quota
                denom[j] = n_slots * quota
                cnt[j] = ref.count
                valid[j] = True
            npts = min(ref.count, n_slots * quota)
        else:
            dists = []
            for fr, loc, ref in zip(t.frames, t.locations, t.points):
                ti = inv[fr - base]
                local = ti[:3, :3] @ np.asarray(loc[:3]) + ti[:3, 3]
                d = float(np.hypot(local[0], local[2]))
                if ref.trunc:
                    d += 5.0
                dists.append(d)
            order = np.argsort(np.asarray(dists))[:min(keep_k, n_slots)]
            total = 0
            for j, oi in enumerate(order):
                ref = t.points[oi]
                fm[j] = (ref.row, ref.mi)
                rt[j] = np.asarray(
                    transforms[t.frames[oi] - base][:3, :4], np.float32)
                cnt[j] = ref.count
                valid[j] = True
                total += ref.count
            if total < min_points:
                continue
            npts = total
        if use_pseudo_lidar:
            loc = np.median(np.stack([np.asarray(v[:3])
                                      for v in t.locations]), axis=0)
            if np.linalg.norm(loc) >= max_distance:
                continue
        kept.append(t)
        masks_out.append(ref_mask)
        slots_out.append(CarSlots(fm, rt, off, denom, cnt, valid, npts))
    return kept, masks_out, slots_out


def merge_slots(a: CarSlots, b: CarSlots) -> CarSlots:
    """NMS-merge: the union of two cars' observation slots, truncated to
    the slot budget by keeping the highest-count observations (the
    reference concatenates both full clouds before the re-fit,
    loader.py:2785-2789; the fit consumes a ~2k subsample either way)."""
    n_slots = a.fm.shape[0]
    rows = []
    for s in (a, b):
        for j in range(n_slots):
            if s.valid[j]:
                rows.append((int(s.cnt[j]), s.fm[j], s.rt[j], s.off[j],
                             s.denom[j], s.cnt[j]))
    rows.sort(key=lambda r: -r[0])
    fm = np.zeros((n_slots, 2), np.int32)
    rt = np.zeros((n_slots, 3, 4), np.float32)
    off = np.zeros(n_slots, np.int32)
    denom = np.ones(n_slots, np.int32)
    cnt = np.zeros(n_slots, np.int32)
    valid = np.zeros(n_slots, bool)
    for j, (_, f, r, o, d, c) in enumerate(rows[:n_slots]):
        fm[j], rt[j], off[j], denom[j], cnt[j] = f, r, o, d, c
        valid[j] = True
    return CarSlots(fm, rt, off, denom, cnt, valid, a.npts + b.npts)


def _fit_from_bank(bank, slot_fm, slot_rt, slot_off, slot_denom, slot_cnt,
                   slot_valid, moving, theta_est, theta_valid, car_valid,
                   template, occ_k, memb_k, spec, cfg: FitConfig,
                   quota: int):
    """bank (F, M, cap, 3); slot_* (B, S, ...) -> BatchFitResult.

    Per (car, slot): select ``quota`` evenly-spaced compacted points
    (strided when the observation has >= denom points, prefix otherwise),
    transform cur->ref, and feed the (B, S*quota) batch to the conv-grid
    fitter.  The transform is written out per coordinate (the JAX
    package's einsum), so the card and the CPU round it alike."""
    cap = bank.shape[2]
    b, s = slot_fm.shape[0], slot_fm.shape[1]
    i = torch.arange(quota, dtype=torch.int32, device=bank.device)
    pos = slot_off[..., None] + i                              # (B, S, q)
    cnt = slot_cnt[..., None]
    strided = (slot_cnt >= slot_denom)[..., None]
    idx = torch.where(strided, (pos * cnt) // slot_denom.clamp_min(1)[
        ..., None], pos)
    pvalid = slot_valid[..., None] & (pos < cnt)
    fm = slot_fm.long()
    sel = bank[fm[..., 0, None], fm[..., 1, None],
               idx.clamp(0, cap - 1).long()]                  # (B, S, q, 3)
    rot = slot_rt[:, :, None, :, :3]                          # (B,S,1,3,3)
    ref = (rot[..., 0] * sel[..., 0:1] + rot[..., 1] * sel[..., 1:2]
           + rot[..., 2] * sel[..., 2:3]) + slot_rt[:, :, None, :, 3]
    batch = CarBatch(points=ref.reshape(b, s * quota, 3),
                     mask=pvalid.reshape(b, s * quota) & car_valid[:, None],
                     moving=moving, theta_est=theta_est,
                     theta_valid=theta_valid, car_valid=car_valid)
    return fit_cars_conv(batch, template, occ_k, memb_k, spec, cfg)


def _fit_nms_from_bank(bank, slot_fm, slot_rt, slot_off, slot_denom,
                       slot_cnt, slot_valid, moving, theta_est, theta_valid,
                       car_valid, car_frame, car_slot, npts, lwh, nms_iou,
                       template, occ_k, memb_k, spec, cfg: FitConfig,
                       quota: int, n_frames: int, max_cars: int,
                       refit_cap: int = 0) -> torch.Tensor:
    """Fused fit + per-frame 3D NMS (+ optional NMS-merge re-fit) on the
    device, returning ONE flat float32 tensor
    [fit (4, B) | keep/merged (2, n_frames, max_cars)
     | n_targets (1) | refit sel/x/y/z/theta (5, R)], R = min(refit_cap, B),
    so the pipeline copies one tensor to the host for the whole group.

    With ``refit_cap > 0`` the NMS-merge re-optimisation (the reference's
    merge-losers-then-reoptimise loop, loader.py:2785-2789 +
    main_class.py:227-235) also runs here: for each kept car that
    suppressed at least one other, the union of the group's observation
    slots is rebuilt exactly as ``merge_slots`` does (count-descending
    order, the winner's slots first on ties, truncated to the slot budget)
    and the first R such targets (batch order) are fitted again; the rows
    of the re-fit that no target fills are fitted empty and ignored.  The
    emitted ``n_targets`` lets the host fit the overflow in one more
    call."""
    dev = bank.device
    res = _fit_from_bank(bank, slot_fm, slot_rt, slot_off, slot_denom,
                         slot_cnt, slot_valid, moving, theta_est,
                         theta_valid, car_valid, template, occ_k, memb_k,
                         spec, cfg, quota)
    b, s = slot_fm.shape[0], slot_fm.shape[1]
    centers = torch.stack([res.x, res.y, res.z], -1)          # (B, 3)
    # invalid rows go to the spare column max_cars, dropped below
    frame = car_frame.long()
    slot_scatter = torch.where(car_valid, car_slot,
                               torch.full_like(car_slot, max_cars)).long()
    c_f = centers.new_zeros((n_frames, max_cars + 1, 3))
    c_f[frame, slot_scatter] = centers
    t_f = centers.new_zeros((n_frames, max_cars + 1))
    t_f[frame, slot_scatter] = res.theta
    np_f = centers.new_zeros((n_frames, max_cars + 1))
    np_f[frame, slot_scatter] = npts
    v_f = torch.zeros((n_frames, max_cars + 1), dtype=torch.bool,
                      device=dev)
    v_f[frame, slot_scatter] = car_valid
    c_f, t_f, np_f, v_f = (c_f[:, :max_cars], t_f[:, :max_cars],
                           np_f[:, :max_cars], v_f[:, :max_cars])
    lwh_f = lwh.expand(n_frames, max_cars, 3)
    keep_f, merged_f = box3d.nms_3d(c_f, lwh_f, t_f, np_f, v_f, nms_iou)
    fit_pack = torch.stack([res.x, res.y, res.z, res.theta]).reshape(-1)
    nms_pack = torch.stack([keep_f.to(torch.float32),
                            merged_f.to(torch.float32)]).reshape(-1)
    if not refit_cap:
        return torch.cat([fit_pack, nms_pack])

    bidx = torch.arange(b, device=dev)
    slot_clip = car_slot.clamp_max(max_cars - 1).long()
    # frame-slot -> batch index (invalid rows to the spare column)
    idx_f = torch.full((n_frames, max_cars + 1), b, dtype=torch.long,
                       device=dev)
    idx_f[frame, slot_scatter] = bidx
    idx_f = idx_f[:, :max_cars]
    keep_b = keep_f[frame, slot_clip] & car_valid
    win_b = idx_f[frame, merged_f[frame, slot_clip]]          # may be b
    keep_pad = torch.cat([keep_b, keep_b.new_zeros(1)])
    # a loser contributes iff its winner survived (the pipeline's
    # keep_i[merged_i[i]] gate)
    contrib = car_valid & ~keep_b & (win_b < b) & keep_pad[win_b]
    owns = (win_b[None, :] == bidx[:, None]) & contrib[None, :]  # (B, B)
    target = car_valid & keep_b & owns.any(1)

    # merged slot union per target, exactly merge_slots' stable
    # count-descending order: the winner's own slots first, then losers in
    # ascending batch order
    member = owns | (bidx[None, :] == bidx[:, None])
    i_idx = bidx.repeat_interleave(s)                          # owning car
    j_idx = torch.arange(s, device=dev).repeat(b)
    rank = torch.where(i_idx[None, :] == bidx[:, None], j_idx[None, :],
                       s * (i_idx[None, :] + 1) + j_idx[None, :])
    kk = b * s + s + 2
    m_flat = member[:, i_idx] & slot_valid.reshape(-1)[None, :]
    score = torch.where(m_flat, slot_cnt.reshape(-1)[None, :].long() * kk
                        - rank, torch.full_like(rank, -1))
    # the s largest, lower index first among equals (jax.lax.top_k)
    top_score, top_idx = torch.sort(score, dim=1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :s], top_idx[:, :s]    # (B, S)
    m_valid = top_score >= 0
    m_fm = slot_fm.reshape(-1, 2)[top_idx]
    m_rt = slot_rt.reshape(-1, 3, 4)[top_idx]
    m_off = slot_off.reshape(-1)[top_idx]
    m_denom = slot_denom.reshape(-1)[top_idx]
    m_cnt = slot_cnt.reshape(-1)[top_idx]

    # first R targets in batch (= frame-major) order
    r = min(refit_cap, b)
    tsel = torch.sort(torch.where(target, bidx, torch.full_like(bidx, b)),
                      stable=True).values[:r]
    rvalid = tsel < b
    rg = tsel.clamp(0, b - 1)
    rres = _fit_from_bank(
        bank, m_fm[rg], m_rt[rg], m_off[rg], m_denom[rg], m_cnt[rg],
        m_valid[rg] & rvalid[:, None], moving[rg], theta_est[rg],
        theta_valid[rg], rvalid, template, occ_k, memb_k, spec, cfg, quota)
    refit_pack = torch.stack([
        torch.where(rvalid, tsel, torch.full_like(tsel, -1)).to(
            torch.float32),
        rres.x, rres.y, rres.z, rres.theta]).reshape(-1)
    n_targets = target.sum().to(torch.float32)[None]
    return torch.cat([fit_pack, nms_pack, n_targets, refit_pack])


def _stack_slots(slots, tracks, windows, angle_min_dist: float):
    """Host arrays of B cars' slot specs (each car's n_slots = its
    ``fm.shape[0]``) and trajectory angles."""
    b = len(slots)
    n_slots = slots[0].fm.shape[0]
    out = dict(fm=np.zeros((b, n_slots, 2), np.int32),
               rt=np.zeros((b, n_slots, 3, 4), np.float32),
               off=np.zeros((b, n_slots), np.int32),
               denom=np.ones((b, n_slots), np.int32),
               cnt=np.zeros((b, n_slots), np.int32),
               valid=np.zeros((b, n_slots), bool),
               moving=np.zeros(b, bool), theta_est=np.zeros(b, np.float32),
               theta_valid=np.zeros(b, bool), car_valid=np.ones(b, bool))
    for i, (s, t, win) in enumerate(zip(slots, tracks, windows)):
        for k in ("fm", "rt", "off", "denom", "cnt", "valid"):
            out[k][i] = getattr(s, k)
        out["moving"][i] = t.moving
        if t.moving:
            locs, lvalid = t.location_array(win)
            try:
                ref_idx = list(win).index(0)
            except ValueError:
                ref_idx = 0
            ang = estimate_angle_from_track(locs, lvalid, ref_idx,
                                            min_dist=angle_min_dist)
            if ang is not None:
                out["theta_est"][i] = ang
                out["theta_valid"][i] = True
    return out


_SLOT_ARGS = ("fm", "rt", "off", "denom", "cnt", "valid", "moving",
              "theta_est", "theta_valid", "car_valid")


def fit_and_nms_slots(bank, slots, tracks, windows, owners, n_frames,
                      max_cars, lwh, nms_iou, template, occ_k, memb_k,
                      spec, cfg: FitConfig, quota: int,
                      angle_min_dist: float = 3.0, refit_cap: int = 0):
    """Host wrapper: stack slot specs + frame ownership, run the fused
    fit + NMS (+ re-fit) on the bank's device, split the one array it
    copies to the host.  Fits exactly the cars there are (the JAX package
    pads the batch for its compile cache).

    Returns (centres (B,3), thetas (B,), {frame: (keep, merged)},
    n_targets, {batch idx: (centre, theta)}): the last two report the
    in-program NMS-merge re-fits when ``refit_cap > 0`` (n_targets >
    refit_cap means the overflow targets still need a re-fit; with
    refit_cap == 0 they are (0, {}) and the caller re-fits all)."""
    b = len(slots)
    dev = bank.device
    host = _stack_slots(slots, tracks, windows, angle_min_dist)
    car_frame = np.asarray(owners, np.int32)
    car_slot = np.zeros(b, np.int32)
    slot_counter: dict = {}
    for i, fi in enumerate(owners):
        car_slot[i] = slot_counter.get(fi, 0)
        slot_counter[fi] = car_slot[i] + 1
    npts = np.asarray([s.npts for s in slots], np.float32)
    out = _fit_nms_from_bank(
        bank, *(to_device(host[k], dev) for k in _SLOT_ARGS),
        to_device(car_frame, dev), to_device(car_slot, dev),
        to_device(npts, dev),
        to_device(np.asarray(lwh, np.float32), dev), float(nms_iou),
        template, occ_k, memb_k, spec, cfg, quota, n_frames, max_cars,
        refit_cap).cpu().numpy()
    fit = out[:4 * b].reshape(4, b)
    nms_end = 4 * b + 2 * n_frames * max_cars
    nms = out[4 * b:nms_end].reshape(2, n_frames, max_cars)
    nms_by_frame = {fi: (nms[0, fi] > 0.5, nms[1, fi].astype(np.int64))
                    for fi in range(n_frames)}
    if not refit_cap:
        return fit[:3].T, fit[3], nms_by_frame, 0, {}
    n_targets = int(out[nms_end])
    r = min(refit_cap, b)
    rp = out[nms_end + 1:].reshape(5, r)
    refits = {int(rp[0, k]): (rp[1:4, k], float(rp[4, k]))
              for k in range(r) if rp[0, k] >= 0}
    return fit[:3].T, fit[3], nms_by_frame, n_targets, refits


def fit_slots(bank, slots: Sequence[CarSlots],
              tracks: Sequence[Track],
              windows: Sequence[Sequence[int]],
              template, occ_k, memb_k, spec, cfg: FitConfig,
              quota: int, angle_min_dist: float = 3.0):
    """Stack per-car slot specs, compute trajectory angles, and run the
    device gather + fit.  Returns BatchFitResult (on the bank's device)."""
    host = _stack_slots(slots, tracks, windows, angle_min_dist)
    return _fit_from_bank(
        bank, *(to_device(host[k], bank.device) for k in _SLOT_ARGS),
        template, occ_k, memb_k, spec, cfg, quota)
