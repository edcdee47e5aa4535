"""Ego-motion transformation stage.

Behavioral contract (pseudo_label_generator/3d/scripts/loader.py:901-1013):
per reference frame, a (2*R+1, 4, 4) array of ``T_cur_to_ref`` camera-frame
transforms over the +-nscans_transformation_range window, cached as
``transformations/<frame>.npy`` with skip-if-exists resumability
(:902-905, :938).

Three pose sources:
* KITTI raw: OXTS IMU chain conjugated into cam2 (:917-935), vectorized in
  kittiio.oxts;
* KITTI-360: cam0_to_world.txt poses (:942-982), missing frames -> zero
  matrices that downstream skips (:956-961);
* waymo_converted: per-frame ``Cur_pose`` rows appended to the calib files
  (:984-1013).

And the ICP pose source (use_icp, calculate_transformationsV2
:1016-1301): ``icp_window_transforms`` (pairwise ICP every ``jump``
frames, chained, intermediate frames interpolated) and
``icp_window_transforms_v2`` (the reference's anchor / escalation /
per-frame cascade), on ``ops/icp.py``.

A copy of the JAX package's ``sowa/transforms.py``: numpy for the pose
windows and cache I/O; the ICP windows subsample each scan with numpy in
the JAX package's draw order and run their pairs in batches on the card
(``ops/icp.icp_batch``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from monosowa_tpu_torch.kittiio.oxts import (oxts_to_poses,
                                             poses_file_transforms,
                                             relative_cam_transforms)


def window_indices(ref: int, n_frames: int, rng: int):
    """Clamped window [ref-rng, ref+rng] intersected with [0, n_frames)."""
    lo = max(ref - rng, 0)
    hi = min(ref + rng, n_frames - 1)
    return list(range(lo, hi + 1))


def kitti_window_transforms(oxts_packets: np.ndarray, imu_to_cam: np.ndarray,
                            ref: int, rng: int = 130) -> np.ndarray:
    """(T_frames, >=6) oxts -> (2*rng+1, 4, 4) T_cur_to_ref, zero-padded
    outside the sequence (matching the reference's fixed-size window)."""
    poses = oxts_to_poses(oxts_packets)
    rel = relative_cam_transforms(poses, imu_to_cam, ref)
    return _window_pack(rel, ref, rng)


def pose_window_transforms(poses_w_cam: np.ndarray, valid: np.ndarray,
                           ref: int, rng: int = 130) -> np.ndarray:
    """KITTI-360 / waymo_converted style world poses -> windowed transforms;
    invalid frames produce zero matrices (loader.py:956-961)."""
    rel = poses_file_transforms(poses_w_cam, ref)
    rel = np.where(valid[:, None, None], rel, np.zeros((4, 4)))
    return _window_pack(rel, ref, rng)


def _window_pack(rel: np.ndarray, ref: int, rng: int) -> np.ndarray:
    out = np.zeros((2 * rng + 1, 4, 4))
    n = rel.shape[0]
    for k, f in enumerate(range(ref - rng, ref + rng + 1)):
        if 0 <= f < n:
            out[k] = rel[f]
    return out


def read_cam0_to_world(path: str):
    """KITTI-360 ``data_poses/<seq>/cam0_to_world.txt`` -> dense
    (max_frame+1, 4, 4) pose array with ZERO matrices at the gaps
    (calculate_transformations_all, loader.py:948-957)."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    max_frame = int(lines[-1].split(" ", 1)[0])
    poses = np.zeros((max_frame + 1, 4, 4))
    for ln in lines:
        frame, rest = ln.split(" ", 1)
        poses[int(frame)] = np.array(
            [float(x) for x in rest.split()]).reshape(4, 4)
    return poses


def k360_window_transforms(poses: np.ndarray, number: int,
                           nscans_before: int, nscans_after: int
                           ) -> np.ndarray:
    """cam0_to_world poses -> (before+after+1, 4, 4) ``T_cur_to_ref``
    with the reference's exact edge semantics
    (calculate_transformations_all, loader.py:942-982):

    * ``number`` beyond the pose table -> an all-zero window (:958-963);
    * a zero REFERENCE pose -> an all-zero window (:966);
    * zero/out-of-range neighbour poses -> zero entries (:968-973);
    * otherwise ``inv(T_ref) @ T_cur`` (camera poses; no conjugation).
    """
    n = nscans_before + nscans_after + 1
    out = np.zeros((n, 4, 4))
    if number >= len(poses):
        return out
    t_ref = poses[number]
    if np.all(t_ref == 0):
        return out
    inv_ref = np.linalg.inv(t_ref)
    for i in range(-nscans_before, nscans_after + 1):
        j = number + i
        if j < 0 or j >= len(poses) or np.all(poses[j] == 0):
            continue
        out[i + nscans_before] = inv_ref @ poses[j]
    return out


def waymoc_window_transforms(calib_dir: str, number: int,
                             nscans_before: int, nscans_after: int,
                             name_fn=None) -> np.ndarray:
    """waymo_converted per-frame calib files (``Cur_pose`` +
    ``Tr_velo_to_cam`` rows, the converter's appended pose) ->
    (before+after+1, 4, 4) ``T_cur_to_ref``, float32
    (calculate_transformations_waymoc, loader.py:984-1013):

        T = V2C_cur @ inv(pose_ref) @ pose_cur @ inv(V2C_cur)

    (V2C = Tr_velo_to_cam as a 4x4).

    Missing neighbour calib files leave zero entries; ``name_fn(i)`` maps a
    frame number to the calib file stem (default: 10-digit zero pad, the
    converter's naming)."""
    from monosowa_tpu_torch.kittiio import Calibration

    name_fn = name_fn or (lambda i: f"{i:010d}")
    ref = Calibration(os.path.join(calib_dir, name_fn(number) + ".txt"))
    inv_ref_pose = np.linalg.inv(ref.pose)
    n = nscans_before + nscans_after + 1
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(number - nscans_before, number + nscans_after + 1):
        p = os.path.join(calib_dir, name_fn(i) + ".txt")
        if i < 0 or not os.path.exists(p):
            continue
        cal = Calibration(p)
        v2c = np.eye(4)
        v2c[:3] = cal.V2C
        t = v2c @ inv_ref_pose @ cal.pose @ np.linalg.inv(v2c)
        out[i - number + nscans_before] = t
    return out


def transforms_cache_path(cache_dir: str, frame: str) -> str:
    return os.path.join(cache_dir, f"{frame}.npy")


def save_window_transforms(cache_dir: str, frame: str,
                           transforms: np.ndarray) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    np.save(transforms_cache_path(cache_dir, frame), transforms)


def load_window_transforms(cache_dir: str, frame: str
                           ) -> Optional[np.ndarray]:
    p = transforms_cache_path(cache_dir, frame)
    if not os.path.exists(p):
        return None
    return np.load(p)


def slice_window(transforms_full: np.ndarray, full_rng: int,
                 before: int, after: int) -> np.ndarray:
    """Cut the +-full_rng cache down to the [-before, +after] aggregation
    window (the reference caches 130 and aggregates 30)."""
    c = full_rng
    return transforms_full[c - before:c + after + 1]


def _interpolate_se3(t_a: np.ndarray, t_b: np.ndarray, alpha: float
                     ) -> np.ndarray:
    """Fractional rigid interpolation between two 4x4 transforms (axis-angle
    slerp on rotation, linear on translation)."""
    from scipy.spatial.transform import Rotation, Slerp

    rots = Rotation.from_matrix(np.stack([t_a[:3, :3], t_b[:3, :3]]))
    r = Slerp([0.0, 1.0], rots)([alpha]).as_matrix()[0]
    out = np.eye(4)
    out[:3, :3] = r
    out[:3, 3] = (1 - alpha) * t_a[:3, 3] + alpha * t_b[:3, 3]
    return out


Padded = Tuple[np.ndarray, np.ndarray]


def _subsampler(rng_np: np.random.Generator, max_points: int
                ) -> Callable[[Optional[np.ndarray]], Optional[Padded]]:
    """prep(pts) -> (pad (max_points, 3) float32, mask) or None for fewer
    than 50 points; above ``max_points`` a subsample without replacement
    drawn from ``rng_np`` (each call draws, so calls must come in the JAX
    package's order)."""
    def prep(pts):
        if pts is None or len(pts) < 50:
            return None
        if len(pts) > max_points:
            pts = pts[rng_np.choice(len(pts), max_points, replace=False)]
        pad = np.zeros((max_points, 3), np.float32)
        pad[:len(pts)] = pts
        m = np.zeros(max_points, bool)
        m[:len(pts)] = True
        return pad, m
    return prep


def icp_pairs(pairs: List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]],
              device=None) -> np.ndarray:
    """(source, source_mask, target, target_mask) numpy pairs -> (B, 4, 4)
    float32 ``T_source_to_target``, one ``icp_batch`` call on ``device``
    (the card unless the caller names another)."""
    from monosowa_tpu_torch.device import resolve_device
    from monosowa_tpu_torch.ops.icp import icp_batch

    if not pairs:
        return np.zeros((0, 4, 4), np.float32)
    dev = resolve_device(device)
    cols = [torch.from_numpy(np.stack([p[k] for p in pairs])).to(dev)
            for k in range(4)]
    with torch.no_grad():
        t, _ = icp_batch(*cols)
    return t.cpu().numpy()


def icp_window_transforms(get_scan, ref: int, rng: int,
                          n_frames: int, jump: int = 5,
                          max_points: int = 4096,
                          seed: int = 0, device=None) -> np.ndarray:
    """ICP-refined ``T_cur_to_ref`` chain (use_icp branch,
    loader.py:1016-1301 calculate_transformationsV2): pairwise
    point-to-plane ICP every ``jump`` frames, chained outward from the
    reference, with SE(3) interpolation of the intermediate frames.

    get_scan(frame_idx) -> (N, 3) camera points or None.  Returns
    (2*rng+1, 4, 4) window-packed transforms (zeros for missing frames).

    The subsample of a pair's two scans is drawn for the current frame and
    then the previous one on every step (no cache), and a chain stops at
    the first missing scan, as in the JAX package; no step depends on an
    ICP result, so all pairs of both directions run in one batch before
    the chains are composed."""
    prep = _subsampler(np.random.default_rng(seed), max_points)
    steps = []                          # (direction, prev, f, a, b)
    for direction in (-1, 1):
        prev = ref
        f = ref + direction * jump
        while 0 <= f < n_frames and abs(f - ref) <= rng:
            a = prep(get_scan(f))
            b = prep(get_scan(prev))
            if a is None or b is None:
                break
            steps.append((direction, prev, f, a, b))
            prev = f
            f += direction * jump
    t_pairs = icp_pairs([(a[0], a[1], b[0], b[1])
                         for _, _, _, a, b in steps], device)

    rel = {ref: np.eye(4)}
    chain, chain_dir = np.eye(4), None
    for (direction, prev, f, _, _), t_pair in zip(steps, t_pairs):
        if direction != chain_dir:
            chain, chain_dir = np.eye(4), direction
        chain = chain @ t_pair
        rel[f] = chain.copy()
        # interpolate the skipped frames between prev and f
        prev_t = rel[prev]
        for k in range(1, jump):
            mid = prev + direction * k
            if 0 <= mid < n_frames and abs(mid - ref) <= rng:
                rel[mid] = _interpolate_se3(prev_t, chain, k / jump)

    out = np.zeros((2 * rng + 1, 4, 4))
    for k, fr in enumerate(range(ref - rng, ref + rng + 1)):
        if fr in rel:
            out[k] = rel[fr]
    return out


def icp_window_transforms_v2(get_scan, ref: int, rng: int, n_frames: int,
                             jump: int = 5, get_prior=None,
                             max_points: int = 4096,
                             seed: int = 0, device=None) -> np.ndarray:
    """Reference-faithful ICP window (calculate_transformationsV2,
    loader.py:1016-1301) with the full fallback cascade:

    1. ANCHORS (multiples of ``jump`` from the reference frame): each is
       pairwise-aligned to its toward-zero partner at distance jump*k,
       escalating k = 1..5 until both scans exist (:1054-1135); the
       escalation STOPS at the first k whose partner would overshoot past
       the reference frame (the reference ``continue``s there).  The ICP
       refines an odometry prior (``get_prior(cur, ref) -> 4x4
       T_cur_to_ref``, identity when absent) and tmp[i] = icp @ prior.
    2. Anchor chains compose toward frame 0 stepping by ``jump``, missing
       links contributing identity (:1206-1230).
    3. NON-ANCHOR frames run their OWN prior+ICP against the nearest
       VALID anchor toward zero (multiples of jump, then jump*2, jump*3
       when the anchor chain came out identity, :1234-1247), composed with
       that anchor's absolute transform (:1295).

    Frames whose scans are missing keep IDENTITY (the reference
    initializes both arrays to eye, :1027-1031), unlike the zero
    matrices of the pose-file paths.

    Batched form: the escalation of phase 1 depends only on which scans
    exist, and phase 3's anchor choice only on phase 2's result, so each
    phase's pairs are collected first (every subsample drawn, once per
    frame offset and in the JAX package's first-access order, and every
    prior asked for, in the order the JAX package asks) and run in one
    ``icp_batch`` call: two batches a window."""
    prep_scan = _subsampler(np.random.default_rng(seed), max_points)
    scan_cache: Dict[int, Optional[Padded]] = {}

    def prep(f):
        """Subsampled padded scan for frame OFFSET f, or None."""
        if f not in scan_cache:
            fr = ref + f
            pts = get_scan(fr) if 0 <= fr < n_frames else None
            if pts is not None:
                pts = np.asarray(pts, np.float32)[:, :3]
            scan_cache[f] = prep_scan(pts)
        return scan_cache[f]

    prior = get_prior or (lambda cur, anchor: np.eye(4))

    def pair(i, partner):
        """(source moved by the prior, masks, target, prior), or None
        when a scan is absent."""
        a = prep(i)
        b = prep(partner)
        if a is None or b is None:
            return None
        p = np.asarray(prior(ref + i, ref + partner), np.float64)
        moved = (a[0] @ p[:3, :3].T + p[:3, 3]).astype(np.float32)
        return (moved, a[1], b[0], b[1]), p

    def run(jobs):
        """[(key, (inputs, prior))] -> {key: T_i_to_partner = icp @ prior}"""
        t = icp_pairs([job[0] for _, job in jobs], device)
        return {key: np.asarray(ti, np.float64) @ job[1]
                for (key, job), ti in zip(jobs, t)}

    n_win = 2 * rng + 1
    tmp = np.tile(np.eye(4), (n_win, 1, 1))
    out = np.tile(np.eye(4), (n_win, 1, 1))

    # phase 1: anchors with the x2..x5 escalation.  Anchors are the
    # multiples of ``jump`` on both sides, the same set phases 2/3 walk
    anchors = (list(range(-jump * (rng // jump), 0, jump))
               + list(range(jump, rng + 1, jump)))
    jobs = []
    for i in anchors:
        for k in range(1, 6):
            partner = i + jump * k if i < 0 else i - jump * k
            if (i < 0 and partner > 0) or (i >= 0 and partner < 0):
                break                    # overshoot: reference continues
            job = pair(i, partner)
            if job is not None:
                jobs.append((i, job))
                break
    for i, t in run(jobs).items():
        tmp[i + rng] = t

    # phase 2: compose anchor chains toward the reference frame
    for i in range(-jump * (rng // jump), 0, jump):
        if prep(i) is None:
            continue
        t = np.eye(4)
        for z in range(i, 0, jump):
            t = tmp[z + rng] @ t
        out[i + rng] = t
    for i in range(rng - rng % jump, 0, -jump):
        if prep(i) is None:
            continue
        t = np.eye(4)
        for z in range(i, 0, -jump):
            t = tmp[z + rng] @ t
        out[i + rng] = t

    # phase 3: per-frame ICP against the nearest valid anchor toward zero
    jobs = []
    for i in range(-rng, rng + 1):
        if i % jump == 0:
            continue
        for mult in (1, 2, 3):
            step = jump * mult
            ref_index = int(np.rint(np.ceil(i / step) * step)) if i < 0 \
                else int(np.rint(np.floor(i / step) * step))
            if ref_index == 0 or not np.array_equal(out[ref_index + rng],
                                                    np.eye(4)):
                break
        if abs(ref_index) > rng:
            continue
        job = pair(i, ref_index)
        if job is not None:
            jobs.append(((i, ref_index), job))
    for (i, ref_index), t in run(jobs).items():
        out[i + rng] = out[ref_index + rng] @ t
    out[rng] = np.eye(4)
    return out
