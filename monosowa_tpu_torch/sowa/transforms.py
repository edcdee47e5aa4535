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

A numpy copy of the JAX package's ``sowa/transforms.py`` (pose windows
and cache I/O); its ICP pose source is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

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
