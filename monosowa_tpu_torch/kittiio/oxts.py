"""OXTS (GPS/IMU) parsing and world-pose chains for KITTI raw sequences.

The pseudo-labeller's ego-motion stage conjugates pykitti's per-frame
``T_w_imu`` poses into the camera frame
(pseudo_label_generator/3d/scripts/loader.py:901-940).  This module provides a
dependency-free equivalent of pykitti's pose computation: Mercator-projected
GPS position + roll/pitch/yaw rotation, normalized to the first frame.

Vectorized over the whole sequence (one (T, 4, 4) array) so the downstream
transformation chains are single einsums rather than per-frame loops.

A numpy copy of the JAX package's ``kittiio/oxts.py``.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS = 6378137.0  # meters


def read_oxts_file(path: str) -> np.ndarray:
    """One oxts txt -> (30,) float array (lat lon alt roll pitch yaw ...)."""
    with open(path, "r") as f:
        vals = f.read().split()
    return np.array([float(v) for v in vals], np.float64)


def rot_x(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([
        np.stack([o, z, z], -1),
        np.stack([z, c, -s], -1),
        np.stack([z, s, c], -1),
    ], -2)


def rot_y(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([
        np.stack([c, z, s], -1),
        np.stack([z, o, z], -1),
        np.stack([-s, z, c], -1),
    ], -2)


def rot_z(a: np.ndarray) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    o, z = np.ones_like(a), np.zeros_like(a)
    return np.stack([
        np.stack([c, -s, z], -1),
        np.stack([s, c, z], -1),
        np.stack([z, z, o], -1),
    ], -2)


def oxts_to_poses(oxts: np.ndarray) -> np.ndarray:
    """(T, >=6) oxts packets -> (T, 4, 4) ``T_w_imu`` poses.

    Mercator projection scaled by cos(lat of frame 0); the first frame's pose
    is the world origin (pykitti convention the reference relies on).
    """
    oxts = np.asarray(oxts, np.float64)
    if oxts.ndim == 1:
        oxts = oxts[None]
    lat, lon, alt = oxts[:, 0], oxts[:, 1], oxts[:, 2]
    roll, pitch, yaw = oxts[:, 3], oxts[:, 4], oxts[:, 5]

    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt
    t = np.stack([tx, ty, tz], axis=-1)  # (T, 3)

    rot = rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)  # (T, 3, 3)

    poses = np.tile(np.eye(4), (oxts.shape[0], 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = t

    # Normalize so frame 0 is the origin: T0^-1 @ Ti.
    inv0 = np.eye(4)
    inv0[:3, :3] = rot[0].T
    inv0[:3, 3] = -rot[0].T @ t[0]
    return inv0[None] @ poses


def relative_cam_transforms(poses_w_imu: np.ndarray, imu_to_cam: np.ndarray,
                            ref_index: int) -> np.ndarray:
    """Per-frame 4x4 ``T_cur_to_ref`` in camera coordinates.

    Equivalent of the reference's transformation chain
    ``T_imu2cam @ inv(T_w_imu[ref]) @ T_w_imu[cur] @ inv(T_imu2cam)``
    (loader.py:917-935), vectorized over the whole window.

    poses_w_imu: (T, 4, 4); imu_to_cam: (4, 4) rigid transform.
    """
    ref_inv = np.linalg.inv(poses_w_imu[ref_index])
    rel_imu = ref_inv[None] @ poses_w_imu  # (T,4,4) imu_cur -> imu_ref
    cam = imu_to_cam[None] @ rel_imu @ np.linalg.inv(imu_to_cam)[None]
    return cam


def poses_file_transforms(poses: np.ndarray, ref_index: int) -> np.ndarray:
    """KITTI-360 style: per-frame cam0-to-world poses -> ``T_cur_to_ref``
    (loader.py:942-982): ``inv(T_w_cam[ref]) @ T_w_cam[cur]``."""
    ref_inv = np.linalg.inv(poses[ref_index])
    return ref_inv[None] @ poses
