"""KITTI raw-sequence calibration files.

Counterpart of the JAX package's ``kittiio/raw_calib.py`` (numpy).

Parses calib_imu_to_velo.txt / calib_velo_to_cam.txt / calib_cam_to_cam.txt
into 4x4 transforms and composes the IMU -> rectified-cam2 chain the
ego-motion stage conjugates with (reference loader.py:917-935 uses pykitti's
equivalent ``calib.T_cam2_imu``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _read_kv(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, _, rest = line.partition(":")
            try:
                out[k.strip()] = np.array([float(v) for v in rest.split()])
            except ValueError:
                continue
    return out


def _rt_to_mat(d: Dict[str, np.ndarray]) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = d["R"].reshape(3, 3)
    t[:3, 3] = d["T"].reshape(3)
    return t


def load_raw_calib(seq_dir: str) -> Dict[str, np.ndarray]:
    """Calibration dir (the date dir holding calib_*.txt) -> transforms.

    Returns dict with T_velo_imu, T_cam0_velo, R_rect00, P_rect20,
    T_cam2rect_imu (the conjugation matrix: IMU frame -> rectified cam-2).
    """
    imu2velo = _rt_to_mat(_read_kv(os.path.join(seq_dir,
                                                "calib_imu_to_velo.txt")))
    velo2cam = _rt_to_mat(_read_kv(os.path.join(seq_dir,
                                                "calib_velo_to_cam.txt")))
    c2c = _read_kv(os.path.join(seq_dir, "calib_cam_to_cam.txt"))
    r_rect = np.eye(4)
    r_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    p_rect2 = c2c["P_rect_02"].reshape(3, 4)

    # rectified cam2 differs from rect cam0 by a pure x-baseline shift
    t_cam2 = np.eye(4)
    t_cam2[0, 3] = p_rect2[0, 3] / p_rect2[0, 0]

    t_cam2rect_imu = t_cam2 @ r_rect @ velo2cam @ imu2velo
    return {"T_imu_velo": imu2velo, "T_velo_cam0": velo2cam,
            "R_rect00": r_rect, "P_rect20": p_rect2,
            "T_cam2rect_imu": t_cam2rect_imu}
