"""Real-LiDAR (velodyne) scan IO and camera-frame preparation.

Counterpart of the JAX package's ``kittiio/velodyne.py`` (numpy).

Behavioral contract:

* ``load_velo_scan``       = pseudo_label_generator/3d/scripts/utils2.py:6-9
  — raw float32 ``.bin``, reshaped (-1, 4) (x, y, z, reflectance).
* ``velo_to_cam``          = loader.py:3337-3352 transform_velo_to_cam —
  homogeneous transform by ``T_cam2_velo`` with the reflectance column
  overwritten by 1, then (optionally) dropping points behind the camera
  (z <= 0).  The pseudo-lidar path skips this transform (points are
  already camera-frame); the real-lidar path always applies it.
"""

from __future__ import annotations

import numpy as np


def load_velo_scan(path: str) -> np.ndarray:
    """Raw KITTI velodyne ``.bin`` -> (N, 4) float32 [x y z reflectance]."""
    scan = np.fromfile(path, dtype=np.float32)
    return scan.reshape((-1, 4))


def velo_to_cam(scan: np.ndarray, t_cam_velo: np.ndarray,
                filter_points: bool = True) -> np.ndarray:
    """(N, >=3) velodyne-frame points -> (M, 3) cam-frame points.

    t_cam_velo: (4, 4) velodyne->camera homogeneous transform
    (pykitti ``calib.T_cam2_velo``).  With ``filter_points`` drops points
    with camera z <= 0 (loader.py:3346-3349).
    """
    pts = np.asarray(scan, np.float64)
    hom = np.concatenate([pts[:, :3], np.ones((pts.shape[0], 1))], 1)
    cam = hom @ np.asarray(t_cam_velo, np.float64).T
    cam = cam[:, :3]
    if filter_points:
        cam = cam[cam[:, 2] > 0.0]
    return cam.astype(np.float32)
