"""Optimizer accuracy harness ("custom dataset" debug path).

Behavioral contract (pseudo_label_generator/3d/scripts/custom_dataset.py):

* ``find_gt_for_car`` (:21-71): match each fitted car to the closest GT box
  center (within a gate) and store the (points, gt box) pair;
* ``save/load`` (:73-134): persist pairs to disk (zstd-pickle blobs in the
  reference; compressed npz here) and lay loaded cars out in a row spaced
  ``distance_between_cars`` apart for visual inspection;
* ``custom_compute_iou`` (:144-149): re-run the optimizer on the stored
  points and report per-car 3D IoU against GT — a fixture-based integration
  test of template fitting without the full pipeline.

A copy of the JAX package's ``sowa/custom_dataset.py``: numpy, with the
port's ``ops/box3d.iou_3d`` (float32, on the CPU) for the IoU.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def find_gt_for_car(car_center: np.ndarray, gt_centers: np.ndarray,
                    gate: float = 4.0) -> Optional[int]:
    if len(gt_centers) == 0:
        return None
    d = np.linalg.norm(gt_centers - car_center[None, :], axis=1)
    i = int(np.argmin(d))
    return i if d[i] < gate else None


def save_pair(out_dir: str, name: str, points: np.ndarray,
              gt_box: np.ndarray) -> str:
    """gt_box = [x, y, z, l, w, h, ry] (center-based camera coords)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez_compressed(path, points=np.asarray(points, np.float32),
                        gt_box=np.asarray(gt_box, np.float32))
    return path


def load_pairs(out_dir: str, limit: Optional[int] = None,
               distance_between: float = 10.0
               ) -> Tuple[List[np.ndarray], np.ndarray, np.ndarray]:
    """Returns (points list, gt boxes (N, 7), row offsets (N, 3)) — loaded
    cars are spaced along x for side-by-side visualization."""
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npz"))
    if limit:
        files = files[:limit]
    points, boxes, offsets = [], [], []
    for i, f in enumerate(files):
        with np.load(os.path.join(out_dir, f)) as z:
            points.append(z["points"])
            boxes.append(z["gt_box"])
        offsets.append([i * distance_between, 0.0, 0.0])
    return (points,
            np.stack(boxes) if boxes else np.zeros((0, 7), np.float32),
            np.asarray(offsets, np.float32))


def compute_pair_iou(fitted_box: np.ndarray, gt_box: np.ndarray) -> float:
    """3D IoU of [x, y, z, l, w, h, ry] boxes (custom_compute_iou)."""
    import torch

    from monosowa_tpu_torch.ops.box3d import iou_3d

    f = torch.as_tensor(np.asarray(fitted_box, np.float32))
    g = torch.as_tensor(np.asarray(gt_box, np.float32))
    out = iou_3d(f[None, :3], f[None, 3:6], f[None, 6],
                 g[None, :3], g[None, 3:6], g[None, 6])
    return float(out[0, 0])


def evaluate_fitting_on_pairs(out_dir: str, fit_fn,
                              limit: Optional[int] = None) -> List[float]:
    """Re-fit every stored pair with ``fit_fn(points) -> [x,y,z,l,w,h,ry]``
    and return per-car IoUs (the harness's headline report)."""
    points, boxes, _ = load_pairs(out_dir, limit)
    ious = []
    for pts, gt in zip(points, boxes):
        fitted = np.asarray(fit_fn(pts), np.float32)
        ious.append(compute_pair_iou(fitted, gt))
    return ious
