"""A synthetic detector training batch (the JAX package's
``__graft_entry__._sample_batch``, the same numpy draws, numpy out)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def sample_batch(b: int, h: int, w: int, max_objs: int = 8,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """``b`` normalised noise images of ``h`` x ``w`` with the KITTI-like P2
    (f = 700, principal point at the centre) and ``max_objs`` padded
    targets per image, of which the first 3 are valid."""
    rng = np.random.default_rng(seed)
    calib = np.tile(np.array([[700.0, 0, w / 2, 0],
                              [0, 700.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    boxes_3d = np.zeros((b, max_objs, 6), np.float32)
    boxes_3d[..., :2] = rng.uniform(0.3, 0.7, (b, max_objs, 2))
    boxes_3d[..., 2:] = rng.uniform(0.02, 0.2, (b, max_objs, 4))
    boxes = np.concatenate([boxes_3d[..., :2],
                            boxes_3d[..., 2:3] + boxes_3d[..., 3:4],
                            boxes_3d[..., 4:5] + boxes_3d[..., 5:6]], -1)
    valid = np.zeros((b, max_objs), bool)
    valid[:, :3] = True
    return {
        "image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
        "calib": calib,
        "img_size": np.tile(np.array([w, h], np.float32), (b, 1)),
        "labels": rng.integers(0, 3, (b, max_objs)).astype(np.int32),
        "boxes": boxes,
        "boxes_3d": boxes_3d,
        "depth": rng.uniform(5, 50, (b, max_objs)).astype(np.float32),
        "size_3d": rng.uniform(-0.3, 0.3, (b, max_objs, 3)).astype(
            np.float32),
        "heading_bin": rng.integers(0, 12, (b, max_objs)).astype(np.int32),
        "heading_res": rng.uniform(-0.2, 0.2, (b, max_objs)).astype(
            np.float32),
        "mask_2d": valid.copy(),
        "valid": valid,
    }
