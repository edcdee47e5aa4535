"""The cache of ego-motion transformations: per reference frame a
(2*R+1, 4, 4) array of ``T_cur_to_ref`` camera-frame transforms over the
+-nscans_transformation_range window, stored as
``transformations/<frame>.npy`` (pseudo_label_generator/3d/scripts/
loader.py:901-1013).

A numpy copy of the cache I/O of the JAX package's ``sowa/transforms.py``;
computing transformations (OXTS chains, KITTI-360 and Waymo poses, ICP)
is not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


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
