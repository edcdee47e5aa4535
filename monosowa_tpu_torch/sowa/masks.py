"""The cache of instance masks: per frame the car masks, bit-packed in
one npz under ``masks_raw/`` (the reference caches Detectron2 car masks
with score > 0.7 per frame, loader.py:1703-1790).

A numpy copy of the cache I/O of the JAX package's ``sowa/masks.py``; the
live segmentation and SAM refinement backends are not ported.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def mask_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return np.zeros(4, np.int64)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.int64)


def save_masks(cache_dir: str, frame: str, masks: List[np.ndarray],
               img_hw) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    h, w = img_hw
    if masks:
        arr = np.stack([m.astype(bool) for m in masks])
    else:
        arr = np.zeros((0, h, w), bool)
    np.savez_compressed(os.path.join(cache_dir, f"{frame}.npz"),
                        packed=np.packbits(arr, axis=-1),
                        shape=np.array(arr.shape))


def load_masks(cache_dir: str, frame: str) -> Optional[List[np.ndarray]]:
    path = os.path.join(cache_dir, f"{frame}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        shape = z["shape"]
        packed = z["packed"]
    arr = np.unpackbits(packed, axis=-1, count=int(shape[-1])).astype(bool)
    return [arr[i] for i in range(int(shape[0]))]
