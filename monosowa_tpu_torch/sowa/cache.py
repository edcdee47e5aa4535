"""Disk caches for the staged pipeline (the de-facto distributed runtime).

Behavioral contract (SURVEY.md §1 storage layer; output.py:127-172 dirs;
loader.py candidate caches :3029-3154, merged-frame caches :378-417): each
``--action`` stage persists per-frame artifacts under merged_frames_path so
later stages (and other share-nothing workers) resume from disk; existence
of a file is the completion marker.

Cache formats are compressed npz (the reference uses zstd-pickle blobs —
an internal format, swapped for a dependency-free one; directory taxonomy
is preserved: candidates_*/, detandtrackedV2/ -> merged_cars/).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from monosowa_tpu_torch.sowa.lomm import Track


# -- candidate caches (per frame-in-window) ---------------------------------

def save_candidates(cache_dir: str, frame: str, cand: dict) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{frame}.npz")
    n = len(cand["points"])
    payload = {"locations": np.asarray(cand["locations"], np.float32),
               "n": np.int64(n)}
    for i, p in enumerate(cand["points"]):
        payload[f"points_{i}"] = np.asarray(p, np.float32)
    np.savez_compressed(path, **payload)
    return path


def load_candidates(cache_dir: str, frame: str) -> Optional[dict]:
    path = os.path.join(cache_dir, f"{frame}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        n = int(z["n"])
        return {"locations": z["locations"],
                "points": [z[f"points_{i}"] for i in range(n)],
                "masks": [None] * n}


# -- merged-car caches (post aggregation, pre optimization) -----------------

def save_merged_cars(cache_dir: str, frame: str, tracks: Sequence[Track],
                     points: Sequence[np.ndarray],
                     ref_masks: Optional[Sequence] = None) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{frame}.npz")
    payload = {"n": np.int64(len(tracks))}
    for i, (t, p) in enumerate(zip(tracks, points)):
        payload[f"points_{i}"] = np.asarray(p, np.float32)
        payload[f"moving_{i}"] = np.bool_(t.moving)
        payload[f"frames_{i}"] = np.asarray(t.frames, np.int32)
        payload[f"locations_{i}"] = np.asarray(
            [loc[:3] for loc in t.locations], np.float32)
        if ref_masks is not None and ref_masks[i] is not None:
            m = np.asarray(ref_masks[i], bool)
            payload[f"mask_{i}"] = np.packbits(m, axis=-1)
            payload[f"mask_shape_{i}"] = np.asarray(m.shape)
    np.savez_compressed(path, **payload)
    return path


def load_merged_cars(cache_dir: str, frame: str
                     ) -> Optional[tuple]:
    """Returns (tracks, points, ref_masks) or None."""
    path = os.path.join(cache_dir, f"{frame}.npz")
    if not os.path.exists(path):
        return None
    tracks: List[Track] = []
    points: List[np.ndarray] = []
    ref_masks: List = []
    with np.load(path) as z:
        for i in range(int(z["n"])):
            frames = z[f"frames_{i}"].tolist()
            locs = [z[f"locations_{i}"][k] for k in range(len(frames))]
            t = Track(frames=frames, locations=locs,
                      points=[None] * len(frames),
                      masks=[None] * len(frames),
                      moving=bool(z[f"moving_{i}"]))
            tracks.append(t)
            points.append(z[f"points_{i}"])
            if f"mask_{i}" in z:
                shape = z[f"mask_shape_{i}"]
                ref_masks.append(np.unpackbits(
                    z[f"mask_{i}"], axis=-1,
                    count=int(shape[-1])).astype(bool))
            else:
                ref_masks.append(None)
    return tracks, points, ref_masks


def stage_done(cache_dir: str, frame: str) -> bool:
    return os.path.exists(os.path.join(cache_dir, f"{frame}.npz"))


# -- optimized-car caches (post optimization, consumed by the detector's ----
# -- TFL/mask auxiliary losses: the reference's optimized_cars/*.zstd ------
# -- blobs, main_class.py:780-816 writer / kitti_dataset.py:421-449 reader --

def save_optimized_cars(cache_dir: str, frame: str,
                        cars: Sequence[dict]) -> str:
    """Persist fitted cars for ``use_add_data`` training.  Each car dict
    needs ``points`` (N, 3) ref-frame cloud, ``mask`` (H, W) bool or None,
    ``moving`` bool, ``theta`` float."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{frame}.npz")
    payload = {"n": np.int64(len(cars))}
    for i, car in enumerate(cars):
        payload[f"points_{i}"] = np.asarray(car["points"], np.float32)
        payload[f"moving_{i}"] = np.bool_(car.get("moving", False))
        payload[f"theta_{i}"] = np.float32(car.get("theta", 0.0))
        m = car.get("mask")
        if m is not None:
            m = np.asarray(m, bool)
            payload[f"mask_{i}"] = np.packbits(m, axis=-1)
            payload[f"mask_shape_{i}"] = np.asarray(m.shape)
    np.savez_compressed(path, **payload)
    return path


def load_optimized_cars(cache_dir: str, frame: str) -> Optional[List[dict]]:
    path = os.path.join(cache_dir, f"{frame}.npz")
    if not os.path.exists(path):
        return None
    cars: List[dict] = []
    with np.load(path) as z:
        for i in range(int(z["n"])):
            mask = None
            if f"mask_{i}" in z:
                shape = z[f"mask_shape_{i}"]
                mask = np.unpackbits(
                    z[f"mask_{i}"], axis=-1,
                    count=int(shape[-1])).astype(bool)
            cars.append({"points": z[f"points_{i}"],
                         "moving": bool(z[f"moving_{i}"]),
                         "theta": float(z[f"theta_{i}"]),
                         "mask": mask})
    return cars
