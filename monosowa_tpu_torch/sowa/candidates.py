"""Candidate extraction: instance masks + per-frame points -> car centroids.

Behavioral contract (pseudo_label_generator/3d/scripts/loader.py:2802-2922,
get_car_locations_from_img):

per mask: shrink the mask by ``2 + sqrt(area)//10`` erosion iterations to
avoid boundary outliers; gather points projecting into the shrunk mask (with
x1-erosion and no-erosion fallbacks when fewer than the
moving_detection_threshold points survive); take the per-axis *median* as
the center; keep points within filter_diameter (4 m) of the center in the
ground plane and re-take the median; drop pseudo-lidar candidates beyond
max_distance (75 m); transform the center into the reference frame and keep
only candidates in front of the camera; the candidate's stored point set is
re-gathered with the *full* mask, circle-filtered, and transformed to the
reference frame.

Projection matches project_lidar_points (loader.py:3354-3376): rounded pixel
coordinates, cropped to the image.

Performance notes (host path, KITTI-size 466k-point pseudo-LiDAR frames):

* erosion = city-block distance transform on the mask's PADDED BBOX CROP
  (> k), equivalent to k iterations of 3x3-cross dilation of the inverse
  over the full image but costing O(car area) instead of O(k x image);
* per-point mask membership rides per-frame BITPLANE images (one uint64
  word gather per point per erosion level for up to 64 masks at once)
  instead of an (N,)-gather per mask per fallback level;
* the frame-local (camera-frame) extraction is split from the per-window
  reference-frame transform so sequence labeling computes each frame's
  candidates ONCE and re-transforms them per window
  (pipeline.label_frames caches by ``frame_ids``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.ndimage


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    moving_detection_threshold: int = 2   # filtering.moving_detection_threshold
    filter_diameter: float = 4.0          # filtering.filter_diameter
    max_distance_pseudo_lidar: float = 75.0
    use_pseudo_lidar: bool = True


def project_points(points_cam: np.ndarray, p2: np.ndarray,
                   img_hw) -> np.ndarray:
    """(N, 3) camera points -> ((N_kept, 5) [x y z u v] float32, keep mask)
    with rounded pixel coords, cropped to the image and to z > 0."""
    pts = np.asarray(points_cam, np.float32)
    p2 = np.asarray(p2, np.float32)
    proj = pts @ p2[:, :3].T + p2[:, 3]
    z = proj[:, 2]
    keep_z = z > 1e-6
    uv = np.rint(proj[:, :2] / np.maximum(z, 1e-6)[:, None])
    h, w = img_hw
    keep = (keep_z & (uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    return np.hstack([pts[keep], uv[keep].astype(np.float32)]), keep


def erode_mask(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Erosion with the reference's semantics (invert -> 3x3-cross binary
    dilation x ``iterations`` -> invert), computed as one city-block
    distance transform on the padded bbox crop."""
    if iterations <= 0:
        return mask
    out = np.zeros_like(mask)
    rows = mask.any(axis=1)
    cols = mask.any(axis=0)
    if not rows.any():
        return out
    y1 = int(np.argmax(rows))
    y2 = int(len(rows) - np.argmax(rows[::-1]))
    x1 = int(np.argmax(cols))
    x2 = int(len(cols) - np.argmax(cols[::-1]))
    crop = np.zeros((y2 - y1 + 2, x2 - x1 + 2), bool)
    crop[1:-1, 1:-1] = mask[y1:y2, x1:x2]
    # the pad ring inside the image is genuine background (bbox is tight);
    # beyond the image border there IS no background (binary_dilation's
    # border_value=0 never dilates in from outside) -> mark it mask so no
    # erosion originates there.
    if y1 == 0:
        crop[0, :] = True
    if y2 == mask.shape[0]:
        crop[-1, :] = True
    if x1 == 0:
        crop[:, 0] = True
    if x2 == mask.shape[1]:
        crop[:, -1] = True
    dist = scipy.ndimage.distance_transform_cdt(crop, metric="taxicab")
    out[y1:y2, x1:x2] = dist[1:-1, 1:-1] > iterations
    return out


def _median3(pts: np.ndarray) -> np.ndarray:
    """np.median semantics via partition (no full sort): mean of the two
    middle order statistics."""
    n = pts.shape[0]
    if n == 0:
        return np.median(pts, axis=0)
    lo = (n - 1) // 2
    hi = n // 2
    part = np.partition(pts, (lo, hi), axis=0)
    return (part[lo] + part[hi]) * 0.5


def _circle_filter(pts: np.ndarray, center: np.ndarray,
                   diameter: float) -> np.ndarray:
    d = np.hypot(pts[:, 0] - center[0], pts[:, 2] - center[2])
    return pts[d < diameter]


def _bitplane_members(masks_eroded: List[np.ndarray], flat: np.ndarray,
                      img_hw) -> List[np.ndarray]:
    """Per-mask (N,) bool membership via uint64 bitplane images: one word
    gather per point per 64 masks."""
    h, w = img_hw
    members: List[np.ndarray] = []
    for c0 in range(0, len(masks_eroded), 64):
        chunk = masks_eroded[c0:c0 + 64]
        bits = np.zeros((h, w), np.uint64)
        for b, m in enumerate(chunk):
            rows = m.any(axis=1)
            if not rows.any():
                continue
            cols = m.any(axis=0)
            y1 = int(np.argmax(rows))
            y2 = int(len(rows) - np.argmax(rows[::-1]))
            x1 = int(np.argmax(cols))
            x2 = int(len(cols) - np.argmax(cols[::-1]))
            bits[y1:y2, x1:x2] |= \
                m[y1:y2, x1:x2].astype(np.uint64) << np.uint64(b)
        pb = bits.reshape(-1)[flat]
        for b in range(len(chunk)):
            members.append((pb >> np.uint64(b)) & np.uint64(1) != 0)
    return members


def extract_candidates_cam(points_cam: np.ndarray, p2: np.ndarray,
                           img_hw, masks: Sequence[np.ndarray],
                           cfg: CandidateConfig = CandidateConfig()) -> dict:
    """Frame-local (camera-frame) candidate extraction — everything of
    get_car_locations_from_img that does not depend on the reference frame.

    Returns {"locations": (K, 3) camera-frame centers, "points": [(Ni, 3)
    camera-frame full-mask circle-filtered points], "masks": [mask]}.
    """
    empty = {"locations": np.zeros((0, 3), np.float32), "points": [],
             "masks": []}
    masks = [m for m in masks]
    if not masks:
        return empty
    proj, _ = project_points(points_cam, p2, img_hw)
    if proj.shape[0] == 0:
        return empty
    h, w = img_hw
    flat = (proj[:, 4].astype(np.int64) * w
            + proj[:, 3].astype(np.int64))
    xyz = proj[:, :3]

    areas = [int(np.count_nonzero(m)) for m in masks]
    structs = [int(2 + np.sqrt(a) // 10) if a else 0 for a in areas]
    eroded0 = [erode_mask(m, s) for m, s in zip(masks, structs)]
    mem0 = _bitplane_members(eroded0, flat, img_hw)
    mem_full = _bitplane_members(list(masks), flat, img_hw)

    locations, pts_out, masks_out = [], [], []
    for i, mask in enumerate(masks):
        if areas[i] == 0:
            continue
        core = xyz[mem0[i]]
        if core.shape[0] < cfg.moving_detection_threshold:
            core = xyz[erode_mask(mask, 1).reshape(-1)[flat]]
            if core.shape[0] < cfg.moving_detection_threshold:
                core = xyz[mem_full[i]]
                if core.shape[0] < cfg.moving_detection_threshold:
                    continue
        center = _median3(core)
        core = _circle_filter(core, center, cfg.filter_diameter)
        if core.shape[0] > 0:
            center = _median3(core)
        if cfg.use_pseudo_lidar and np.linalg.norm(center) > \
                cfg.max_distance_pseudo_lidar:
            continue
        # the stored point set comes from the FULL mask (loader.py:2878-2896)
        full = xyz[mem_full[i]]
        if full.shape[0] == 0:
            continue
        fc = _median3(full)
        full = _circle_filter(full, fc, cfg.filter_diameter)
        if full.shape[0] < cfg.moving_detection_threshold:
            continue
        locations.append(center)
        pts_out.append(full)
        masks_out.append(mask)

    if not locations:
        return empty
    return {"locations": np.stack(locations).astype(np.float32),
            "points": pts_out, "masks": masks_out}


def transform_candidates(cand_cam: dict, t_cur_to_ref: np.ndarray,
                         cfg: CandidateConfig = CandidateConfig()) -> dict:
    """Apply the window transform to camera-frame candidates and the
    reference-frame gates (center in front of the camera; enough points)."""
    rot = np.asarray(t_cur_to_ref[:3, :3], np.float32)
    tr = np.asarray(t_cur_to_ref[:3, 3], np.float32)
    locations, pts_out, masks_out = [], [], []
    for center, pts, mask in zip(cand_cam["locations"], cand_cam["points"],
                                 cand_cam["masks"]):
        center_ref = rot @ center + tr
        if center_ref[2] <= 0.0:
            continue
        full_ref = pts @ rot.T + tr
        if full_ref.shape[0] < cfg.moving_detection_threshold:
            continue
        locations.append(center_ref)
        pts_out.append(full_ref)
        masks_out.append(mask)
    if not locations:
        return {"locations": np.zeros((0, 3), np.float32), "points": [],
                "masks": []}
    return {"locations": np.stack(locations), "points": pts_out,
            "masks": masks_out}


def extract_candidates(points_cam: np.ndarray, p2: np.ndarray,
                       img_hw, masks: Sequence[np.ndarray],
                       t_cur_to_ref: np.ndarray,
                       cfg: CandidateConfig = CandidateConfig()) -> dict:
    """One frame -> candidate dict for the tracker (lomm.greedy_track).

    points_cam: (N, 3) this frame's (pseudo-)LiDAR in its own camera frame;
    masks: list of (H, W) bool instance masks; t_cur_to_ref: (4, 4).
    Returns {"locations": (K, 3) ref-frame centroids, "points": [(Ni, 3)
    ref-frame points], "masks": [mask]}.
    """
    return transform_candidates(
        extract_candidates_cam(points_cam, p2, img_hw, masks, cfg),
        t_cur_to_ref, cfg)
