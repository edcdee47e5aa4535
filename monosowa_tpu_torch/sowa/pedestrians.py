"""Pedestrian extraction (the reference's ``extract_pedestrians`` branch).

Counterpart of the JAX package's ``sowa/pedestrians.py`` (numpy, on the
host, as there).

The reference declares this capability but leaves it unfinished: the flag
only prepares a ``pedestrians/`` cache dir (output.py:141-143) and
``writetxt_cars`` accepts a ``pedestrians`` list it formats as
``Pedestrian`` rows (output.py:55-91), yet nothing upstream ever produces
one (the detectron filter keeps classes 2/7 only, loader.py:1764) and no
caller passes the argument.  The rebuild completes the evidently intended
path: person-class masks cached under ``pedestrians/`` (or produced live by
the mask backend), reference-frame point gathering with pedestrian-scale
filters, extent-based box estimation, and ``Pedestrian`` label rows through
the standard writer.

No template fitting: pedestrians have no CAD template library and the
reference's grid search is car-specific — dims come from the gathered
point extents clamped to human priors (the dimension-estimator fallback
style, dimension_estimator.py:13-120), orientation is emitted as ry = 0
(pedestrian yaw is unobservable from a near-isotropic point blob and KITTI
pedestrian eval uses axis-aligned-ish boxes at IoU 0.5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from monosowa_tpu_torch.sowa import candidates as cand_mod


@dataclasses.dataclass(frozen=True)
class PedestrianConfig:
    min_points: int = 20          # discard blobs with fewer gathered points
    filter_diameter: float = 1.2  # radius filter around the median [m]
    max_distance: float = 75.0    # pseudo-lidar trust range (config.yaml:48)
    default_hwl: tuple = (1.73, 0.6, 0.8)   # KITTI pedestrian mean shape
    min_h: float = 1.0
    max_h: float = 2.1
    max_wl: float = 1.2


def _extent(vals: np.ndarray, lo_q: float = 5.0, hi_q: float = 95.0) -> float:
    """Robust extent: inner-percentile span (the dimension estimator's
    10/90-percentile edge style, dimension_estimator.py:29-47)."""
    lo, hi = np.percentile(vals, [lo_q, hi_q])
    return float(hi - lo)


def extract_pedestrian_labels(points_cam: np.ndarray, p2: np.ndarray,
                              img_hw, ped_masks: Sequence[np.ndarray],
                              cfg: PedestrianConfig = PedestrianConfig()
                              ) -> List[dict]:
    """Reference-frame points + person masks -> Pedestrian label dicts for
    :func:`monosowa_tpu_torch.kittiio.labels.write_pseudo_label_file`.

    Per mask (the get_car_locations_from_img gather recipe at pedestrian
    scale, loader.py:2802-2922): project points, gather in-mask hits,
    median center, radius filter, distance gate; box dims from robust
    point extents clamped to human priors; bottom of the box at the lowest
    gathered point (y grows downward in the camera frame).
    """
    if not ped_masks:
        return []
    proj, _ = cand_mod.project_points(points_cam, p2, img_hw)
    if len(proj) == 0:
        return []
    u = proj[:, 3].astype(int)
    v = proj[:, 4].astype(int)
    out: List[dict] = []
    for mask in ped_masks:
        mask = np.asarray(mask, bool)
        hit = mask[v, u]
        pts = proj[hit, :3]
        if len(pts) < cfg.min_points:
            continue
        center = np.median(pts, axis=0)
        # horizontal (XZ) gate only — a standing person's vertical extent
        # exceeds any sensible horizontal radius
        d = np.linalg.norm((pts - center)[:, [0, 2]], axis=1)
        pts = pts[d < cfg.filter_diameter / 2.0 + 1e-6]
        if len(pts) < cfg.min_points:
            continue
        center = np.median(pts, axis=0)
        if float(np.linalg.norm(center)) > cfg.max_distance:
            continue
        h = np.clip(_extent(pts[:, 1], 2.0, 98.0), cfg.min_h, cfg.max_h)
        w = np.clip(_extent(pts[:, 0]), 0.25, cfg.max_wl)
        length = np.clip(_extent(pts[:, 2]), 0.25, cfg.max_wl)
        bottom = float(np.percentile(pts[:, 1], 98.0))
        out.append({
            "cls": "Pedestrian",
            "box2d": _mask_bbox(mask),
            "h": float(h), "w": float(w), "l": float(length),
            "x": float(center[0]),
            # writer emits bottom y = y + h/2 (output.py:39)
            "y": bottom - float(h) / 2.0,
            "z": float(center[2]),
            # ry = 0 after the writer's -pi/2 shift (output.py:44-49)
            "theta": float(np.pi / 2.0),
            "num_points": int(len(pts)),
            "moving": False,
            "points": pts.astype(np.float32),
            "mask": mask,
        })
    return out


def _mask_bbox(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return None
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)
