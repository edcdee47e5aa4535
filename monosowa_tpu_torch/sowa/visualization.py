"""Visualization: BEV scenes, projected 3D boxes, label-dir comparisons.

Behavioral contract (pseudo_label_generator/3d/scripts/visualization.py):
scenes of aggregated points + fitted boxes + templates + GT labels with
per-source colors (visu_output_labels red / gt green / labels1 blue /
labels2 yellow — config visualization.*), plus box IoU helpers.

The reference renders interactive open3d windows; this module, a copy of
the JAX package's ``sowa/visualization.py``, saves matplotlib renderings to
files (same information, file-based).  matplotlib and cv2 are imported
inside the functions that draw.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from monosowa_tpu_torch.kittiio import Calibration, read_label_file

SOURCE_COLORS = {"pred": "red", "gt": "green", "labels1": "blue",
                 "labels2": "gold"}


def _box_bev_corners(x, z, l, w, ry):
    dx = np.array([l, l, -l, -l]) / 2.0
    dz = np.array([w, -w, -w, w]) / 2.0
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * dx + s * dz + x, -s * dx + c * dz + z], 1)


def plot_bev(points: Optional[np.ndarray] = None,
             label_sets: Optional[Dict[str, Sequence]] = None,
             out_path: str = "bev.png", xlim=(-30, 30), zlim=(0, 70),
             title: str = "") -> str:
    """BEV scene: (N, 3) camera-frame points + {source: LabelSet/objects}."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 9))
    if points is not None and len(points):
        ax.scatter(points[:, 0], points[:, 2], s=0.3, c="gray", alpha=0.5)
    for source, objs in (label_sets or {}).items():
        color = SOURCE_COLORS.get(source, "purple")
        for o in objs:
            if o.cls_type in ("DontCare",):
                continue
            corners = _box_bev_corners(o.pos[0], o.pos[2], o.l, o.w, o.ry)
            loop = np.vstack([corners, corners[:1]])
            ax.plot(loop[:, 0], loop[:, 1], c=color, lw=1.2, label=source)
    if label_sets:
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        ax.legend(uniq.values(), uniq.keys(), loc="upper right")
    ax.set_xlim(*xlim)
    ax.set_ylim(*zlim)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.set_title(title)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path


def draw_boxes_on_image(image: np.ndarray, objects: Sequence,
                        calib: Calibration,
                        color=(255, 0, 0)) -> np.ndarray:
    """Project each object's 3D corners into the image and draw wireframes."""
    import cv2

    out = np.ascontiguousarray(image.copy())
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for o in objects:
        if o.cls_type == "DontCare" or o.pos[2] <= 0.5:
            continue
        corners = o.corners3d()
        uv, depth = calib.rect_to_img(corners)
        if np.any(depth <= 0.1):
            continue
        pts = uv.astype(int)
        for a, b in edges:
            cv2.line(out, tuple(pts[a]), tuple(pts[b]), color, 1)
    return out


def compare_label_dirs(frame_id: str, out_path: str,
                       points: Optional[np.ndarray] = None,
                       pred_dir: Optional[str] = None,
                       gt_dir: Optional[str] = None,
                       labels1_dir: Optional[str] = None,
                       labels2_dir: Optional[str] = None) -> str:
    """The reference's multi-source label overlay (visu_labels_gt /
    visu_labels1 / visu_labels2) as one BEV figure."""
    import os

    sets = {}
    for name, d in (("pred", pred_dir), ("gt", gt_dir),
                    ("labels1", labels1_dir), ("labels2", labels2_dir)):
        if d is None:
            continue
        path = os.path.join(d, f"{frame_id}.txt")
        if os.path.exists(path):
            sets[name] = list(read_label_file(path))
    return plot_bev(points, sets, out_path, title=f"frame {frame_id}")
