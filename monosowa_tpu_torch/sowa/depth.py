"""Pseudo-LiDAR from cached depth maps: monocular depth -> camera-frame
point clouds.

Behavioural contract (pseudo_label_generator/3d/scripts/metric3d.py): the
depth network predicts canonical depth at a 1000-focal camera; the decode
de-canonicalises with the intrinsic (``depth * fx / 1000``), clamps to
[0, 300] m, and back-projects the full pixel grid through the intrinsics;
per-frame outputs are cached as npz with skip-if-exists resumability
(:82-83, :97).

Deviation kept from the JAX package: ``pseudo_lidar_from_depth`` drops
z <= 0 points (they carry no geometry and downstream projection divides
by z).

Counterpart of the parts of the JAX package's ``sowa/depth.py`` that need
no network: ``CachedDepthBackend`` reads precomputed depth maps, so the
pipeline runs without a depth checkpoint.  Cached-depth protocol:
``predict_depth_for`` returns canonical depth at the ORIGINAL resolution,
so metric depth = value * fx / 1000.  The live depth networks
(``TorchHubMetric3DBackend``, ``FlaxDepthAnythingBackend``) and the
Metric3D encode/decode wait for the model zoo (``sowa/zoo.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops.geometry import backproject_depth

MAX_DEPTH = 300.0
CANONICAL_FOCAL = 1000.0


class CachedDepthBackend:
    """Reads precomputed depth maps (``<depth_dir>/<frame>.npz`` with key
    'depth'), the phase-1 operating mode."""

    def __init__(self, depth_dir: str, key: str = "depth"):
        self.depth_dir = depth_dir
        self.key = key

    def predict_depth_for(self, frame: str) -> Optional[np.ndarray]:
        path = os.path.join(self.depth_dir, f"{frame}.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return np.asarray(z[self.key], np.float32)


def lift_depth_to_points(depth: torch.Tensor, fu, fv, cu, cv,
                         fx_scale) -> torch.Tensor:
    """Canonical depth map (H, W) -> (H*W, 3) metric camera points.

    fx_scale = fx / 1000 de-canonicalises depth (metric3d.py:327-333);
    depth clamped to MAX_DEPTH.  Scalars as tensors on the depth's device
    (see ``backproject_depth``)."""
    metric = torch.clamp(depth * fx_scale, 0.0, MAX_DEPTH)
    return backproject_depth(metric, fu, fv, cu, cv)


def pseudo_lidar_from_depth(depth: np.ndarray, p2: np.ndarray,
                            canonical: bool = True,
                            device=None) -> np.ndarray:
    """Host convenience wrapper -> (N, 3) float32 points (z > 0), computed
    on ``device`` (None: the card)."""
    dev = resolve_device(device)
    fu, fv = p2[0, 0], p2[1, 1]
    cu, cv = p2[0, 2], p2[1, 2]
    scale = fu / CANONICAL_FOCAL if canonical else 1.0
    f32 = [torch.tensor(np.float32(v), device=dev)
           for v in (fu, fv, cu, cv, scale)]
    pts = lift_depth_to_points(
        torch.as_tensor(np.asarray(depth, np.float32), device=dev),
        *f32).cpu().numpy()
    return pts[pts[:, 2] > 0].astype(np.float32)


def generate_pseudo_lidar_cache(frames, images_or_depths, p2: np.ndarray,
                                out_dir: str, backend=None,
                                canonical: bool = True, device=None) -> int:
    """Write per-frame pseudo-lidar npz caches (skip-if-exists) from depth
    maps.  frames: frame name list; images_or_depths: matching (H, W)
    depth maps.  Returns the number of frames newly generated.  A live
    depth ``backend`` (RGB images in) needs the model zoo."""
    if backend is not None:
        raise NotImplementedError(
            "generate_pseudo_lidar_cache with a live depth backend: the "
            "depth networks of sowa/zoo.py (Metric3D, Depth Anything) are "
            "not ported; give depth maps with backend=None")
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for frame, arr in zip(frames, images_or_depths):
        out = os.path.join(out_dir, f"{frame}.npz")
        if os.path.exists(out):
            continue
        pts = pseudo_lidar_from_depth(np.asarray(arr, np.float32), p2,
                                      canonical, device)
        np.savez_compressed(out, points=pts)
        done += 1
    return done


def load_pseudo_lidar(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        key = "points" if "points" in z else list(z.keys())[0]
        pts = np.asarray(z[key], np.float32)
    return pts.reshape(-1, pts.shape[-1])[:, :3]
