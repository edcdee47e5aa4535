"""Car template point clouds for Template-Fitting-Loss optimization.

The reference samples 1000 surface points from four CAD meshes
(fiat/hatchback, passat/sedan, suv, mpv — loader.py:3465-3840), centered at
the oriented-bbox center and anisotropically scaled so extents equal the
configured template dims (h 1.526, w 1.63, l 3.88 — configs/config.yaml).

We generate the same *capability* procedurally: four parametric car-shaped
surface point clouds (body box + cabin wedge with model-specific proportions),
deterministically sampled and normalized to exact extents.  Axis convention
matches the reference's KITTI path (loader.py:3513-3530): x = width,
y = height (camera down-axis), z = length; yaw rotates about y
(optimizer.py:468-472); KITTI label ry = theta - pi/2.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

TEMPLATE_H = 1.526
TEMPLATE_W = 1.63
TEMPLATE_L = 3.88
NUM_TEMPLATE_POINTS = 1000

# Model-specific cabin proportions: (cabin_height_frac, cabin_len_frac,
# cabin_rear_frac, hood_height_frac).  Index order matches the reference's
# template_index (0 fiat/hatchback, 1 passat/sedan, 2 suv, 3 mpv).
_PROFILES = {
    0: (0.42, 0.50, 0.80, 0.58),   # hatchback: short, cabin reaches tail
    1: (0.38, 0.42, 0.68, 0.55),   # sedan: long hood + trunk
    2: (0.45, 0.55, 0.85, 0.65),   # suv: tall box
    3: (0.48, 0.62, 0.90, 0.60),   # mpv: one-box
}
TEMPLATE_NAMES = ("hatchback", "sedan", "suv", "mpv")


def _car_profile_height(z: np.ndarray, profile: Tuple[float, float, float, float]
                        ) -> np.ndarray:
    """Roof height (0..1, fraction of total height) along normalized length
    z in [-0.5, 0.5] (z = forward)."""
    cab_h, cab_len, cab_rear, hood_h = profile
    # cabin occupies [front_start, rear_end] in normalized z
    rear_end = -0.5 + (1.0 - cab_rear)  # distance from rear
    rear_end = cab_rear - 0.5           # cabin rear edge
    front_start = rear_end - cab_len
    h = np.full_like(z, hood_h)
    in_cab = (z >= front_start) & (z <= rear_end)
    h = np.where(in_cab, 1.0, h)
    # slope the windshield / rear window over 15% of length
    slope = 0.15
    ws = (z > rear_end) & (z <= rear_end + slope)
    h = np.where(ws, 1.0 - (z - rear_end) / slope * (1.0 - hood_h), h)
    rw = (z < front_start) & (z >= front_start - slope)
    h = np.where(rw, 1.0 - (front_start - z) / slope * (1.0 - hood_h), h)
    return h


def make_template(index: int, num_points: int = NUM_TEMPLATE_POINTS,
                  h: float = TEMPLATE_H, w: float = TEMPLATE_W,
                  l: float = TEMPLATE_L, seed: int = 12345) -> np.ndarray:
    """Deterministic (num_points, 3) surface point cloud, extents exactly
    (w, h, l) on axes (x, y, z), centered at the bounding-box center."""
    profile = _PROFILES[index % 4]
    rng = np.random.default_rng(seed + index)

    n_side = int(num_points * 0.40)
    n_top = int(num_points * 0.25)
    n_ends = int(num_points * 0.20)
    n_wheel = num_points - n_side - n_top - n_ends

    pts = []
    # side panels (x = +-0.5 in normalized width)
    z = rng.uniform(-0.5, 0.5, n_side)
    prof = _car_profile_height(z, profile)
    y = rng.uniform(0.0, prof)
    x = np.where(rng.uniform(size=n_side) < 0.5, -0.5, 0.5)
    # taper the sides slightly near the roof (tumblehome)
    x = x * (1.0 - 0.12 * np.clip(y - 0.6, 0, 1))
    pts.append(np.stack([x, y, z], 1))
    # roof / hood surface
    z = rng.uniform(-0.5, 0.5, n_top)
    prof = _car_profile_height(z, profile)
    x = rng.uniform(-0.5, 0.5, n_top) * (1.0 - 0.12 * np.clip(prof - 0.6, 0, 1))
    pts.append(np.stack([x, prof, z], 1))
    # front / rear ends
    z = np.where(rng.uniform(size=n_ends) < 0.5, -0.5, 0.5)
    prof = _car_profile_height(z, profile)
    y = rng.uniform(0.0, prof)
    x = rng.uniform(-0.5, 0.5, n_ends)
    pts.append(np.stack([x, y, z], 1))
    # lower body / wheel region points to anchor the floor
    z = rng.uniform(-0.5, 0.5, n_wheel)
    y = rng.uniform(0.0, 0.15, n_wheel)
    x = np.where(rng.uniform(size=n_wheel) < 0.5, -0.48, 0.48)
    pts.append(np.stack([x, y, z], 1))

    p = np.concatenate(pts, 0)[:num_points]

    # normalize extents exactly, then center at bbox center
    for axis in range(3):
        lo, hi = p[:, axis].min(), p[:, axis].max()
        p[:, axis] = (p[:, axis] - lo) / max(hi - lo, 1e-9) - 0.5
    p[:, 0] *= w
    p[:, 1] *= h
    p[:, 2] *= l

    # camera y points DOWN: flip so y spans [-h/2 (roof), +h/2 (ground)]
    p[:, 1] *= -1.0
    return p.astype(np.float32)


@dataclasses.dataclass
class TemplateBank:
    """All template point clouds stacked: (4, N, 3), plus dims."""

    points: np.ndarray          # (4, N, 3)
    dims_lwh: np.ndarray        # (3,) = (l, w, h) nominal
    offsets_y: np.ndarray       # (4,) per-template y offset (config: 0.0)

    @classmethod
    def default(cls, num_points: int = NUM_TEMPLATE_POINTS,
                h: float = TEMPLATE_H, w: float = TEMPLATE_W,
                l: float = TEMPLATE_L) -> "TemplateBank":
        pts = np.stack([make_template(i, num_points, h, w, l)
                        for i in range(4)])
        return cls(points=pts,
                   dims_lwh=np.array([l, w, h], np.float32),
                   offsets_y=np.zeros(4, np.float32))

    # CAD mesh files per template slot, reference data/ naming + the KITTI
    # zxy euler angles each loader applies (loader.py:3502-3840 else-branch)
    GLTF_SPECS = (
        ("fiat2.gltf", (np.pi, np.pi / 2, 0)),
        ("passat2.gltf", (np.pi, 0, np.pi)),
        ("suv.gltf", (np.pi, 0, 0)),
        ("minivan.gltf", (np.pi, 0, np.pi / 2)),
    )

    @classmethod
    def from_gltf(cls, data_dir: str,
                  num_points: int = NUM_TEMPLATE_POINTS,
                  h: float = TEMPLATE_H, w: float = TEMPLATE_W,
                  l: float = TEMPLATE_L, seed: int = 0) -> "TemplateBank":
        """Build the bank from the 4 car CAD meshes exactly like the
        reference (loader.py:3465-3840, KITTI path): load the glTF (node
        transforms honored), center, rotate by the per-model zxy euler
        angles, anisotropically scale axis0->width / axis1->height /
        axis2->length, sample ``num_points`` surface points area-uniformly.
        Deviation: centering uses the axis-aligned bbox center (the
        reference's minimal-OBB center is within a few cm for car meshes
        and the optimizer translates the template anyway)."""
        import os

        from monosowa_tpu_torch.sowa.mesh_io import (load_gltf, rotation_zxy,
                                               sample_mesh_surface)
        pts = []
        for i, (fname, angles) in enumerate(cls.GLTF_SPECS):
            v, f = load_gltf(os.path.join(data_dir, fname))
            v = v - (v.min(0) + v.max(0)) / 2.0
            v = v @ rotation_zxy(*angles).T
            ext = np.ptp(v, axis=0)
            v = v * (np.array([w, h, l]) / np.maximum(ext, 1e-9))
            p = sample_mesh_surface(v, f, num_points, seed=seed + i)
            pts.append(p.astype(np.float32))
        return cls(points=np.stack(pts),
                   dims_lwh=np.array([l, w, h], np.float32),
                   offsets_y=np.zeros(4, np.float32))
