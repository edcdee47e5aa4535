"""A synthetic driving sequence at KITTI-realistic sizes, in numpy.

The scene of the JAX package's ``tools/bench_pipeline.py`` ``make_sequence``:
375x1242 frames, a dense pseudo-LiDAR cloud back-projected from a rendered
depth image (about 460k points a frame: a ground plane and flat car-sized
rectangles at one depth each), about ``n_cars`` cars visible per frame, the
ego camera driving +z at 0.8 m a frame.  Optionally the cars are rendered
farther (``z_max``), cars are added (``extra_cars``), some are left out of
some frames (``hidden``) and a standing person is added (``person``).
``make_jobs`` turns it into the job dicts ``PseudoLabeler.label_frames``
takes: points, masks and frame ids (host candidates), the person's mask
where there is one, and with ``with_depth`` each frame's depth map too
(device extraction and bank mode).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

H, W = 375, 1242
N_CARS = 6
EGO_STEP = 0.8        # metres the ego camera advances per frame


def intrinsics(h: int = H, w: int = W) -> Tuple[float, np.ndarray]:
    """(fu, P2) of the scene's pinhole camera."""
    fu = 721.5 * w / 1242
    return fu, np.array([[fu, 0, w / 2, 0], [0, fu, h / 2, 0], [0, 0, 1, 0]])


def make_sequence(n_frames: int = 8, window: int = 6, seed: int = 0,
                  h: int = H, w: int = W, n_cars: int = N_CARS,
                  z_max: float = 70.0,
                  hidden: Optional[Dict[int, Sequence[int]]] = None,
                  person: Optional[dict] = None,
                  extra_cars: Sequence[dict] = ()):
    """``n_frames + 2 * window`` frames.  Returns (frames, cars): per frame
    a dict of ``points`` (h * w, 3) float32 in the frame's camera
    coordinates, ``depth`` (h, w) float32 (the rendered depth before the
    points' noise, as ``tools/bench_pipeline.py`` keeps it), ``masks`` (the
    visible cars' boolean (h, w) masks) and ``ego_z``; ``cars`` are the
    scene's cars (x, y, z, theta in the coordinates of frame 0).

    ``extra_cars`` (x, y, z, theta) join the random ones, after them.
    Cars are rendered between 4 m and ``z_max`` of the camera; ``hidden``
    maps a frame index to the indices of cars left out of that frame (no
    pixels, no mask).  ``person`` (x, z in frame 0's coordinates, width
    and height in metres) adds a flat standing figure on the ground,
    rendered like the cars, and its mask as the frame's
    ``person_mask``."""
    rng = np.random.default_rng(seed)
    fu, _ = intrinsics(h, w)

    total = n_frames + 2 * window
    # static cars at constant density along the whole driven corridor:
    # about n_cars visible per frame in the 4-70 m band whatever the
    # sequence length
    spacing = 66.0 / max(n_cars, 1)
    road_end = total * EGO_STEP + max(74.0, z_max + 4.0)
    cars = []
    for z0 in np.arange(8.0, road_end, spacing):
        cars.append(dict(
            x=rng.uniform(-8, 8), y=1.1,
            z=float(z0) + rng.uniform(-0.4 * spacing, 0.4 * spacing),
            theta=rng.uniform(0, 2 * np.pi)))
    cars += [dict(c) for c in extra_cars]
    frames = []
    ys, xs = np.mgrid[0:h, 0:w]
    for k in range(total):
        ego_z = k * EGO_STEP
        # depth image: ground plane + car boxes
        depth = np.full((h, w), 300.0, np.float32)
        # ground: y = 1.65 -> depth = fu * 1.65 / (v - cv) for v > cv
        v_rel = ys - h / 2
        ground_d = np.where(v_rel > 1, fu * 1.65 / np.maximum(v_rel, 1),
                            300.0)
        depth = np.minimum(depth, ground_d)
        masks = []
        gone = set((hidden or {}).get(k, ()))
        for ci, car in enumerate(cars):
            z = car["z"] - ego_z
            if z < 4 or z > z_max or ci in gone:
                continue
            u = fu * car["x"] / z + w / 2
            v = fu * car["y"] / z + h / 2
            wpx = fu * 4.0 / z
            hpx = fu * 1.6 / z
            x1, x2 = int(u - wpx / 2), int(u + wpx / 2)
            y1, y2 = int(v - hpx), int(v)
            if x2 < 0 or x1 >= w or y2 < 0 or y1 >= h:
                continue
            x1, x2 = max(x1, 0), min(x2, w)
            y1, y2 = max(y1, 0), min(y2, h)
            m = np.zeros((h, w), bool)
            m[y1:y2, x1:x2] = True
            depth[m] = np.minimum(depth[m], z)
            masks.append(m)
        person_mask = None
        if person is not None:
            z = person["z"] - ego_z
            u = fu * person["x"] / z + w / 2
            wpx = fu * person.get("width", 0.6) / z
            top = fu * (1.65 - person.get("height", 1.7)) / z + h / 2
            bottom = fu * 1.65 / z + h / 2
            person_mask = np.zeros((h, w), bool)
            if z >= 1.0:
                person_mask[max(int(top), 0):max(int(bottom), 0),
                            max(int(u - wpx / 2), 0):max(int(u + wpx / 2),
                                                         0)] = True
            depth[person_mask] = np.minimum(depth[person_mask], z)
        pts = np.stack([(xs - w / 2) * depth / fu,
                        (ys - h / 2) * depth / fu,
                        depth], -1).reshape(-1, 3).astype(np.float32)
        pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
        frames.append(dict(points=pts, depth=depth.astype(np.float32),
                           masks=masks, ego_z=ego_z))
        if person is not None:
            frames[-1]["person_mask"] = person_mask
    return frames, cars


def make_jobs(frames: List[dict], window: int, out_dir: str,
              tag: str = "seq", lo: int = 0, hi: int = None,
              h: int = H, w: int = W, with_depth: bool = False
              ) -> List[dict]:
    """One ``label_frames`` job per reference frame ``window + lo`` ..
    ``window + hi`` of ``frames``: the +-``window`` offsets, ego-motion
    transforms into the reference frame, accessors for points and masks,
    and global frame ids so overlapping windows share the extraction; the
    reference frame's person mask, where the scene has one, as
    ``ped_masks``.  ``with_depth`` adds ``get_depth``, which sends the jobs
    through the device extraction (bank mode under the default config)."""
    _, p2 = intrinsics(h, w)
    offsets = list(range(-window, window + 1))
    if hi is None:
        hi = len(frames) - 2 * window
    jobs = []
    for fi in range(window + lo, window + hi):
        ref_z = frames[fi]["ego_z"]
        transforms = []
        for k in offsets:
            t = np.eye(4)
            t[2, 3] = frames[fi + k]["ego_z"] - ref_z
            transforms.append(t)
        jobs.append(dict(
            out_path=os.path.join(out_dir, f"{tag}_{fi:06d}.txt"),
            frame_index=fi,
            window_frames=offsets,
            frame_ids=[(tag, fi - window + k) for k in range(len(offsets))],
            get_points=(lambda k, fi=fi: frames[fi - window + k]["points"]),
            get_masks=(lambda k, fi=fi: frames[fi - window + k]["masks"]),
            transforms=np.stack(transforms), p2=p2, img_hw=(h, w)))
        if frames[fi].get("person_mask") is not None:
            jobs[-1]["ped_masks"] = [frames[fi]["person_mask"]]
        if with_depth:
            jobs[-1]["get_depth"] = (
                lambda k, fi=fi: frames[fi - window + k]["depth"])
    return jobs
