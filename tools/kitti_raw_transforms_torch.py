#!/usr/bin/env python
"""Generate windowed ego-motion transform caches for a KITTI raw sequence,
with the port alone.

The counterpart of ``tools/kitti_raw_transforms.py`` over the port's
``kittiio/oxts.py``, ``kittiio/raw_calib.py`` and ``sowa/transforms.py``:
the `--action transformations` equivalent for raw-sequence data
(reference loader.py:901-940).  Per frame, cache the (2*range+1, 4, 4)
``T_cur_to_ref`` array built from the OXTS IMU chain conjugated into
rectified cam-2, under <out_dir>/<frame>.npy with skip-if-exists (the same
files as the JAX tool's).

Usage:
  kitti_raw_transforms_torch.py <date_dir> <drive_dir_name> <out_dir>
      [--range 130]
  (date_dir holds calib_*.txt; drive dir holds oxts/data/*.txt)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from monosowa_tpu_torch.kittiio.oxts import (  # noqa: E402
    oxts_to_poses, read_oxts_file, relative_cam_transforms)
from monosowa_tpu_torch.kittiio.raw_calib import load_raw_calib  # noqa: E402
from monosowa_tpu_torch.sowa import transforms as T  # noqa: E402


def main(date_dir: str, drive: str, out_dir: str, rng: int = 130) -> int:
    calib = load_raw_calib(date_dir)
    imu_to_cam = calib["T_cam2rect_imu"]
    oxts_dir = os.path.join(date_dir, drive, "oxts", "data")
    frames = sorted(os.path.splitext(f)[0] for f in os.listdir(oxts_dir)
                    if f.endswith(".txt"))
    packets = np.stack([read_oxts_file(os.path.join(oxts_dir, f + ".txt"))
                        for f in frames])
    poses = oxts_to_poses(packets)

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for ref, frame in enumerate(frames):
        out = T.transforms_cache_path(out_dir, frame)
        if os.path.exists(out):
            continue
        rel = relative_cam_transforms(poses, imu_to_cam, ref)
        np.save(out, T._window_pack(rel, ref, rng))
        n += 1
    print(f"wrote {n} transform caches to {out_dir}")
    return n


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("date_dir")
    p.add_argument("drive")
    p.add_argument("out_dir")
    p.add_argument("--range", type=int, default=130, dest="rng")
    a = p.parse_args()
    main(a.date_dir, a.drive, a.out_dir, a.rng)
