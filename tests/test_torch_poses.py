"""The port's ego-motion poses (``kittiio/oxts.py``, the pose windows of
``sowa/transforms.py``) against the JAX package's, on the same seeded
numpy inputs.  All of it is numpy in both packages: the arrays must be
equal, dtypes included (float64, float32 for the waymo_converted
source)."""

import os

import numpy as np
import pytest

from monosowa_tpu.kittiio import oxts as joxts
from monosowa_tpu.sowa import transforms as jtransforms
from monosowa_tpu_torch.kittiio import oxts, oxts_to_poses, read_oxts_file
from monosowa_tpu_torch.sowa import transforms


def _random_pose(rng):
    from scipy.spatial.transform import Rotation
    t = np.eye(4)
    t[:3, :3] = Rotation.random(random_state=rng.integers(1 << 30)
                                ).as_matrix()
    t[:3, 3] = rng.uniform(-50, 50, 3)
    return t


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _oxts_packets(rng, n):
    """n packets of 30 values: lat/lon near Karlsruhe, altitude, roll,
    pitch, yaw, then velocities and the rest."""
    p = rng.normal(size=(n, 30))
    p[:, 0] = 49.0 + np.cumsum(rng.normal(scale=1e-5, size=n))
    p[:, 1] = 8.4 + np.cumsum(rng.normal(scale=1e-5, size=n))
    p[:, 2] = 110.0 + rng.normal(scale=0.1, size=n)
    p[:, 3:6] = rng.normal(scale=0.05, size=(n, 3))
    return p


def test_oxts_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    packets = _oxts_packets(rng, 12)
    path = tmp_path / "0000000003.txt"
    path.write_text(" ".join(repr(float(v)) for v in packets[3]) + "\n")
    _equal(read_oxts_file(str(path)), joxts.read_oxts_file(str(path)))
    for fn in ("rot_x", "rot_y", "rot_z"):
        _equal(getattr(oxts, fn)(packets[:, 3]),
               getattr(joxts, fn)(packets[:, 3]))
    poses = oxts_to_poses(packets)
    _equal(poses, joxts.oxts_to_poses(packets))
    _equal(oxts_to_poses(packets[0]), joxts.oxts_to_poses(packets[0]))
    imu_to_cam = _random_pose(rng)
    for ref in (0, 5, 11):
        _equal(oxts.relative_cam_transforms(poses, imu_to_cam, ref),
               joxts.relative_cam_transforms(poses, imu_to_cam, ref))
        _equal(oxts.poses_file_transforms(poses, ref),
               joxts.poses_file_transforms(poses, ref))


@pytest.mark.parametrize("ref,rng_w", [(0, 3), (6, 2), (11, 4)])
def test_kitti_and_pose_windows_match_jax(ref, rng_w):
    """Windows clamped at both ends of a 12-frame sequence; invalid frames
    of a pose table give zero matrices."""
    rng = np.random.default_rng(ref)
    packets = _oxts_packets(rng, 12)
    imu_to_cam = _random_pose(rng)
    assert transforms.window_indices(ref, 12, rng_w) == \
        jtransforms.window_indices(ref, 12, rng_w)
    _equal(transforms.kitti_window_transforms(packets, imu_to_cam, ref,
                                              rng_w),
           jtransforms.kitti_window_transforms(packets, imu_to_cam, ref,
                                               rng_w))
    poses = np.stack([_random_pose(rng) for _ in range(12)])
    valid = rng.random(12) > 0.3
    valid[ref] = True
    _equal(transforms.pose_window_transforms(poses, valid, ref, rng_w),
           jtransforms.pose_window_transforms(poses, valid, ref, rng_w))


def _write_cam0_to_world(path, poses, missing):
    with open(path, "w") as f:
        for i, p in enumerate(poses):
            if i not in missing:
                f.write(f"{i} " + " ".join(f"{v:.12f}" for v in p.ravel())
                        + "\n")


@pytest.mark.parametrize("number", [0, 4, 5, 9, 19, 25])
def test_k360_windows_match_jax(tmp_path, number):
    """cam0_to_world.txt with gaps (5, 6 and 17 missing: zero matrices),
    windows across a gap, at the ends, a zero reference pose (5) and
    numbers beyond the table (25)."""
    rng = np.random.default_rng(1)
    poses = np.stack([_random_pose(rng) for _ in range(20)])
    path = tmp_path / "cam0_to_world.txt"
    _write_cam0_to_world(path, poses, {5, 6, 17})
    got = transforms.read_cam0_to_world(str(path))
    want = jtransforms.read_cam0_to_world(str(path))
    _equal(got, want)
    assert not got[5].any() and got[4].any()
    win = transforms.k360_window_transforms(got, number, 4, 3)
    _equal(win, jtransforms.k360_window_transforms(want, number, 4, 3))
    assert win.shape == (8, 4, 4)
    if number in (5, 25):
        assert not win.any()          # zero reference / beyond the table


def _write_waymoc_calib(path, pose, v2c, rng):
    p2 = rng.normal(size=12)
    lines = [f"P{i}: " + " ".join(map(str, p2)) for i in range(4)]
    lines += ["R0_rect: 1 0 0 0 1 0 0 0 1",
              "Tr_velo_to_cam: " + " ".join(map(str, v2c[:3].ravel())),
              "Cur_pose: " + " ".join(map(str, pose.ravel()))]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("layout", ["flat", "sequence"])
def test_waymoc_windows_match_jax(tmp_path, layout):
    """waymo_converted calib files with ``Cur_pose`` rows: a flat
    object-layout directory (6-digit names) and a sequence directory
    (the converter's 10-digit names); frames 0-7 exist, so the windows
    run past the first and the last file (zero entries)."""
    rng = np.random.default_rng(2)
    v2c = _random_pose(rng)
    width = 6 if layout == "flat" else 10
    for i in range(8):
        _write_waymoc_calib(tmp_path / f"{i:0{width}d}.txt",
                            _random_pose(rng), v2c, rng)
    name_fn = (lambda i: f"{i:06d}") if layout == "flat" else None
    for number in (1, 6):
        got = transforms.waymoc_window_transforms(str(tmp_path), number, 3,
                                                  2, name_fn=name_fn)
        want = jtransforms.waymoc_window_transforms(str(tmp_path), number,
                                                    3, 2, name_fn=name_fn)
        _equal(got, want)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got[3], np.eye(4), atol=1e-5)
    assert not got[5].any()           # frame 8 has no calib file
    assert os.path.exists(tmp_path / f"{7:0{width}d}.txt")
