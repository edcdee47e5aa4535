#!/usr/bin/env python
"""Waymo TFRecord -> KITTI-projected per-sequence layout.

CLI contract (pseudo_label_generator/waymo_to_kitti_projected.py):
``--seq_start/--seq_end`` sharding over sorted TFRecord files; per sequence
emits front-cam PNGs, fused 6-column lidar npz (xyz + camera projection),
calib txt with P0..P3/R0_rect/Tr_velo_to_cam/Tr_imu_to_velo plus the
appended ``Cur_pose`` row (:194-202), and Car labels from the
projected_lidar_labels <-> laser_labels id-join with the vehicle-to-camera
axis permutation R=[[0,-1,0],[0,0,-1],[1,0,0]] and ``heading ->
-heading - pi/2`` (:235); validation additionally writes the
``label_l{1,2}_{030,3050,50xx}`` distance/level-stratified label dirs
(:276-447; L2 = fewer than 5 lidar points).

The conversion math lives in pure functions (testable offline); TFRecord
framing, the Waymo wire schema and the range-image -> point-cloud decode
are native (monosowa_tpu_torch/waymo/) — no tensorflow or
waymo_open_dataset.  The torch port's copy of the JAX package's
``tools/waymo_to_kitti_projected.py``: the same files from the same
segments.  It runs on the host (protobuf, PIL and OpenCV, imported by
``convert_split``):

    python tools/waymo_to_kitti_projected_torch.py \
        --dataset_folder <dir with training/ and validation/ TFRecords> \
        --output_dir <out> [--seq_start N --seq_end M]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# vehicle-frame -> camera-frame axis permutation (reference :169-174)
AXIS_PERM = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def waymo_heading_to_kitti(heading: float) -> float:
    return -heading - np.pi / 2.0


def vehicle_center_to_kitti_cam(center_xyz, extrinsic_4x4) -> np.ndarray:
    """Waymo vehicle-frame box center -> KITTI camera coords (:243-255)."""
    c = np.array([center_xyz[0], center_xyz[1], center_xyz[2], 1.0])
    c = np.linalg.inv(np.asarray(extrinsic_4x4).reshape(4, 4)) @ c
    return AXIS_PERM @ c[:3]


def waymo_calib_text(intrinsic, extrinsic_4x4, pose_4x4) -> str:
    """Calib file contents with the appended Cur_pose row (:183-202)."""
    k = np.eye(4)
    k[0, 0], k[1, 1] = intrinsic[0], intrinsic[1]
    k[0, 2], k[1, 2] = intrinsic[2], intrinsic[3]
    p2 = [str(c) for c in k[:3, :4].flatten().tolist()]
    r0 = [str(c) for c in np.eye(3).flatten().tolist()]
    tr = np.zeros((4, 4))
    tr[0, 1] = -1.0
    tr[1, 2] = -1.0
    tr[2, 0] = 1.0
    tr = tr @ np.linalg.inv(np.asarray(extrinsic_4x4).reshape(4, 4))
    tr_v2c = [str(c) for c in tr[:3, :4].flatten().tolist()]
    tr_i2v = [str(c) for c in np.eye(4)[:3, :4].flatten().tolist()]
    pose = [str(c) for c in np.asarray(pose_4x4).reshape(-1).tolist()]
    lines = [
        "P0: " + " ".join(p2), "P1: " + " ".join(p2),
        "P2: " + " ".join(p2), "P3: " + " ".join(p2),
        "R0_rect: " + " ".join(r0),
        "Tr_velo_to_cam: " + " ".join(tr_v2c),
        "Tr_imu_to_velo: " + " ".join(tr_i2v),
        "Cur_pose: " + " ".join(pose),
    ]
    return "\n".join(lines) + "\n"


def label_line(left_u, left_v, right_u, right_v, width, height, length,
               x, y, z, heading) -> str:
    """One label row in the converter's byte format (:88-104): Car stub
    fields, w h l order, y shifted to the box bottom, no score."""
    return ("Car -1 -1 -10 "
            f"{float(left_u):.2f} {float(left_v):.2f} "
            f"{float(right_u):.2f} {float(right_v):.2f} "
            f"{float(width):.2f} {float(height):.2f} {float(length):.2f} "
            f"{float(x):.2f} {float(y + height / 2.0):.2f} {float(z):.2f} "
            f"{float(heading):.2f}\n")


def level_of(num_lidar_points: int) -> int:
    """Waymo difficulty proxy (:378-382): L2 when < 5 points."""
    return 2 if num_lidar_points < 5 else 1


def distance_bands(dist: float):
    """Validation stratification suffixes the label belongs to (:413-447)."""
    if dist < 30.0:
        return "030"
    if dist < 50.0:
        return "3050"
    return "50xx"


def convert_split(split_dir: str, out_dir: str, seq_start: int, seq_end: int,
                  validation: bool) -> int:
    # Native ingestion: monosowa_tpu_torch.waymo ships the wire schema
    # (protoc-compiled), the numpy range-image -> point-cloud port, and a
    # pure-python TFRecord reader — no tensorflow / waymo_open_dataset.
    import io

    import cv2
    from PIL import Image

    from monosowa_tpu_torch.waymo import dataset_pb2 as open_dataset
    from monosowa_tpu_torch.waymo import frame_utils
    from monosowa_tpu_torch.waymo.tfrecord import read_tfrecord

    files = sorted(os.listdir(split_dir))
    if seq_start >= 0 or seq_end >= 0:
        files = files[seq_start:seq_end]
    n = 0
    for file_name in files:
        seq_out = os.path.join(out_dir, file_name)
        subdirs = ["label_2", "image_2", "velodyne", "calib"]
        if validation:
            subdirs += ["label_l1", "label_l1_030", "label_l1_3050",
                        "label_l1_50xx", "label_l2_030", "label_l2_3050",
                        "label_l2_50xx"]
        for s in subdirs:
            os.makedirs(os.path.join(seq_out, s), exist_ok=True)

        records = read_tfrecord(os.path.join(split_dir, file_name))
        for i, data in enumerate(records):
            frame = open_dataset.Frame()
            frame.ParseFromString(data)
            stem = str(i).zfill(10)

            img = np.asarray(Image.open(io.BytesIO(frame.images[0].image))
                             .convert("RGB"))
            cv2.imwrite(os.path.join(seq_out, "image_2", stem + ".png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))

            ri, cp, _, top_pose = \
                frame_utils.parse_range_image_and_camera_projection(frame)
            pts, cps = frame_utils.convert_range_image_to_point_cloud(
                frame, ri, cp, top_pose)
            fused = np.concatenate(
                [np.concatenate(pts, 0),
                 np.concatenate(cps, 0)[..., 0:3]], -1)
            np.savez_compressed(
                os.path.join(seq_out, "velodyne", stem + ".npz"),
                np.float32(fused))

            calib = list(frame.context.camera_calibrations)[0]
            extrinsic = np.array(list(calib.extrinsic.transform))
            pose = np.array(frame.pose.transform).reshape(4, 4)
            with open(os.path.join(seq_out, "calib", stem + ".txt"),
                      "w") as f:
                f.write(waymo_calib_text(list(calib.intrinsic), extrinsic,
                                         pose))

            labels3d = {l.id: l for l in frame.laser_labels
                        if l.type == 1 and l.num_lidar_points_in_box > 0}
            rows = []
            for image_labels in frame.projected_lidar_labels[:1]:
                for il in image_labels.labels:
                    if il.type != 1:
                        continue
                    l3 = labels3d.get(il.id[:-6])
                    if l3 is None:
                        continue
                    c = vehicle_center_to_kitti_cam(
                        (l3.box.center_x, l3.box.center_y, l3.box.center_z),
                        extrinsic)
                    rows.append(dict(
                        left_u=il.box.center_x - il.box.length / 2,
                        left_v=il.box.center_y - il.box.width / 2,
                        right_u=il.box.center_x + il.box.length / 2,
                        right_v=il.box.center_y + il.box.width / 2,
                        width=l3.box.width, height=l3.box.height,
                        length=l3.box.length, x=c[0], y=c[1], z=c[2],
                        heading=waymo_heading_to_kitti(l3.box.heading),
                        level=level_of(l3.num_lidar_points_in_box),
                        dist=float(np.linalg.norm(c))))

            def write_rows(path, pred):
                with open(path, "w") as f:
                    for r in rows:
                        if pred(r):
                            f.write(label_line(
                                r["left_u"], r["left_v"], r["right_u"],
                                r["right_v"], r["width"], r["height"],
                                r["length"], r["x"], r["y"], r["z"],
                                r["heading"]))

            write_rows(os.path.join(seq_out, "label_2", stem + ".txt"),
                       lambda r: True)
            if validation:
                write_rows(os.path.join(seq_out, "label_l1", stem + ".txt"),
                           lambda r: r["level"] == 1)
                for band in ("030", "3050", "50xx"):
                    write_rows(
                        os.path.join(seq_out, f"label_l1_{band}",
                                     stem + ".txt"),
                        lambda r, b=band: r["level"] == 1
                        and distance_bands(r["dist"]) == b)
                    write_rows(
                        os.path.join(seq_out, f"label_l2_{band}",
                                     stem + ".txt"),
                        lambda r, b=band: distance_bands(r["dist"]) == b)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser("waymo -> kitti projected converter")
    p.add_argument("--dataset_folder", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--seq_start", type=int, default=-1)
    p.add_argument("--seq_end", type=int, default=-1)
    a = p.parse_args(argv)
    for split, val in (("training", False), ("validation", True)):
        d = os.path.join(a.dataset_folder, split)
        if os.path.isdir(d):
            convert_split(d, os.path.join(a.output_dir, split),
                          a.seq_start, a.seq_end, val)


if __name__ == "__main__":
    main(sys.argv[1:])
