"""Range-image -> point-cloud math, numpy port of the public
waymo_open_dataset.utils.{frame_utils,range_image_utils,transform_utils}
entry points the MonoSOWA converter calls
(pseudo_label_generator/waymo_to_kitti_projected.py:139-143):

  parse_range_image_and_camera_projection(frame)
  convert_range_image_to_point_cloud(frame, ri, cp, top_pose)

Semantics ported (not copied — this is a host-side decode that runs once
per frame; numpy is the right tool, the TPU never sees range images):

- range images / camera projections / the TOP per-pixel pose tensor are
  zlib-compressed serialized MatrixFloat / MatrixInt32 protos;
- beams: row r's inclination comes from ``beam_inclinations`` when the
  calibration carries them, else uniform in [min, max] at row centers;
  row 0 is the TOP beam, so the computed min->max ramp is reversed;
- columns sweep azimuth right-to-left: ``((W-i-0.5)/W * 2 - 1) * pi``
  minus the extrinsic yaw correction ``atan2(R[1,0], R[0,0])``;
- spherical -> sensor cartesian -> vehicle frame via the laser extrinsic;
  the TOP lidar additionally goes vehicle -> global through its per-pixel
  pose and back through ``inv(frame.pose)`` (rolling-shutter correction);
- points with range <= 0 are dropped; returns are per-laser lists sorted
  by laser name, matching the reference converter's ``np.concatenate``.

A copy of the JAX package's ``waymo/frame_utils.py``; the schema module is
imported where a frame is parsed, so the math imports without protobuf.
"""

from __future__ import annotations

import zlib

import numpy as np

TOP_LIDAR = 1  # LaserName.TOP


def _decompress_matrix(buf: bytes, proto_cls) -> np.ndarray:
    m = proto_cls()
    m.ParseFromString(zlib.decompress(buf))
    return np.array(m.data).reshape(tuple(m.shape.dims))


def parse_range_image_and_camera_projection(frame):
    """-> (range_images, camera_projections, seg_labels, top_pose).

    range_images / camera_projections: {laser_name: [return1, return2]}
    as [H, W, C] numpy arrays; top_pose: [H, W, 6] float array or None.
    """
    from monosowa_tpu_torch.waymo import dataset_pb2

    range_images, camera_projections, seg_labels = {}, {}, {}
    top_pose = None
    for laser in frame.lasers:
        for index, ri in enumerate((laser.ri_return1, laser.ri_return2)):
            if len(ri.range_image_compressed):
                range_images.setdefault(laser.name, []).append(
                    _decompress_matrix(ri.range_image_compressed,
                                       dataset_pb2.MatrixFloat))
                if (laser.name == TOP_LIDAR and index == 0
                        and len(ri.range_image_pose_compressed)):
                    top_pose = _decompress_matrix(
                        ri.range_image_pose_compressed,
                        dataset_pb2.MatrixFloat)
            if len(ri.camera_projection_compressed):
                camera_projections.setdefault(laser.name, []).append(
                    _decompress_matrix(ri.camera_projection_compressed,
                                       dataset_pb2.MatrixInt32))
    return range_images, camera_projections, seg_labels, top_pose


def compute_inclination(inclination_range, height: int) -> np.ndarray:
    """Uniform beam inclinations at row centers, min -> max."""
    lo, hi = inclination_range
    return (0.5 + np.arange(height)) / height * (hi - lo) + lo


def rotation_from_rpy(roll, pitch, yaw) -> np.ndarray:
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), broadcastable -> [..., 3, 3]."""
    roll, pitch, yaw = np.broadcast_arrays(roll, pitch, yaw)
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    one, zero = np.ones_like(cr), np.zeros_like(cr)
    rx = np.stack([one, zero, zero,
                   zero, cr, -sr,
                   zero, sr, cr], -1).reshape(roll.shape + (3, 3))
    ry = np.stack([cp, zero, sp,
                   zero, one, zero,
                   -sp, zero, cp], -1).reshape(roll.shape + (3, 3))
    rz = np.stack([cy, -sy, zero,
                   sy, cy, zero,
                   zero, zero, one], -1).reshape(roll.shape + (3, 3))
    return rz @ ry @ rx


def _range_image_to_vehicle_points(range_image, extrinsic, inclinations,
                                   pixel_pose=None, frame_pose=None):
    """[H, W] ranges -> [H, W, 3] vehicle-frame cartesian points."""
    h, w = range_image.shape
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(w, 0, -1) - 0.5) / w
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction      # [W]

    cos_az, sin_az = np.cos(azimuth)[None, :], np.sin(azimuth)[None, :]
    cos_incl = np.cos(inclinations)[:, None]
    sin_incl = np.sin(inclinations)[:, None]
    x = cos_az * cos_incl * range_image
    y = sin_az * cos_incl * range_image
    z = sin_incl * range_image
    pts = np.stack([x, y, z], -1)                               # [H, W, 3]

    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]
    if pixel_pose is not None:
        rot = rotation_from_rpy(pixel_pose[..., 0], pixel_pose[..., 1],
                                pixel_pose[..., 2])             # [H, W, 3, 3]
        pts = np.einsum("hwij,hwj->hwi", rot, pts) + pixel_pose[..., 3:6]
        inv = np.linalg.inv(frame_pose)
        pts = pts @ inv[:3, :3].T + inv[:3, 3]
    return pts


def convert_range_image_to_point_cloud(frame, range_images,
                                       camera_projections, top_pose,
                                       ri_index: int = 0):
    """-> (points, cp_points): per-laser lists sorted by laser name of
    [N, 3] vehicle-frame points and [N, 6] camera-projection rows."""
    calibrations = sorted(frame.context.laser_calibrations,
                          key=lambda c: c.name)
    frame_pose = np.array(frame.pose.transform).reshape(4, 4)
    points, cp_points = [], []
    for c in calibrations:
        ri = range_images[c.name][ri_index]
        if len(c.beam_inclinations):
            inclinations = np.array(c.beam_inclinations)
        else:
            inclinations = compute_inclination(
                (c.beam_inclination_min, c.beam_inclination_max),
                ri.shape[0])
        inclinations = inclinations[::-1]          # row 0 = top beam
        extrinsic = np.array(c.extrinsic.transform).reshape(4, 4)
        pixel_pose = (top_pose if c.name == TOP_LIDAR and ri_index == 0
                      and top_pose is not None else None)
        pts = _range_image_to_vehicle_points(
            ri[..., 0], extrinsic, inclinations, pixel_pose,
            frame_pose if pixel_pose is not None else None)
        mask = ri[..., 0] > 0
        points.append(pts[mask])
        cp = camera_projections[c.name][ri_index]
        cp_points.append(cp[mask])
    return points, cp_points


def compress_matrix(arr: np.ndarray, proto_cls) -> bytes:
    """Inverse of _decompress_matrix (test/fixture helper)."""
    m = proto_cls()
    m.data.extend(np.asarray(arr).reshape(-1).tolist())
    m.shape.dims.extend(arr.shape)
    return zlib.compress(m.SerializeToString())
