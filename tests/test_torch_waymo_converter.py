"""The port's Waymo converter (``monosowa_tpu_torch/waymo/``,
``tools/waymo_to_kitti_projected_torch.py``) against the JAX package's.

Both converters read the same synthetic segments (frames built as
tests/test_waymo_ingest.py builds them, written with the TFRecord writer):
every PNG, calib and ``label_*`` file must be equal byte for byte, and each
fused-LiDAR ``.npz`` equal by its arrays (``np.savez_compressed`` stamps the
write time into each zip entry).  The port's schema is the JAX package's
under its own file name and proto package: both load in one process and
serialise a frame to the same bytes.  The port's pure functions pass the
cases of tests/test_converters.py and tests/test_waymo_ingest.py.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import waymo_to_kitti_projected as jax_w2k                  # noqa: E402
import waymo_to_kitti_projected_torch as w2k                # noqa: E402
from monosowa_tpu.waymo import dataset_pb2 as jax_od        # noqa: E402
from monosowa_tpu.waymo import frame_utils as jax_fu        # noqa: E402
from monosowa_tpu.waymo.tfrecord import \
    write_tfrecord as jax_write_tfrecord                    # noqa: E402
from monosowa_tpu_torch.waymo import dataset_pb2 as od      # noqa: E402
from monosowa_tpu_torch.waymo import frame_utils as fu      # noqa: E402
from monosowa_tpu_torch.waymo.tfrecord import (masked_crc32c,  # noqa: E402
                                               read_tfrecord, write_tfrecord)


def test_both_schemas_load_in_one_process():
    assert od is not jax_od
    assert od.DESCRIPTOR.name == "monosowa_torch_waymo.proto"
    assert od.DESCRIPTOR.package == "monosowa_torch.waymo"
    assert jax_od.DESCRIPTOR.package == "monosowa.waymo"
    assert od.Frame.DESCRIPTOR.full_name == "monosowa_torch.waymo.Frame"
    # the same messages and fields, number for number and type for type
    for name, msg in jax_od.DESCRIPTOR.message_types_by_name.items():
        ours = od.DESCRIPTOR.message_types_by_name[name]
        assert [(f.name, f.number, f.type) for f in ours.fields] \
            == [(f.name, f.number, f.type) for f in msg.fields], name


# ---------------------------------------------------------------- segments

def _jpeg_bytes(h, w, seed):
    import io

    from PIL import Image
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return buf.getvalue()


def _frame(schema, utils, i, rng):
    """A frame at tests/test_waymo_ingest.py's sizes with more in it: a
    moving pose, the TOP laser (with its per-pixel pose) and the FRONT
    laser, both returns, vehicles at every distance band and both levels,
    a pedestrian, a projected label without a 3D box, one whose 3D box has
    no points."""
    frame = schema.Frame()
    frame.timestamp_micros = 1000 + i
    pose = np.eye(4)
    pose[:3, :3] = utils.rotation_from_rpy(0.0, 0.0, 0.05 * i)
    pose[:3, 3] = [2.0 * i, 0.3 * i, 0.1]
    frame.pose.transform.extend(pose.reshape(-1).tolist())

    cam = frame.context.camera_calibrations.add()
    cam.name = schema.CameraName.FRONT
    cam.intrinsic.extend([2000.0, 2010.0, 960.5, 640.25, 0, 0, 0, 0, 0])
    ext = np.eye(4)
    ext[:3, 3] = [1.5, -0.1, 2.0]
    cam.extrinsic.transform.extend(ext.reshape(-1).tolist())
    cam.width, cam.height = 64, 48
    img = frame.images.add()
    img.name = schema.CameraName.FRONT
    img.image = _jpeg_bytes(48, 64, i)

    for name, (lo, hi), h, w in ((schema.LaserName.TOP, (-0.3, 0.2), 4, 16),
                                 (schema.LaserName.FRONT, (-0.5, 0.5), 3,
                                  8)):
        lc = frame.context.laser_calibrations.add()
        lc.name = name
        lc.beam_inclination_min, lc.beam_inclination_max = lo, hi
        lext = np.eye(4)
        lext[:3, :3] = utils.rotation_from_rpy(0.0, 0.0, 0.1 * name)
        lext[:3, 3] = [0.5 * name, 0.0, 1.8]
        lc.extrinsic.transform.extend(lext.reshape(-1).tolist())
        laser = frame.lasers.add()
        laser.name = name
        for ri_msg in (laser.ri_return1, laser.ri_return2):
            ri = np.zeros((h, w, 4), np.float32)
            hits = rng.random((h, w)) < 0.4
            ri[..., 0] = np.where(hits, rng.uniform(2, 70, (h, w)), 0.0)
            ri[..., 1:] = rng.normal(size=(h, w, 3))
            cp = np.zeros((h, w, 6), np.int32)
            cp[..., 0] = schema.CameraName.FRONT
            cp[..., 1] = rng.integers(0, 64, (h, w))
            cp[..., 2] = rng.integers(0, 48, (h, w))
            ri_msg.range_image_compressed = utils.compress_matrix(
                ri, schema.MatrixFloat)
            ri_msg.camera_projection_compressed = utils.compress_matrix(
                cp, schema.MatrixInt32)
            if name == schema.LaserName.TOP:
                pose6 = np.broadcast_to(
                    np.array([0.0, 0.0, 0.05 * i, 2.0 * i, 0.3 * i, 0.1],
                             np.float32), (h, w, 6)).copy()
                pose6 += rng.normal(0, 1e-3, (h, w, 6)).astype(np.float32)
                ri_msg.range_image_pose_compressed = utils.compress_matrix(
                    pose6, schema.MatrixFloat)

    pl = frame.projected_lidar_labels.add()
    pl.name = schema.CameraName.FRONT
    for k, (x, pts, typ) in enumerate(((12.0, 30, 1), (20.0, 3, 1),
                                       (40.0, 12, 1), (35.0, 2, 1),
                                       (65.0, 8, 1), (70.0, 1, 1),
                                       (15.0, 9, 2), (25.0, 0, 1))):
        l3 = frame.laser_labels.add()
        l3.id = f"obj{k}"
        l3.type = typ
        l3.num_lidar_points_in_box = pts
        l3.box.center_x = x + 0.37 * i
        l3.box.center_y = float(rng.uniform(-6, 6))
        l3.box.center_z = float(rng.uniform(0.2, 1.2))
        l3.box.length, l3.box.width, l3.box.height = 4.51, 1.83, 1.62
        l3.box.heading = float(rng.uniform(-3, 3))
        il = pl.labels.add()
        il.id = f"obj{k}_FRONT"
        il.type = typ
        il.box.center_x = float(rng.uniform(50, 1900))
        il.box.center_y = float(rng.uniform(50, 1200))
        il.box.length, il.box.width = 80.25, 40.5
    orphan = pl.labels.add()
    orphan.id = "ghost_FRONT"
    orphan.type = 1
    orphan.box.center_x, orphan.box.center_y = 300.0, 300.0
    return frame


def _segments(root, schema, utils, writer):
    """Two splits: training with two segments of 2 frames, validation with
    one of 3; returns the serialised frames in order."""
    rng = np.random.default_rng(7)
    data = []
    for split, segs in (("training", (2, 2)), ("validation", (3,))):
        os.makedirs(os.path.join(root, split))
        for s, n in enumerate(segs):
            recs = [_frame(schema, utils, i, rng).SerializeToString()
                    for i in range(n)]
            writer(os.path.join(root, split, f"segment-{s:03d}.tfrecord"),
                   recs)
            data.extend(recs)
    return data


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = \
                os.path.join(d, f)
    return out


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Each converter's CLI over the segments the other schema wrote."""
    base = tmp_path_factory.mktemp("waymo_conv")
    jax_data = _segments(str(base / "in_jax"), jax_od, jax_fu,
                         jax_write_tfrecord)
    port_data = _segments(str(base / "in_port"), od, fu, write_tfrecord)
    jax_w2k.main(["--dataset_folder", str(base / "in_port"),
                  "--output_dir", str(base / "out_jax")])
    w2k.main(["--dataset_folder", str(base / "in_jax"),
              "--output_dir", str(base / "out_port")])
    return {"jax_data": jax_data, "port_data": port_data,
            "jax": _tree(str(base / "out_jax")),
            "port": _tree(str(base / "out_port")),
            "in": (str(base / "in_jax"), str(base / "in_port"))}


def test_both_schemas_write_the_same_bytes(converted):
    assert converted["jax_data"] == converted["port_data"]
    jax_in, port_in = converted["in"]
    for rel in ("training/segment-000.tfrecord",
                "validation/segment-000.tfrecord"):
        with open(os.path.join(jax_in, rel), "rb") as a, \
                open(os.path.join(port_in, rel), "rb") as b:
            assert a.read() == b.read()


def test_converter_writes_the_same_files(converted):
    got, want = converted["port"], converted["jax"]
    assert sorted(got) == sorted(want)
    kinds = {}
    for rel in sorted(want):
        kind = rel.split(os.sep)[-2]
        kinds[kind] = kinds.get(kind, 0) + 1
        if rel.endswith(".npz"):
            with np.load(got[rel]) as g, np.load(want[rel]) as w:
                assert sorted(g.files) == sorted(w.files) == ["arr_0"]
                for k in w.files:
                    assert g[k].dtype == w[k].dtype == np.float32
                    np.testing.assert_array_equal(g[k], w[k], err_msg=rel)
            continue
        with open(got[rel], "rb") as a, open(want[rel], "rb") as b:
            assert a.read() == b.read(), rel
    # 7 frames: images, scans, calibs and label_2 of each; 7 validation
    # label directories of 3 frames
    assert kinds["image_2"] == kinds["velodyne"] == kinds["calib"] == \
        kinds["label_2"] == 7
    for sub in ("label_l1", "label_l1_030", "label_l1_3050", "label_l1_50xx",
                "label_l2_030", "label_l2_3050", "label_l2_50xx"):
        assert kinds[sub] == 3, sub
    # the files hold what was asked for: rows in every band and level
    rows = {rel: open(path).read() for rel, path in got.items()
            if rel.startswith("validation") and rel.endswith(".txt")
            and "label_" in rel}
    for sub in ("label_l1_030", "label_l1_3050", "label_l2_50xx"):
        assert any(txt for rel, txt in rows.items()
                   if rel.split(os.sep)[-2] == sub), sub
    calib = next(open(p).read() for rel, p in got.items()
                 if os.sep + "calib" + os.sep in rel)
    assert "Cur_pose: " in calib


def test_convert_split_shards_by_sequence(tmp_path, converted):
    jax_in, _ = converted["in"]
    split = os.path.join(jax_in, "training")
    n = w2k.convert_split(split, str(tmp_path / "port"), 1, 2, False)
    m = jax_w2k.convert_split(split, str(tmp_path / "jax"), 1, 2, False)
    assert n == m == 2
    assert sorted(os.listdir(tmp_path / "port")) == ["segment-001.tfrecord"]


# ------------------------------------------- the cases of the JAX tests

def test_tfrecord_roundtrip(tmp_path):
    recs = [b"alpha", b"", b"\x00" * 1000, os.urandom(4096)]
    path = str(tmp_path / "t.tfrecord")
    write_tfrecord(path, recs)
    assert list(read_tfrecord(path)) == recs
    other = str(tmp_path / "jax.tfrecord")
    jax_write_tfrecord(other, recs)
    assert open(path, "rb").read() == open(other, "rb").read()


def test_tfrecord_crc_detects_corruption(tmp_path):
    path = str(tmp_path / "t.tfrecord")
    write_tfrecord(path, [b"payload"])
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        list(read_tfrecord(path))


def test_masked_crc_known_vector():
    c = 0xE3069283                      # crc32c("123456789")
    assert masked_crc32c(b"123456789") == \
        ((((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _laser_calib(name, lo, hi, extrinsic=np.eye(4)):
    c = od.LaserCalibration()
    c.name = name
    c.beam_inclination_min = lo
    c.beam_inclination_max = hi
    c.extrinsic.transform.extend(np.asarray(extrinsic).reshape(-1).tolist())
    return c


def _cloud(frame, name, ri, top_pose=None):
    cp = np.zeros(ri.shape[:2] + (6,), np.int32)
    pts, _ = fu.convert_range_image_to_point_cloud(
        frame, {name: [ri]}, {name: [cp]}, top_pose)
    return pts


def test_axis_aligned_pixel_maps_to_x_axis():
    frame = od.Frame()
    frame.pose.transform.extend(np.eye(4).reshape(-1).tolist())
    frame.context.laser_calibrations.append(
        _laser_calib(od.LaserName.REAR, -0.1, 0.1))
    ri = np.zeros((1, 5, 4))
    ri[0, 2, 0] = 7.5
    pts = _cloud(frame, od.LaserName.REAR, ri)
    assert len(pts) == 1 and pts[0].shape == (1, 3)
    np.testing.assert_allclose(pts[0][0], [7.5, 0.0, 0.0], atol=1e-9)


def test_extrinsic_translation_and_yaw_correction():
    ri = np.zeros((1, 5, 4))
    ri[0, 2, 0] = 4.0

    def run(extrinsic):
        frame = od.Frame()
        frame.pose.transform.extend(np.eye(4).reshape(-1).tolist())
        frame.context.laser_calibrations.append(
            _laser_calib(od.LaserName.REAR, -0.1, 0.1, extrinsic))
        return _cloud(frame, od.LaserName.REAR, ri)[0][0]

    base = run(np.eye(4))
    e = np.eye(4)
    e[:3, :3] = fu.rotation_from_rpy(0.0, 0.0, 0.7)
    e[:3, 3] = [1.0, -2.0, 0.5]
    np.testing.assert_allclose(run(e), base + [1.0, -2.0, 0.5], atol=1e-9)


def test_top_pixel_pose_identity_when_static():
    h, w = 2, 8
    ri = np.zeros((h, w, 4))
    ri[:, ::2, 0] = np.arange(1, 1 + h * w // 2).reshape(h, -1)
    pose = np.eye(4)
    pose[:3, :3] = fu.rotation_from_rpy(0.05, -0.02, 1.3)
    pose[:3, 3] = [10.0, -4.0, 0.3]
    rpy_xyz = np.broadcast_to(
        np.array([0.05, -0.02, 1.3, 10.0, -4.0, 0.3]), (h, w, 6))

    def run(top_pose, frame_pose):
        frame = od.Frame()
        frame.pose.transform.extend(frame_pose.reshape(-1).tolist())
        frame.context.laser_calibrations.append(
            _laser_calib(od.LaserName.TOP, -0.3, 0.2))
        return _cloud(frame, od.LaserName.TOP, ri, top_pose)[0]

    np.testing.assert_allclose(run(rpy_xyz, pose), run(None, np.eye(4)),
                               atol=1e-9)


def test_beam_inclination_rows_reversed():
    frame = od.Frame()
    frame.pose.transform.extend(np.eye(4).reshape(-1).tolist())
    frame.context.laser_calibrations.append(
        _laser_calib(od.LaserName.REAR, -0.4, 0.4))
    ri = np.zeros((2, 5, 4))
    ri[0, 2, 0] = 1.0
    pts = _cloud(frame, od.LaserName.REAR, ri)
    incl = fu.compute_inclination((-0.4, 0.4), 2)[1]
    assert pts[0][0][2] == pytest.approx(np.sin(incl))


def test_matrix_compress_roundtrip():
    arr = np.random.default_rng(0).normal(size=(3, 4, 6)).astype(np.float32)
    buf = fu.compress_matrix(arr, od.MatrixFloat)
    assert buf == jax_fu.compress_matrix(arr, jax_od.MatrixFloat)
    np.testing.assert_allclose(fu._decompress_matrix(buf, od.MatrixFloat),
                               arr, rtol=1e-6)


def test_waymo_heading_conversion():
    assert w2k.waymo_heading_to_kitti(0.0) == pytest.approx(-np.pi / 2)
    assert w2k.waymo_heading_to_kitti(-np.pi / 2) == pytest.approx(0.0)


def test_waymo_axis_permutation():
    c = w2k.vehicle_center_to_kitti_cam([10.0, 2.0, 1.0], np.eye(4))
    np.testing.assert_allclose(c, [-2.0, -1.0, 10.0])


def test_waymo_calib_text_roundtrip(tmp_path):
    from monosowa_tpu_torch.kittiio.calib import Calibration

    intr = [1000.0, 1001.0, 960.0, 640.0]
    pose = np.arange(16, dtype=float).reshape(4, 4)
    txt = w2k.waymo_calib_text(intr, np.eye(4), pose)
    assert txt == jax_w2k.waymo_calib_text(intr, np.eye(4), pose)
    lines = dict(ln.split(": ", 1) for ln in txt.strip().split("\n"))
    p2 = np.array([float(v) for v in lines["P2"].split()]).reshape(3, 4)
    assert p2[0, 0] == 1000.0 and p2[1, 2] == 640.0
    cur = np.array([float(v) for v in lines["Cur_pose"].split()]
                   ).reshape(4, 4)
    np.testing.assert_allclose(cur, pose)
    (tmp_path / "c.txt").write_text(txt)
    calib = Calibration(str(tmp_path / "c.txt"))
    np.testing.assert_allclose(calib.pose, pose)
    assert calib.fu == 1000.0


def test_waymo_label_line_format():
    line = w2k.label_line(10.0, 20.0, 110.0, 90.0, 2.0, 1.6, 4.5,
                          1.0, 0.7, 15.0, -1.2)
    assert line == ("Car -1 -1 -10 10.00 20.00 110.00 90.00 "
                    "2.00 1.60 4.50 1.00 1.50 15.00 -1.20\n")


def test_waymo_level_and_bands():
    assert w2k.level_of(4) == 2 and w2k.level_of(5) == 1
    assert w2k.distance_bands(10) == "030"
    assert w2k.distance_bands(30) == "3050"
    assert w2k.distance_bands(49.9) == "3050"
    assert w2k.distance_bands(50) == "50xx"
