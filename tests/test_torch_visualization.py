"""The port's renders (``sowa/visualization.py``) against the JAX package's
on the same label files and points: ``draw_boxes_on_image`` gives equal
arrays, ``plot_bev`` and ``compare_label_dirs`` PNGs with equal decoded
pixels (both through the same matplotlib)."""

import numpy as np
import pytest
from PIL import Image

from monosowa_tpu.kittiio import Calibration as JaxCalibration
from monosowa_tpu.kittiio import KittiObject as JaxObject
from monosowa_tpu.sowa import visualization as jax_vis
from monosowa_tpu_torch.kittiio import Calibration, KittiObject
from monosowa_tpu_torch.sowa import visualization as vis

P2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
               [0, 0, 1, 0.003]])
ROWS = ("Car 0.00 0 -1.58 500 150 600 250 1.52 1.63 3.88 {x} 1.7 {z} {ry}",
        "Pedestrian 0.00 0 0.2 700 160 720 240 1.75 0.6 0.8 4.0 1.6 9.0 "
        "0.1",
        "DontCare -1 -1 -10 0 0 10 10 -1 -1 -1 -1000 -1000 -1000 -10")


def _lines(rng, n):
    """n label lines: cars at random places (one behind the camera, one
    within 0.5 m of it), a pedestrian and a DontCare row."""
    cars = [ROWS[0].format(x=round(float(rng.uniform(-15, 15)), 2),
                           z=round(float(rng.uniform(3, 60)), 2),
                           ry=round(float(rng.uniform(-3.1, 3.1)), 2))
            for _ in range(n)]
    cars += [ROWS[0].format(x=1.0, z=-4.0, ry=0.3),
             ROWS[0].format(x=0.5, z=0.4, ry=0.0)]
    return cars + list(ROWS[1:])


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


@pytest.mark.parametrize("seed", [0, 1])
def test_draw_boxes_on_image_equals_jax(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (375, 1242, 3), np.uint8)
    lines = _lines(rng, 6)
    got = vis.draw_boxes_on_image(img, [KittiObject.from_line(ln)
                                        for ln in lines],
                                  Calibration({"P2": P2}), color=(0, 255, 0))
    want = jax_vis.draw_boxes_on_image(img, [JaxObject.from_line(ln)
                                             for ln in lines],
                                       JaxCalibration({"P2": P2}),
                                       color=(0, 255, 0))
    assert (got != img).any()                  # something was drawn
    np.testing.assert_array_equal(got, want)


def test_plot_bev_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.uniform([-20, 0, 0], [20, 2, 60], (3000, 3))
    lines = {"pred": _lines(rng, 4), "gt": _lines(rng, 3),
             "other": _lines(rng, 1)}
    got = vis.plot_bev(pts, {k: [KittiObject.from_line(ln) for ln in v]
                             for k, v in lines.items()},
                       str(tmp_path / "port.png"), title="t")
    want = jax_vis.plot_bev(pts, {k: [JaxObject.from_line(ln) for ln in v]
                                  for k, v in lines.items()},
                            str(tmp_path / "jax.png"), title="t")
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    # no points, no labels: the empty axes
    got = vis.plot_bev(None, None, str(tmp_path / "port0.png"))
    want = jax_vis.plot_bev(None, None, str(tmp_path / "jax0.png"))
    np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_compare_label_dirs_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    dirs = {}
    for name in ("pred", "gt", "labels1"):
        d = tmp_path / name
        d.mkdir()
        (d / "000007.txt").write_text("\n".join(_lines(rng, 3)) + "\n")
        dirs[name] = str(d)
    # labels2 names a directory without the frame's file: skipped in both
    (tmp_path / "labels2").mkdir()
    pts = rng.uniform([-10, 0, 0], [10, 2, 40], (500, 3))
    kw = dict(points=pts, pred_dir=dirs["pred"], gt_dir=dirs["gt"],
              labels1_dir=dirs["labels1"],
              labels2_dir=str(tmp_path / "labels2"))
    got = vis.compare_label_dirs("000007", str(tmp_path / "port.png"), **kw)
    want = jax_vis.compare_label_dirs("000007", str(tmp_path / "jax.png"),
                                      **kw)
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
