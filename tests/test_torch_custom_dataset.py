"""The port's optimizer accuracy harness (``monosowa_tpu_torch/sowa/
custom_dataset.py``) against the JAX package's: files written by either
package load in the other, the IoUs agree within 1e-5 (float32 polygon
clipping in another order), the GT match is the same, and the harness runs
the port's gather-field fit."""

import numpy as np
import pytest
import torch

from monosowa_tpu.sowa import custom_dataset as jcd
from monosowa_tpu_torch.sowa import custom_dataset as tcd
from monosowa_tpu_torch.sowa import fitting
from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.sowa.templates import TemplateBank

torch.set_num_threads(1)    # the suite runs six worker processes at once


def _pairs(out_dir, module, seed=2):
    rng = np.random.default_rng(seed)
    for i in range(3):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        gt = np.array([i * 2.0, 1.0, 10.0, 3.9, 1.6, 1.5, 0.3], np.float32)
        module.save_pair(str(out_dir), f"car{i}", pts, gt)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_round_trip_between_packages(tmp_path, writer):
    _pairs(tmp_path, jcd if writer == "jax" else tcd)
    for limit in (None, 2):
        pj, bj, oj = jcd.load_pairs(str(tmp_path), limit, 7.5)
        pt, bt, ot = tcd.load_pairs(str(tmp_path), limit, 7.5)
        assert len(pt) == len(pj)
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(bt, bj)
        np.testing.assert_array_equal(ot, oj)


def test_iou_and_gt_match_equal():
    rng = np.random.default_rng(3)
    gt = np.array([1.0, 1.0, 10.0, 3.9, 1.6, 1.5, 0.3], np.float32)
    for _ in range(4):
        fit = gt + rng.normal(scale=[0.5, 0.1, 0.5, 0.3, 0.1, 0.1, 0.4])
        got = tcd.compute_pair_iou(fit, gt)
        want = jcd.compute_pair_iou(fit, gt)
        assert abs(got - want) <= 1e-5, (got, want)
    assert tcd.compute_pair_iou(gt, gt) == pytest.approx(1.0, abs=1e-4)
    centers = rng.uniform(-20, 20, (6, 3))
    for _ in range(10):
        car = rng.uniform(-20, 20, 3)
        assert tcd.find_gt_for_car(car, centers) \
            == jcd.find_gt_for_car(car, centers)
    assert tcd.find_gt_for_car(np.zeros(3), np.zeros((0, 3))) is None


def test_evaluate_fitting_with_the_gather_fit(tmp_path):
    """Each stored car is a posed template; the harness re-fits it with the
    port's fit_cars and reports its IoU, the same through both packages'
    harness code."""
    template = TemplateBank.default(num_points=300).points[0]
    rng = np.random.default_rng(4)
    for i in range(2):
        th = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(th), np.sin(th)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        center = np.array([rng.uniform(-3, 3), 1.0, rng.uniform(8, 20)])
        pts = template @ rot.T + center + rng.normal(
            scale=0.02, size=template.shape)
        # KITTI's ry = theta - pi/2 with l along the template's z
        gt = np.array([*center, 3.88, 1.63, 1.526, th - np.pi / 2])
        tcd.save_pair(str(tmp_path), f"car{i}", pts, gt)
    cfg = fitting.FitConfig(n_dx=11, n_dz=11, n_theta=8, n_theta_fine=36)
    tmpl_t = torch.from_numpy(template)
    field = tfl.build_template_field(template, cfg.radius)

    def fit_fn(pts):
        s = 512
        pad = np.zeros((1, s, 3), np.float32)
        mask = np.zeros((1, s), bool)
        pad[0, :len(pts)] = pts[:s]
        mask[0, :min(len(pts), s)] = True
        res = fitting.fit_cars(fitting.CarBatch(
            pad, mask, np.zeros(1, bool), np.zeros(1, np.float32),
            np.zeros(1, bool), np.ones(1, bool)), tmpl_t, field, cfg)
        return [float(res.x[0]), float(res.y[0]), float(res.z[0]), 3.88,
                1.63, 1.526, float(res.theta[0]) - np.pi / 2]

    got = tcd.evaluate_fitting_on_pairs(str(tmp_path), fit_fn)
    want = jcd.evaluate_fitting_on_pairs(str(tmp_path), fit_fn)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert len(got) == 2 and min(got) > 0.5
