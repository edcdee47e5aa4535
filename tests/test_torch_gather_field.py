"""The port's gather-field fit (``monosowa_tpu_torch/ops/tfl.py``
membership fields and ``grid_pose_losses``; ``sowa/fitting.py``
``fit_standing_car``, ``fit_moving_car``, ``fit_cars``) against the JAX
package's, on ``test_torch_fitting.py``'s scenes at its small grid.

Tolerances: fields and memberships equal; ``grid_pose_losses`` within
1e-6 (counts over T and S in float32: the last bit); poses equal (x, z,
theta within 1e-6: table entries or a centroid of them), losses within
1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.ops import tfl as jtfl
from monosowa_tpu.sowa import fitting as jfit
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.sowa import fitting

from test_torch_fitting import GRID, _car

torch.set_num_threads(1)    # the suite runs six worker processes at once

RADIUS = 0.2


@pytest.fixture(scope="module")
def state():
    template = JTemplateBank.default(num_points=300).points[0]
    return dict(template=template,
                field_j=jtfl.build_template_field(template, RADIUS),
                field_t=tfl.build_template_field(template, RADIUS),
                cfg_j=jfit.FitConfig(**GRID), cfg_t=fitting.FitConfig(**GRID))


def test_fields_equal(state):
    np.testing.assert_array_equal(state["field_t"].numpy(),
                                  np.asarray(state["field_j"]))
    np.testing.assert_array_equal(tfl._neighbor_offsets(0.2, 0.08),
                                  jtfl._neighbor_offsets(0.2, 0.08))
    cars = [_car(s, state["template"]) for s in range(3)]
    pts = np.stack([c[0] for c in cars])
    mask = np.stack([c[1] for c in cars])
    batched = tfl.build_membership_field(torch.from_numpy(pts),
                                         torch.from_numpy(mask),
                                         tfl.CAR_FIELD, RADIUS).numpy()
    for i in range(3):
        want = np.asarray(jtfl.build_membership_field(
            jnp.asarray(pts[i]), jnp.asarray(mask[i]), jtfl.CAR_FIELD,
            RADIUS))
        assert want.sum() > 0
        np.testing.assert_array_equal(batched[i], want)


def test_sample_membership_equal(state):
    rng = np.random.default_rng(5)
    spec = tfl.TEMPLATE_FIELD
    pts = rng.uniform(-2.5, 2.5, (4000, 3)).astype(np.float32)
    # voxel faces
    pts[:500] = (np.float32(spec.origin)
                 + np.float32(rng.integers(-2, 60, (500, 3)))
                 * np.float32(spec.voxel))
    want = np.asarray(jtfl.sample_membership(state["field_j"],
                                             jtfl.TEMPLATE_FIELD,
                                             jnp.asarray(pts)))
    got = tfl.sample_membership(state["field_t"], spec,
                                torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    xyz = [torch.from_numpy(np.ascontiguousarray(pts[:, k]))
           for k in range(3)]
    want = np.asarray(jtfl._sample_membership_xyz(
        state["field_j"], jtfl.TEMPLATE_FIELD,
        *(jnp.asarray(pts[:, k]) for k in range(3))))
    got = tfl._sample_membership_xyz(state["field_t"], spec, *xyz).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_pose_losses_match_jax(state, seed):
    pts, mask, _ = _car(seed, state["template"])
    local = pts - np.median(pts[mask], 0).astype(np.float32)
    thetas, trans = jfit._pose_grids(state["cfg_j"])
    want = np.asarray(jtfl.grid_pose_losses(
        jnp.asarray(local), jnp.asarray(mask),
        jnp.asarray(state["template"]), state["field_j"], thetas, trans,
        RADIUS))
    got = tfl.grid_pose_losses(
        torch.from_numpy(local)[None], torch.from_numpy(mask)[None],
        torch.from_numpy(state["template"]), state["field_t"],
        torch.from_numpy(np.array(thetas)), torch.from_numpy(np.array(trans)),
        RADIUS)[0].numpy()
    diff = float(np.abs(got - want).max())
    print(diff)
    assert diff <= 1e-6


def _close(got, want):
    for k in ("x", "z", "theta", "loss"):
        diff = float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
        assert diff <= 1e-6, (k, diff)


@pytest.mark.parametrize("seed", [0, 2])
def test_single_car_fits_match_jax(state, seed):
    pts, mask, _ = _car(seed, state["template"])
    local = pts - np.median(pts[mask], 0).astype(np.float32)
    tmpl_t = torch.from_numpy(state["template"])
    args_j = (jnp.asarray(local), jnp.asarray(mask),
              jnp.asarray(state["template"]), state["field_j"])
    args_t = (torch.from_numpy(local), torch.from_numpy(mask), tmpl_t,
              state["field_t"])
    _close(fitting.fit_standing_car(*args_t, state["cfg_t"])._asdict(),
           jfit.fit_standing_car(*args_j, state["cfg_j"])._asdict())
    for th, valid in ((0.7, True), (0.0, False)):
        _close(fitting.fit_moving_car(*args_t, th, valid,
                                      state["cfg_t"])._asdict(),
               jfit.fit_moving_car(*args_j, jnp.float32(th),
                                   jnp.asarray(valid),
                                   state["cfg_j"])._asdict())


def test_fit_cars_matches_jax(state):
    cars = [_car(s, state["template"], center=(s - 2.0, 0.5, 10.0 + s))
            for s in range(5)]
    pts = np.stack([c[0] for c in cars])
    mask = np.stack([c[1] for c in cars])
    moving = np.array([False, True, False, True, True])
    theta_est = np.array([0.0, cars[1][2], 0.0, 0.0, cars[4][2]],
                         np.float32)
    theta_valid = np.array([False, True, False, False, True])
    valid = np.ones(5, bool)
    rj = jfit.fit_cars(jfit.CarBatch(*(jnp.asarray(a) for a in (
        pts, mask, moving, theta_est, theta_valid, valid))),
        jnp.asarray(state["template"]), state["field_j"], state["cfg_j"])
    rt = fitting.fit_cars(fitting.CarBatch(pts, mask, moving, theta_est,
                                           theta_valid, valid),
                          torch.from_numpy(state["template"]),
                          state["field_t"], state["cfg_t"])
    _close(rt._asdict(), rj._asdict())
    np.testing.assert_array_equal(rt.center.numpy(), np.asarray(rj.center))
    np.testing.assert_array_equal(rt.y.numpy(), np.asarray(rj.y))
