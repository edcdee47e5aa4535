"""The port's conv fit (``monosowa_tpu_torch/sowa/fitting.py``) against the
JAX package's ``sowa/fitting.py`` with the same template and conv kernels,
at a small grid (11 x 13 translations, 8 thetas, 36 fine thetas, 300
template points, 512 scan points).  On the CPU the exact coverage runs its
plain version.

Tolerances: x and z within 1e-5 m, theta within 1e-5 rad, loss within
1e-6: translations and moving-car thetas come from tables, the standing
theta from a centroid of table entries, the loss from integer counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.sowa import fitting as jfit
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch.sowa import fitting

torch.set_num_threads(1)    # the suite runs six worker processes at once

GRID = dict(n_dx=11, n_dz=11, n_theta=8, n_theta_fine=36, fine_chunk=12)
S = 512


@pytest.fixture(scope="module")
def state():
    template = JTemplateBank.default(num_points=300).points[0]
    cfg_j, cfg_t = jfit.FitConfig(**GRID), fitting.FitConfig(**GRID)
    spec_j, occ_j, memb_j = jfit.make_conv_kernels(template, cfg_j)
    spec_t, occ_t, memb_t = fitting.make_conv_kernels(template, cfg_t, "cpu")
    return dict(template=template, cfg_j=cfg_j, cfg_t=cfg_t,
                jax=(jnp.asarray(template), occ_j, memb_j, spec_j),
                torch=(torch.from_numpy(template), occ_t, memb_t, spec_t))


def _car(seed, template, center=(0.0, 0.0, 0.0), n_ground=100):
    """A posed template with 0.02 m noise plus ground points, padded to S;
    the pose offset from ``center`` is inside the translation grid."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(th), np.sin(th)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pose = np.array([rng.uniform(-1, 1), 0.1, rng.uniform(0, 2)])
    car = template @ rot.T + pose + rng.normal(scale=0.02,
                                               size=template.shape)
    ground = np.stack([rng.uniform(-3, 3, n_ground),
                       np.full(n_ground, 0.8),
                       rng.uniform(-3, 3, n_ground)], 1)
    pts = (np.concatenate([car, ground]) + np.asarray(center)
           ).astype(np.float32)
    out = np.zeros((S, 3), np.float32)
    mask = np.zeros(S, bool)
    out[:len(pts)] = pts
    mask[:len(pts)] = True
    return out, mask, th


def _close(name, got, want):
    got = {k: np.asarray(v, np.float64) for k, v in got.items()}
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    diff = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    dth = np.abs((got["theta"] - want["theta"] + np.pi) % (2 * np.pi)
                 - np.pi)
    diff["theta"] = float(dth.max())
    print({"test": name, **diff})
    assert diff["x"] <= 1e-5 and diff["z"] <= 1e-5, diff
    assert diff["theta"] <= 1e-5, diff
    assert diff["loss"] <= 1e-6, diff


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fit_standing_car_conv_matches_jax(state, seed):
    pts, mask, th = _car(seed, state["template"])
    rj = jfit.fit_standing_car_conv(jnp.asarray(pts), jnp.asarray(mask),
                                    *state["jax"], state["cfg_j"])
    rt = fitting.fit_standing_car_conv(torch.from_numpy(pts),
                                       torch.from_numpy(mask),
                                       *state["torch"], state["cfg_t"])
    _close("standing", rt._asdict(), rj._asdict())
    assert float(rt.y) == 0.0
    assert float(rt.loss) < -1.0    # the car was found


@pytest.mark.parametrize("seed,valid", [(0, True), (1, True), (2, False),
                                        (3, False)])
def test_fit_moving_car_conv_matches_jax(state, seed, valid):
    pts, mask, th = _car(seed, state["template"])
    theta_est = np.float32(th + 0.05) if valid else np.float32(0.0)
    jt, jo, jm, js = state["jax"]
    rj = jfit.fit_moving_car_conv(jnp.asarray(pts), jnp.asarray(mask),
                                  jt, jo, jm, js, jnp.float32(theta_est),
                                  jnp.asarray(valid), state["cfg_j"])
    tt, to, tm, ts = state["torch"]
    rt = fitting.fit_moving_car_conv(torch.from_numpy(pts),
                                     torch.from_numpy(mask), tt, to, tm, ts,
                                     float(theta_est), valid, state["cfg_t"])
    _close(f"moving valid={valid}", rt._asdict(), rj._asdict())
    if valid:
        # the trajectory angle is returned as given
        assert float(rt.theta) == float(theta_est)


def _batch(template, seeds, center):
    cars = [_car(s, template, center) for s in seeds]
    b = len(cars) + 1                                  # one padded car
    pts = np.zeros((b, S, 3), np.float32)
    mask = np.zeros((b, S), bool)
    for i, (p, m, _) in enumerate(cars):
        pts[i], mask[i] = p, m
    moving = np.array([False, True, True, False, False][:b])
    theta_est = np.zeros(b, np.float32)
    theta_valid = np.zeros(b, bool)
    theta_est[1], theta_valid[1] = cars[1][2] - 0.04, True
    valid = np.ones(b, bool)
    valid[-1] = False
    return pts, mask, moving, theta_est, theta_valid, valid


@pytest.mark.parametrize("seeds", [(0, 1, 2, 3), (4, 5, 6, 7)])
def test_fit_cars_conv_matches_jax(state, seeds):
    """A batch of two standing cars, a moving car with and one without a
    trajectory angle, and a padded car, at a camera-frame offset."""
    arrays = _batch(state["template"], seeds, (2.0, 0.9, 14.0))
    rj = jfit.fit_cars_conv(jfit.CarBatch(*(jnp.asarray(a) for a in arrays)),
                            *state["jax"], state["cfg_j"])
    rt = fitting.fit_cars_conv(fitting.CarBatch(*arrays), *state["torch"],
                               state["cfg_t"])
    real = slice(0, len(seeds))
    _close("fit_cars_conv",
           {k: getattr(rt, k)[real].numpy() for k in ("x", "z", "theta",
                                                      "loss")},
           {k: np.asarray(getattr(rj, k))[real] for k in ("x", "z", "theta",
                                                          "loss")})
    np.testing.assert_allclose(rt.center.numpy(), np.asarray(rj.center),
                               atol=1e-6)
    np.testing.assert_allclose(rt.y.numpy(), np.asarray(rj.y), atol=1e-6)
    assert torch.isfinite(torch.stack([rt.x, rt.z, rt.theta, rt.loss])).all()

    # tensors in, and the padded car changes no real car's result
    head = fitting.CarBatch(*(torch.from_numpy(a[:len(seeds)])
                              for a in arrays))
    rh = fitting.fit_cars_conv(head, *state["torch"], state["cfg_t"])
    for k in ("x", "y", "z", "theta", "loss"):
        assert torch.equal(getattr(rh, k), getattr(rt, k)[real]), k


def test_batched_fit_equals_single_car_fits(state):
    arrays = _batch(state["template"], (0, 1, 2, 3), (0.0, 0.0, 0.0))
    pts, mask, moving, theta_est, theta_valid, _ = arrays
    rt = fitting.fit_cars_conv(fitting.CarBatch(*arrays), *state["torch"],
                               state["cfg_t"])
    tt, to, tm, ts = state["torch"]
    for i in range(4):
        local = torch.from_numpy(pts[i]) - rt.center[i]
        if moving[i]:
            one = fitting.fit_moving_car_conv(
                local, torch.from_numpy(mask[i]), tt, to, tm, ts,
                float(theta_est[i]), bool(theta_valid[i]), state["cfg_t"])
        else:
            one = fitting.fit_standing_car_conv(
                local, torch.from_numpy(mask[i]), tt, to, tm, ts,
                state["cfg_t"])
        assert float(one.x + rt.center[i, 0]) == float(rt.x[i])
        assert float(one.z + rt.center[i, 2]) == float(rt.z[i])
        assert float(one.theta) == float(rt.theta[i])
        assert float(one.loss) == float(rt.loss[i])


def test_tie_breaking_is_first_minimum_and_lowest_index():
    """What the rescore relies on: ``argmin`` returns the first minimum and
    a stable sort lists equal losses by index, as ``jnp.argmin`` and
    ``jax.lax.top_k`` do."""
    import jax
    vals = np.array([[3, 1, 2, 1, 5, 1, 2, 0, 0, 4]], np.float32)
    t = torch.from_numpy(vals)
    assert int(t.argmin(dim=1)) == int(jnp.argmin(jnp.asarray(vals[0]))) == 7
    _, cand = jax.lax.top_k(-jnp.asarray(vals[0]), 6)
    got = torch.sort(t, dim=1, stable=True).indices[0, :6]
    assert got.tolist() == np.asarray(cand).tolist() == [7, 8, 1, 3, 5, 2]


def test_exact_topk_zero_and_other_loss_kinds(state):
    """exact_topk 0 (no rescore), and the ``chamfer`` loss kind's exact
    sweep (which raised before the other kinds were ported): each fit
    equals the JAX package's."""
    pts, mask, _ = _car(0, state["template"])
    jt, jo, jm, js = state["jax"]
    tt, to, tm, ts = state["torch"]
    cfg_j = jfit.FitConfig(**GRID, exact_topk=0)
    cfg_t = fitting.FitConfig(**GRID, exact_topk=0)
    rj = jfit.fit_standing_car_conv(jnp.asarray(pts), jnp.asarray(mask), jt,
                                    jo, jm, js, cfg_j)
    rt = fitting.fit_standing_car_conv(torch.from_numpy(pts),
                                       torch.from_numpy(mask), tt, to, tm,
                                       ts, cfg_t)
    _close("exact_topk=0", rt._asdict(), rj._asdict())
    rj = jfit.fit_standing_car_conv(
        jnp.asarray(pts), jnp.asarray(mask), jt, jo, jm, js,
        jfit.FitConfig(**GRID, loss_function="chamfer"))
    rt = fitting.fit_standing_car_conv(
        torch.from_numpy(pts), torch.from_numpy(mask), tt, to, tm, ts,
        fitting.FitConfig(**GRID, loss_function="chamfer"))
    _close("chamfer", rt._asdict(), rj._asdict())


@pytest.mark.parametrize("kind", ["binary1way", "diffbin", "med1way",
                                  "medboth", "trimmed"])
def test_other_loss_kind_fits_match_jax(state, kind):
    """``fit_cars_conv`` with a loss kind other than binary2way (the exact
    sweep of the reference's grid, then the fine pass with the same kind)
    on a standing and a moving car against the JAX package's."""
    arrays = [a[:2] for a in _batch(state["template"], (5, 6),
                                    (2.0, 0.5, 15.0))]
    jt, jo, jm, js = state["jax"]
    tt, to, tm, ts = state["torch"]
    cfg_j = jfit.FitConfig(**GRID, loss_function=kind, trim_threshold=0.3)
    cfg_t = fitting.FitConfig(**GRID, loss_function=kind, trim_threshold=0.3)
    rj = jfit.fit_cars_conv(jfit.CarBatch(*map(jnp.asarray, arrays)),
                            jt, jo, jm, js, cfg_j)
    rt = fitting.fit_cars_conv(fitting.CarBatch(*arrays), tt, to, tm, ts,
                               cfg_t)
    _close(f"fit {kind}", {k: getattr(rt, k) for k in
                           ("x", "z", "theta", "loss")},
           {k: getattr(rj, k) for k in ("x", "z", "theta", "loss")})


@pytest.mark.parametrize("kind", ["binary2way", "chamfer"])
def test_exact_grid_losses_match_jax(state, kind):
    """The exact (theta x translation) sweep: the coverage counts' one call
    (binary2way) and the chunked plain sweep (chamfer) against the JAX
    package's ``exact_grid_losses`` (within 1e-6)."""
    pts, mask, th = _car(3, state["template"])
    cfg_j = jfit.FitConfig(**GRID, loss_function=kind)
    cfg_t = fitting.FitConfig(**GRID, loss_function=kind)
    thetas = np.array([th, th + 1.0, th + np.pi], np.float32)
    _, trans = fitting._pose_grids(cfg_t)
    want = np.asarray(jfit.exact_grid_losses(
        jnp.asarray(pts), jnp.asarray(mask), state["jax"][0],
        jnp.asarray(trans), jnp.asarray(thetas), cfg_j))
    got = fitting.exact_grid_losses(
        torch.from_numpy(pts)[None], torch.from_numpy(mask)[None],
        state["torch"][0], torch.from_numpy(trans),
        torch.from_numpy(thetas)[None], cfg_t)[0].numpy()
    assert got.shape == want.shape == (3, len(trans))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,flip", [(7, False), (8, True)])
def test_fit_loc_only_matches_jax(state, seed, flip):
    """The translation-only grid at a given yaw (theta in {est, est +
    pi}); with ``flip`` the estimate is the truth + pi."""
    pts, mask, th = _car(seed, state["template"])
    est = np.float32(th + np.pi if flip else th + 0.02)
    rj = jfit.fit_loc_only(jnp.asarray(pts), jnp.asarray(mask),
                           state["jax"][0], jnp.float32(est), state["cfg_j"])
    rt = fitting.fit_loc_only(torch.from_numpy(pts), torch.from_numpy(mask),
                              state["torch"][0], est, state["cfg_t"])
    _close(f"loc_only flip={flip}", rt._asdict(), rj._asdict())


def test_fit_cars_robust_matches_jax(state):
    """The robust branch on _batch's cars: standing with a valid estimator
    yaw (the translation-only grid), moving with and without a trajectory
    yaw and standing without an estimator yaw (the standard fit), and a
    padded row (not compared, as in test_fit_cars_conv_matches_jax)."""
    arrays = _batch(state["template"], (9, 10, 11, 12), (2.0, 0.5, 15.0))
    th_rob = np.array([_car(9, state["template"])[2] + 0.02, 0.4, 0.4, 0.0,
                       0.0], np.float32)
    rob_valid = np.array([True, True, True, False, True])
    jt, jo, jm, js = state["jax"]
    tt, to, tm, ts = state["torch"]
    rj = jfit.fit_cars_robust(
        jfit.CarBatch(*map(jnp.asarray, arrays)), jt, jo, jm, js,
        state["cfg_j"], jnp.asarray(th_rob), jnp.asarray(rob_valid))
    rt = fitting.fit_cars_robust(
        fitting.CarBatch(*arrays), tt, to, tm, ts, state["cfg_t"], th_rob,
        rob_valid)
    real = slice(0, 4)
    _close("robust", {k: getattr(rt, k)[real] for k in
                      ("x", "z", "theta", "loss")},
           {k: np.asarray(getattr(rj, k))[real] for k in
            ("x", "z", "theta", "loss")})
    np.testing.assert_allclose(rt.y.numpy()[real], np.asarray(rj.y)[real],
                               atol=1e-5)
    np.testing.assert_allclose(rt.center.numpy()[real],
                               np.asarray(rj.center)[real], atol=1e-5)
    # car 0 took the translation-only grid: its yaw is the estimate
    assert float(rt.theta[0]) == pytest.approx(float(th_rob[0]), abs=1e-6)


def test_estimate_angle_and_grids_equal_jax():
    rng = np.random.default_rng(0)
    locs = np.cumsum(rng.normal([0.3, 0, 1.2], 0.2, (13, 3)), 0)
    valid = rng.random(13) > 0.2
    valid[6] = True
    assert fitting.estimate_angle_from_track(locs, valid, 6) == \
        jfit.estimate_angle_from_track(locs, valid, 6)
    assert fitting.estimate_angle_from_track(locs[:2], valid[:2], 0) is None
    th_t, tr_t = fitting._pose_grids(fitting.FitConfig())
    th_j, tr_j = jfit._pose_grids(jfit.FitConfig())
    np.testing.assert_array_equal(th_t, np.asarray(th_j))
    np.testing.assert_array_equal(tr_t, np.asarray(tr_j))
    np.testing.assert_array_equal(
        fitting._fine_thetas(fitting.FitConfig()),
        np.asarray(jfit._fine_thetas(jfit.FitConfig())))


def test_posed_templates_agree_with_jax_to_the_last_bits(state):
    """The posed templates the exact coverage sees: sin and cos differ in
    the last bit between the two frameworks, so a few coordinates do too
    (a pair within that of the radius could flip a count by one)."""
    from monosowa_tpu.ops.geometry import rot_y as jrot_y
    thetas = fitting._fine_thetas(state["cfg_t"])
    want = np.asarray(jnp.einsum("tj,cij->cti", state["jax"][0],
                                 jrot_y(jnp.asarray(thetas))))
    got = fitting._pose_template(state["torch"][0],
                                 torch.from_numpy(thetas)).numpy()
    diff = np.abs(got - want)
    print({"test": "posed templates", "max_abs_diff": float(diff.max()),
           "share_differing": float((diff > 0).mean())})
    assert diff.max() <= 5e-7
