"""The port's template-fitting loss (``monosowa_tpu_torch/ops/tfl.py``)
against the JAX package's ``ops/tfl.py`` and its Pallas kernel in interpret
mode, on the same numpy inputs.  On the CPU the port's
``binary_both_way_counts`` runs its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.ops import tfl as jtfl
from monosowa_tpu.ops.tfl_pallas import binary_both_way_counts_pallas
from monosowa_tpu.sowa import fitting as jfit
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.sowa import fitting
from monosowa_tpu_torch.sowa.templates import TemplateBank

torch.set_num_threads(1)    # the suite runs six worker processes at once

GRID = dict(n_dx=11, n_dz=11, n_theta=8, n_theta_fine=36)


def _scan_and_poses(seed, t, s=512, n_valid=400, p=4):
    """The inputs of tests/test_tfl_pallas.py: a padded scan with a masked
    tail of garbage and posed templates with planted overlap."""
    rng = np.random.default_rng(seed)
    scan = rng.normal(scale=1.5, size=(s, 3)).astype(np.float32)
    mask = np.ones(s, bool)
    mask[n_valid:] = False
    scan[n_valid:] = 77.0
    poses = rng.normal(scale=1.5, size=(p, t, 3)).astype(np.float32)
    poses[0, :50] = scan[:50] + rng.normal(scale=0.05, size=(50, 3))
    return scan, mask, poses


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t", [100, 256, 300])
def test_counts_match_jax_and_pallas(seed, t):
    scan, mask, poses = _scan_and_poses(seed, t)
    tf, sf = tfl.binary_both_way_counts(
        torch.from_numpy(scan), torch.from_numpy(mask),
        torch.from_numpy(poses), 0.2)
    tf_x, sf_x = jtfl.binary_both_way_counts(
        jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(poses), 0.2)
    tf_p, sf_p = binary_both_way_counts_pallas(
        jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(poses), 0.2,
        interpret=True)
    for got, want in ((tf, tf_x), (sf, sf_x), (tf, tf_p), (sf, sf_p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(tf[0]) > 0     # the planted overlap registered


def test_counts_all_masked_scan_is_zero():
    scan, mask, poses = _scan_and_poses(2, 100)
    mask[:] = False
    tf, sf = tfl.binary_both_way_counts(
        torch.from_numpy(scan), torch.from_numpy(mask),
        torch.from_numpy(poses), 0.2)
    tf_x, sf_x = jtfl.binary_both_way_counts(
        jnp.asarray(scan), jnp.asarray(mask), jnp.asarray(poses), 0.2)
    assert tf.abs().max() == 0 and sf.abs().max() == 0
    assert np.abs(np.asarray(tf_x)).max() == 0
    assert np.abs(np.asarray(sf_x)).max() == 0


def test_counts_batched_equals_loop_over_cars():
    cars = [_scan_and_poses(seed, 100, s=256, n_valid=nv, p=5)
            for seed, nv in ((3, 256), (4, 120), (5, 0))]
    scan = torch.from_numpy(np.stack([c[0] for c in cars]))
    mask = torch.from_numpy(np.stack([c[1] for c in cars]))
    poses = torch.from_numpy(np.stack([c[2] for c in cars]))
    tf, sf = tfl.binary_both_way_counts(scan, mask, poses, 0.2)
    assert tf.shape == sf.shape == (3, 5)
    for i in range(3):
        tf_i, sf_i = tfl.binary_both_way_counts(scan[i], mask[i], poses[i],
                                                0.2)
        assert torch.equal(tf[i], tf_i) and torch.equal(sf[i], sf_i)
    # the plain version's pose chunking changes nothing
    old = tfl._PLAIN_CHUNK_ELEMS
    tfl._PLAIN_CHUNK_ELEMS = 2 * 100 * 256
    try:
        tf_c, sf_c = tfl.binary_both_way_counts(scan, mask, poses, 0.2)
    finally:
        tfl._PLAIN_CHUNK_ELEMS = old
    assert torch.equal(tf, tf_c) and torch.equal(sf, sf_c)


def test_counts_reject_bad_arguments():
    scan, mask, poses = (torch.from_numpy(a)
                         for a in _scan_and_poses(0, 100, s=64, n_valid=64))
    with pytest.raises(ValueError):
        tfl.binary_both_way_counts(scan[None], mask[None], poses, 0.2)
    with pytest.raises(ValueError):
        tfl.binary_both_way_counts(scan, mask[:32], poses, 0.2)
    with pytest.raises(TypeError):
        tfl.binary_both_way_counts(scan[None].double(), mask[None],
                                   poses[None], 0.2)


def test_pairwise_sq_dists_matches_jax():
    rng = np.random.default_rng(6)
    for k in (3, 7):
        a = rng.normal(size=(2, 40, k)).astype(np.float32)
        b = rng.normal(size=(2, 30, k)).astype(np.float32)
        got = tfl.pairwise_sq_dists(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(jtfl.pairwise_sq_dists(jnp.asarray(a),
                                                 jnp.asarray(b)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


KINDS = ("binary2way", "binary1way", "chamfer", "diffbin", "med1way",
         "medboth", "trimmed")
# the loss_functions keywords, trim at the shipped yaml's 0.3
LOSS_KW = dict(radius=0.2, steepness=10.0, trim=0.3)


def _kind_cases(seed):
    """(scan, mask, posed) cases of tests/test_tfl_loss_dispatch.py's kind
    (templates near the scan): T = 100 and 101 (an even and an odd count
    for med1way's median), a scan with a masked garbage tail, and an
    all-masked scan."""
    rng = np.random.default_rng(seed)
    for t in (100, 101):
        for case in ("full", "masked", "all masked"):
            s = 64
            scan = rng.normal(size=(s, 3)).astype(np.float32)
            mask = np.ones(s, bool)
            if case == "masked":
                mask[40:] = False
                scan[40:] = 77.0
            if case == "all masked":
                mask[:] = False
            posed = (scan[rng.integers(0, s, (5, t))]
                     + rng.normal(scale=0.15, size=(5, t, 3))
                     ).astype(np.float32)
            yield f"T={t} {case}", scan, mask, posed


def _kind_close(kind, label, got, want):
    """The JAX package's float32 loss within 1e-6, relative where the
    all-masked cases reach 1e9 (their sums of BIG)."""
    diff = np.abs(got - want)
    print({"test": "loss kind", "kind": kind, "case": label,
           "max_abs": float(diff.max()),
           "max_rel": float((diff / np.maximum(np.abs(want), 1e-30)).max())})
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["binary1way", "chamfer", "diffbin",
                                  "med1way", "medboth", "trimmed"])
def test_other_loss_kinds_raise(kind):
    """Named for what these kinds did before they were ported: each kind
    of the reference's loss_function dispatch now equals the JAX
    package's ``tfl_loss`` (within 1e-6, relative for the all-masked
    scans' 1e9 sums) on the cases of ``_kind_cases``; an unknown kind
    still raises ValueError."""
    for label, scan, mask, posed in _kind_cases(0):
        want = np.asarray(jtfl.tfl_loss(jnp.asarray(scan), jnp.asarray(mask),
                                        jnp.asarray(posed), kind, **LOSS_KW))
        got = tfl.tfl_loss(torch.from_numpy(scan), torch.from_numpy(mask),
                           torch.from_numpy(posed), kind, **LOSS_KW)
        _kind_close(kind, label, got.numpy(), want)
    scan, mask, poses = (torch.from_numpy(a)
                         for a in _scan_and_poses(0, 100, s=64, n_valid=64))
    with pytest.raises(ValueError):
        tfl.tfl_loss(scan, mask, poses, "nonsense")
    want = np.asarray(jtfl.tfl_loss(jnp.asarray(scan.numpy()),
                                    jnp.asarray(mask.numpy()),
                                    jnp.asarray(poses.numpy()),
                                    "binary2way"))
    got = tfl.tfl_loss(scan, mask, poses, "binary2way")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def _car_scan(seed, template, s=512, on_faces=False):
    """A noisy posed template plus clutter, relative to the car's center,
    padded to ``s``.  ``on_faces`` also puts points exactly on voxel
    faces of the test grid's lattice (multiples of 0.4 m plus its
    origin's offset)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi)
    c, sn = np.cos(th), np.sin(th)
    rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    car = template @ rot.T + rng.normal(scale=0.02, size=template.shape) \
        + np.array([rng.uniform(-1, 1), 0.0, rng.uniform(0, 2)])
    clutter = rng.uniform(-5, 5, (80, 3))
    pts = np.concatenate([car, clutter])
    if on_faces:
        faces = 0.2 + 0.4 * rng.integers(-8, 8, (40, 3))
        pts = np.concatenate([pts, faces])
    pts = pts.astype(np.float32)
    out = np.zeros((s, 3), np.float32)
    mask = np.zeros(s, bool)
    out[:len(pts)] = pts
    mask[:len(pts)] = True
    mask[5:15] = False          # a few holes inside the valid prefix
    return out, mask


@pytest.fixture(scope="module")
def conv_state():
    template = JTemplateBank.default(num_points=300).points[0]
    spec_j, occ_j, memb_j = jfit.make_conv_kernels(
        template, jfit.FitConfig(**GRID))
    spec_t, occ_t, memb_t = fitting.make_conv_kernels(
        template, fitting.FitConfig(**GRID), device="cpu")
    return template, (spec_j, occ_j, memb_j), (spec_t, occ_t, memb_t)


def test_templates_and_conv_kernels_equal_jax_bit_for_bit(conv_state):
    np.testing.assert_array_equal(TemplateBank.default().points,
                                  JTemplateBank.default().points)
    _, (spec_j, occ_j, memb_j), (spec_t, occ_t, memb_t) = conv_state
    assert dataclass_fields(spec_j) == dataclass_fields(spec_t)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    np.testing.assert_array_equal(memb_t.numpy(), np.asarray(memb_j))
    np.testing.assert_array_equal(tfl.conv_translations(spec_t),
                                  jtfl.conv_translations(spec_j))
    np.testing.assert_array_equal(tfl._ball_kernel(0.2, 0.08),
                                  jtfl._ball_kernel(0.2, 0.08))


def dataclass_fields(spec):
    import dataclasses
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("seed,on_faces", [(0, False), (1, True), (2, True)])
def test_occupancy_and_fields_equal_jax(conv_state, seed, on_faces):
    """Counts exactly equal, also for points on voxel faces: the origin
    and the voxel size are rounded to float32 as JAX rounds them."""
    template, (spec_j, _, _), (spec_t, _, _) = conv_state
    pts, mask = _car_scan(seed, template, on_faces=on_faces)
    fspec_j = jtfl.FieldSpec(origin=spec_j.origin, voxel=spec_j.h,
                             shape=(spec_j.x_size, spec_j.y_size,
                                    spec_j.z_size))
    fspec_t = tfl.FieldSpec(origin=spec_t.origin, voxel=spec_t.h,
                            shape=fspec_j.shape)
    want = np.asarray(jtfl.occupancy_histogram(
        jnp.asarray(pts), jnp.asarray(mask), fspec_j))
    got = tfl.occupancy_histogram(torch.from_numpy(pts)[None],
                                  torch.from_numpy(mask)[None], fspec_t)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 300

    counts_j, memb_j = jtfl._conv_fields(jnp.asarray(pts), jnp.asarray(mask),
                                         spec_j)
    counts_t, memb_t = tfl._conv_fields(torch.from_numpy(pts)[None],
                                        torch.from_numpy(mask)[None], spec_t)
    np.testing.assert_array_equal(counts_t[0].numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(memb_t[0].numpy(), np.asarray(memb_j))


def test_conv_fields_dilation_equals_jax_at_fine_voxels():
    """A 5 x 5 x 5 ball (voxel 0.1 m): the port's one 3-D correlation
    against the JAX package's per-dy 2-D convolutions."""
    template = JTemplateBank.default(num_points=300).points[0]
    kw = dict(dx_min=-0.5, dx_max=0.5, dz_min=-0.5, dz_max=0.5, n_dx=11,
              n_dz=11, n_theta=4, radius=0.2, reach=1.0)
    spec_j, spec_t = jtfl.ConvGridSpec(**kw), tfl.ConvGridSpec(**kw)
    pts, mask = _car_scan(3, 0.4 * template)
    counts_j, memb_j = jtfl._conv_fields(jnp.asarray(pts), jnp.asarray(mask),
                                         spec_j)
    counts_t, memb_t = tfl._conv_fields(torch.from_numpy(pts)[None],
                                        torch.from_numpy(mask)[None], spec_t)
    np.testing.assert_array_equal(counts_t[0].numpy(), np.asarray(counts_j))
    np.testing.assert_array_equal(memb_t[0].numpy(), np.asarray(memb_j))
    assert 0 < float(memb_t.sum()) < memb_t.numel()


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_pose_losses_conv_match_jax(conv_state, seed):
    template, (spec_j, occ_j, memb_j), (spec_t, occ_t, memb_t) = conv_state
    cars = [_car_scan(10 * seed + i, template) for i in range(2)]
    pts = np.stack([c[0] for c in cars])
    mask = np.stack([c[1] for c in cars])
    count_t, count_s = tfl.grid_pose_counts_conv(
        torch.from_numpy(pts), torch.from_numpy(mask), occ_t, memb_t, spec_t)
    # integer counts, exactly
    assert torch.equal(count_t, count_t.round())
    assert torch.equal(count_s, count_s.round())
    got = tfl.grid_pose_losses_conv(torch.from_numpy(pts),
                                    torch.from_numpy(mask), occ_t, memb_t,
                                    spec_t, template.shape[0])
    assert got.shape == (2, 8, spec_t.n_dx * spec_t.n_dz)
    for i in range(2):
        want = np.asarray(jtfl.grid_pose_losses_conv(
            jnp.asarray(pts[i]), jnp.asarray(mask[i]), occ_j, memb_j, spec_j,
            template.shape[0]))
        np.testing.assert_allclose(got[i].numpy(), want, atol=1e-6)
        # the counts behind the JAX losses are the port's: the losses
        # differ only in how XLA rounds count / T + count / n
        n_scan = np.float32(mask[i].sum())
        exact = -(count_t[i].numpy().astype(np.float64) / template.shape[0]
                  + count_s[i].numpy().astype(np.float64) / n_scan)
        np.testing.assert_allclose(want, exact.reshape(8, -1), atol=2.5e-7)
        print({"test": "grid_pose_losses_conv", "car": i,
               "max_abs_diff": float(np.abs(got[i].numpy() - want).max()),
               "cells_differing": float((got[i].numpy() != want).mean())})


def test_float32_origin_decides_voxels_on_faces():
    """Why ``occupancy_histogram`` rounds the origin and the voxel size to
    float32 first, as JAX does: at the full grid (voxel 0.1 m, origin
    -4.35 m) points on voxel faces land in another voxel when the origin
    stays in float64, and a product with the reciprocal moves some too."""
    spec = tfl.ConvGridSpec.aligned(-2, 2, -1, 3, 40, 40, 40, 0.2)
    spec_j = jtfl.ConvGridSpec.aligned(-2, 2, -1, 3, 40, 40, 40, 0.2)
    fshape = (spec.x_size, spec.y_size, spec.z_size)
    rng = np.random.default_rng(0)
    cells = np.stack([rng.integers(0, n, 4000) for n in fshape], 1)
    on_faces = (np.array(spec.origin) + cells * spec.h).astype(np.float32)
    origin32 = np.array(spec.origin, np.float32)
    idx32 = np.floor((on_faces - origin32) / np.float32(spec.h))
    idx64 = np.floor((on_faces.astype(np.float64) - np.array(spec.origin))
                     / spec.h)
    moved = float((idx32 != idx64).any(1).mean())
    rand = rng.uniform(-4, 4, (200000, 3)).astype(np.float32)
    by_div = np.floor((rand - origin32) / np.float32(spec.h))
    by_mul = np.floor((rand - origin32) * np.float32(1 / spec.h))
    print({"test": "origin rounding", "on_face_points_moved_by_float64":
           moved, "random_points_moved_by_reciprocal":
           float((by_div != by_mul).any(1).mean())})
    assert moved > 0.5
    mask = np.ones(len(on_faces), bool)
    want = np.asarray(jtfl.occupancy_histogram(
        jnp.asarray(on_faces), jnp.asarray(mask),
        jtfl.FieldSpec(origin=spec_j.origin, voxel=spec_j.h, shape=fshape)))
    got = tfl.occupancy_histogram(
        torch.from_numpy(on_faces)[None], torch.from_numpy(mask)[None],
        tfl.FieldSpec(origin=spec.origin, voxel=spec.h, shape=fshape))[0]
    np.testing.assert_array_equal(got.numpy(), want)



@pytest.mark.parametrize("kind", KINDS)
def test_loss_kinds_batched_and_chunked_match_jax(kind, monkeypatch):
    """Every kind in the batched form (two cars of (P, T, 3) poses) with
    chunks of 3 poses: each car's losses equal the JAX package's
    single-car ``tfl_loss`` (within 1e-6)."""
    monkeypatch.setattr(tfl, "_PLAIN_CHUNK_ELEMS", 3 * 101 * 64)
    cases = list(_kind_cases(1))
    # T = 101: a masked scan and an all-masked one
    (la, scan_a, mask_a, pa), (lb, scan_b, mask_b, pb) = cases[4], cases[5]
    got = tfl.tfl_loss(torch.from_numpy(np.stack([scan_a, scan_b])),
                       torch.from_numpy(np.stack([mask_a, mask_b])),
                       torch.from_numpy(np.stack([pa, pb])), kind, **LOSS_KW)
    assert got.shape == (2, 5)
    for i, (label, scan, mask, posed) in enumerate(
            ((la, scan_a, mask_a, pa), (lb, scan_b, mask_b, pb))):
        want = np.asarray(jtfl.tfl_loss(jnp.asarray(scan), jnp.asarray(mask),
                                        jnp.asarray(posed), kind, **LOSS_KW))
        _kind_close(kind, label, got[i].numpy(), want)