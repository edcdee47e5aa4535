"""``use_add_data`` in the torch port against the JAX package: the car
payload of the dataset, the Template-Fitting and silhouette-mask auxiliary
losses, one train step with them, and the epoch loop.

Tolerances: 2e-4 of each tensor's largest magnitude for losses and
gradients (tests/test_criterion_reference_parity.py:226, as in
tests/test_torch_train_step.py); arrays of the dataset and the mask warp
exactly equal.  Inputs are seeded numpy; the loss tests put the predicted
boxes near the cars, so that the two-way sigmoid is not saturated and the
gradients are not zero.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from monosowa_tpu.data.kitti_dataset import \
    KittiDetectionDataset as JaxKittiDataset
from monosowa_tpu.models import criterion as jax_crit
from monosowa_tpu.models import mask_aux as jax_mask
from monosowa_tpu.models import tfl_aux as jax_tfl
from monosowa_tpu.models.matcher import MatcherConfig as JaxMatcherConfig
from monosowa_tpu.models.monodetr import MonoDETR as JaxMonoDETR
from monosowa_tpu.train import trainer as jax_trainer
from monosowa_tpu_torch.convert import _torch_name
from monosowa_tpu_torch.data.affine import (get_affine_transform,
                                            warp_affine_nearest)
from monosowa_tpu_torch.data.kitti_dataset import (KittiDetectionDataset,
                                                   collate)
from monosowa_tpu_torch.models import criterion as crit
from monosowa_tpu_torch.models import mask_aux, tfl_aux
from monosowa_tpu_torch.models.matcher import MatcherConfig
from monosowa_tpu_torch.models.monodetr import MonoDETR
from monosowa_tpu_torch.sowa.cache import save_optimized_cars
from monosowa_tpu_torch.sowa.templates import TemplateBank
from monosowa_tpu_torch.train import optim, trainer
from monosowa_tpu_torch.train.sample import (SampleDataset, sample_batch,
                                             write_sample_cars,
                                             write_sample_labels)
from test_torch_train import _one_torch_thread  # noqa: F401 (autouse)
from test_torch_train import (B, H, MODEL_INPUTS, TINY, TOL, W, _close,
                              _flax_paths, _jax_layout, _jax_variables,
                              _port_model)
from test_torch_train_step import _JaxDepthEncoderNoDropout, _no_dropout
from test_torch_train_val import kitti_root  # noqa: F401 (fixture)

P2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
               [0, 0, 1, 0.003]], np.float32)


def _t(a, grad=False):
    t = torch.from_numpy(np.asarray(a))
    return t.requires_grad_() if grad else t


def _cars(rng, centers, p=64, n_masked=10):
    """(C, P, 3) clouds of about a car's size around ``centers``, the last
    ``n_masked`` points of each padding."""
    c = len(centers)
    pts = (np.asarray(centers)[:, None, :]
           + rng.normal(0, [0.8, 0.5, 1.8], (c, p, 3))).astype(np.float32)
    pmask = np.ones((c, p), bool)
    pmask[:, p - n_masked:] = False
    pts[~pmask] = 0.0
    return pts, pmask


def _boxes7(rng, centers, k):
    """k predicted boxes near the cars (x, y, z within 0.6 m, dims near a
    car's, ry anywhere); the last one 20 m away from every car."""
    ctr = np.asarray(centers)[rng.integers(0, len(centers), k)]
    b = np.concatenate([ctr + rng.normal(0, 0.3, (k, 3)),
                        rng.uniform([1.3, 1.4, 3.5], [1.7, 1.8, 4.3],
                                    (k, 3)),
                        rng.uniform(-np.pi, np.pi, (k, 1))], 1)
    b[-1, :3] += 20.0
    return b.astype(np.float32)


def _templates(t=40):
    bank = TemplateBank.default()
    pts = np.asarray(bank.points)[:, ::1000 // t][:, :t].astype(np.float32)
    l, w, h = (float(v) for v in bank.dims_lwh)
    return pts, np.array([h, w, l], np.float32)


# ---------------------------------------------------------------------------
# tfl_aux and mask_aux
# ---------------------------------------------------------------------------

def test_tfl_templates_equal_jax():
    got_pts, got_dims = trainer._tfl_templates(torch.device("cpu"))
    want_pts, want_dims = jax_trainer._tfl_templates()
    assert got_pts.shape == (4, 256, 3)
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))
    np.testing.assert_array_equal(got_dims.numpy(), np.asarray(want_dims))


def test_pose_templates_matches_jax():
    rng = np.random.default_rng(0)
    tmpl, dims = _templates()
    boxes = _boxes7(rng, [[0.0, 1.0, 12.0]], 6)
    detach = np.array([True, False] * 3)
    wts = rng.normal(size=(6, 4, tmpl.shape[1], 3)).astype(np.float32)

    def jf(bx):
        return jnp.sum(jax_tfl.pose_templates(bx, tmpl, dims, detach) * wts)

    want, want_g = jax.value_and_grad(jf)(jnp.asarray(boxes))
    tb = _t(boxes, True)
    got = (tfl_aux.pose_templates(tb, _t(tmpl), _t(dims), _t(detach))
           * _t(wts)).sum()
    got.backward()
    _close(float(got.detach()), float(want), TOL, "pose_templates")
    _close(tb.grad.numpy(), np.asarray(want_g), TOL, "pose_templates grad")
    # dims are detached; the rotation only where not detached
    assert (tb.grad[:, 3:6] == 0).all() and (tb.grad[0::2, 6] == 0).all()
    assert (tb.grad[1::2, 6] != 0).all()


@pytest.mark.parametrize("moving", [False, True])
def test_loss_tfl_aux_matches_jax(moving):
    rng = np.random.default_rng(1 + moving)
    centers = [[-3.0, 1.0, 14.0], [2.5, 0.9, 22.0], [0.0, 1.1, 30.0]]
    pts, pmask = _cars(rng, centers)
    valid = np.array([True, True, False])
    car_moving = np.array([moving, False, True])
    boxes = _boxes7(rng, centers, 8)
    matched = np.array([True] * 6 + [False, True])
    tmpl, dims = _templates()
    args = (pts, pmask, valid, car_moving, tmpl, dims)

    want, want_g = jax.value_and_grad(
        lambda bx: jax_tfl.loss_tfl_aux(bx, matched, *args))(
        jnp.asarray(boxes))
    tb = _t(boxes, True)
    got = tfl_aux.loss_tfl_aux(tb, _t(matched), *[_t(a) for a in args])
    got.backward()
    assert 0 < float(want) < 10
    _close(float(got.detach()), float(want), TOL,
           f"loss_tfl_aux moving={moving}")
    _close(tb.grad.numpy(), np.asarray(want_g), TOL,
           f"loss_tfl_aux moving={moving} grad")
    assert np.abs(np.asarray(want_g)[:6, :3]).max() > 0
    assert (tb.grad[6:] == 0).all()     # unmatched and far: no gradient


@pytest.mark.parametrize("flip", [False, True])
def test_decode_pred_boxes7_matches_jax(flip):
    rng = np.random.default_rng(3)
    k = 7
    heads = [rng.uniform(0.1, 0.9, (k, 6)), rng.uniform(5, 40, (k, 2)),
             rng.uniform(1.2, 4.0, (k, 3)), rng.normal(size=(k, 24))]
    heads = [h.astype(np.float32) for h in heads]
    center = np.array([610.0, 190.0])
    trans, trans_inv = get_affine_transform(center, np.array([1180., 360.]),
                                            0, np.array([1280, 384]), inv=1)
    fixed = (P2, np.array([1280.0, 384.0], np.float32), np.float32(0.69),
             np.zeros(3, np.float32), trans_inv.astype(np.float32),
             np.bool_(flip), np.float32(1242.0))
    wts = rng.normal(size=(k, 7)).astype(np.float32)

    def jf(*h):
        return jnp.sum(jax_tfl.decode_pred_boxes7(*h, *fixed) * wts)

    want = jax_tfl.decode_pred_boxes7(*heads, *fixed)
    want_g = jax.grad(jf, argnums=(0, 1, 2, 3))(*heads)
    th = [_t(h, True) for h in heads]
    got = tfl_aux.decode_pred_boxes7(*th, *[_t(a) for a in fixed])
    (got * _t(wts)).sum().backward()
    _close(got.detach().numpy(), np.asarray(want), TOL,
           f"decode_pred_boxes7 flip={flip}")
    for name, t, g in zip(("boxes", "depth", "dims", "angle"), th, want_g):
        _close(t.grad.numpy(), np.asarray(g), TOL,
               f"decode_pred_boxes7 flip={flip} d{name}")


def test_gather_matched_queries_matches_jax():
    """The first k matched queries in query order: with groups, the first
    groups only (a stable sort of ~matched)."""
    rng = np.random.default_rng(4)
    for q, k in ((110, 32), (20, 32), (50, 8)):
        idx = np.where(rng.random(q) < 0.3, rng.integers(0, 9, q), -1)
        want_i, want_v = jax_tfl.gather_matched_queries(jnp.asarray(idx), k)
        got_i, got_v = tfl_aux.gather_matched_queries(_t(idx), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("kind", ["BCE", "DICE"])
def test_splat_and_mask_loss_match_jax(kind):
    rng = np.random.default_rng(5)
    tmpl, _ = _templates(64)
    pts = (tmpl[0][None] + rng.normal([0.0, 1.0, 15.0], 0.5, (5, 1, 3))
           ).astype(np.float32)
    affine = np.array([[0.125, 0, 0], [0, 0.125, 0]], np.float32)
    target = (rng.random((5, 12, 20)) < 0.3).astype(np.float32)
    valid = np.array([True, True, False, True, True])

    def jf(p):
        sil = jax_mask.splat_silhouette(p, P2, affine, 12, 20, 1.5)
        return jax_mask.mask_loss(sil, target, valid, kind), sil

    (want, want_sil), want_g = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(pts))
    tp = _t(pts, True)
    sil = mask_aux.splat_silhouette(tp, _t(P2), _t(affine), 12, 20, 1.5)
    got = mask_aux.mask_loss(sil, _t(target), _t(valid), kind)
    got.backward()
    _close(sil.detach().numpy(), np.asarray(want_sil), TOL,
           "splat_silhouette")
    _close(float(got.detach()), float(want), TOL, f"mask_loss {kind}")
    _close(tp.grad.numpy(), np.asarray(want_g), TOL, f"mask_loss {kind} grad")
    with pytest.raises(ValueError):
        mask_aux.mask_loss(sil, _t(target), _t(valid), "L1")


# ---------------------------------------------------------------------------
# _add_data_losses and the criterion
# ---------------------------------------------------------------------------

def _layer_and_add_data(seed, q=12, flip=False):
    """One decoder layer's heads whose matched queries decode near the cars
    of a 2-image payload (through the identity affine at 640 x 384 or the
    flip), and the payload."""
    rng = np.random.default_rng(seed)
    res = np.array([640.0, 384.0], np.float32)
    tmpl, dims = _templates(48)
    b, c, p, hm, wm = 2, 3, 64, 48, 80
    centers = np.array([[[-4.0, 1.0, 14.0], [3.0, 0.9, 20.0],
                         [0.0, 1.1, 9.0]]] * b)
    centers[1, :, 0] *= -1
    points = np.zeros((b, c, p, 3), np.float32)
    pmask = np.zeros((b, c, p), bool)
    for i in range(b):
        points[i], pmask[i] = _cars(rng, centers[i], p)
    masks = (rng.random((b, c, hm, wm)) < 0.2).astype(np.float32)
    masks[0, 2] = 0.0                         # a car without a mask
    img_w = np.full(b, 640.0, np.float32)
    flips = np.array([flip, False])
    # heads: queries at the cars' projections, depth and dims near theirs
    boxes = rng.uniform(0.02, 0.06, (b, q, 6)).astype(np.float32)
    depth = np.stack([rng.uniform(8, 25, (b, q)), rng.normal(0, .3, (b, q))],
                     -1).astype(np.float32)
    for i in range(b):
        for j in range(q):
            x, y, z = centers[i, j % c] + rng.normal(0, 0.4, 3)
            u = P2[0, 0] * x / z + P2[0, 2]
            if flips[i]:
                u = img_w[i] - u
            boxes[i, j, :2] = (u / res[0], (P2[1, 1] * y / z + P2[1, 2])
                               / res[1])
            depth[i, j, 0] = z
    out = {"pred_boxes": boxes, "pred_depth": depth,
           "pred_3d_dim": rng.uniform([1.3, 1.4, 3.5], [1.7, 1.8, 4.3],
                                      (b, q, 3)).astype(np.float32),
           "pred_angle": rng.normal(size=(b, q, 24)).astype(np.float32)}
    match_idx = np.where(rng.random((b, q)) < 0.7, rng.integers(0, 5, (b, q)),
                         -1).astype(np.int32)
    ident = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
                    (b, 1, 1))
    add = dict(car_points=points, car_pmask=pmask,
               car_valid=np.array([[True, True, True], [True, True, False]]),
               car_moving=np.array([[False, True, False]] * b),
               car_masks=masks, calib=np.tile(P2, (b, 1, 1)),
               resolution=res, canonical_scale=np.ones(b, np.float32),
               trans=ident, trans_inv=ident, flip=flips, img_w=img_w,
               templates=tmpl, template_dims_hwl=dims)
    return out, match_idx, add


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,flip,on", [
    ("BCE", False, "both"), ("DICE", True, "both"), ("BCE", True, "tfl"),
    ("BCE", False, "mask")])
def test_add_data_losses_match_jax(kind, flip, on, dtype):
    """The loss values in float32 and float64; the gradients held in
    float64 and reported in float32.  The float32 gradient of the BCE
    silhouette loss is ill-conditioned (log(1 - sil + 1e-6) where a soft
    OR of many gaussians is near 1): at these inputs the JAX package's own
    float32 gradient is 2e-3 of its scale off its float64 one, and the
    port's differs from it by as much, while in float64 the two packages
    agree within 6e-7."""
    out, match_idx, add = _layer_and_add_data(11, flip=flip)
    f64 = dtype == "float64"
    if f64:
        out, add = ({k: v.astype(np.float64) if v.dtype == np.float32 else v
                     for k, v in d.items()} for d in (out, add))
    flags = dict(use_tfl=on != "mask", use_mask_loss=on != "tfl",
                 mask_kind=kind, tfl_gather_k=8)
    with jax.enable_x64(f64):
        jcfg = jax_crit.CriterionConfig(**flags)
        jadd = jax_crit.AddData(**{k: jnp.asarray(v) for k, v in add.items()})

        def jf(o):
            d = jax_crit._add_data_losses(o, jnp.asarray(match_idx), jadd,
                                          jcfg)
            return sum(d.values()), d

        (_, want), want_g = jax.value_and_grad(jf, has_aux=True)(
            {k: jnp.asarray(v) for k, v in out.items()})
        want = {k: float(v) for k, v in want.items()}
        want_g = {k: np.asarray(v) for k, v in want_g.items()}
    t_out = {k: _t(v, True) for k, v in out.items()}
    got = crit._add_data_losses(t_out, _t(match_idx).long(),
                                crit.AddData(**{k: _t(v)
                                                for k, v in add.items()}),
                                crit.CriterionConfig(**flags))
    sum(got.values()).backward()
    what = f"{on} {kind} flip={flip} {dtype}"
    assert sorted(got) == sorted(want)
    for k in want:
        assert want[k] > 0, k
        _close(float(got[k].detach()), want[k], TOL, f"{k} {what}")
    for k, g in want_g.items():
        got_g = t_out[k].grad.numpy()
        if f64:
            _close(got_g, g, TOL, f"d{k} of {what}")
        else:
            scale = max(float(np.abs(g).max()), 1e-12)
            print(json.dumps({"port_vs_jax": f"d{k} of {what}, reported",
                              "max_rel": float(np.abs(got_g - g).max())
                              / scale}))
    assert np.abs(want_g["pred_depth"]).max() > 0


def test_criterion_with_add_data_on_every_layer_matches_jax():
    """criterion(..., add_data=...) adds loss_tfl / loss_mask to the final
    layer and, with tfl_on_aux, to each aux layer, weighted into
    loss_total by tfl_loss_coef / mask_loss_coef."""
    from test_torch_train import _batch_with_edges, _random_outputs

    rng = np.random.default_rng(12)
    q = TINY["num_queries"] * TINY["group_num"]
    out = _random_outputs(rng, q)
    layer, _, add = _layer_and_add_data(12, q=q, flip=True)
    for o in [out] + out["aux_outputs"]:
        o.update({k: v + rng.normal(0, 1e-3, v.shape).astype(np.float32)
                  for k, v in layer.items()})
    batch = _batch_with_edges(12)
    flags = dict(group_num=TINY["group_num"], num_queries=TINY["num_queries"],
                 num_classes=3, use_tfl=True, use_mask_loss=True,
                 tfl_gather_k=8, w_tfl=0.7, w_mask=1.3)
    want = jax_crit.criterion(
        jax.tree_util.tree_map(jnp.asarray, out),
        jax_trainer.targets_from_batch(
            {k: jnp.asarray(a) for k, a in batch.items()}),
        jax_crit.CriterionConfig(matcher=JaxMatcherConfig(backend="jv"),
                                 **flags),
        add_data=jax_crit.AddData(**{k: jnp.asarray(v)
                                     for k, v in add.items()}))
    got = crit.criterion(
        jax.tree_util.tree_map(torch.from_numpy, out),
        trainer.targets_from_batch(batch, torch.device("cpu")),
        crit.CriterionConfig(matcher=MatcherConfig(backend="jv"), **flags),
        add_data=crit.AddData(**{k: _t(v) for k, v in add.items()}))
    assert sorted(got) == sorted(want)
    assert {"loss_tfl", "loss_mask", "loss_tfl_0", "loss_mask_0"} <= set(got)
    for k in sorted(want):
        _close(float(got[k]), float(want[k]), TOL, f"criterion {k}")


def test_criterion_config_from_yaml_reads_the_aux_losses():
    """A model yaml with non-default aux-loss keys: every field of the
    port's config, the matcher's too, as the JAX package reads it."""
    mcfg = {"use_tfl": True, "use_mask_loss": True, "tfl_loss_coef": 0.25,
            "mask_loss_coef": 3, "mask_loss": "DICE", "cls_loss_coef": 3,
            "focal_alpha": 0.3, "depth_max": 70.0}
    want = jax_trainer.criterion_config_from_yaml(JaxMonoDETR(**TINY), mcfg)
    got = trainer.criterion_config_from_yaml(MonoDETR(device="cpu", **TINY),
                                             mcfg)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        w, g = getattr(want, field.name), getattr(got, field.name)
        if field.name == "matcher":
            w, g = dataclasses.asdict(w), dataclasses.asdict(g)
        assert g == w, field.name
    assert (got.w_tfl, got.w_mask, got.mask_kind) == (0.25, 3.0, "DICE")
    assert got.matcher.backend == "jv"


# ---------------------------------------------------------------------------
# the dataset's payload and the mask warp
# ---------------------------------------------------------------------------

IMG_W, IMG_H = 1242, 375


@pytest.fixture(scope="module")
def kitti_dir_with_cars(tmp_path_factory):
    """One KITTI frame with a labelled car, and a cache of three fitted
    cars for it (one of 1,000 points to subsample, one moving, one without
    a mask), at the image's resolution."""
    root = tmp_path_factory.mktemp("kitti_add")
    for sub in ("image_2", "calib", "label_2"):
        (root / "training" / sub).mkdir(parents=True)
    fid = "000007"
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (IMG_H, IMG_W, 3), np.uint8)).save(
        root / "training" / "image_2" / f"{fid}.png")
    p2l = " ".join(str(v) for v in P2.reshape(-1))
    (root / "training" / "calib" / f"{fid}.txt").write_text(
        f"P0: {p2l}\nP1: {p2l}\nP2: {p2l}\nP3: {p2l}\n"
        "R0_rect: 1 0 0 0 1 0 0 0 1\n"
        "Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    (root / "training" / "label_2" / f"{fid}.txt").write_text(
        "Car 0.00 0 -1.40 500.00 160.00 620.00 220.00 "
        "1.52 1.63 3.88 -1.50 1.70 25.00 -1.46\n")
    (root / "ImageSets").mkdir()
    (root / "ImageSets" / "train.txt").write_text(fid + "\n")
    bank = TemplateBank.default()
    masks = []
    for y0, x0, hh, ww in ((160, 500, 60, 120), (150, 40, 90, 200)):
        m = np.zeros((IMG_H, IMG_W), bool)
        m[y0:y0 + hh, x0:x0 + ww] = True
        m[y0 + 5, x0 + 7] = False
        masks.append(m)
    cars = [{"points": bank.points[0] + np.float32([-1.5, 0.9, 25.0]),
             "mask": masks[0], "moving": False, "theta": 0.3},
            {"points": rng.normal(size=(200, 3)).astype(np.float32),
             "mask": masks[1], "moving": True, "theta": -1.0},
            {"points": rng.normal(size=(30, 3)).astype(np.float32),
             "mask": None, "moving": False, "theta": 0.0}]
    save_optimized_cars(str(root / "adddata" / "optimized_cars"), fid, cars)
    return str(root)


@pytest.mark.parametrize("flip,crop", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_load_add_data_equals_jax(kitti_dir_with_cars, flip, crop):
    """The whole sample, car payload included, equal array for array with
    the JAX dataset's under flip and crop / scale (np.random seeded alike;
    ``hash(idx)`` is the same within one process)."""
    cfg = {"use_add_data": True,
           "add_data_path": os.path.join(kitti_dir_with_cars, "adddata"),
           "add_data_points": 256, "max_add_cars": 4, "add_mask_stride": 8,
           "random_flip": float(flip), "aug_crop": crop,
           "random_crop": float(crop), "use_canonical_module": True}
    ours = KittiDetectionDataset(kitti_dir_with_cars, "train", cfg)
    theirs = JaxKittiDataset(kitti_dir_with_cars, "train", cfg)
    for seed in (0, 1):
        np.random.seed(seed)
        got = ours[0]
        np.random.seed(seed)
        want = theirs[0]
        assert bool(got["flip_flag"]) == flip
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["car_masks"].shape == (4, 48, 160)
        assert got["car_masks"][:2].any(axis=(1, 2)).all()
        assert not got["car_masks"][2].any() and got["car_valid"][:3].all()
        assert got["car_pmask"][0].all() and got["car_pmask"][2].sum() == 30


def _pil_warp(img, size, coeffs):
    return np.asarray(Image.fromarray(img).transform(
        size, Image.AFFINE, data=tuple(coeffs), resample=Image.NEAREST))


def test_numpy_mask_warp_equals_pil():
    """``warp_affine_nearest`` against PIL 12's ``Image.transform`` (AFFINE,
    NEAREST), pixel for pixel: scale-only affines (PIL's scaling path),
    rotations and shears near the image (its 16.16 fixed-point path) and
    far off it (its float path), and the dataset's own flip / crop / scale
    affines."""
    rng = np.random.default_rng(0)
    cases = []
    for k in range(60):
        h, w = int(rng.integers(5, 200)), int(rng.integers(5, 700))
        img = ((rng.random((h, w)) > 0.5) * 255).astype(np.uint8)
        size = (int(rng.integers(8, 700)), int(rng.integers(8, 200)))
        kind = ("scale", "fixed", "float")[k % 3]
        if kind == "scale":
            a = [rng.uniform(-3, 3), 0.0, rng.uniform(-100, 800), 0.0,
                 rng.uniform(0.2, 3), rng.uniform(-50, 50)]
        else:
            off = 50.0 if kind == "fixed" else 5e4
            a = list(rng.normal(size=6) * [1, .3, off, .3, 1, off])
        cases.append((f"{kind} {k}", img, size, a))
    for k in range(24):
        img_size = np.array([IMG_W, IMG_H], np.float64)
        img = np.zeros((IMG_H, IMG_W), np.uint8)
        y0, x0 = rng.integers(0, IMG_H - 20), rng.integers(0, IMG_W - 40)
        img[y0:y0 + rng.integers(1, 60), x0:x0 + rng.integers(1, 200)] = 255
        center, crop_size = img_size / 2.0, img_size.copy()
        if k % 2:
            s = float(np.clip(rng.normal() * 0.05 + 1, 0.95, 1.05))
            crop_size = img_size * s
            center += img_size * np.clip(rng.normal(size=2) * .05, -.1, .1)
        if k % 4 > 1:
            img = img[:, ::-1].copy()
        _, trans_inv = get_affine_transform(center, crop_size, 0,
                                            np.array([1280, 384]), inv=1)
        cases.append((f"dataset {k}", img, (1280, 384),
                      trans_inv.reshape(-1).tolist()))
    for name, img, size, a in cases:
        got = warp_affine_nearest(img, size, a)
        want = _pil_warp(img, size, a)
        assert got.shape == want.shape, name
        diff = int((got != want).sum())
        assert diff == 0, f"{name}: {diff} pixels differ from PIL"


def test_sample_dataset_payload_equals_jax_loader(tmp_path):
    """SampleDataset with use_add_data reads write_sample_cars' cache
    through the identity affine: the JAX dataset's ``_load_add_data`` (its
    PIL warp) on the same cache and affine gives the same arrays."""
    cfg = {"resolution": [160, 96], "use_add_data": True,
           "add_data_path": str(tmp_path), "add_data_points": 128,
           "max_add_cars": 4, "add_mask_stride": 8}
    ds = SampleDataset(3, cfg)
    write_sample_cars(str(tmp_path), ds)
    for item in range(3):
        got = ds[item]
        want = JaxKittiDataset._load_add_data(ds, ds.idx_list[item],
                                              got["trans_inv"].astype(
                                                  np.float64))
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert got["car_valid"].sum() == 3 and got["car_masks"].any()
        assert got["car_moving"].tolist() == [False, True, False, False]


# ---------------------------------------------------------------------------
# one train step with add data, and the epoch loop
# ---------------------------------------------------------------------------

def _add_batch(b, h, w, seed=0):
    """sample_batch plus a car payload: per image two cars of 64 template
    points near the synthetic targets, one moving, and masks."""
    batch = sample_batch(b, h, w, seed=seed)
    rng = np.random.default_rng(seed + 10)
    tmpl, _ = _templates(64)
    c, p = 3, 64
    pts = np.zeros((b, c, p, 3), np.float32)
    for i in range(b):
        for k in range(2):
            pts[i, k] = tmpl[k] + rng.uniform([-3, 0.5, 8], [3, 1.5, 25])
    masks = np.zeros((b, c, h // 8, w // 8), np.float32)
    masks[:, :2, 4:8, 6:14] = 1.0
    ident = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
                    (b, 1, 1))
    batch.update(car_points=pts,
                 car_pmask=np.ones((b, c, p), bool),
                 car_valid=np.tile([True, True, False], (b, 1)),
                 car_moving=np.tile([False, True, False], (b, 1)),
                 car_masks=masks, trans=ident, trans_inv=ident,
                 flip_flag=np.zeros(b, bool),
                 canonical_scale=np.ones(b, np.float32))
    return batch


@pytest.fixture(scope="module", params=["jv", "auction"])
def add_step_run(request):
    """One train step with TFL and mask losses from the same weights and
    batch in both packages, dropout off: the JAX trainer's loss under
    value_and_grad (as tests/test_add_data_wiring.py:239 builds it) and the
    port's forward, criterion and backward, both in float64 (JAX under
    ``jax.enable_x64``), as tests/test_torch_train_step.py holds every
    gradient.  In float32 the silhouette's BCE is ill-conditioned where the
    random model's splats are near 0 or 1 (d log(sil + 1e-6) / d sil up to
    1e6): loss_mask then differs by 2.6e-3 of itself between the packages,
    as it differs between float32 and float64 within each.  The port's
    ``make_train_step`` also takes the step in float32 from the same
    weights: its loss dict must agree with the float64 one but for the
    mask losses (reported).  The port's matcher solves float32 costs in
    every mode, as the JAX package's JV solver does (``cost.T.astype(
    jnp.float32)``); its auction would run in float64 under x64, so here
    it runs as it runs without x64: on the float32 cost, its prices and
    bids in float32 (under x64 its ``jnp.zeros`` would make them float64,
    and its epsilon-optimal assignment another)."""
    backend = request.param
    batch = _add_batch(B, H, W)
    batch64 = {k: a.astype(np.float64) if a.dtype == np.float32 else a
               for k, a in batch.items()}
    flags = dict(group_num=TINY["group_num"], num_queries=TINY["num_queries"],
                 num_classes=3, use_tfl=True, use_mask_loss=True,
                 tfl_gather_k=8)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        from monosowa_tpu.models import depth_predictor as jax_dp
        from monosowa_tpu.models import matcher as jax_matcher
        mp.setattr(jax_dp, "DepthEncoderLayer", _JaxDepthEncoderNoDropout)
        auction = jax_matcher.solve_lap_auction

        def auction_f32(c, m):
            with jax.enable_x64(False):
                return auction(c.astype(jnp.float32), m)

        mp.setattr(jax_matcher, "solve_lap_auction", auction_f32)
        jm = JaxMonoDETR(msda_backend="xla", dropout=0.0,
                         compute_dtype="float64", **TINY)
        v = _jax_variables(jm, batch)
        jv = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        jbatch = {k: jnp.asarray(a) for k, a in batch64.items()}
        targets = jax_trainer.targets_from_batch(jbatch)
        tmpl, dims = jax_trainer._tfl_templates()
        jadd = jax_trainer.add_data_from_batch(
            jbatch, jnp.asarray(tmpl, jnp.float64),
            jnp.asarray(dims, jnp.float64))
        ccfg = jax_crit.CriterionConfig(
            matcher=JaxMatcherConfig(backend=backend), **flags)

        def loss_fn(params):
            out = jm.apply({"params": params, "frozen": jv["frozen"]},
                           *[jbatch[k] for k in MODEL_INPUTS], training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
            losses = jax_crit.criterion(out, targets, ccfg, training=True,
                                        add_data=jadd)
            return losses["loss_total"], losses

        (_, j_losses), j_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(jv["params"])
        j_losses = {k: float(x) for k, x in j_losses.items()}
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)

    pcfg = crit.CriterionConfig(matcher=MatcherConfig(backend=backend),
                                **flags)
    dev = torch.device("cpu")
    tm = _no_dropout(_port_model(v, dropout=0.0))
    f32_losses = trainer.make_train_step(
        tm, pcfg, optim.make_optimizer(tm, 0.0, 0.0))(batch)
    tm = _no_dropout(_port_model(v, dropout=0.0)).double()
    tm.train()
    t_tmpl, t_dims = trainer._tfl_templates(dev)
    t_targets = trainer.targets_from_batch(batch64, dev)
    t_targets = crit.Targets(*[t.double() if t.is_floating_point() else t
                               for t in t_targets])
    add = trainer.add_data_from_batch(batch64, t_tmpl.double(),
                                      t_dims.double(), dev)
    add = crit.AddData(*[t.double() if t.is_floating_point() else t
                         for t in add])
    losses = crit.criterion(
        tm(*[torch.from_numpy(batch64[k]) for k in MODEL_INPUTS]),
        t_targets, pcfg, training=True, add_data=add)
    losses["loss_total"].backward()
    t_losses = {k: float(x.detach()) for k, x in losses.items()}
    t_grads = {n: p.grad.numpy() for n, p in tm.named_parameters()
               if p.grad is not None}
    return dict(model=tm, backend=backend, j_losses=j_losses,
                t_losses=t_losses, f32_losses=f32_losses, j_grads=j_grads,
                t_grads=t_grads)


def test_add_data_step_losses_match_jax(add_step_run):
    run = add_step_run
    t, j, f32 = run["t_losses"], run["j_losses"], run["f32_losses"]
    assert sorted(t) == sorted(j)
    assert sorted(f32) == sorted(list(j) + ["grad_norm"])
    for k in ("loss_tfl", "loss_mask", "loss_tfl_0", "loss_mask_0"):
        assert np.isfinite(t[k]) and t[k] > 0, k
    for k in sorted(j):
        _close(t[k], j[k], TOL, f"add-data step {run['backend']} {k}")
        if k.startswith("loss_mask") or k == "loss_total":
            print(json.dumps({"port_vs_jax": f"add-data step float32 "
                              f"{run['backend']} {k}, reported",
                              "max_rel": abs(f32[k] - j[k]) / abs(j[k])}))
        else:
            _close(f32[k], j[k], TOL,
                   f"add-data step float32 {run['backend']} {k}")


def test_add_data_step_gradients_match_jax(add_step_run):
    """Every gradient, the backbone's included, within 2e-4 of the JAX
    gradient's scale (floored at 1e-4 of the largest gradient), in
    float64 as tests/test_torch_train_step.py holds them: held with the JV
    matcher's matches, reported with the auction's.

    With the auction's matches a gathered query's four template losses
    tie within 3.6e-13 (the random model's dims are near 0, so the posed
    templates nearly collapse), the two packages' forwards differ by about
    1e-7 there, and the min over templates takes another template in each:
    the gradients below it jump (up to 3.3e-2 of dim_embed1's scale, via
    the depth's dims term; ROADMAP.md Queue 3).  On the same outputs the
    two criteria give the same gradients
    (test_add_data_losses_match_jax), and the loss dicts agree within 4e-8
    (test_add_data_step_losses_match_jax)."""
    run = add_step_run
    held = run["backend"] == "jv"
    tm, t_grads = run["model"], run["t_grads"]
    j_grads = list(_flax_paths(run["j_grads"]))
    floor = 1e-4 * max(float(np.abs(g).max()) for _, g in j_grads)
    worst, seen = (0.0, ""), set()
    for path, g in j_grads:
        name = _torch_name(tm, path, "params")
        assert name in t_grads, f"no gradient for {name}"
        got = _jax_layout(t_grads[name], path[-1])
        scale = max(float(np.abs(g).max()), floor)
        worst = max(worst, (float(np.abs(got - g).max()) / scale, name))
        if held:
            np.testing.assert_allclose(got / scale, g / scale, atol=TOL,
                                       err_msg=name)
        seen.add(name)
    assert seen == set(dict(tm.named_parameters()))
    print(json.dumps({"port_vs_jax": f"add-data step {run['backend']} "
                      f"float64 gradients, {'held' if held else 'reported'}"
                      f", worst {worst[1]}", "max_rel": worst[0]}))


def test_train_val_run_trains_with_add_data(tmp_path):
    """tools/train_val_torch.py ``run``, one tiny epoch on SampleDataset
    with use_add_data, use_tfl and use_mask_loss: the loader collates the
    car keys, the step reports the aux losses, test and AP follow."""
    from tools import train_val_torch

    model = {"num_classes": 3, "num_feature_levels": 4, "num_depth_bins": 16,
             "enc_layers": 1, "dec_layers": 2, "hidden_dim": 32,
             "dim_feedforward": 32, "dropout": 0.0, "nheads": 4,
             "num_queries": 20, "enc_n_points": 2, "dec_n_points": 2,
             "use_tfl": True, "use_mask_loss": True, "tfl_loss_coef": 0.5,
             "mask_loss": "DICE"}
    ds_cfg = {"batch_size": 2, "resolution": [160, 96], "use_add_data": True,
              "add_data_path": str(tmp_path / "add"), "add_data_points": 96,
              "max_add_cars": 4, "add_mask_stride": 8,
              "root_dir": str(tmp_path)}
    cfg = {"random_seed": 444, "dataset": ds_cfg, "model": model,
           "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
           "lr_scheduler": {"warmup": False, "decay_rate": 0.1,
                            "decay_list": [125]},
           "trainer": {"max_epoch": 1, "save_frequency": 1,
                       "save_path": str(tmp_path / "out")},
           "tester": {"threshold": 0.0, "topk": 20}}
    train_ds = SampleDataset(4, ds_cfg)
    val_ds = SampleDataset(2, ds_cfg, first_id=4)
    write_sample_cars(ds_cfg["add_data_path"], train_ds)
    write_sample_labels(str(tmp_path / "training" / "label_2"), val_ds)
    assert {"car_points", "car_masks"} <= set(collate([train_ds[0],
                                                       train_ds[1]]))
    record = train_val_torch.run(cfg, train_ds, val_ds, "cpu",
                                 logger=lambda s: None)
    ep = record["epochs"][0]
    assert len(ep["loss_total"]) == 2
    for k in ("loss_tfl", "loss_mask", "loss_tfl_0", "loss_mask_0"):
        assert np.isfinite(ep["losses"][k]), k
    assert record["evaluated"] and record["evaluated"][0]["results"]


def test_train_val_main_trains_with_add_data(kitti_root, tmp_path):
    """tools/train_val_torch.py ``main`` from a yaml file over a KITTI
    directory (tests/test_torch_train_val.py's) whose frames have an
    ``optimized_cars`` cache: one epoch with use_add_data, use_tfl and
    use_mask_loss, then test and AP."""
    import yaml

    from test_torch_train_val import IMG_H as KH, IMG_W as KW
    from test_torch_train_val import MODEL_CFG, _dataset_cfg
    from tools import train_val_torch

    root = kitti_root
    rng = np.random.default_rng(13)
    mask = np.zeros((KH, KW), bool)
    mask[40:70, 60:100] = True
    for fid in ("000000", "000001", "000002", "000003"):
        save_optimized_cars(str(tmp_path / "add" / "optimized_cars"), fid, [
            {"points": (rng.normal(0, 0.6, (300, 3))
                        + [-1.5, 0.9, 10.0]).astype(np.float32),
             "mask": mask, "moving": fid == "000001", "theta": 0.0}])
    cfg = {"random_seed": 444,
           "dataset": _dataset_cfg(root, use_add_data=True,
                                   add_data_path=str(tmp_path / "add"),
                                   add_data_points=128, max_add_cars=2,
                                   add_mask_stride=8),
           "model": {**MODEL_CFG, "use_tfl": True, "use_mask_loss": True,
                     "mask_loss_coef": 0.5},
           "optimizer": {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4},
           "lr_scheduler": {"type": "step", "decay_list": [125, 165]},
           "trainer": {"max_epoch": 1, "save_frequency": 1,
                       "save_path": str(tmp_path / "out")},
           "tester": {"threshold": 0.0, "topk": 10}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    record = train_val_torch.main(["--config", str(path), "--device", "cpu"])
    losses = record["epochs"][0]["losses"]
    for k in ("loss_tfl", "loss_mask", "loss_tfl_0", "loss_mask_0"):
        assert np.isfinite(losses[k]), k
    assert record["evaluated"][0]["results"]
