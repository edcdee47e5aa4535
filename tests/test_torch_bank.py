"""Bank mode of the port (``sowa/bank.py`` and the bank branch of
``sowa/pipeline.py``) against the JAX package's, on the same seeded numpy
inputs, on the CPU.

Scenes: the JAX tests' 96 x 160 depth images (``tests/test_bank_refit.py``:
ground plus car boxes, each box giving two nearly identical masks so that
the NMS merges and the winner is fitted again).  Both labellers fit with
the same 200-point template and conv kernels at a small grid.
Tolerances: the numpy host half equal; ``BankArena`` rows, free list and
buffer equal; ``fit_and_nms_slots`` / ``fit_slots`` x, z, theta within
1e-5 with keep and merged identical; label files: names equal, x, y, z
and theta within 1e-4; the port's stream against its per-group calls byte
for byte."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monosowa_tpu.sowa import bank as jbank
from monosowa_tpu.sowa import lomm as jlomm
from monosowa_tpu.sowa import pipeline as jpipe
from monosowa_tpu.sowa.fitting import FitConfig as JFitConfig
from monosowa_tpu.sowa.templates import TemplateBank as JTemplateBank
from monosowa_tpu_torch.kittiio import read_label_file
from monosowa_tpu_torch.sowa import bank, lomm, pipeline
from monosowa_tpu_torch.sowa.candidates_device import DeviceExtractor
from monosowa_tpu_torch.sowa.fitting import FitConfig
from monosowa_tpu_torch.sowa.templates import TemplateBank

torch.set_num_threads(1)    # the suite runs six worker processes at once

H, W = 96, 160
FU = 120.0
P2 = np.array([[FU, 0, W / 2, 0], [0, FU, H / 2, 0], [0, 0, 1, 0]],
              np.float32)
GRID = dict(n_dx=12, n_dz=12, n_theta=12, n_theta_fine=36, fine_chunk=9)
N_TEMPLATE = 200
BOXES_ONE = ((40, 20, 30, 14, 12.0),)
BOXES_TWO = ((30, 20, 26, 14, 12.0), (100, 40, 40, 22, 7.0))
WINDOW = 2
OFFSETS = list(range(-WINDOW, WINDOW + 1))


def _scene(seed, dup_boxes):
    """Depth image with ground + car boxes; each box emits TWO nearly
    identical masks (1 px inset), so NMS merges one into the other."""
    rng = np.random.default_rng(seed)
    depth = np.full((H, W), 300.0, np.float32)
    vrel = np.maximum(np.arange(H)[:, None] - H / 2, 1)
    depth = np.minimum(depth, (FU * 1.6 / vrel).astype(np.float32)
                       * np.ones((H, W), np.float32))
    masks = []
    for (x1, y1, bw, bh, z) in dup_boxes:
        m = np.zeros((H, W), bool)
        m[y1:y1 + bh, x1:x1 + bw] = True
        depth[m] = z + rng.normal(scale=0.01, size=int(m.sum())) \
            .astype(np.float32)
        m2 = np.zeros((H, W), bool)
        m2[y1 + 1:y1 + bh - 1, x1 + 1:x1 + bw - 1] = True
        masks.extend([m, m2])
    return depth, masks


def _backproject(depth):
    ys, xs = np.mgrid[0:H, 0:W]
    return np.stack([(xs - W / 2) * depth / FU, (ys - H / 2) * depth / FU,
                     depth], -1).reshape(-1, 3).astype(np.float32)


def _jobs(out_dir, tag, boxes, n_frames=2, seed0=5, with_points=False,
          one_mask=False):
    """Jobs over n_frames reference frames; ``one_mask`` keeps one mask a
    car (no duplicate to merge)."""
    scenes = [_scene(seed0 + k, boxes) for k in range(n_frames + 2 * WINDOW)]
    if one_mask:
        scenes = [(d, m[::2]) for d, m in scenes]
    jobs = []
    for fi in range(WINDOW, WINDOW + n_frames):
        jobs.append(dict(
            out_path=os.path.join(str(out_dir), f"{tag}_{fi:06d}.txt"),
            window_frames=OFFSETS,
            frame_ids=[fi - WINDOW + k for k in range(len(OFFSETS))],
            get_points=(lambda k, fi=fi:
                        _backproject(scenes[fi - WINDOW + k][0])),
            get_depth=(lambda k, fi=fi: scenes[fi - WINDOW + k][0]),
            get_masks=(lambda k, fi=fi: scenes[fi - WINDOW + k][1]),
            transforms=np.tile(np.eye(4), (len(OFFSETS), 1, 1)),
            p2=P2, img_hw=(H, W)))
        if not with_points:
            jobs[-1]["get_points"] = lambda k: None
    return jobs


def _common(**kw):
    return dict(nscans_before=WINDOW, nscans_after=WINDOW, max_cars=8,
                max_points=768, min_standing_points=150, **kw)


def _port(**kw):
    return pipeline.PseudoLabeler(
        pipeline.PipelineConfig(fit=FitConfig(**GRID), **_common(**kw)),
        bank=TemplateBank.default(num_points=N_TEMPLATE), device="cpu")


@pytest.fixture(scope="module")
def labelers():
    lab_j = jpipe.PseudoLabeler(
        jpipe.PipelineConfig(fit=JFitConfig(**GRID), **_common()),
        bank=JTemplateBank.default(num_points=N_TEMPLATE))
    lab_t = _port()
    np.testing.assert_array_equal(lab_t.bank.points, lab_j.bank.points)
    np.testing.assert_array_equal(lab_t.occ_kernels.numpy(),
                                  np.asarray(lab_j.occ_kernels))
    np.testing.assert_array_equal(lab_t.memb_kernels.numpy(),
                                  np.asarray(lab_j.memb_kernels))
    return lab_j, lab_t


def _assert_labels_close(a, b, tol=1e-4):
    assert a.names == b.names
    if not len(a.names):
        return
    np.testing.assert_allclose(a.pos, b.pos, atol=tol)
    np.testing.assert_allclose(a.ry, b.ry, atol=tol)
    np.testing.assert_allclose(a.hwl, b.hwl, atol=1e-6)
    np.testing.assert_allclose(a.box2d, b.box2d, atol=1e-3)
    np.testing.assert_allclose(a.score, b.score, atol=1e-4)


def _read(jobs):
    return [read_label_file(j["out_path"]) for j in jobs]


@pytest.mark.parametrize("device_bank", [True, False])
def test_label_frames_with_depth_matches_jax(labelers, tmp_path,
                                             device_bank):
    """Jobs with get_depth: bank mode (the default), and with bank mode
    off the device extraction with host aggregation."""
    lab_j, lab_t = labelers
    cfg_j, cfg_t = lab_j.cfg, lab_t.cfg
    lab_j.cfg = dataclasses.replace(cfg_j, device_bank=device_bank)
    lab_t.cfg = dataclasses.replace(cfg_t, device_bank=device_bank)
    try:
        jobs_j = _jobs(tmp_path, "jax", BOXES_TWO)
        jobs_t = _jobs(tmp_path, "torch", BOXES_TWO)
        assert lab_j.label_frames(jobs_j) == 2
        assert lab_t.label_frames(jobs_t) == 2
    finally:
        lab_j.cfg, lab_t.cfg = cfg_j, cfg_t
    assert lab_t.stage_seconds["bank_path"] == float(device_bank)
    got, want = _read(jobs_t), _read(jobs_j)
    assert sum(len(x.names) for x in got) >= 2
    for a, b in zip(got, want):
        _assert_labels_close(a, b)
    for jt, jj in zip(jobs_t, jobs_j):
        assert open(jt["out_path"]).read() == open(jj["out_path"]).read()


@pytest.mark.parametrize("boxes,cap", [(BOXES_ONE, 8), (BOXES_TWO, 1)],
                         ids=["fused", "overflow"])
def test_refit_cap_gives_the_host_merge_labels(tmp_path, boxes, cap):
    """The fused in-program re-fit (cap 8) and the overflow path (cap 1,
    two merge targets) write the labels of the cap-0 path (NMS pulled,
    merge_slots, one more fit): the port of tests/test_bank_refit.py."""
    host = _jobs(tmp_path, "host", boxes)
    dev = _jobs(tmp_path, "dev", boxes)
    assert _port(bank_refit_cap=0).label_frames(host) == 2
    assert _port(bank_refit_cap=cap).label_frames(dev) == 2
    a, b = _read(host), _read(dev)
    n_cars = [len(x.names) for x in a]
    # two masks a car: one merge a car (BOXES_ONE); with two cars, two
    # merge targets in one frame at least
    assert (n_cars == [1, 1]) if boxes is BOXES_ONE else (min(n_cars) == 2)
    for x, y in zip(a, b):
        _assert_labels_close(x, y)


def test_stream_matches_per_group(tmp_path):
    """label_frames_stream (two deep, the cross-group extraction cache and
    the arena) writes the files of per-group label_frames byte for byte,
    and leaves nothing cached."""
    lab = _port()
    seq = _jobs(tmp_path, "seq", BOXES_ONE, n_frames=4)
    assert lab.label_frames(seq[:2]) == 2
    assert lab.label_frames(seq[2:]) == 2
    assert lab.label_frames_stream(_jobs(tmp_path, "str", BOXES_ONE,
                                         n_frames=4), group_size=2) == 4
    for fi in range(WINDOW, WINDOW + 4):
        assert (tmp_path / f"seq_{fi:06d}.txt").read_text() == \
            (tmp_path / f"str_{fi:06d}.txt").read_text() != ""
    cache = lab._ext_cache
    assert cache["cands"] == {} and cache["arena"].live == {}
    assert sorted(cache["arena"].free) == list(
        range(cache["arena"].n_blocks))
    # skip-if-exists
    assert lab.label_frames_stream(seq, group_size=2) == 0


def test_bank_path_against_host_path(tmp_path):
    """The bank path against the port's host-candidate path on the same
    frames: the checks of tests/test_candidates_device.py:175-180 (the
    bank feeds the fit an even subsample, the host path a seeded one)."""
    lab = _port()
    host = _jobs(tmp_path, "host", BOXES_TWO, with_points=True,
                 one_mask=True)
    for j in host:
        del j["get_depth"]
    dev = _jobs(tmp_path, "dev", BOXES_TWO, one_mask=True)
    assert lab.label_frames(host) == 2
    assert lab.stage_seconds["bank_path"] == 0.0
    assert lab.label_frames(dev) == 2
    assert lab.stage_seconds["bank_path"] == 1.0
    for lh, ld in zip(_read(host), _read(dev)):
        assert lh.names == ld.names and len(lh.names)
        np.testing.assert_allclose(ld.box2d, lh.box2d, atol=0.5)
        np.testing.assert_allclose(ld.pos[:, 1], lh.pos[:, 1], atol=0.1)
        np.testing.assert_allclose(ld.pos, lh.pos, atol=2.0)


def _arena_state(a):
    return (list(a.free), {k: sorted(v) for k, v in a.live.items()},
            dict(a.fid_block), a.n_blocks)


def test_arena_matches_jax():
    rng = np.random.default_rng(0)
    aj = jbank.BankArena(2, 4, 8, 2)
    at = bank.BankArena(2, 4, 8, 2, device="cpu")
    chunks = [rng.normal(size=(2, m, 8, 3)).astype(np.float32)
              for m in (4, 2, 3, 4)]
    rows = []
    for i, c in enumerate(chunks[:3]):       # the third write grows
        fids = [f"f{2 * i}", f"f{2 * i + 1}"]
        rows.append((aj.write(jnp.asarray(c), fids),
                     at.write(torch.from_numpy(c), fids)))
    for f in ("f0", "f3", "f1", "nope"):     # block 0 frees, block 1 not
        aj.release(f)
        at.release(f)
    rows.append((aj.write(jnp.asarray(chunks[3]), ["g0", "g1"]),
                 at.write(torch.from_numpy(chunks[3]), ["g0", "g1"])))
    assert [r[0] for r in rows] == [r[1] for r in rows] == [0, 2, 4, 0]
    assert _arena_state(at) == _arena_state(aj)
    np.testing.assert_array_equal(at.buf.numpy(), np.asarray(aj.buf))


def _bank_tracks(lab_t):
    """Bank candidates of one window of BOXES_TWO frames, tracked by both
    packages: (bank (F, M, cap, 3), port tracks, JAX tracks, transforms)."""
    scenes = [_scene(5 + k, BOXES_TWO) for k in range(len(OFFSETS))]
    cfg = lab_t.cfg
    ext = DeviceExtractor(P2, (H, W), cfg.candidate, max_masks=cfg.max_cars,
                          device="cpu")
    cands, bk = ext.extract_frames_banked([s[0] for s in scenes],
                                          [s[1] for s in scenes],
                                          cap=cfg.max_points)
    tf = np.tile(np.eye(4), (len(OFFSETS), 1, 1))
    tf[:, 2, 3] = np.arange(len(OFFSETS)) * 0.01
    thr = cfg.candidate.moving_detection_threshold
    got = [bank.transform_candidates_bank(c, tf[k], thr)
           for k, c in enumerate(cands)]
    want = [jbank.transform_candidates_bank(c, tf[k], thr)
            for k, c in enumerate(cands)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["locations"], b["locations"])
        assert a["points"] == b["points"]
    tracks_t = lomm.greedy_track(got, OFFSETS, cfg.dist_threshold_tracking)
    tracks_j = jlomm.greedy_track(want, OFFSETS, cfg.dist_threshold_tracking)
    lomm.classify_all(tracks_t, method=cfg.moving_method)
    jlomm.classify_all(tracks_j, method=cfg.moving_method)
    return bk, tracks_t, tracks_j, tf


def _slots_equal(a, b):
    for k in ("fm", "rt", "off", "denom", "cnt", "valid"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.npts == b.npts


def test_host_half_matches_jax(labelers):
    _, lab_t = labelers
    cfg = lab_t.cfg
    _, tracks_t, tracks_j, tf = _bank_tracks(lab_t)
    quota = cfg.max_points // cfg.bank_slots
    args = (OFFSETS, cfg.keep_k_frames, cfg.min_standing_points,
            cfg.bank_slots, quota)
    kept_t, masks_t, slots_t = bank.select_car_slots(tracks_t, tf, *args)
    kept_j, masks_j, slots_j = jbank.select_car_slots(tracks_j, tf, *args)
    assert len(slots_t) == len(slots_j) == 4
    assert [t.frames for t in kept_t] == [t.frames for t in kept_j]
    for a, b in zip(slots_t, slots_j):
        _slots_equal(a, b)
    for a, b in zip(masks_t, masks_j):
        np.testing.assert_array_equal(a, b)
    # a moving car's single reference observation over all slots
    longest = max(tracks_t, key=lambda t: len(t.frames))
    moving = dataclasses.replace(longest, moving=True)
    mt = bank.select_car_slots([moving], tf, *args)[2]
    mj = jbank.select_car_slots([moving], tf, *args)[2]
    _slots_equal(mt[0], mj[0])
    assert mt[0].off.tolist() == [j * quota for j in range(cfg.bank_slots)]
    _slots_equal(bank.merge_slots(slots_t[0], slots_t[1]),
                 jbank.merge_slots(slots_j[0], slots_j[1]))


def test_fit_and_nms_slots_match_jax(labelers):
    """The fused device function on the same bank and slots: fit, NMS,
    the in-program re-fit and its count of targets; then fit_slots."""
    lab_j, lab_t = labelers
    cfg = lab_t.cfg
    bk, tracks_t, _, tf = _bank_tracks(lab_t)
    quota = cfg.max_points // cfg.bank_slots
    kept, _, slots = bank.select_car_slots(
        tracks_t, tf, OFFSETS, cfg.keep_k_frames, cfg.min_standing_points,
        cfg.bank_slots, quota)
    # two "frames" of four cars: two merges in each
    kept, slots = kept * 2, slots * 2
    windows, owners = [OFFSETS] * 8, [0] * 4 + [1] * 4
    lwh = np.asarray(cfg.template_dims_lwh, np.float32)
    common = (kept, windows, owners, 2, cfg.max_cars, lwh, cfg.nms_iou)
    got = bank.fit_and_nms_slots(
        bk, slots, *common, lab_t.template, lab_t.occ_kernels,
        lab_t.memb_kernels, lab_t.conv_spec, cfg.fit, quota, refit_cap=3)
    want = jbank.fit_and_nms_slots(
        jnp.asarray(bk.numpy()), slots, *common, lab_j.template,
        lab_j.occ_kernels, lab_j.memb_kernels, lab_j.conv_spec,
        lab_j.cfg.fit, cfg.bank_slots, quota, refit_cap=3)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    for fi in (0, 1):
        np.testing.assert_array_equal(got[2][fi][0], want[2][fi][0])
        np.testing.assert_array_equal(got[2][fi][1], want[2][fi][1])
    assert not got[2][0][0].all()             # the NMS merged
    assert got[3] == want[3] == 4             # targets: 2 a frame
    assert sorted(got[4]) == sorted(want[4]) and len(got[4]) == 3
    for k in got[4]:
        np.testing.assert_allclose(got[4][k][0], want[4][k][0], atol=1e-5)
        assert abs(got[4][k][1] - want[4][k][1]) <= 1e-5
    rt = bank.fit_slots(bk, slots[:3], kept[:3], windows[:3], lab_t.template,
                        lab_t.occ_kernels, lab_t.memb_kernels,
                        lab_t.conv_spec, cfg.fit, quota)
    rj = jbank.fit_slots(jnp.asarray(bk.numpy()), slots[:3], kept[:3],
                         windows[:3], lab_j.template, lab_j.occ_kernels,
                         lab_j.memb_kernels, lab_j.conv_spec, lab_j.cfg.fit,
                         cfg.bank_slots, quota)
    for k in ("x", "z", "theta"):
        np.testing.assert_allclose(getattr(rt, k).numpy(),
                                   np.asarray(getattr(rj, k))[:3], atol=1e-5)
