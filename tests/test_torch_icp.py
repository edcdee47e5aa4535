"""The port's point-to-plane ICP (``monosowa_tpu_torch/ops/icp.py``) and the
ICP windows of ``sowa/transforms.py`` against the JAX package's.

Tolerances: a pair's transform and rms within 1e-5 (float32 sums in
another order over 20 Gauss-Newton steps); the windows' transforms within
1e-4 (chains of up to 5 pairs, each pair float32).  The normals' sign is
free in both packages, so the step's A = sum w j j^T and b = -sum w j r
are compared, relative to their magnitude, within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monosowa_tpu.ops import icp as jicp
from monosowa_tpu.ops.geometry import rot_y
from monosowa_tpu.sowa import transforms as jtr
from monosowa_tpu_torch.ops import icp
from monosowa_tpu_torch.sowa import transforms as ttr

from test_icp_custom import _surface_cloud

torch.set_num_threads(1)    # the suite runs six worker processes at once

MAX_POINTS = 512            # below the scenes' 800 points: the windows draw


def _pair():
    src = _surface_cloud(seed=1)
    t = np.eye(4)
    t[:3, :3] = np.asarray(rot_y(jnp.float32(0.05)))
    t[:3, 3] = [0.3, 0.05, -0.2]
    tgt = (src @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
    mask = np.ones(len(src), bool)
    mask[::17] = False                          # padded rows
    return src, tgt, mask


def _step_system(src, tgt, normals, max_dist=1.0):
    """A and b of the first Gauss-Newton step (identity pose), float64."""
    src, tgt, normals = (np.asarray(a, np.float64)
                         for a in (src, tgt, normals))
    d2 = ((src[:, None] - tgt[None]) ** 2).sum(-1)
    nn = d2.argmin(1)
    w = (d2.min(1) < max_dist ** 2).astype(np.float64)
    n = normals[nn]
    r = ((src - tgt[nn]) * n).sum(1)
    jac = np.concatenate([np.cross(src, n), n], 1)
    return (jac * w[:, None]).T @ jac, -(jac * (r * w)[:, None]).sum(0)


def test_normals_give_the_jax_step():
    src, tgt, mask = _pair()
    nj = np.asarray(jicp.estimate_normals(jnp.asarray(tgt), jnp.asarray(mask)))
    nt = icp.estimate_normals(torch.from_numpy(tgt),
                              torch.from_numpy(mask)).numpy()
    valid = mask
    aj, bj = _step_system(src, tgt[valid], nj[valid])
    at, bt = _step_system(src, tgt[valid], nt[valid])
    print({"A": float(np.abs(aj - at).max() / np.abs(aj).max()),
           "b": float(np.abs(bj - bt).max() / np.abs(bj).max())})
    assert np.abs(aj - at).max() <= 1e-5 * np.abs(aj).max()
    assert np.abs(bj - bt).max() <= 1e-5 * np.abs(bj).max()
    # unit normals; the sign is free
    np.testing.assert_allclose(np.abs((nj * nt).sum(1)), 1.0, atol=1e-5)


def test_smallest_eigenvector_is_eighs():
    """The closed form against float64 LAPACK: random covariances, planar
    patches (a zero eigenvalue), two equal large eigenvalues; a multiple
    of the identity gives e0, as eigh's identity eigenvectors."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(64, 10, 3)) * rng.uniform(0.01, 2, (64, 1, 3))
    pts[:16, :, 1] = 1.6                                   # planar
    pts[16:24] = np.concatenate([rng.normal(size=(8, 10, 2)),
                                 0.01 * rng.normal(size=(8, 10, 1))], -1)
    c = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("bki,bkj->bij", c, c).astype(np.float32) / 10
    want = np.linalg.eigh(cov.astype(np.float64))[1][..., :, 0]
    got = icp.smallest_eigenvector(torch.from_numpy(cov)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(np.abs((got * want).sum(-1)), 1.0, atol=1e-6)
    iso = torch.eye(3).repeat(3, 1, 1) * torch.tensor([0.0, 1.0, 5.0])[:, None,
                                                                        None]
    np.testing.assert_array_equal(icp.smallest_eigenvector(iso).numpy(),
                                  np.tile([1.0, 0.0, 0.0], (3, 1)))


def test_knn_indices_order_ties_as_top_k():
    """Equal distances: the lower index first, as jax.lax.top_k(-d2)."""
    import jax

    rng = np.random.default_rng(0)
    d2 = rng.integers(0, 5, (7, 40)).astype(np.float32)
    want = np.asarray(jax.lax.top_k(-jnp.asarray(d2), 10)[1])
    got = icp.knn_indices(torch.from_numpy(d2), 10).numpy()
    np.testing.assert_array_equal(got, want)


def test_se3_exp_is_the_svd_polar_factor():
    rng = np.random.default_rng(1)
    xi = rng.normal(scale=0.3, size=(16, 6))
    got = icp._se3_exp(torch.from_numpy(xi)).numpy()
    for x, g in zip(xi, got):
        wx, wy, wz = x[:3]
        m = np.array([[1.0, -wz, wy], [wz, 1.0, -wx], [-wy, wx, 1.0]])
        u, _, vt = np.linalg.svd(m)
        np.testing.assert_allclose(g[:3, :3], u @ vt, atol=1e-12)
        np.testing.assert_allclose(g[:3, 3], x[3:], atol=0)
        np.testing.assert_allclose(g[3], [0, 0, 0, 1], atol=0)


def test_icp_pair_matches_jax():
    src, tgt, mask = _pair()
    tj, rj = jicp.icp_point_to_plane(jnp.asarray(src), jnp.asarray(mask),
                                     jnp.asarray(tgt), jnp.asarray(mask))
    tt, rt = icp.icp_point_to_plane(torch.from_numpy(src),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(tgt),
                                    torch.from_numpy(mask))
    diff = float(np.abs(np.asarray(tj) - tt.numpy()).max())
    print({"T": diff, "rms": (float(rj), float(rt))})
    assert diff <= 1e-5
    assert abs(float(rj) - float(rt)) <= 1e-5
    assert float(rt) < 0.05


def test_icp_batch_equals_per_pair_calls():
    src, tgt, mask = _pair()
    rng = np.random.default_rng(2)
    srcs = np.stack([src, src + rng.normal(scale=0.01, size=src.shape),
                     src[::-1]]).astype(np.float32)
    tgts = np.stack([tgt, tgt, tgt[::-1]]).astype(np.float32)
    masks = np.stack([mask, mask, mask[::-1]])
    tb, rb = icp.icp_batch(*(torch.from_numpy(a)
                             for a in (srcs, masks, tgts, masks)))
    for i in range(3):
        t1, r1 = icp.icp_point_to_plane(
            *(torch.from_numpy(np.ascontiguousarray(a[i]))
              for a in (srcs, masks, tgts, masks)))
        np.testing.assert_allclose(tb[i].numpy(), t1.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(rb[i]), float(r1), atol=1e-7)


def _world(seed):
    """tests/test_transforms.py's scene: a ground plane and two walls."""
    rng = np.random.default_rng(seed)
    plane = np.stack([rng.uniform(-5, 5, 400), np.full(400, 1.6),
                      rng.uniform(2, 20, 400)], 1)
    wall = np.stack([rng.uniform(-5, 5, 200), rng.uniform(0, 1.5, 200),
                     np.full(200, 20.0)], 1)
    wall2 = np.stack([np.full(200, 5.0), rng.uniform(0, 1.5, 200),
                      rng.uniform(2, 20, 200)], 1)
    return np.concatenate([plane, wall, wall2]).astype(np.float32)


def _scans(seed, missing=()):
    world = _world(seed)

    def get_scan(f):
        if f in missing:
            return None
        return world - np.array([0.0, 0.0, 0.4 * f], np.float32)
    return get_scan


def _prior(cur, anchor):
    """An odometry prior 5 cm and 0.3 degrees off the truth."""
    t = np.eye(4)
    t[:3, :3] = np.asarray(rot_y(jnp.float32(0.005 * (cur - anchor))))
    t[2, 3] = 0.4 * (cur - anchor) + 0.05
    return t


# tests/test_transforms.py:44-150's cases: v1 recovering the motion; v2 per
# frame, escalating over a missing anchor partner, and with rng % jump != 0;
# v2 with a prior; each also with every scan subsampled (800 -> 512 points)
CASES = {
    "v1": ("icp_window_transforms", 0, (), dict(ref=4, rng=4, n_frames=9,
                                                jump=2)),
    "v1 missing": ("icp_window_transforms", 0, (6,),
                   dict(ref=4, rng=4, n_frames=9, jump=2)),
    "v2": ("icp_window_transforms_v2", 1, (),
           dict(ref=5, rng=4, n_frames=11, jump=2)),
    "v2 escalation": ("icp_window_transforms_v2", 2, (3,),
                      dict(ref=5, rng=4, n_frames=11, jump=2)),
    "v2 rng % jump": ("icp_window_transforms_v2", 3, (),
                      dict(ref=5, rng=5, n_frames=11, jump=2)),
    "v2 prior": ("icp_window_transforms_v2", 1, (7,),
                 dict(ref=5, rng=5, n_frames=11, jump=2,
                      get_prior=_prior)),
}


@pytest.mark.parametrize("subsample", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_icp_windows_match_jax(case, subsample):
    fn, seed, missing, kw = CASES[case]
    kw = dict(kw, max_points=MAX_POINTS if subsample else 800, seed=7)
    get_scan = _scans(seed, missing)
    want = getattr(jtr, fn)(get_scan, **kw)
    got = getattr(ttr, fn)(get_scan, device="cpu", **kw)
    diff = float(np.abs(got - want).max())
    print({"case": case, "subsample": subsample, "max_abs": diff})
    assert got.shape == want.shape
    assert diff <= 1e-4
    # the motion is recovered (the JAX tests' bars)
    ref = kw["ref"]
    for k in range(got.shape[0]):
        fr = ref - kw["rng"] + k
        if np.allclose(got[k], 0) or np.allclose(got[k], np.eye(4)) \
                or fr in missing:
            continue
        assert got[k][2, 3] == pytest.approx(0.4 * (fr - ref), abs=0.15)


def test_icp_window_v2_draws_once_per_frame_in_first_access_order():
    """The subsample of each frame offset is drawn once, in the order the
    JAX package first asks for it: a recorded get_scan sees the same frame
    order in both packages."""
    seen = {"jax": [], "torch": []}

    def recorder(key):
        get_scan = _scans(1)

        def fn(f):
            seen[key].append(f)
            return get_scan(f)
        return fn

    kw = dict(ref=5, rng=5, n_frames=11, jump=2, max_points=MAX_POINTS)
    jtr.icp_window_transforms_v2(recorder("jax"), **kw)
    ttr.icp_window_transforms_v2(recorder("torch"), device="cpu", **kw)
    assert seen["torch"] == seen["jax"]
