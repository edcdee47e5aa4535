"""The port's deformable mesh fit (``monosowa_tpu_torch/sowa/deformable.py``)
against the JAX package's ``sowa/deformable.py``.

Tolerances: mesh, edges, adjacency, degrees and mirror indices equal; each
loss term within 1e-6 of its magnitude (float32 sums in another order);
the fit within 1e-4 after 30 float32 steps, and within 1e-8 of each
output's magnitude after 100 float64 steps (JAX under ``enable_x64``);
the optimizer alone against ``optax.adamw`` within 1e-6 (float32) and
1e-12 (float64) of the parameters' magnitude over 40 steps.

Past the y-offsets' release (step 250) the two fits part: Adam's first
step moves a parameter by lr * sign(g), so a y-offset whose gradient is
rounding noise moves either way (ROADMAP Queue 3); the long run is held to
finite values, the clip range and the JAX test's fit quality."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from monosowa_tpu.sowa import deformable as jd
from monosowa_tpu_torch.sowa import deformable as td

torch.set_num_threads(1)    # the suite runs six worker processes at once


def test_mesh_topology_equal(tmp_path):
    for kw in ({}, {"nu": 16, "nv": 8, "profile_idx": 2}):
        vj, fj = jd.make_car_mesh(**kw)
        vt, ft = td.make_car_mesh(**kw)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(td.mesh_edges(ft), jd.mesh_edges(fj))
        np.testing.assert_array_equal(td.vertex_adjacency(ft, len(vt)),
                                      jd.vertex_adjacency(fj, len(vj)))
        np.testing.assert_array_equal(td.vertex_degrees(ft, len(vt)),
                                      jd.vertex_degrees(fj, len(vj)))
        np.testing.assert_array_equal(td.mirror_indices(vt),
                                      jd.mirror_indices(vj))
    # an .obj written here (a quad fanned into two triangles)
    path = tmp_path / "car.obj"
    vt, ft = td.make_car_mesh(nu=6, nv=4)
    lines = [f"v {x} {y} {z}" for x, y, z in vt.astype(np.float64)]
    lines += [f"f {a + 1}/1 {b + 1} {c + 1}" for a, b, c in ft]
    lines += ["f 1 2 3 4"]
    path.write_text("\n".join(lines) + "\n")
    for dims in (None, (1.7, 1.5, 4.2)):
        a = td.load_car_mesh_obj(str(path), dims)
        b = jd.load_car_mesh_obj(str(path), dims)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _scene(b=2, s=256, seed=0, dtype=np.float32):
    """tests/test_deformable.py's scene: the mesh, stretched, posed at
    theta 0.5 and (1, 0.8, 12), 2 cm noise; B cars, the second longer."""
    verts, faces = jd.make_car_mesh(nu=16, nv=8)
    rng = np.random.default_rng(seed)
    theta = 0.5
    center = np.array([1.0, 0.8, 12.0])
    c, sn = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]])
    pts = np.zeros((b, s, 3))
    mask = np.zeros((b, s), bool)
    for i in range(b):
        scan = (verts * np.array([1.0, 1.0, 1.1 + 0.05 * i])) @ rot.T \
            + center
        scan = scan + rng.normal(scale=0.02, size=scan.shape)
        pts[i, :len(scan)] = scan[:s]
        mask[i, :min(len(scan), s)] = True
    return dict(verts=verts.astype(dtype), edges=jd.mesh_edges(faces),
                adj=jd.vertex_adjacency(faces, len(verts)),
                mirror=jd.mirror_indices(verts), pts=pts.astype(dtype),
                mask=mask, centers=np.tile(center, (b, 1)).astype(dtype),
                thetas=np.full(b, theta, dtype),
                dims=np.tile([3.9, 1.6, 1.5], (b, 1)).astype(dtype),
                degree=jd.vertex_degrees(faces, len(verts)))


def _torch_args(sc):
    t = torch.from_numpy
    return (t(sc["verts"]), t(sc["edges"]).long(), t(sc["adj"]).long(),
            t(sc["mirror"]).long(), t(sc["pts"]), t(sc["mask"]),
            t(sc["centers"]), t(sc["thetas"]))


def _jax_args(sc):
    return tuple(jnp.asarray(sc[k]) for k in (
        "verts", "edges", "adj", "mirror", "pts", "mask", "centers",
        "thetas"))


def test_loss_terms_match_jax():
    sc = _scene(b=3)
    rng = np.random.default_rng(1)
    vb = (sc["verts"][None] + rng.normal(scale=0.05, size=(3,) + sc[
        "verts"].shape)).astype(np.float32) + sc["centers"][:, None]
    w = sc["mask"].astype(np.float32)
    th = np.array([0.3, -1.0, 2.5], np.float32)
    t, j = torch.from_numpy, jnp.asarray
    pairs = {
        "tfl_knn": (td.tfl_knn_ref(t(sc["pts"]), t(vb), t(w)),
                    jd.tfl_knn_ref(j(sc["pts"]), j(vb), j(w))),
        "tfl_new": (td.tfl_new_ref(t(sc["pts"]), t(vb), t(th)),
                    jd.tfl_new_ref(j(sc["pts"]), j(vb), j(th))),
        "edge": (td.edge_loss_ref(t(vb), t(sc["edges"]).long()),
                 jd.edge_loss_ref(j(vb), j(sc["edges"]))),
        "symmetry": (td.symmetry_ref(t(vb), t(sc["mirror"]).long()),
                     jd.symmetry_ref(j(vb), j(sc["mirror"]))),
        "laplacian": (td.laplacian_ref(t(vb), t(sc["adj"]).long(),
                                       t(sc["degree"])),
                      jd.laplacian_ref(j(vb), j(sc["adj"]),
                                       j(sc["degree"]))),
    }
    cfg = td.DeformConfig()
    deg = (sc["adj"] != np.arange(len(sc["verts"]))[:, None]).sum(1)
    pairs["per-car total"] = (
        td._losses_batch(t(vb), t(sc["pts"]), t(w), t(th),
                         t(sc["edges"]).long(), t(sc["adj"]).long(),
                         t(deg), t(sc["mirror"]).long(), cfg),
        jd._losses_batch(j(vb), j(sc["pts"]), j(w), j(th), j(sc["edges"]),
                         j(sc["adj"]), j(deg), j(sc["mirror"]),
                         jd.DeformConfig()))
    for name, (got, want) in pairs.items():
        got, want = got.numpy(), np.asarray(want)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        print(name, rel)
        assert rel <= 1e-6, name


def _fit_both(sc, cfg_kw, init_dims):
    dims_t = torch.from_numpy(sc["dims"]) if init_dims else None
    dims_j = jnp.asarray(sc["dims"]) if init_dims else None
    rt = td.fit_deformable_batch(*_torch_args(sc), td.DeformConfig(**cfg_kw),
                                 dims_t)
    rj = jd.fit_deformable_batch(*_jax_args(sc), jd.DeformConfig(**cfg_kw),
                                 dims_j)
    return rt, rj


@pytest.mark.parametrize("init_dims", [False, True])
def test_fit_float32_30_steps(init_dims):
    rt, rj = _fit_both(_scene(), dict(iterations=30), init_dims)
    for k in rj._fields:
        got, want = getattr(rt, k).numpy(), np.asarray(getattr(rj, k))
        diff = float(np.abs(got - want).max())
        print(k, diff)
        assert got.dtype == np.float32 and diff <= 1e-4, k


def test_fit_float64_100_steps():
    """Past the scales' release (step 100), under jax's float64."""
    with jax.enable_x64(True):
        rt, rj = _fit_both(_scene(dtype=np.float64),
                           dict(iterations=102), True)
        for k in rj._fields:
            got, want = getattr(rt, k).numpy(), np.asarray(getattr(rj, k))
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            print(k, rel)
            assert want.dtype == np.float64 and got.dtype == np.float64
            assert rel <= 1e-8, k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_adamw_step_is_optax_adamw(dtype):
    """The update alone, on gradients that are 0 for some steps (the
    frozen scales: weight decay still moves them)."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(4, 7)).astype(dtype)
    grads = rng.normal(size=(40, 4, 7)).astype(dtype)
    grads[:10, :, 3:6] = 0.0
    cfg = td.DeformConfig()
    with jax.enable_x64(dtype == np.float64):
        tx = optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)
        pj = jnp.asarray(p0)
        state = tx.init(pj)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, pj)
            pj = optax.apply_updates(pj, upd)
        pj = np.asarray(pj)
    pt = torch.from_numpy(p0.copy())
    mu, nu = torch.zeros_like(pt), torch.zeros_like(pt)
    bc = td.bias_corrections(len(grads), pt.dtype, pt.device)
    for i, g in enumerate(grads):
        td.adamw_step([pt], [torch.from_numpy(g)], [mu], [nu], bc[i, 0],
                      bc[i, 1], cfg)
    rel = float(np.abs(pt.numpy() - pj).max() / np.abs(pj).max())
    print(rel)
    assert rel <= (1e-6 if dtype == np.float32 else 1e-12)


def test_long_fits_stay_finite():
    """Past the y-offsets' release: both fits finite, inside the clip
    range, hugging the scan (the JAX test's 0.25 m bar)."""
    sc = _scene(b=1)
    rt, rj = _fit_both(sc, dict(iterations=300), False)
    scan = sc["pts"][0][sc["mask"][0]]
    for res in (rt, rj):
        for k in res._fields:
            assert np.isfinite(np.asarray(getattr(res, k))).all(), k
        scales = np.asarray(res.scales)
        assert (scales >= 0.6 - 1e-6).all() and (scales <= 1.25 + 1e-6).all()
        v = np.asarray(res.verts[0])
        d = np.sqrt(((v[:, None] - scan[None]) ** 2).sum(-1)).min(1)
        assert d.mean() < 0.25
