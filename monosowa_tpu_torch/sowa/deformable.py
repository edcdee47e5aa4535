"""Deformable mesh refinement (batched AdamW fit).

Behavioral contract (pseudo_label_generator/3d/scripts/deformable_mesh.py):

* ``deformable_mesh_fit_lim_dof_batch`` (:330-517): batched AdamW fit (1000
  iterations) of a car mesh to each standing car's aggregated points over
  per-vertex y-offsets + 7 global DoF (xyz translation, 3 axis scales, yaw
  delta), dims clipped to [0.6, 1.25] x template;
* losses (:519-817), reference-exact:
  - ``tfl_knn_ref``    = tfl_knn_batch (:769-781): K=10 kNN scan->mesh on
    SQUARED distances, sigmoid(10 d^2)-0.5, validity-weighted;
  - ``tfl_new_ref``    = tfl_new_batch (:783-812): yaw-aligned two-plane
    projections, K=10 mean squared distances mesh->scan, summed;
  - ``edge_loss_ref``  = mesh_edge_loss_v2_batch (:566-612): per-coordinate
    abs-deviation norm + |edge length - mean| about per-mesh means, 1/E
    weighting;
  - ``symmetry_ref``   = symmetry_loss (:814-817): L1 on the Y coordinate
    between each vertex and its Hungarian-matched mirror partner;
  - ``laplacian_ref``  = pytorch3d mesh_laplacian_smoothing(method=
    "uniform"): mean over vertices of || mean(neighbors) - v ||.
  Weights and schedule follow the driver (:417-483): w_chamfer 5, w_edge 1,
  w_laplacian 10, w_symmetry 1, w_tfl_new 2.5; AdamW lr 0.025, 1000 iters;
  scales frozen for the first 100 iterations, per-vertex y-offsets (x10)
  released at iteration 250; scale/dim clipping applied only to the final
  result, not inside the loop.

Counterpart of the JAX package's ``sowa/deformable.py``: the same formulas
on torch tensors, the gradients from autograd, and the optimizer written
out in ``optax.adamw``'s order (``adamw_step``: b1 0.9, b2 0.999, eps 1e-8,
no eps_root, weight decay on every parameter, so the frozen scales decay
from 1 by lr * wd a step while their gradient is 0).  The k-NN distances
are ``torch.topk`` values in ascending order, as ``-top_k(-d2, k)`` gives
them (a mean's float sum depends on their order).  The 1,000-step loop
makes no host sync: the bias corrections of every step are one tensor
made before it.  ``jnp.linalg.norm``'s gradient at an exact zero is NaN in
JAX and 0 in torch; the formulas are kept as they are.

The mesh is procedural (same parametric car surface as sowa.templates);
the reference loads fiat_deformed2.obj, which ``load_car_mesh_obj`` reads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from monosowa_tpu_torch.ops.tfl import pairwise_sq_dists
from monosowa_tpu_torch.sowa.templates import (_car_profile_height,
                                               _PROFILES, TEMPLATE_H,
                                               TEMPLATE_L, TEMPLATE_W)


def make_car_mesh(nu: int = 24, nv: int = 12, profile_idx: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural closed-ish car surface mesh: (V, 3) verts, (F, 3) faces.

    A parametric grid wraps the car cross-section: for each z-slice the
    cross-section is a rounded rectangle whose height follows the cabin
    profile.  Axes match templates.py (x=width, y=height-down, z=length).
    """
    profile = _PROFILES[profile_idx]
    zs = np.linspace(-0.5, 0.5, nu)
    heights = _car_profile_height(zs, profile)

    verts = []
    for zi, z in enumerate(zs):
        h = heights[zi]
        for k in range(nv):
            t = k / nv * 2 * np.pi
            # superellipse cross-section: rounded box
            cx = 0.5 * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** 0.5
            cy = np.sign(np.sin(t)) * np.abs(np.sin(t)) ** 0.5
            y = (cy * 0.5 + 0.5) * h       # 0..h
            verts.append([cx, y, z])
    verts = np.asarray(verts, np.float64)

    faces = []
    for zi in range(nu - 1):
        for k in range(nv):
            a = zi * nv + k
            b = zi * nv + (k + 1) % nv
            c = (zi + 1) * nv + k
            d = (zi + 1) * nv + (k + 1) % nv
            faces.append([a, b, c])
            faces.append([b, d, c])
    faces = np.asarray(faces, np.int32)

    # normalize to template dims, center, flip y down (camera frame)
    for axis, target in ((0, TEMPLATE_W), (1, TEMPLATE_H), (2, TEMPLATE_L)):
        lo, hi = verts[:, axis].min(), verts[:, axis].max()
        verts[:, axis] = ((verts[:, axis] - lo) / max(hi - lo, 1e-9)
                          - 0.5) * target
    verts[:, 1] *= -1.0
    return verts.astype(np.float32), faces


def load_car_mesh_obj(path: str, target_dims_whl=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a reference deformed car mesh (data/*_deformed*.obj, the
    meshes the reference's pytorch3d load_objs_as_meshes consumes,
    loader.py:3541-3543): already centered in the fitting frame at
    near-template scale.  ``target_dims_whl`` optionally rescales extents
    to exact (w, h, l)."""
    from monosowa_tpu_torch.sowa.mesh_io import load_obj

    v, f = load_obj(path)
    v = v - (v.min(0) + v.max(0)) / 2.0
    if target_dims_whl is not None:
        v = v * (np.asarray(target_dims_whl, np.float64)
                 / np.maximum(np.ptp(v, axis=0), 1e-9))
    return v.astype(np.float32), f.astype(np.int32)


def mesh_edges(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], 0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def vertex_adjacency(faces: np.ndarray, n_verts: int,
                     max_degree: int = 12) -> np.ndarray:
    """(V, max_degree) neighbor indices padded with self (for the uniform
    laplacian)."""
    adj = [[] for _ in range(n_verts)]
    for a, b in mesh_edges(faces):
        adj[a].append(b)
        adj[b].append(a)
    out = np.zeros((n_verts, max_degree), np.int32)
    for v in range(n_verts):
        nb = adj[v][:max_degree]
        out[v, :len(nb)] = nb
        out[v, len(nb):] = v
    return out


def vertex_degrees(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """(V,) true neighbor counts (for the exact uniform laplacian: the
    self-padded rows of ``vertex_adjacency`` must not dilute the mean)."""
    deg = np.zeros(n_verts, np.int32)
    for a, b in mesh_edges(faces):
        deg[a] += 1
        deg[b] += 1
    return deg


def mirror_indices(verts: np.ndarray) -> np.ndarray:
    """Hungarian match of each vertex to its x-mirrored position
    (deformable_mesh.py:399-405: linear_sum_assignment over the cdist of
    the template vs its x-negated clone)."""
    from scipy.optimize import linear_sum_assignment

    m = verts * np.array([-1.0, 1.0, 1.0])
    d = np.sqrt(((verts[:, None, :] - m[None, :, :]) ** 2).sum(-1))
    row, col = linear_sum_assignment(d)
    out = np.empty(len(verts), np.int32)
    out[row] = col
    return out


# ---------------------------------------------------------------------------
# Reference-exact loss terms (deformable_mesh.py:519-817)
# ---------------------------------------------------------------------------

def _knn_sq_dists(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """(..., Na, k) smallest SQUARED distances from each a-point to b
    (pytorch3d ``knn_points().dists`` contract: squared, ascending)."""
    return torch.topk(pairwise_sq_dists(a, b), k, dim=-1, largest=False,
                      sorted=True).values


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _yaw_planes(scans, mesh_pts, c, s):
    """The two yaw-aligned (horizontal axis, y) projections of both clouds
    (tfl_new_batch's planes): [(scan_p, mesh_p)] x 2, each (B, N, 2)."""
    zeros = torch.zeros_like(c)
    out = []
    for e in (torch.stack([c, zeros, s], 1), torch.stack([-s, zeros, c], 1)):
        scan_p = torch.stack([torch.einsum("bsd,bd->bs", scans, e),
                              scans[:, :, 1]], 2)
        mesh_p = torch.stack([torch.einsum("bmd,bd->bm", mesh_pts, e),
                              mesh_pts[:, :, 1]], 2)
        out.append((scan_p, mesh_p))
    return out


def tfl_knn_ref(scan: torch.Tensor, mesh_pts: torch.Tensor,
                weights: torch.Tensor, k: int = 10,
                steepness: float = 10.0) -> torch.Tensor:
    """tfl_knn_batch (:769-781): scan->mesh K-NN on squared distances,
    sigmoid(steepness * d^2) - 0.5, per-point validity weights."""
    nn = _knn_sq_dists(scan, mesh_pts, k)
    s = torch.sigmoid(steepness * nn) - 0.5                 # (B, S, k)
    per_pt = s.mean(2) * weights
    return per_pt.mean(1).mean()


def tfl_new_ref(scan: torch.Tensor, mesh_pts: torch.Tensor,
                thetas: torch.Tensor, k: int = 10) -> torch.Tensor:
    """tfl_new_batch (:783-812): project both clouds onto the yaw-aligned
    horizontal axes paired with y; mesh->scan K-NN mean squared distance in
    each plane, summed."""
    loss = 0.0
    for scan_p, mesh_p in _yaw_planes(scan, mesh_pts, torch.cos(thetas),
                                      torch.sin(thetas)):
        loss = loss + _knn_sq_dists(mesh_p, scan_p, k).mean(2)  # (B, M)
    return loss.mean(1).mean()


def _edge_terms(verts_b: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    diffs = verts_b[:, edges[:, 0]] - verts_b[:, edges[:, 1]]   # (B, E, 3)
    da = diffs.abs()
    loss = _norm(da - da.mean(1, keepdim=True))
    norms = _norm(diffs)
    return loss + (norms - norms.mean(1, keepdim=True)).abs()


def edge_loss_ref(verts_b: torch.Tensor, edges: torch.Tensor
                  ) -> torch.Tensor:
    """mesh_edge_loss_v2_batch (:566-612) for shared-topology meshes."""
    return _edge_terms(verts_b, edges).mean()   # == sum * (1/E) / B


def symmetry_ref(verts_b: torch.Tensor, mirror_idx: torch.Tensor
                 ) -> torch.Tensor:
    """symmetry_loss (:814-817): L1 between each vertex's Y and its
    mirror partner's Y (partner indices from a Hungarian match of the
    template against its x-mirrored self, :399-405)."""
    return (verts_b[:, :, 1] - verts_b[:, mirror_idx, 1]).abs().mean()


def _laplacian_terms(verts_b, adj, degree) -> torch.Tensor:
    d = degree.to(verts_b.dtype)
    pad = adj.shape[1] - d
    nbr_sum = verts_b[:, adj].sum(2)                        # (B, V, 3)
    true_mean = (nbr_sum - pad[None, :, None] * verts_b) \
        / d.clamp_min(1)[None, :, None]
    return _norm(true_mean - verts_b)                       # (B, V)


def laplacian_ref(verts_b: torch.Tensor, adj: torch.Tensor,
                  degree: torch.Tensor) -> torch.Tensor:
    """pytorch3d mesh_laplacian_smoothing(method="uniform"): per vertex
    || mean(true neighbors) - v ||, averaged.  ``adj`` is self-padded, so
    the pad contribution (max_degree - degree) * v is subtracted."""
    return _laplacian_terms(verts_b, adj, degree).mean()


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    """Reference driver constants (deformable_mesh.py:414-421, 409, 455-474)."""
    iterations: int = 1000
    lr: float = 0.025                 # AdamW lr (:409)
    weight_decay: float = 0.01        # torch AdamW default
    steepness: float = 10.0
    knn_k: int = 10
    w_chamfer: float = 5.0            # w_chamfer (:417)
    w_tfl: float = 2.5                # w_tfl_new (:421)
    w_edge: float = 1.0               # w_edge (:418)
    w_laplacian: float = 10.0         # w_laplacian (:419)
    w_symmetry: float = 1.0           # w_symmetry (:420)
    scale_release_iter: int = 100     # scales active when i > 100 (:455)
    yoff_release_iter: int = 250      # y-offsets active when i >= 250 (:461)
    yoff_gain: float = 10.0           # off * 10 (:463)
    scale_min: float = 0.6            # final dim clip (:508-510)
    scale_max: float = 1.25


class DeformResult(NamedTuple):
    verts: torch.Tensor       # (B, V, 3) fitted world-frame vertices
    translation: torch.Tensor  # (B, 3)
    scales: torch.Tensor       # (B, 3)
    dtheta: torch.Tensor       # (B,)
    loss: torch.Tensor         # (B,)


def _apply_dof(verts0_b, y_offsets, dof2, center, theta0, it: int,
               cfg: DeformConfig):
    """verts0_b (B, V, 3); y_offsets (B, V); dof2 (B, 7) = [dx,dy,dz,
    sx,sy,sz, dtheta] (reference ``deform_verts2``, init [0,0,0,1,1,1,0]);
    pose deltas are relative to the grid-fit (center (B, 3), theta0 (B,)).

    Reference staging (:455-463): scales act only after iteration 100;
    per-vertex y-offsets (x10) only from iteration 250.  The y-offset is
    added post-rotation in the reference (world frame), equal to a
    canonical-frame add since yaw rotations leave y invariant."""
    scales = dof2[:, 3:6] if it > cfg.scale_release_iter \
        else torch.ones_like(dof2[:, 3:6])
    v = verts0_b * scales[:, None, :]
    theta = theta0 + dof2[:, 6]
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([c, z, s], -1),
                       torch.stack([z, o, z], -1),
                       torch.stack([-s, z, c], -1)], -2)        # (B, 3, 3)
    v = v @ rot.transpose(-1, -2) + center[:, None, :] + dof2[:, None, :3]
    y_gate = cfg.yoff_gain if it >= cfg.yoff_release_iter else 0.0
    return torch.stack([v[..., 0], v[..., 1] + y_gate * y_offsets,
                        v[..., 2]], -1)


def _losses_batch(vb, scans, weights, thetas_total, edges, adj, degree,
                  mirror_idx, cfg: DeformConfig) -> torch.Tensor:
    """Per-car decomposition of the reference total (:472-478); the batch
    mean of the returned vector equals the reference scalar loss."""
    nn = _knn_sq_dists(scans, vb, cfg.knn_k)
    s = torch.sigmoid(cfg.steepness * nn) - 0.5
    chamfer = (s.mean(2) * weights).mean(1)                 # (B,)

    tfl = 0.0
    for scan_p, mesh_p in _yaw_planes(scans, vb, torch.cos(-thetas_total),
                                      torch.sin(-thetas_total)):
        tfl = tfl + _knn_sq_dists(mesh_p, scan_p, cfg.knn_k).mean(2)
    tfl = tfl.mean(1)                                       # (B,)

    edge = _edge_terms(vb, edges).mean(1)                   # (B,)
    sym = (vb[:, :, 1] - vb[:, mirror_idx, 1]).abs().mean(1)
    lap = _laplacian_terms(vb, adj, degree).mean(1)
    return (cfg.w_chamfer * chamfer + cfg.w_tfl * tfl + cfg.w_edge * edge
            + cfg.w_laplacian * lap + cfg.w_symmetry * sym)


def adamw_step(params, grads, mu, nu, bc1, bc2, cfg: DeformConfig,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One ``optax.adamw`` update in place, in optax's order:
    mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu; u = (mu / bc1) /
    (sqrt(nu / bc2) + eps); u = u + wd p; p = p + (-lr) u.  ``bc1`` /
    ``bc2`` are this step's 1 - b^count as 0-dim tensors on the
    parameters' device (a division by a host scalar may become a product
    with its reciprocal on the card)."""
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.copy_((1 - b1) * g + b1 * m)
            v.copy_((1 - b2) * (g * g) + b2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            u = u + cfg.weight_decay * p
            p.add_(u * (-cfg.lr))


def bias_corrections(iterations: int, dtype, device, b1: float = 0.9,
                     b2: float = 0.999):
    """(iterations, 2) 1 - b^count for count = 1..iterations, computed as
    optax does (``decay ** count`` in the moments' precision) on the host
    and copied once."""
    n = np.arange(1, iterations + 1)
    np_t = np.float64 if dtype == torch.float64 else np.float32
    bc = np.stack([np_t(1) - np.power(np_t(b1), n.astype(np_t)),
                   np_t(1) - np.power(np_t(b2), n.astype(np_t))], 1)
    return torch.as_tensor(bc.astype(np_t), device=device)


class DeformProblem(NamedTuple):
    """The fit's inputs on one device, as the loop reads them."""
    verts0_b: torch.Tensor    # (B, V, 3) canonical mesh, per car scaled
    edges: torch.Tensor
    adj: torch.Tensor
    degree: torch.Tensor      # (V,) from the self-padded adj (:350)
    mirror_idx: torch.Tensor
    scans: torch.Tensor
    weights: torch.Tensor     # (B, S) scan_masks in the scans' dtype
    centers: torch.Tensor
    thetas: torch.Tensor


class DeformState(NamedTuple):
    """The parameters [y_off (B, V), dof2 (B, 7)] and AdamW's moments."""
    params: list
    mu: list
    nu: list


def deform_problem(verts0, edges, adj, mirror_idx, scans, scan_masks,
                   centers, thetas, init_dims=None) -> DeformProblem:
    """The arguments of ``fit_deformable_batch`` as one ``DeformProblem``."""
    b, nv = scans.shape[0], verts0.shape[0]
    if init_dims is not None:
        # mesh axis convention (templates.py): x = width, y = height,
        # z = length; init_dims is (l, w, h)
        ext = verts0.amax(0) - verts0.amin(0)
        dims_xyz = torch.stack([init_dims[:, 1], init_dims[:, 2],
                                init_dims[:, 0]], 1)
        verts0_b = verts0[None] * (dims_xyz / ext)[:, None, :]
    else:
        verts0_b = verts0.expand(b, nv, 3)
    degree = (adj != torch.arange(nv, device=adj.device)[:, None]).sum(1)
    return DeformProblem(verts0_b, edges, adj, degree, mirror_idx, scans,
                         scan_masks.to(scans.dtype), centers, thetas)


def initial_state(prob: DeformProblem) -> DeformState:
    """y-offsets 0 and dof2 [0,0,0,1,1,1,0] per car, moments 0."""
    b, nv = prob.verts0_b.shape[:2]
    dt, dev = prob.scans.dtype, prob.scans.device
    y_off = torch.zeros(b, nv, dtype=dt, device=dev, requires_grad=True)
    dof2 = torch.tensor([0., 0., 0., 1., 1., 1., 0.], dtype=dt,
                        device=dev).repeat(b, 1).requires_grad_(True)
    params = [y_off, dof2]
    return DeformState(params, [torch.zeros_like(p) for p in params],
                       [torch.zeros_like(p) for p in params])


def deform_vertices(prob: DeformProblem, state: DeformState, it: int,
                    cfg: DeformConfig) -> torch.Tensor:
    """(B, V, 3) vertices of the state as step ``it`` poses them."""
    y_off, dof2 = state.params
    return _apply_dof(prob.verts0_b, y_off, dof2, prob.centers,
                      prob.thetas, it, cfg)


def deform_step(prob: DeformProblem, state: DeformState, it: int,
                bc: torch.Tensor, cfg: DeformConfig) -> torch.Tensor:
    """Step ``it`` of the fit, in place: the per-car losses (B,) at the
    state before it, their gradients, one ``adamw_step`` with ``bc`` =
    ``bias_corrections(...)[it]``."""
    vb = deform_vertices(prob, state, it, cfg)
    dof2 = state.params[1]
    per = _losses_batch(vb, prob.scans, prob.weights, prob.thetas + dof2[:, 6],
                        prob.edges, prob.adj, prob.degree, prob.mirror_idx,
                        cfg)
    grads = torch.autograd.grad(per.mean(), state.params)
    adamw_step(state.params, grads, state.mu, state.nu, bc[0], bc[1], cfg)
    return per.detach()


def fit_deformable_batch(verts0: torch.Tensor, edges: torch.Tensor,
                         adj: torch.Tensor, mirror_idx: torch.Tensor,
                         scans: torch.Tensor, scan_masks: torch.Tensor,
                         centers: torch.Tensor, thetas: torch.Tensor,
                         cfg: DeformConfig = DeformConfig(),
                         init_dims: Optional[torch.Tensor] = None
                         ) -> DeformResult:
    """Batched mesh fit (deformable_mesh_fit_lim_dof_batch :330-517), on the
    device and in the dtype of ``scans``.

    verts0 (V, 3) canonical mesh; scans (B, S, 3) camera-frame points,
    zero-padded like the reference (:355-358) with ``scan_masks`` marking
    real rows (they become the tfl_knn validity weights; tfl_new runs
    unmasked, as in the reference); centers (B, 3) + thetas (B,) initial
    poses from the grid fit.  ``init_dims`` (B, 3) optional per-car
    (length, width, height): the template is scaled to each car's dims
    before optimizing (deformable_mesh.py:368-392), and the returned
    ``scales`` are relative to them.  ``loss`` is the per-car loss of the
    last step (before its update), as the JAX scan's last output."""
    prob = deform_problem(verts0, edges, adj, mirror_idx, scans, scan_masks,
                          centers, thetas, init_dims)
    state = initial_state(prob)
    bc = bias_corrections(cfg.iterations, scans.dtype, scans.device)
    per = scans.new_zeros(scans.shape[0])
    for it in range(cfg.iterations):
        per = deform_step(prob, state, it, bc[it], cfg)

    with torch.no_grad():
        dof2 = state.params[1]
        return DeformResult(
            verts=deform_vertices(prob, state, cfg.iterations, cfg),
            translation=centers + dof2[:, :3],
            scales=dof2[:, 3:6].clamp(cfg.scale_min, cfg.scale_max),
            dtheta=dof2[:, 6].clone(), loss=per)
