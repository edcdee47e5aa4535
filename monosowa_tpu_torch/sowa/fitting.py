"""Grid-search 3D template fitting (the reference's Optimizer), batched over
cars.

Behavioral contract (pseudo_label_generator/3d/scripts/optimizer.py):

* standing car (optimize_coarse:53-93 + optimize_fine:95-112): coarse grid
  over dx in [-2, 2] x dz in [-1, 3] x theta in [0, 2pi) (40 steps each)
  around the scan median, minimizing the binary2way TFL; then a fine pass of
  360 theta steps at the chosen (x, z).
* moving car (optimize_moving:293-345): theta fixed from the trajectory
  median arctan2 (estimate_angle_from_movement_tracked:347-424) when
  available, translation grid with dz shifted +1.
* template posing (get_template:426-488): yaw about camera-y, then translate.

Counterpart of the convolutional path of the JAX package's
``sowa/fitting.py``: every function takes a leading car dimension ``B``
(the single-car entry points add and strip it).  Per ``fit_cars_conv`` call
the exact coverage (``ops.tfl.binary_both_way_counts``) runs three times:
the rescore of the coarse grid's best translations, its half-pitch
refinement, and the fine theta pass; each is one call for all cars (only
the fine pass runs when ``FitConfig.exact_topk`` is 0).  The loss kinds
other than ``binary2way`` sweep the reference's grid exactly
(``exact_grid_losses``) in place of the conv grid.  ``fit_cars_robust``
(the robust optimisation) adds a translation-only grid at a given yaw
per car (``fit_loc_only``), one coverage call for all cars.

``fit_cars`` (with ``fit_standing_car`` / ``fit_moving_car``) is the JAX
package's first coarse pass: the grid scored by sampling voxel membership
fields (``ops.tfl.grid_pose_losses``), then the exact fine theta pass;
no labelling path calls it, the conv fit replaced it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.ops.geometry import masked_median, rot_y


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Grid geometry; defaults = reference configs/config.yaml optimization.*"""

    dx_min: float = -2.0
    dx_max: float = 2.0
    dz_min: float = -1.0
    dz_max: float = 3.0
    n_dx: int = 40
    n_dz: int = 40
    n_theta: int = 40
    n_theta_fine: int = 360
    radius: float = 0.2          # binary_loss_threshold
    moving_dz_shift: float = 1.0  # optimize_moving shifts the z range by +1
    # theta chunking of the JAX package's exact fine pass; kept so configs
    # compare, the port evaluates all fine thetas in one call
    fine_chunk: int = 24
    # the conv-grid coarse loss is a field-quantized approximation; re-score
    # the top-K candidate translations with the EXACT binary loss before the
    # fine pass (0 disables).  Aligns the selected cell with the reference's
    # exact-loss grid argmin (optimizer.py:53-93).
    exact_topk: int = 8
    # exact losses are evaluated at each candidate's conv-argmin theta row
    # +- this many rows (the conv kernels are exact per-theta rotations,
    # only the translation axis is voxel-quantized, so theta ranking within
    # a translation is already trustworthy; +-2 rows = +-18 deg at nt=40).
    # The standing-car theta itself always comes from the exact 360-step
    # fine pass.  Set >= n_theta//2 for the full theta set.
    rescore_theta_window: int = 2
    # loss_functions.loss_function dispatch (loss.py:98-116): binary2way
    # (default, the conv grid) or binary1way / chamfer / diffbin / med1way /
    # medboth / trimmed, which sweep the grid exactly instead (the conv
    # fields approximate binary2way only)
    loss_function: str = "binary2way"
    sigmoid_steepness: float = 10.0   # loss_functions.sigmoid_steepness
    # loss_functions yaml ships trim_threshold: 0.3 but compute_loss reads
    # the MISSPELLED trim_treshold key (loss.py:100), which is absent ->
    # None -> the shipped 'trimmed' branch crashes; the yaml value is used
    trim_threshold: float = 0.3

    def loss_kwargs(self) -> dict:
        return dict(kind=self.loss_function, radius=self.radius,
                    steepness=self.sigmoid_steepness,
                    trim=self.trim_threshold)


class FitResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    theta: torch.Tensor
    loss: torch.Tensor


def _linspace_thetas(n: int) -> np.ndarray:
    return np.linspace(0.0, 2 * np.pi - 2 * np.pi / n, n, dtype=np.float32)


def _pose_grids(cfg: FitConfig):
    """(thetas (n_theta,), trans (n_dx * n_dz, 3)) of the reference's
    continuous linspace grid, float32 numpy."""
    dx = np.linspace(cfg.dx_min, cfg.dx_max, cfg.n_dx, dtype=np.float32)
    dz = np.linspace(cfg.dz_min, cfg.dz_max, cfg.n_dz, dtype=np.float32)
    gx, gz = np.meshgrid(dx, dz, indexing="ij")
    trans = np.stack([gx.reshape(-1), np.zeros(gx.size, np.float32),
                      gz.reshape(-1)], -1)
    return _linspace_thetas(cfg.n_theta), trans


def _plateau_theta(thetas: torch.Tensor, losses: torch.Tensor
                   ) -> torch.Tensor:
    """Circular centroid of the minimal-loss plateau; thetas (N,), losses
    (..., N) -> (...,).

    The binary TFL saturates over a band of thetas (radius-tolerant); plain
    argmin returns the band edge.  The centroid of the tied minimum is a
    strictly better point estimate with the same minimizer set."""
    lmin = losses.min(-1, keepdim=True).values
    on = (losses <= lmin + 1e-6).to(losses.dtype)
    c = (on * torch.cos(thetas)).sum(-1)
    s = (on * torch.sin(thetas)).sum(-1)
    return torch.remainder(torch.atan2(s, c), 2 * np.pi)


def _fine_thetas(cfg: FitConfig) -> np.ndarray:
    return _linspace_thetas(cfg.n_theta_fine)


def _pose_template(template: torch.Tensor, thetas: torch.Tensor
                   ) -> torch.Tensor:
    """template (T, 3), thetas (...,) -> (..., T, 3) rotated about y."""
    return torch.einsum("tj,...ij->...ti", template, rot_y(thetas))


def exact_theta_losses(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                       template: torch.Tensor, trans: torch.Tensor,
                       thetas: torch.Tensor, radius: float,
                       loss_kwargs: Optional[dict] = None) -> torch.Tensor:
    """Exact TFL (default binary2way; any loss.py:98-116 kind via
    ``loss_kwargs``) for all thetas at one fixed translation per car:
    scan_local (B, S, 3), scan_mask (B, S), template (T, 3), trans (B, 3),
    thetas (N,) -> (B, N), in one call of the loss."""
    kw = loss_kwargs or dict(kind="binary2way", radius=radius)
    posed = _pose_template(template, thetas)[None] \
        + trans[:, None, None, :]                           # (B, N, T, 3)
    return tfl.tfl_loss(scan_local, scan_mask, posed, **kw)


# posed template points (B x poses x T) a call of exact_grid_losses poses
# at once for the loss kinds swept in plain torch (binary2way: one call)
_GRID_CHUNK_POINTS = 1 << 24


def exact_grid_losses(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                      template: torch.Tensor, trans: torch.Tensor,
                      thetas: torch.Tensor, cfg: FitConfig) -> torch.Tensor:
    """EXACT loss over the full (theta x translation) pose grid of every
    car: the coarse pass of the loss kinds other than binary2way (the
    reference evaluates its selected loss at every grid pose,
    optimizer.py:67-84; the conv fields approximate only binary2way), and
    the grid of ``fit_loc_only``.  scan_local (B, S, 3), scan_mask (B, S),
    template (T, 3), trans (G, 3), thetas (B, nt) per-car rows -> (B, nt,
    G), theta-major as the JAX package orders it.  binary2way poses the
    whole grid and counts it in one call; the other kinds pose it in
    chunks."""
    b, nt = thetas.shape
    g = trans.shape[0]
    n = nt * g
    th_rep = thetas.repeat_interleave(g, dim=1)             # (B, n)
    tr_rep = trans.repeat(nt, 1)                            # (n, 3)
    kw = cfg.loss_kwargs()
    chunk = n if cfg.loss_function == "binary2way" else max(
        1, _GRID_CHUNK_POINTS // (b * template.shape[0]))
    out = scan_local.new_empty(b, n)
    for p0 in range(0, n, chunk):
        posed = _pose_template(template, th_rep[:, p0:p0 + chunk]) \
            + tr_rep[p0:p0 + chunk][None, :, None, :]       # (B, c, T, 3)
        out[:, p0:p0 + chunk] = tfl.tfl_loss(scan_local, scan_mask, posed,
                                             **kw)
    return out.reshape(b, nt, g)


def estimate_angle_from_track(locations: np.ndarray, valid: np.ndarray,
                              ref_idx: int, min_dist: float = 3.0,
                              kitti_convention: bool = True
                              ) -> Optional[float]:
    """Trajectory yaw estimate (optimizer.py:347-424): median arctan2 of
    displacements from the reference frame to up to 5 sufficiently-distant
    neighbours on each side; odd-length median; mapped into the fitting
    frame with theta = -angle + pi/2 for camera-frame datasets.

    locations: (F, 3) per-frame car centers (camera coords), valid: (F,) bool.
    Returns None when fewer than 3 usable displacement angles exist.
    """
    if valid.sum() < 3 or not valid[ref_idx]:
        return None
    ref = locations[ref_idx]
    angles = []

    def scan(indices):
        count = 0
        for i in indices:
            if count >= 5:
                break
            if not valid[i]:
                continue
            d = np.hypot(locations[i][0] - ref[0], locations[i][2] - ref[2])
            if d > min_dist:
                if i < ref_idx:
                    a = np.arctan2(ref[2] - locations[i][2],
                                   ref[0] - locations[i][0])
                else:
                    a = np.arctan2(locations[i][2] - ref[2],
                                   locations[i][0] - ref[0])
                angles.append(a)
                count += 1

    scan(range(ref_idx - 1, -1, -1))
    scan(range(ref_idx + 1, len(locations)))
    if len(angles) < 3:
        return None
    if len(angles) % 2 == 0:
        angles.append(angles[-1])
    pred = float(np.median(np.array(angles)))
    if pred > np.pi:
        pred -= 2 * np.pi
    if kitti_convention:
        pred = -pred + np.pi / 2
    return pred


# ---------------------------------------------------------------------------
# Batched car fitting
# ---------------------------------------------------------------------------

class CarBatch(NamedTuple):
    """Padded SoA batch of car point clouds ready for fitting (numpy arrays
    or torch tensors).

    points: (B, S, 3) camera-frame aggregated points; mask: (B, S);
    moving: (B,) bool; theta_est/theta_valid: (B,) trajectory angles;
    car_valid: (B,) bool.
    """

    points: object
    mask: object
    moving: object
    theta_est: object
    theta_valid: object
    car_valid: object


class BatchFitResult(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    theta: torch.Tensor
    loss: torch.Tensor
    center: torch.Tensor  # (B, 3) medians the offsets are relative to


def make_conv_kernels(template: np.ndarray, cfg: FitConfig = FitConfig(),
                      device=None):
    """Precompute the per-theta rotated template kernels (host, once).

    Returns (spec, occ_kernels, memb_kernels) for grid_pose_losses_conv:
    numpy arrays when ``device`` is None, else tensors on ``device``.
    """
    spec = tfl.ConvGridSpec.aligned(
        cfg.dx_min, cfg.dx_max, cfg.dz_min, cfg.dz_max,
        cfg.n_dx, cfg.n_dz, cfg.n_theta, cfg.radius)
    occ, memb = tfl.rotated_template_kernels(np.asarray(template), spec)
    if device is None:
        return spec, occ, memb
    return (spec, torch.as_tensor(occ, device=device),
            torch.as_tensor(memb, device=device))


def _exact_losses_at(scan_local, scan_mask, template, trans_set, theta_set,
                     radius):
    """Exact binary2way TFL over an explicit pose set per car in one call:
    trans_set (B, N, 3), theta_set (B, N, Wn) per-translation thetas ->
    (B, N, Wn)."""
    b, n, wn = theta_set.shape
    posed = _pose_template(template, theta_set.reshape(b, n * wn)) \
        + trans_set.repeat_interleave(wn, dim=1)[:, :, None, :]
    losses = tfl.binary_both_way_loss(scan_local, scan_mask, posed, radius)
    return losses.reshape(b, n, wn)


def _take(a: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx0[b], idx1[b], ...] for every car b."""
    return a[(torch.arange(a.shape[0], device=a.device),) + idx]


def _exact_rescore_translations(scan_local, scan_mask, template, losses,
                                trans, thetas, cfg: FitConfig, pitch):
    """Pick the best translation by EXACT binary loss among the conv grid's
    top-K candidates, then refine at half-pitch around the winner: the conv
    lattice is voxel-aligned, so sub-cell refinement recovers the accuracy
    of the reference's continuous linspace grid (optimizer.py:71-75).

    ``losses`` (B, nt, G) are the conv losses with fixed-theta row masking
    already applied; ``thetas`` (B, nt) are the per-row theta values (a
    broadcast constant for moving cars with a trajectory angle); ``trans``
    (G, 3).  Exact losses are evaluated in a +-rescore_theta_window row
    window around each candidate's conv-argmin row (see FitConfig).

    Ties are broken as in the JAX package: the K candidates are the K
    smallest losses with the lower index first among equals (a stable
    sort; ``torch.topk`` promises no order), and every argmin is the first
    minimum.

    Returns (t_best (B, 3), theta_best (B,), loss_best (B,))."""
    b, nt, g = losses.shape
    per_trans = losses.min(dim=1).values                    # (B, G)
    k = min(cfg.exact_topk, g)
    cand = torch.sort(per_trans, dim=1, stable=True).indices[:, :k]
    cand_trans = trans[cand]                                # (B, K, 3)
    cand_row = torch.gather(losses, 2, cand[:, None, :].expand(b, nt, k)
                            ).argmin(dim=1)                 # (B, K)
    w = min(cfg.rescore_theta_window, (nt - 1) // 2)
    win = torch.arange(-w, w + 1, device=losses.device)
    wn = win.shape[0]
    rows = (cand_row[:, :, None] + win) % nt                # (B, K, Wn)
    cand_losses = _exact_losses_at(
        scan_local, scan_mask, template, cand_trans,
        torch.gather(thetas, 1, rows.reshape(b, -1)).reshape(b, k, wn),
        cfg.radius)
    ci = cand_losses.min(dim=2).values.argmin(dim=1)        # (B,)
    t0 = _take(cand_trans, ci)                              # (B, 3)
    row0 = _take(rows, ci, _take(cand_losses, ci).argmin(dim=1))

    # 3x3 half-pitch refinement: the +-1-pitch lattice neighbours are
    # already ranked by the conv top-K above; only sub-cell offsets add
    # information beyond it.
    px, pz = pitch
    offs = np.array([-0.5, 0.0, 0.5], np.float32)
    gx, gz = np.meshgrid(offs * px, offs * pz, indexing="ij")
    ref_offs = torch.as_tensor(np.stack(
        [gx.reshape(-1), np.zeros(gx.size, np.float32), gz.reshape(-1)], -1),
        device=losses.device)
    ref_trans = t0[:, None, :] + ref_offs                   # (B, 9, 3)
    n_ref = ref_trans.shape[1]
    rrows = ((row0[:, None] + win) % nt)[:, None, :].expand(b, n_ref, wn)
    ref_losses = _exact_losses_at(
        scan_local, scan_mask, template, ref_trans,
        torch.gather(thetas, 1, rrows.reshape(b, -1)).reshape(b, n_ref, wn),
        cfg.radius)
    ri = ref_losses.min(dim=2).values.argmin(dim=1)
    wi = _take(ref_losses, ri).argmin(dim=1)
    return (_take(ref_trans, ri), _take(thetas, _take(rrows, ri, wi)),
            ref_losses.reshape(b, -1).min(dim=1).values)


def _fit_conv(scan_local, scan_mask, moving, theta_est, theta_valid,
              template, occ_k, memb_k, spec, cfg: FitConfig):
    """The conv fit of B cars: standing and moving evaluated through ONE
    grid pass + ONE rescore (the two reference paths, optimize_coarse:53-93
    and optimize_moving:293-345, differ only in a -moving_dz_shift scan
    shift and the theta policy, merged with per-car selects).

    scan_local (B, S, 3) relative to each car's center, scan_mask (B, S),
    moving / theta_valid (B,) bool, theta_est (B,).  Returns (x, z, theta,
    loss), each (B,), as pose offsets in the local frame."""
    dev = scan_local.device
    shift = torch.where(moving, scan_local.new_tensor(cfg.moving_dz_shift),
                        scan_local.new_tensor(0.0))         # (B,)
    local_eff = scan_local - torch.stack(
        [torch.zeros_like(shift), torch.zeros_like(shift), shift],
        -1)[:, None, :]
    if cfg.loss_function != "binary2way":
        return _fit_exact(local_eff, scan_mask, moving, theta_est,
                          theta_valid, template, shift, cfg)

    trans = torch.as_tensor(tfl.conv_translations(spec), device=dev)
    losses = tfl.grid_pose_losses_conv(local_eff, scan_mask, occ_k, memb_k,
                                       spec, template.shape[0])  # (B,nt,G)
    nt = losses.shape[1]
    thetas_grid = torch.as_tensor(_linspace_thetas(nt), device=dev)
    # with a reliable trajectory angle only the nearest-theta kernel row
    # competes and the output theta is the exact trajectory estimate
    fixed = moving & theta_valid
    row = torch.round(theta_est / theta_est.new_tensor(2 * np.pi / nt)
                      ).long() % nt
    row_mask = (torch.arange(nt, device=dev)[None, :] == row[:, None]) \
        | ~fixed[:, None]
    masked = torch.where(row_mask[:, :, None], losses,
                         losses.new_tensor(float("inf")))
    th_set = torch.where(fixed[:, None], theta_est[:, None],
                         thetas_grid[None, :])              # (B, nt)
    if cfg.exact_topk > 0:
        pitch = ((spec.dx_max - spec.dx_min) / (spec.n_dx - 1),
                 (spec.dz_max - spec.dz_min) / (spec.n_dz - 1))
        t_best, th_best, loss_best = _exact_rescore_translations(
            local_eff, scan_mask, template, masked, trans, th_set, cfg,
            pitch)
    else:
        flat = masked.reshape(masked.shape[0], -1)
        best = flat.argmin(dim=1)
        t_best = trans[best % trans.shape[0]]
        th_best = _take(th_set, best // trans.shape[0])
        loss_best = _take(flat, best)

    fine_thetas = torch.as_tensor(_fine_thetas(cfg), device=dev)
    fine = exact_theta_losses(local_eff, scan_mask, template, t_best,
                              fine_thetas, cfg.radius)      # (B, N)
    theta = torch.where(moving, th_best, _plateau_theta(fine_thetas, fine))
    loss = torch.where(moving, loss_best, fine.min(dim=1).values)
    return t_best[:, 0], t_best[:, 2] + shift, theta, loss


def _fit_exact(local_eff, scan_mask, moving, theta_est, theta_valid,
               template, shift, cfg: FitConfig):
    """The fit of the loss kinds other than binary2way: an exact sweep over
    the reference's continuous linspace grid (the conv fields approximate
    binary2way only; the reference evaluates its selected loss at every
    grid pose, optimizer.py:67-84), then the exact fine theta pass with
    the same kind.  Arguments as ``_fit_conv``, ``local_eff`` already
    shifted for the moving cars."""
    dev = local_eff.device
    thetas_np, trans_np = _pose_grids(cfg)
    thetas_c = torch.as_tensor(thetas_np, device=dev)
    trans_ref = torch.as_tensor(trans_np, device=dev)
    nt, g = thetas_c.shape[0], trans_ref.shape[0]
    fixed = moving & theta_valid
    row = torch.round(theta_est / theta_est.new_tensor(2 * np.pi / nt)
                      ).long() % nt
    on_row = torch.arange(nt, device=dev)[None, :] == row[:, None]
    # the reference's optimize_moving evaluates the loss exactly at
    # estimated_angle (opt_param3_range=[estimated_angle]): theta_est takes
    # the selected row's place, so the masked sweep scores the translation
    # grid at the exact angle, not the nearest lattice theta
    rows_b = torch.where(on_row & fixed[:, None], theta_est[:, None],
                         thetas_c[None, :])                 # (B, nt)
    losses = exact_grid_losses(local_eff, scan_mask, template, trans_ref,
                               rows_b, cfg)                 # (B, nt, G)
    row_mask = on_row | ~fixed[:, None]
    masked = torch.where(row_mask[:, :, None], losses,
                         losses.new_tensor(float("inf")))
    th_set = torch.where(fixed[:, None], theta_est[:, None],
                         thetas_c[None, :])
    flat = masked.reshape(masked.shape[0], -1)
    best = flat.argmin(dim=1)
    t_best = trans_ref[best % g]
    th_best = _take(th_set, best // g)
    loss_best = _take(flat, best)
    fine_thetas = torch.as_tensor(_fine_thetas(cfg), device=dev)
    fine = exact_theta_losses(local_eff, scan_mask, template, t_best,
                              fine_thetas, cfg.radius, cfg.loss_kwargs())
    theta = torch.where(moving, th_best, _plateau_theta(fine_thetas, fine))
    loss = torch.where(moving, loss_best, fine.min(dim=1).values)
    return t_best[:, 0], t_best[:, 2] + shift, theta, loss


def _fit_single(scan_local, scan_mask, moving: bool, theta_est, theta_valid,
                template, occ_k, memb_k, spec, cfg) -> FitResult:
    dev = scan_local.device
    x, z, theta, loss = _fit_conv(
        scan_local[None], scan_mask[None].bool(),
        torch.tensor([moving], device=dev),
        torch.as_tensor(theta_est, dtype=scan_local.dtype,
                        device=dev).reshape(1),
        torch.as_tensor(theta_valid, dtype=torch.bool,
                        device=dev).reshape(1),
        template, occ_k, memb_k, spec, cfg)
    return FitResult(x=x[0], y=x.new_zeros(()), z=z[0], theta=theta[0],
                     loss=loss[0])


def fit_standing_car_conv(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                          template: torch.Tensor, occ_k: torch.Tensor,
                          memb_k: torch.Tensor, spec,
                          cfg: FitConfig = FitConfig()) -> FitResult:
    """One standing car, scan_local (S, 3) relative to its center: coarse
    grid via the conv kernels + exact fine theta pass."""
    return _fit_single(scan_local, scan_mask, False, 0.0, False, template,
                       occ_k, memb_k, spec, cfg)


def fit_moving_car_conv(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                        template: torch.Tensor, occ_k: torch.Tensor,
                        memb_k: torch.Tensor, spec, theta_est, theta_valid,
                        cfg: FitConfig = FitConfig()) -> FitResult:
    """One moving car on the conv grid: the scan shifts by -moving_dz_shift
    so the shifted translation range stays lattice-aligned (optimize_moving
    semantics: theta fixed from the trajectory when available, translation
    searched)."""
    return _fit_single(scan_local, scan_mask, True, theta_est, theta_valid,
                       template, occ_k, memb_k, spec, cfg)


def fit_cars_conv(batch: CarBatch, template: torch.Tensor,
                  occ_k: torch.Tensor, memb_k: torch.Tensor, spec,
                  cfg: FitConfig = FitConfig()) -> BatchFitResult:
    """Fit every car of a padded batch in one pass.  The batch (numpy or
    tensors) is brought to the device of ``template``, where the result
    stays.  A padded car (empty mask) costs its share of the work and
    changes no other car's result."""
    dev = template.device
    points = torch.as_tensor(batch.points, dtype=template.dtype, device=dev)
    mask = torch.as_tensor(batch.mask, dtype=torch.bool, device=dev)
    moving = torch.as_tensor(batch.moving, dtype=torch.bool, device=dev)
    theta_est = torch.as_tensor(batch.theta_est, dtype=template.dtype,
                                device=dev)
    theta_valid = torch.as_tensor(batch.theta_valid, dtype=torch.bool,
                                  device=dev)
    center = masked_median(points, mask)                    # (B, 3)
    xs, zs, thetas, losses = _fit_conv(
        points - center[:, None, :], mask, moving, theta_est, theta_valid,
        template, occ_k, memb_k, spec, cfg)
    return BatchFitResult(
        x=center[:, 0] + xs, y=center[:, 1], z=center[:, 2] + zs,
        theta=thetas, loss=losses, center=center)


# ---------------------------------------------------------------------------
# The gather-field fit (membership fields; the JAX package's ``fit_cars``)
# ---------------------------------------------------------------------------

def _gather_standing(scan_local, scan_mask, template, template_field,
                     cfg: FitConfig):
    """Coarse grid by membership fields + the exact fine theta pass for B
    cars: (x, z, theta, loss), each (B,)."""
    thetas_np, trans_np = _pose_grids(cfg)
    dev = scan_local.device
    thetas = torch.as_tensor(thetas_np, device=dev)
    trans = torch.as_tensor(trans_np, device=dev)
    losses = tfl.grid_pose_losses(scan_local, scan_mask, template,
                                  template_field, thetas, trans, cfg.radius)
    best = losses.reshape(losses.shape[0], -1).argmin(1)
    t_best = trans[best % trans.shape[0]]                   # (B, 3)
    fine_th = torch.as_tensor(_fine_thetas(cfg), device=dev)
    fine = exact_theta_losses(scan_local, scan_mask, template, t_best,
                              fine_th, cfg.radius)          # (B, N)
    return (t_best[:, 0], t_best[:, 2], _plateau_theta(fine_th, fine),
            fine.min(-1).values)


def _gather_moving(scan_local, scan_mask, template, template_field,
                   theta_est, theta_valid, cfg: FitConfig):
    """Moving cars: the translation grid (dz shifted by +moving_dz_shift)
    at the trajectory theta where valid, else over the full theta grid
    (optimize_moving:306-311); argmin over the (theta, translation)
    losses: (x, z, theta, loss), each (B,)."""
    thetas_np, trans_np = _pose_grids(cfg)
    dev = scan_local.device
    trans = torch.as_tensor(trans_np, device=dev) \
        + torch.tensor([0.0, 0.0, cfg.moving_dz_shift], device=dev)
    thetas_full = torch.as_tensor(thetas_np, device=dev)
    thetas = torch.where(theta_valid[:, None], theta_est[:, None],
                         thetas_full[None, :])              # (B, NT)
    losses = tfl.grid_pose_losses(scan_local, scan_mask, template,
                                  template_field, thetas, trans, cfg.radius)
    flat = losses.reshape(losses.shape[0], -1)
    best = flat.argmin(1)
    g = trans.shape[0]
    t = trans[best % g]
    return t[:, 0], t[:, 2], _take(thetas, best // g), _take(flat, best)


def _one_car(scan_local, scan_mask):
    return scan_local[None], scan_mask[None].bool()


def fit_standing_car(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                     template: torch.Tensor, template_field: torch.Tensor,
                     cfg: FitConfig = FitConfig()) -> FitResult:
    """Coarse grid (membership fields) + exact fine theta pass for one car,
    scan_local (S, 3) relative to its median center.  Returns the pose
    offset relative to the center (x/z are deltas; y = 0)."""
    x, z, theta, loss = _gather_standing(*_one_car(scan_local, scan_mask),
                                         template, template_field, cfg)
    return FitResult(x=x[0], y=x.new_zeros(()), z=z[0], theta=theta[0],
                     loss=loss[0])


def fit_moving_car(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                   template: torch.Tensor, template_field: torch.Tensor,
                   theta_est, theta_valid,
                   cfg: FitConfig = FitConfig()) -> FitResult:
    """Moving car: translation grid (dz +1 shifted) at fixed trajectory
    theta; if no reliable trajectory angle, the full theta grid
    (optimize_moving:306-311)."""
    dev = scan_local.device
    x, z, theta, loss = _gather_moving(
        *_one_car(scan_local, scan_mask), template, template_field,
        torch.as_tensor(theta_est, dtype=scan_local.dtype,
                        device=dev).reshape(1),
        torch.as_tensor(theta_valid, dtype=torch.bool, device=dev
                        ).reshape(1), cfg)
    return FitResult(x=x[0], y=x.new_zeros(()), z=z[0], theta=theta[0],
                     loss=loss[0])


def fit_cars(batch: CarBatch, template: torch.Tensor,
             template_field: torch.Tensor,
             cfg: FitConfig = FitConfig()) -> BatchFitResult:
    """Fit every car of a padded batch on the membership-field grid (the
    JAX package's ``fit_cars``): both the standing and the moving fit run
    for every car, selected per car.  The batch (numpy or tensors) is
    brought to the device of ``template``."""
    dev = template.device
    points = torch.as_tensor(batch.points, dtype=template.dtype, device=dev)
    mask = torch.as_tensor(batch.mask, dtype=torch.bool, device=dev)
    moving = torch.as_tensor(batch.moving, dtype=torch.bool, device=dev)
    theta_est = torch.as_tensor(batch.theta_est, dtype=template.dtype,
                                device=dev)
    theta_valid = torch.as_tensor(batch.theta_valid, dtype=torch.bool,
                                  device=dev)
    template_field = template_field.to(dev)
    center = masked_median(points, mask)                    # (B, 3)
    local = points - center[:, None, :]
    std = _gather_standing(local, mask, template, template_field, cfg)
    mov = _gather_moving(local, mask, template, template_field, theta_est,
                         theta_valid, cfg)
    x, z, theta, loss = (torch.where(moving, m, s) for s, m in zip(std, mov))
    return BatchFitResult(
        x=center[:, 0] + x, y=center[:, 1], z=center[:, 2] + z,
        theta=theta, loss=loss, center=center)


def _fit_loc_only(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                  template: torch.Tensor, theta_est: torch.Tensor,
                  cfg: FitConfig):
    """The translation-only grid of B cars at their yaws: scan_local
    (B, S, 3), scan_mask (B, S), theta_est (B,) -> (x, z, theta, loss),
    each (B,); the 2 x n_dx x n_dz poses of all cars in one call of the
    loss."""
    thetas = torch.stack([theta_est, theta_est + np.pi], 1)  # (B, 2)
    _, trans_np = _pose_grids(cfg)
    trans = torch.as_tensor(trans_np, device=scan_local.device)
    g = trans.shape[0]
    flat = exact_grid_losses(scan_local, scan_mask, template, trans, thetas,
                             cfg).reshape(thetas.shape[0], -1)
    best = flat.argmin(dim=1)
    t = trans[best % g]
    return t[:, 0], t[:, 2], _take(thetas, best // g), _take(flat, best)


def fit_loc_only(scan_local: torch.Tensor, scan_mask: torch.Tensor,
                 template: torch.Tensor, theta_est,
                 cfg: FitConfig = FitConfig()) -> FitResult:
    """Translation-only grid at a fixed estimated yaw (optimize_loc_only,
    optimizer.py:114-155): (dx, dz) linspace grid x theta in
    {theta_est, theta_est + pi}, template at its default size, scored with
    the configured loss kind.  One car: scan_local (S, 3)."""
    th = torch.as_tensor(theta_est, dtype=scan_local.dtype,
                         device=scan_local.device).reshape(1)
    x, z, theta, loss = _fit_loc_only(scan_local[None],
                                      scan_mask[None].bool(), template, th,
                                      cfg)
    return FitResult(x=x[0], y=x.new_zeros(()), z=z[0], theta=theta[0],
                     loss=loss[0])


def fit_cars_robust(batch: CarBatch, template: torch.Tensor,
                    occ_k: torch.Tensor, memb_k: torch.Tensor, spec,
                    cfg: FitConfig, theta_robust, robust_valid
                    ) -> BatchFitResult:
    """The robust_optimization branch (optimize_car_robust,
    optimizer.py:27-44): standing cars with a valid dims-estimator yaw run
    the translation-only grid at that yaw; the others keep the standard
    coarse + fine fit (moving cars optimize_moving).  The estimator's dims
    themselves are clamped to template dims by the reference's ``or
    True`` (dimension_estimator.py:115): only the yaw and the location
    survive.  Every car of the batch takes the translation-only grid in
    one call of the loss, as the JAX package computes it for each."""
    base = fit_cars_conv(batch, template, occ_k, memb_k, spec, cfg)
    dev = template.device
    points = torch.as_tensor(batch.points, dtype=template.dtype, device=dev)
    mask = torch.as_tensor(batch.mask, dtype=torch.bool, device=dev)
    moving = torch.as_tensor(batch.moving, dtype=torch.bool, device=dev)
    car_valid = torch.as_tensor(batch.car_valid, dtype=torch.bool,
                                device=dev)
    theta_robust = torch.as_tensor(theta_robust, dtype=template.dtype,
                                   device=dev)
    robust_valid = torch.as_tensor(robust_valid, dtype=torch.bool,
                                   device=dev)
    center = masked_median(points, mask)                    # (B, 3)
    x, z, theta, loss = _fit_loc_only(points - center[:, None, :], mask,
                                      template, theta_robust, cfg)
    use = robust_valid & ~moving & car_valid

    def pick(a, b):
        return torch.where(use, a, b)

    return BatchFitResult(
        x=pick(center[:, 0] + x, base.x), y=pick(center[:, 1], base.y),
        z=pick(center[:, 2] + z, base.z), theta=pick(theta, base.theta),
        loss=pick(loss, base.loss),
        center=torch.where(use[:, None], center, base.center))
