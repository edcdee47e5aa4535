"""Template-Fitting auxiliary loss for the detector (use_tfl path).

Behavioral contract (MonoDETR monodetr.py; the JAX package's
``models/tfl_aux.py``):

* ``decode_preds`` (:1085-1157): lift matched queries to camera-frame
  (x, y, z, h, w, l, ry) using the canonical-scale-corrected depth;
* ``perform_matching`` (:1053-1083): match each query to the nearest
  pseudo-label car by center distance (centers = per-car point medians);
* ``get_templates`` (:577-660): pose all 4 template clouds scaled by the
  predicted dims (y*h, x*w, z*l about the template dims), rotated by
  ry + pi/2 (rotation detached for moving cars), translated to the
  predicted center;
* ``tfl_knn`` (:817-845): differentiable two-way sigmoid TFL on SQUARED
  kNN distances (sigmoid(10 d^2) - 0.5), min over the 4 templates, mean
  over the queries matched to each car, summed over cars and batch.

Cars and points are padded with masks.  Every function here is one image's
and differentiable by autograd; minima are ``amin``, which shares the
gradient among equal values as JAX's ``min`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from monosowa_tpu_torch.ops.geometry import masked_median
from monosowa_tpu_torch.ops.tfl import pairwise_sq_dists

BIG = 1e9


def pose_templates(pred_boxes7: torch.Tensor, templates: torch.Tensor,
                   template_dims_hwl: torch.Tensor,
                   detach_rotation: torch.Tensor) -> torch.Tensor:
    """(Q, 7) [x,y,z,h,w,l,ry] x (4, T, 3) -> (Q, 4, T, 3) posed
    templates."""
    dims = pred_boxes7[:, 3:6].detach()
    scale_h = dims[:, 0] / template_dims_hwl[0]
    scale_w = dims[:, 1] / template_dims_hwl[1]
    scale_l = dims[:, 2] / template_dims_hwl[2]
    t = templates[None] * torch.stack(
        [scale_w, scale_h, scale_l], -1)[:, None, None, :]   # (Q,4,T,3)

    ry = pred_boxes7[:, 6] + math.pi / 2.0
    ry = torch.where(detach_rotation, ry.detach(), ry)
    c, s = torch.cos(ry), torch.sin(ry)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rot = torch.stack([torch.stack([c, z, s], -1),
                       torch.stack([z, o, z], -1),
                       torch.stack([-s, z, c], -1)], -2)      # (Q, 3, 3)
    posed = torch.einsum("qkti,qji->qktj", t, rot)
    return posed + pred_boxes7[:, None, None, :3]


def loss_tfl_aux(pred_boxes7: torch.Tensor, pred_matched: torch.Tensor,
                 car_points: torch.Tensor, car_point_mask: torch.Tensor,
                 car_valid: torch.Tensor, car_moving: torch.Tensor,
                 templates: torch.Tensor, template_dims_hwl: torch.Tensor,
                 steepness: float = 10.0,
                 match_dist: float = 5.0) -> torch.Tensor:
    """One image's TFL auxiliary loss.

    pred_boxes7 (Q, 7); pred_matched (Q,) bool (Hungarian-matched queries);
    car_points (C, P, 3) padded pseudo-label clouds; car_point_mask (C, P);
    car_valid (C,); car_moving (C,); templates (4, T, 3) canonical.
    """
    q = pred_boxes7.shape[0]
    n_cars = car_points.shape[0]
    centers = masked_median(car_points, car_point_mask)      # (C, 3)
    d = torch.sqrt(pairwise_sq_dists(pred_boxes7[None, :, :3].detach(),
                                     centers[None])[0] + 1e-12)  # (Q, C)
    d = torch.where(car_valid[None, :], d, BIG)
    match = d.argmin(1)
    ok = pred_matched & (d.amin(1) < match_dist)

    posed = pose_templates(pred_boxes7, templates, template_dims_hwl,
                           car_moving[match])                 # (Q,4,T,3)
    pts = car_points[match]                                   # (Q, P, 3)
    pmask = car_point_mask[match]
    d2 = pairwise_sq_dists(posed.reshape(q, -1, 3), pts)      # (Q,4T,P)
    d2 = d2.reshape(q, posed.shape[1], posed.shape[2], -1)
    d2m = torch.where(pmask[:, None, None, :], d2, BIG)

    t2s = torch.sigmoid(steepness * d2m.amin(-1)) - 0.5       # (Q,4,T)
    s2t = torch.sigmoid(steepness * d2m.amin(2)) - 0.5        # (Q,4,P)
    s2t = torch.where(pmask[:, None, :], s2t, 0.0)
    n_pts = pmask.sum(-1).clamp(min=1)[:, None]

    per_tmpl = t2s.mean(-1) + s2t.sum(-1) / n_pts             # (Q, 4)
    per_query = per_tmpl.amin(-1)                             # (Q,)

    # mean over queries matched to each car, summed over cars (tfl_knn)
    contrib = torch.where(ok, per_query, 0.0)
    car_ids = torch.where(ok, match, n_cars)
    sums = per_query.new_zeros(n_cars + 1).index_add(0, car_ids, contrib)
    counts = per_query.new_zeros(n_cars + 1).index_add(
        0, car_ids, ok.to(per_query.dtype))
    return (sums[:-1] / counts[:-1].clamp(min=1.0)).sum()


def _apply_affine(trans: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2, 3) affine on pixel coords."""
    return (trans[0, 0] * u + trans[0, 1] * v + trans[0, 2],
            trans[1, 0] * u + trans[1, 1] * v + trans[1, 2])


def decode_pred_boxes7(pred_boxes: torch.Tensor, pred_depth: torch.Tensor,
                       pred_dims: torch.Tensor, pred_angle: torch.Tensor,
                       calib: torch.Tensor, resolution: torch.Tensor,
                       canonical_scale: torch.Tensor,
                       mean_size_hwl: torch.Tensor,
                       trans_inv: Optional[torch.Tensor] = None,
                       flip: Optional[torch.Tensor] = None,
                       img_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, ...) head outputs -> (Q, 7) [x,y,z,h,w,l,ry] camera-frame boxes.

    Faithful to decode_preds (monodetr.py:1085-1157): normalized centers
    unprojected through the inverse augmentation affine and un-flipped back
    to the original image, depth de-canonicalized, center rays including
    the calib baseline terms, dims used directly (+ mean shape, zeros with
    meanshape=False like the shipped configs), heading = 12-bin argmax +
    residual, flipped to -h+pi, plus the global-ray correction
    arctan2(u_box_center - cu, fu) from the un-affined 2D box corners.
    """
    depth = pred_depth[:, 0] / canonical_scale
    u = pred_boxes[:, 0] * resolution[0]
    v = pred_boxes[:, 1] * resolution[1]
    if trans_inv is not None:
        u, v = _apply_affine(trans_inv, u, v)
    if flip is not None:
        u = torch.where(flip, img_w - u, u)
    fu, fv = calib[0, 0], calib[1, 1]
    cu, cv = calib[0, 2], calib[1, 2]
    x = (u - cu) * depth / fu + calib[0, 3] / -fu
    y = (v - cv) * depth / fv + calib[1, 3] / -fv
    dims = pred_dims + mean_size_hwl

    bin_id = pred_angle[:, :12].argmax(1)
    res = pred_angle[:, 12:24].gather(1, bin_id[:, None])[:, 0]
    heading = res + bin_id.to(res.dtype) * (2 * math.pi / 12)

    # box-center u in the original image for the ray correction (:1121-1151)
    u1 = (pred_boxes[:, 0] - pred_boxes[:, 2]) * resolution[0]
    v1 = (pred_boxes[:, 1] - pred_boxes[:, 4]) * resolution[1]
    u2 = (pred_boxes[:, 0] + pred_boxes[:, 3]) * resolution[0]
    v2 = (pred_boxes[:, 1] + pred_boxes[:, 5]) * resolution[1]
    if trans_inv is not None:
        u1, v1 = _apply_affine(trans_inv, u1, v1)
        u2, v2 = _apply_affine(trans_inv, u2, v2)
    uc = (u1 + u2) / 2.0
    if flip is not None:
        uc = torch.where(flip, img_w - uc, uc)
        heading = torch.where(flip, -heading + math.pi, heading)
    ry = heading + torch.atan2(uc - cu, fu)
    return torch.cat([x[:, None], y[:, None], depth[:, None], dims,
                      ry[:, None]], 1)


def gather_matched_queries(match_idx: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q,) Hungarian assignment row -> indices of the first ``k`` matched
    queries in query order (padded with unmatched ones) and their validity
    mask: a stable sort of ~matched.  Keeps the aux-loss pairwise tensors
    at a fixed small K instead of Q = queries x groups; with Group-DETR
    that is the first groups' queries."""
    matched = match_idx >= 0
    order = torch.sort((~matched).to(torch.int8), stable=True).indices
    return order[:k], matched[order[:k]]
