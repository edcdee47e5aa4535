"""Rotated 3D box IoU and NMS on torch tensors (fixed shapes, batched).

Counterpart of the JAX package's ``ops/box3d.py``, which replaces two
native components of the reference: pytorch3d ``box3d_overlap`` used by the
pseudo-label NMS (loader.py:2727-2800) and the rotated-BEV IoU kernels of
the KITTI evaluation (kitti_eval_python/rotate_iou.py).

Method: the intersection of two convex quads is convex, so collect the <= 24
candidate vertices (corners of A in B, corners of B in A, 16 edge-edge
intersections), sort them by angle about their centroid, and take the
shoelace area, with fixed-size masks.  3D IoU = BEV intersection x vertical
overlap (yaw-only boxes).  Every function takes leading batch dimensions
(``...``), e.g. one per frame.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def bev_corners(center_xz: torch.Tensor, lw: torch.Tensor,
                ry: torch.Tensor) -> torch.Tensor:
    """(..., 2) center, (..., 2) (l, w), (...,) yaw -> (..., 4, 2) corners.

    The BEV plane is camera (x, z); yaw rotates x toward z like
    ops.geometry.rot_y restricted to the plane.  Corner order is CCW."""
    l, w = lw[..., 0], lw[..., 1]
    dx = torch.stack([l, l, -l, -l], -1) / 2.0
    dz = torch.stack([w, -w, -w, w], -1) / 2.0
    c, s = torch.cos(ry), torch.sin(ry)
    x = c[..., None] * dx + s[..., None] * dz
    z = -s[..., None] * dx + c[..., None] * dz
    return torch.stack([x, z], -1) + center_xz[..., None, :]


def _cross2(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _points_in_quad(pts: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) points, (..., 4, 2) convex quad -> (..., N) bool.

    A point is inside iff it is on the same side of all four edges."""
    q0 = quad[..., None, :, :]                      # (..., 1, 4, 2)
    q1 = torch.roll(quad, -1, dims=-2)[..., None, :, :]
    p = pts[..., :, None, :]                        # (..., N, 1, 2)
    cr = _cross2(q0, q1, p)                         # (..., N, 4)
    return (cr >= -EPS).all(-1) | (cr <= EPS).all(-1)


def _edge_intersections(qa: torch.Tensor, qb: torch.Tensor):
    """All 16 segment-segment intersection points between two quads.

    Returns points (..., 16, 2) and validity (..., 16)."""
    a0 = qa[..., :, None, :]                        # (..., 4, 1, 2)
    a1 = torch.roll(qa, -1, dims=-2)[..., :, None, :]
    b0 = qb[..., None, :, :]                        # (..., 1, 4, 2)
    b1 = torch.roll(qb, -1, dims=-2)[..., None, :, :]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    diff = b0 - a0
    safe = torch.where(denom.abs() < EPS, torch.ones_like(denom), denom)
    t = (diff[..., 0] * db[..., 1] - diff[..., 1] * db[..., 0]) / safe
    u = (diff[..., 0] * da[..., 1] - diff[..., 1] * da[..., 0]) / safe
    valid = (denom.abs() >= EPS) & (t >= -EPS) & (t <= 1 + EPS) \
        & (u >= -EPS) & (u <= 1 + EPS)
    pts = a0 + t[..., None] * da
    bshape = pts.shape[:-3]
    return pts.reshape(bshape + (16, 2)), valid.reshape(bshape + (16,))


def quad_intersection_area(qa: torch.Tensor, qb: torch.Tensor
                           ) -> torch.Tensor:
    """(..., 4, 2) x (..., 4, 2) -> (...,) intersection area."""
    in_b = _points_in_quad(qa, qb)                  # (..., 4)
    in_a = _points_in_quad(qb, qa)
    inter, ivalid = _edge_intersections(qa, qb)
    pts = torch.cat([qa, qb, inter], dim=-2)        # (..., 24, 2)
    valid = torch.cat([in_b, in_a, ivalid], dim=-1)  # (..., 24)

    n = valid.sum(-1)
    zero = torch.zeros_like(pts)
    centroid = (torch.where(valid[..., None], pts, zero).sum(-2)
                / n.clamp_min(1)[..., None])
    rel = pts - centroid[..., None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    ang = torch.where(valid, ang, torch.full_like(ang, 1e9))  # invalid last
    order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))

    # shoelace over the valid prefix with wraparound to vertex 0
    idx = torch.arange(sp.shape[-2], device=sp.device).expand(order.shape)
    nxt = torch.where(idx + 1 < n[..., None], idx + 1,
                      torch.zeros_like(idx))
    p_next = torch.gather(sp, -2, nxt[..., None].expand(*nxt.shape, 2))
    cross = sp[..., 0] * p_next[..., 1] - sp[..., 1] * p_next[..., 0]
    area = 0.5 * torch.where(idx < n[..., None], cross,
                             torch.zeros_like(cross)).sum(-1).abs()
    return torch.where(n >= 3, area, torch.zeros_like(area))


def _pairwise_inter(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """(..., N, 4, 2) x (..., M, 4, 2) -> (..., N, M) intersection areas."""
    n, m = qa.shape[-3], qb.shape[-3]
    shape = qa.shape[:-3] + (n, m, 4, 2)
    return quad_intersection_area(qa[..., :, None, :, :].expand(shape),
                                  qb[..., None, :, :, :].expand(shape))


def iou_bev(centers_a, lw_a, ry_a, centers_b, lw_b, ry_b,
            criterion: int = -1) -> torch.Tensor:
    """Pairwise rotated BEV IoU: (..., N, .) vs (..., M, .) -> (..., N, M).

    ``criterion`` matches rotate_iou.py:236-249: -1 = IoU (union), 0 =
    intersection / area_a, 1 = intersection / area_b."""
    inter = _pairwise_inter(bev_corners(centers_a, lw_a, ry_a),
                            bev_corners(centers_b, lw_b, ry_b))
    area_a = (lw_a[..., 0] * lw_a[..., 1])[..., :, None]
    area_b = (lw_b[..., 0] * lw_b[..., 1])[..., None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = area_a * torch.ones_like(inter)
    else:
        denom = area_b * torch.ones_like(inter)
    return inter / denom.clamp_min(EPS)


def iou_3d(center_a, lwh_a, ry_a, center_b, lwh_b, ry_b) -> torch.Tensor:
    """Pairwise exact 3D IoU for yaw-only boxes:
    (..., N, .) x (..., M, .) -> (..., N, M).

    ``center`` is the box middle (not KITTI bottom-center); lwh = (l, w, h).
    """
    qa = bev_corners(center_a[..., [0, 2]], lwh_a[..., :2], ry_a)
    qb = bev_corners(center_b[..., [0, 2]], lwh_b[..., :2], ry_b)
    inter_bev = _pairwise_inter(qa, qb)
    ya0 = center_a[..., 1] - lwh_a[..., 2] / 2
    ya1 = center_a[..., 1] + lwh_a[..., 2] / 2
    yb0 = center_b[..., 1] - lwh_b[..., 2] / 2
    yb1 = center_b[..., 1] + lwh_b[..., 2] / 2
    y_overlap = (torch.minimum(ya1[..., :, None], yb1[..., None, :])
                 - torch.maximum(ya0[..., :, None], yb0[..., None, :])
                 ).clamp_min(0.0)
    inter = inter_bev * y_overlap
    vol_a = lwh_a.prod(-1)[..., :, None]
    vol_b = lwh_b.prod(-1)[..., None, :]
    return inter / (vol_a + vol_b - inter).clamp_min(EPS)


def nms_3d(center, lwh, ry, score, valid, iou_thresh: float):
    """Greedy 3D NMS over padded box sets: center (..., n, 3), lwh
    (..., n, 3), ry, score, valid (..., n).

    Returns (keep, merged_into): ``keep[..., i]`` True if box i survives;
    ``merged_into[..., i]`` = index of the surviving box that suppressed i
    (or i itself).  The reference merges the loser's points into the winner
    and re-optimizes (loader.py:2727-2800, main_class.py:227-235);
    merged_into gives the mapping needed to do that batched.  Boxes are
    visited by descending score, equal scores by index."""
    n = center.shape[-2]
    iou = iou_3d(center, lwh, ry, center, lwh, ry)            # (..., n, n)
    order_score = torch.where(valid, score,
                              torch.full_like(score, -float("inf")))
    order = torch.argsort(-order_score, dim=-1, stable=True)  # (..., n)
    rank = torch.empty_like(order)
    ar = torch.arange(n, device=center.device).expand(order.shape)
    rank.scatter_(-1, order, ar)

    keep = torch.ones_like(valid, dtype=torch.bool)
    merged = ar.clone()
    for k in range(n):                      # n is small (<= ~64 per frame)
        i = order[..., k:k + 1]                               # (..., 1)
        alive = torch.gather(keep & valid, -1, i)
        iou_i = torch.gather(iou, -2, i[..., None].expand(
            *i.shape, n))[..., 0, :]                          # (..., n)
        # only a currently-alive box suppresses others, and only boxes that
        # come later in score order
        suppress = (iou_i > iou_thresh) & valid & keep & (ar != i) \
            & alive & (rank > k)
        keep = keep & ~suppress
        merged = torch.where(suppress, i.expand_as(merged), merged)
    return keep & valid, merged
