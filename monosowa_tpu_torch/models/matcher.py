"""Hungarian set matcher (reference: MonoDETR matcher.py:14-112).

Cost = 2 * focal-style class cost + 10 * L1(3D center) + 5 * L1(2D lrtb)
+ 2 * (-GIoU), solved per Group-DETR group: queries are split into
``group_num`` blocks of ``num_queries`` and each block is matched
independently against all targets of its image (matcher.py:95-108).

Targets arrive as padded tensors (B, M, ...) with a validity mask, as in the
JAX package.  The cost matrices are computed on the predictions' device
without a gradient and copied to the host once; each (image, group) block
is solved there with scipy's ``linear_sum_assignment`` over the first
``sum(valid)`` target columns, exactly as the JAX package's exact solvers
(``ops/lap.py`` ``solve_lap_host`` / ``solve_lap_jv``) do.  Output is a
per-query target index (B, G * Q) with -1 for unmatched queries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BIG = 1e6


def box_cxcylrtb_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    """(cx, cy, l, r, t, b) -> (x1, y1, x2, y2)  (box_ops.py:20-26)."""
    return torch.stack([b[..., 0] - b[..., 2], b[..., 1] - b[..., 4],
                        b[..., 0] + b[..., 3], b[..., 1] + b[..., 5]], -1)


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)
    (box_ops.py:51-74)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    iou = inter / union.clamp(min=1e-9)
    lt_hull = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb_hull = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh_hull = (rb_hull - lt_hull).clamp(min=0.0)
    hull = wh_hull[..., 0] * wh_hull[..., 1]
    return iou - (hull - union) / hull.clamp(min=1e-9)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 2.0
    cost_3dcenter: float = 10.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0


def cost_matrix(logits, boxes, tgt_labels, tgt_boxes, tgt_valid,
                cfg: MatcherConfig) -> torch.Tensor:
    """(B, Q, C), (B, Q, 6) vs (B, M), (B, M, 6), (B, M) -> (B, Q, M) cost
    (the JAX package's ``_cost_matrix``, batched)."""
    prob = torch.sigmoid(logits)
    a, g = cfg.focal_alpha, cfg.focal_gamma
    neg = (1 - a) * prob ** g * (-torch.log(1 - prob + 1e-8))
    pos = a * (1 - prob) ** g * (-torch.log(prob + 1e-8))
    labels = tgt_labels.long().clamp(0, logits.shape[-1] - 1)
    idx = labels[:, None, :].expand(-1, logits.shape[1], -1)
    cost_class = pos.gather(2, idx) - neg.gather(2, idx)        # (B, Q, M)

    c3d = (boxes[:, :, None, :2] - tgt_boxes[:, None, :, :2]).abs().sum(-1)
    c2d = (boxes[:, :, None, 2:6] - tgt_boxes[:, None, :, 2:6]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcylrtb_to_xyxy(boxes),
                               box_cxcylrtb_to_xyxy(tgt_boxes))
    cost = (cfg.cost_class * cost_class + cfg.cost_3dcenter * c3d
            + cfg.cost_bbox * c2d + cfg.cost_giou * (-giou))
    return torch.where(tgt_valid[:, None, :], cost,
                       torch.full_like(cost, BIG))


def solve_assignment(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """(Q, M) cost, the number of valid target columns -> (Q,) assigned
    column or -1 (the JAX package's ``ops/lap.py`` ``_scipy_solve``)."""
    from scipy.optimize import linear_sum_assignment

    out = np.full(cost.shape[0], -1, np.int64)
    if n_valid > 0:
        rows, cols = linear_sum_assignment(cost[:, :n_valid])
        out[rows] = cols
    return out


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                    tgt_valid: torch.Tensor,
                    cfg: MatcherConfig = MatcherConfig(),
                    num_queries: int = 50) -> torch.Tensor:
    """pred_logits (B, G*Q, C); pred_boxes (B, G*Q, 6); targets padded
    (B, M, ...).  Returns (B, G*Q) matched target index or -1, on the
    predictions' device."""
    b, gq, _ = pred_logits.shape
    g = gq // num_queries
    m = tgt_valid.shape[1]
    cost = cost_matrix(pred_logits.float(), pred_boxes.float(), tgt_labels,
                       tgt_boxes.float(), tgt_valid.bool(), cfg)
    cost = cost.reshape(b, g, num_queries, m).cpu().numpy()
    n_valid = tgt_valid.sum(1).cpu().numpy()
    idx = np.stack([np.concatenate([solve_assignment(cost[i, k],
                                                     int(n_valid[i]))
                                    for k in range(g)])
                    for i in range(b)])
    return torch.from_numpy(idx).to(pred_logits.device)
