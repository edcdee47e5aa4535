"""Hungarian set matcher (reference: MonoDETR matcher.py:14-112).

Cost = 2 * focal-style class cost + 10 * L1(3D center) + 5 * L1(2D lrtb)
+ 2 * (-GIoU), solved per Group-DETR group: queries are split into
``group_num`` blocks of ``num_queries`` and each block is matched
independently against all targets of its image (matcher.py:95-108).

Targets arrive as padded tensors (B, M, ...) with a validity mask, as in the
JAX package.  The cost matrices are computed on the predictions' device
without a gradient, reshaped to one (Q, M) problem per (image, group) and
solved by ``MatcherConfig.backend`` over the first ``sum(valid)`` target
columns (``ops/lap.py``): ``host`` copies them to the host once and solves
each with scipy's ``linear_sum_assignment`` (the default, as in the JAX
package); ``jv`` (exact) and ``auction`` (near-optimal) solve the whole
batch in one launch of a hand-written kernel on the card, with no copy to
the host, or with their plain versions for CPU tensors.  Output is a
per-query target index (B, G * Q) with -1 for unmatched queries.
"""

from __future__ import annotations

import dataclasses

import torch

from monosowa_tpu_torch.ops import lap

BIG = 1e6
BACKENDS = ("host", "jv", "auction")


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
    backend: str = "host"  # "host" (scipy on the host), "jv" (exact, on the
    #                        card), "auction" (eps-scaled, near-optimal)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"matcher backend {self.backend!r}: want one of "
                             f"{BACKENDS}")


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


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                    tgt_valid: torch.Tensor,
                    cfg: MatcherConfig = MatcherConfig(),
                    num_queries: int = 50) -> torch.Tensor:
    """pred_logits (B, G*Q, C); pred_boxes (B, G*Q, 6); targets padded
    (B, M, ...).  Returns (B, G*Q) matched target index or -1, on the
    predictions' device."""
    for t in (pred_logits, pred_boxes):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the matcher's cost takes float32 heads, got "
                            f"{t.dtype}")
    b, gq, _ = pred_logits.shape
    g = gq // num_queries
    m = tgt_valid.shape[1]
    cost = cost_matrix(pred_logits.float(), pred_boxes.float(), tgt_labels,
                       tgt_boxes.float(), tgt_valid.bool(), cfg)
    n_valid = tgt_valid.sum(1)[:, None].expand(b, g).reshape(-1)
    solve = {"host": lap.solve_lap_host, "jv": lap.lap_jv,
             "auction": lap.lap_auction}[cfg.backend]
    idx = solve(cost.reshape(b * g, num_queries, m), n_valid)
    return idx.reshape(b, gq)
