"""Set criterion: Hungarian-matched detection losses (torch).

Behavioral contract (MonoDETR monodetr.py:302-575, 1188-1229 and
depth_predictor/ddn_loss/*; the JAX package's ``models/criterion.py``):

* focal classification over all queries (loss_labels :396-421);
* L1 3D-center (:437-446), L1 + GIoU on the 6-dof boxes (:448-467);
* Laplacian aleatoric depth: 1.4142*exp(-s)*|d-gt| + s (:469-480);
* dimension-aware L1 with detached compensation weight (:482-496);
* 24-channel angle: 12-bin CE + per-bin residual L1 (:498-522);
* DDN foreground depth-map loss: GT map painted from 2D boxes sorted by
  depth (nearest box wins per pixel), LID binning, one-hot focal loss,
  13:1 fg/bg balancing (ddn_loss.py:43-110, balancer.py:7-51);
* all losses normalized by num_boxes = total valid targets x group_num
  (:1201-1206);
* aux decoder layers re-matched and re-supervised, minus depth_map
  (:1216-1229).

Targets are padded tensors with a validity mask.  The TFL and mask
auxiliary losses (``use_tfl``, ``use_mask_loss``), the two-stage encoder
losses and DN-DETR are not in the port yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from monosowa_tpu_torch.models.matcher import (MatcherConfig,
                                               box_cxcylrtb_to_xyxy,
                                               generalized_box_iou,
                                               hungarian_match)


class Targets(NamedTuple):
    """Padded detection targets (B, M, ...)."""

    labels: torch.Tensor        # (B, M) int
    boxes_3d: torch.Tensor      # (B, M, 6) cx cy l r t b (normalized)
    boxes_2d: torch.Tensor      # (B, M, 4) cx cy w h (normalized)
    depth: torch.Tensor         # (B, M)
    size_3d: torch.Tensor       # (B, M, 3) h w l (mean-shape residual space)
    heading_bin: torch.Tensor   # (B, M) int in [0, 12)
    heading_res: torch.Tensor   # (B, M)
    valid: torch.Tensor         # (B, M) bool


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 3
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    group_num: int = 11
    num_queries: int = 50
    matcher: MatcherConfig = MatcherConfig()
    # loss weights (configs/monodetr.yaml:96-107)
    w_cls: float = 2.0
    w_bbox: float = 5.0
    w_giou: float = 2.0
    w_center: float = 10.0
    w_dim: float = 1.0
    w_angle: float = 1.0
    w_depth: float = 1.0
    w_depth_map: float = 1.0
    # ddn
    ddn_fg_weight: float = 13.0
    ddn_bg_weight: float = 1.0
    depth_min: float = 1e-3
    depth_max: float = 60.0
    num_depth_bins: int = 80
    # TFL / silhouette auxiliary losses: not in the port yet
    use_tfl: bool = False
    use_mask_loss: bool = False


WEIGHT_OF = {"loss_ce": "w_cls", "loss_center": "w_center",
             "loss_bbox": "w_bbox", "loss_giou": "w_giou",
             "loss_depth": "w_depth", "loss_dim": "w_dim",
             "loss_angle": "w_angle", "loss_depth_map": "w_depth_map"}


def _gather_targets(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered at idx (B, Q) -> (B, Q, ...); idx<0 -> entry 0
    (losses mask those out)."""
    safe = idx.clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], safe]


def _layer_losses(out: Dict[str, torch.Tensor], targets: Targets,
                  match_idx: torch.Tensor, num_boxes: torch.Tensor,
                  cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    logits = out["pred_logits"]                     # (B, Q, C)
    boxes = out["pred_boxes"]                       # (B, Q, 6)
    matched = match_idx >= 0                        # (B, Q)

    # ----- focal classification over all queries -----------------------
    tgt_cls = _gather_targets(targets.labels, match_idx).long()
    tgt_cls = torch.where(matched, tgt_cls,
                          torch.full_like(tgt_cls, cfg.num_classes))
    onehot = F.one_hot(tgt_cls, cfg.num_classes + 1)[..., :-1].to(
        logits.dtype)
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(p + 1e-8)
           + (1 - onehot) * torch.log(1 - p + 1e-8))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = cfg.focal_alpha * onehot + (1 - cfg.focal_alpha) * (1 - onehot)
    loss_ce = (alpha_t * (1 - p_t) ** cfg.focal_gamma * ce).sum() / num_boxes

    mask = matched.to(logits.dtype)

    # ----- 3D center + 2D box L1 + GIoU ---------------------------------
    tgt_boxes = _gather_targets(targets.boxes_3d, match_idx)
    l1_center = (boxes[..., :2] - tgt_boxes[..., :2]).abs().sum(-1)
    loss_center = (l1_center * mask).sum() / num_boxes
    l1_box = (boxes[..., 2:6] - tgt_boxes[..., 2:6]).abs().sum(-1)
    loss_bbox = (l1_box * mask).sum() / num_boxes

    giou_pair = generalized_box_iou(
        box_cxcylrtb_to_xyxy(boxes).reshape(-1, 1, 4),
        box_cxcylrtb_to_xyxy(tgt_boxes).reshape(-1, 1, 4))[:, 0, 0]
    loss_giou = ((1 - giou_pair.reshape(mask.shape)) * mask).sum() / num_boxes

    # ----- Laplacian depth ---------------------------------------------
    depth_pred = out["pred_depth"]
    tgt_depth = _gather_targets(targets.depth, match_idx)
    d, s = depth_pred[..., 0], depth_pred[..., 1]
    lap = 1.4142 * torch.exp(-s) * (d - tgt_depth).abs() + s
    loss_depth = (lap * mask).sum() / num_boxes

    # ----- dim-aware L1 -------------------------------------------------
    dims = out["pred_3d_dim"]
    tgt_dims = _gather_targets(targets.size_3d, match_idx)
    dim_l1 = (dims - tgt_dims).abs() / tgt_dims.abs().clamp(min=1e-6)
    dim_l1 = dim_l1 * mask[..., None]
    n_el = (mask.sum() * 3).clamp(min=1.0)
    mean_abs = ((dims - tgt_dims).abs() * mask[..., None]).sum() / n_el
    mean_dim_loss = dim_l1.sum() / n_el
    comp = (mean_abs / mean_dim_loss.clamp(min=1e-9)).detach()
    loss_dim = dim_l1.sum() * comp / num_boxes

    # ----- angle: 12-bin CE + residual ---------------------------------
    angle = out["pred_angle"]
    tgt_bin = _gather_targets(targets.heading_bin, match_idx).long()
    tgt_res = _gather_targets(targets.heading_res, match_idx)
    logp = torch.log_softmax(angle[..., :12], dim=-1)
    ce_angle = -logp.gather(-1, tgt_bin[..., None])[..., 0]
    res_pred = angle[..., 12:24].gather(-1, tgt_bin[..., None])[..., 0]
    l1_res = (res_pred - tgt_res).abs()
    loss_angle = ((ce_angle + l1_res) * mask).sum() / num_boxes

    return {"loss_ce": loss_ce, "loss_center": loss_center,
            "loss_bbox": loss_bbox, "loss_giou": loss_giou,
            "loss_depth": loss_depth, "loss_dim": loss_dim,
            "loss_angle": loss_angle}


def ddn_depth_map_loss(depth_logits: torch.Tensor, targets: Targets,
                       cfg: CriterionConfig) -> torch.Tensor:
    """depth_logits (B, H, W, D+1) NHWC; paints the GT depth map from 2D
    boxes (nearest box wins), LID-bins it, focal CE + 13:1 balancing."""
    b, h, w, nbins_p1 = depth_logits.shape
    nbins = nbins_p1 - 1
    dev = depth_logits.device
    scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
    boxes = targets.boxes_2d * scale                  # cx cy w h in grid px
    x1 = torch.floor(boxes[..., 0] - boxes[..., 2] / 2)
    y1 = torch.floor(boxes[..., 1] - boxes[..., 3] / 2)
    x2 = torch.ceil(boxes[..., 0] + boxes[..., 2] / 2)
    y2 = torch.ceil(boxes[..., 1] + boxes[..., 3] / 2)

    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    # (B, M, H, W) coverage.  The reference paints depth_maps[v1:v2, u1:u2]
    # with raw long() corners (ddn_loss.py:47-64, balancer.py:69-80): a box
    # whose floored u1/v1 is negative yields an EMPTY torch slice and is not
    # painted at all, as in the JAX package (criterion.py:201-206).
    inb = (x1 >= 0) & (y1 >= 0)

    def e(t):
        return t[..., None, None]

    cover = ((xs >= e(x1)) & (xs < e(x2)) & (ys >= e(y1)) & (ys < e(y2))
             & e(targets.valid & inb))
    depth_or_inf = torch.where(cover, e(targets.depth),
                               torch.full_like(cover, torch.inf,
                                               dtype=torch.float32))
    gt_depth = depth_or_inf.min(1).values             # (B, H, W)
    fg = torch.isfinite(gt_depth)
    gt_depth = torch.where(fg, gt_depth, torch.zeros_like(gt_depth))

    # LID bin target (background/out-of-range -> bin nbins)
    bin_size = 2 * (cfg.depth_max - cfg.depth_min) / (nbins * (1 + nbins))
    idxf = -0.5 + 0.5 * torch.sqrt(
        (1 + 8 * (gt_depth - cfg.depth_min) / bin_size).clamp(min=0.0))
    oob = (idxf < 0) | (idxf > nbins) | ~torch.isfinite(idxf)
    tgt_bin = torch.where(oob, torch.full_like(idxf, nbins),
                          torch.floor(idxf)).long()

    logp = torch.log_softmax(depth_logits, dim=-1)
    ce = -logp.gather(-1, tgt_bin[..., None])[..., 0]
    pt = torch.exp(-ce)
    focal = cfg.focal_alpha * (1 - pt) ** cfg.focal_gamma * ce

    weights = torch.where(fg, cfg.ddn_fg_weight, cfg.ddn_bg_weight)
    return (focal * weights).sum() / float(b * h * w)


def criterion(outputs: Dict[str, Any], targets: Targets,
              cfg: CriterionConfig = CriterionConfig(),
              training: bool = True,
              add_data: Any = None) -> Dict[str, torch.Tensor]:
    """Full loss dict; 'loss_total' is the weighted sum the trainer steps
    on."""
    if add_data is not None or cfg.use_tfl or cfg.use_mask_loss:
        raise NotImplementedError("the TFL / mask auxiliary losses are not "
                                  "in the port yet")
    for key in ("enc_outputs", "dn_outputs"):
        if key in outputs:
            raise NotImplementedError(f"{key} (two_stage / DN-DETR) is not "
                                      "in the port yet")
    group_num = cfg.group_num if training else 1
    num_boxes = (targets.valid.sum().to(torch.float32) * group_num).clamp(
        min=1.0)

    def match(out):
        return hungarian_match(out["pred_logits"], out["pred_boxes"],
                               targets.labels, targets.boxes_3d,
                               targets.valid, cfg.matcher, cfg.num_queries)

    losses = _layer_losses(outputs, targets, match(outputs), num_boxes, cfg)
    losses["loss_depth_map"] = ddn_depth_map_loss(
        outputs["pred_depth_map_logits"], targets, cfg)
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        for k, v in _layer_losses(aux, targets, match(aux), num_boxes,
                                  cfg).items():
            losses[f"{k}_{i}"] = v

    total = 0.0
    for k, v in losses.items():
        base = k.rsplit("_", 1)[0] if k[-1].isdigit() else k
        total = total + getattr(cfg, WEIGHT_OF[base]) * v
    losses["loss_total"] = total
    return losses
