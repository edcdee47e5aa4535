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
  (:1216-1229);
* with pseudo-label cars (``add_data``, use_add_data), the Template-Fitting
  and silhouette-mask auxiliary losses (``use_tfl``, ``use_mask_loss``,
  monodetr.py:538-575) on the final layer and, with ``tfl_on_aux``, on each
  aux layer.

* with two_stage, the encoder proposals (``enc_outputs``) matched with one
  group over all S tokens and supervised on class and box terms, weighted
  by the ``_enc`` suffix rule (the JAX package's criterion.py:295-382).

Targets are padded tensors with a validity mask.  ``dn_outputs`` are
ignored, as in the JAX package's criterion: ``dn_components.dn_loss``
supervises them.

Data parallelism (``group``, ``parallel.dist``): the terms over the whole
batch, ``num_boxes``, the dimension loss's compensation ratio and the
depth map's pixel count, are summed over the group's ranks, so that each
rank's loss dict is its share of the global batch's (the sum over the ranks
is the loss one process computes on the whole batch).  The other terms are
sums over images (the TFL and mask losses are means within an image).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from monosowa_tpu_torch.models import mask_aux, tfl_aux
from monosowa_tpu_torch.models.matcher import (MatcherConfig,
                                               box_cxcylrtb_to_xyxy,
                                               generalized_box_iou,
                                               hungarian_match)
from monosowa_tpu_torch.parallel.dist import global_sum, group_size


class AddData(NamedTuple):
    """Pseudo-label car payload for the TFL / silhouette auxiliary losses —
    the reference's ``info`` side-channel (kitti_dataset.py:421-449 loads
    optimized_cars blobs; monodetr.py:967-1157 consumes them)."""

    car_points: torch.Tensor        # (B, C, P, 3) aggregated car clouds
    car_pmask: torch.Tensor         # (B, C, P) point validity
    car_valid: torch.Tensor         # (B, C)
    car_moving: torch.Tensor        # (B, C)
    car_masks: torch.Tensor         # (B, C, Hm, Wm) instance masks (0/1)
    calib: torch.Tensor             # (B, 3, 4) P2
    resolution: torch.Tensor        # (2,) network input (w, h)
    canonical_scale: torch.Tensor   # (B,)
    trans: torch.Tensor             # (B, 2, 3) original -> resolution affine
    trans_inv: torch.Tensor         # (B, 2, 3) inverse affine
    flip: torch.Tensor              # (B,) bool random-flip flags
    img_w: torch.Tensor             # (B,) original image width
    templates: torch.Tensor         # (4, T, 3) canonical template clouds
    template_dims_hwl: torch.Tensor  # (3,)


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
    # TFL / silhouette auxiliary losses against pseudo-label cars
    # (use_tfl / use_mask_loss, monodetr.py:538-575; off by default like
    # configs/monodetr.yaml:113-115)
    use_tfl: bool = False
    use_mask_loss: bool = False
    w_tfl: float = 1.0             # tfl_loss_coef
    w_mask: float = 1.0            # mask_loss_coef
    mask_kind: str = "BCE"         # mask_loss: BCE | DICE
    tfl_on_aux: bool = True        # reference runs tfl on aux layers too
    tfl_gather_k: int = 32         # fixed matched-query slots
    tfl_steepness: float = 10.0
    tfl_match_dist: float = 5.0
    mask_sigma_px: float = 1.5


WEIGHT_OF = {"loss_ce": "w_cls", "loss_center": "w_center",
             "loss_bbox": "w_bbox", "loss_giou": "w_giou",
             "loss_depth": "w_depth", "loss_dim": "w_dim",
             "loss_angle": "w_angle", "loss_depth_map": "w_depth_map",
             "loss_tfl": "w_tfl", "loss_mask": "w_mask"}


def _gather_targets(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered at idx (B, Q) -> (B, Q, ...); idx<0 -> entry 0
    (losses mask those out)."""
    safe = idx.clamp(min=0)
    return x[torch.arange(x.shape[0], device=x.device)[:, None], safe]


def _class_box_losses(out: Dict[str, torch.Tensor], targets: Targets,
                      match_idx: torch.Tensor, num_boxes: torch.Tensor,
                      cfg: CriterionConfig) -> Dict[str, torch.Tensor]:
    """Focal classification over all queries, L1 3D center, L1 + GIoU on
    the 6-dof boxes: a decoder layer's first four terms and all of the
    two-stage encoder proposals' (whose head has no depth/dim/angle
    outputs, the JAX package's ``_enc_layer_losses``)."""
    logits, boxes = out["pred_logits"], out["pred_boxes"]
    matched = match_idx >= 0
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
    tgt_boxes = _gather_targets(targets.boxes_3d, match_idx)
    l1c = (boxes[..., :2] - tgt_boxes[..., :2]).abs().sum(-1)
    l1b = (boxes[..., 2:6] - tgt_boxes[..., 2:6]).abs().sum(-1)
    giou_pair = generalized_box_iou(
        box_cxcylrtb_to_xyxy(boxes).reshape(-1, 1, 4),
        box_cxcylrtb_to_xyxy(tgt_boxes).reshape(-1, 1, 4))[:, 0, 0]
    return {"loss_ce": loss_ce,
            "loss_center": (l1c * mask).sum() / num_boxes,
            "loss_bbox": (l1b * mask).sum() / num_boxes,
            "loss_giou": ((1 - giou_pair.reshape(mask.shape))
                          * mask).sum() / num_boxes}


def _layer_losses(out: Dict[str, torch.Tensor], targets: Targets,
                  match_idx: torch.Tensor, num_boxes: torch.Tensor,
                  cfg: CriterionConfig, group=None
                  ) -> Dict[str, torch.Tensor]:
    losses = _class_box_losses(out, targets, match_idx, num_boxes, cfg)
    mask = (match_idx >= 0).to(out["pred_logits"].dtype)

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
    # the compensation ratio over the whole batch (detached)
    n_el, abs_sum, l1_sum = global_sum(torch.stack([
        mask.sum() * 3, ((dims - tgt_dims).abs() * mask[..., None]).sum(),
        dim_l1.sum()]).detach(), group)
    n_el = n_el.clamp(min=1.0)
    comp = (abs_sum / n_el) / (l1_sum / n_el).clamp(min=1e-9)
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

    losses.update(loss_depth=loss_depth, loss_dim=loss_dim,
                  loss_angle=loss_angle)
    return losses


def ddn_depth_map_loss(depth_logits: torch.Tensor, targets: Targets,
                       cfg: CriterionConfig, group=None) -> torch.Tensor:
    """depth_logits (B, H, W, D+1) NHWC; paints the GT depth map from 2D
    boxes (nearest box wins), LID-bins it, focal CE + 13:1 balancing; the
    mean over the pixels of the group's whole batch."""
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
    # every rank holds as many images (parallel.dist.shard_slice)
    return (focal * weights).sum() / float(group_size(group) * b * h * w)


def _add_data_losses(out: Dict[str, torch.Tensor], match_idx: torch.Tensor,
                     add: AddData, cfg: CriterionConfig
                     ) -> Dict[str, torch.Tensor]:
    """TFL + silhouette mask losses of one decoder layer against the
    pseudo-label cars (loss_tfl, monodetr.py:538-575).

    Matched queries are gathered into ``tfl_gather_k`` fixed slots per image
    so the pairwise (K, 4, T, P) tensors stay small instead of scaling with
    queries x groups; summed over the batch like compute_tfl_loss
    (:806-815)."""
    k = cfg.tfl_gather_k
    hm, wm = add.car_masks.shape[2], add.car_masks.shape[3]
    mean_size = add.car_points.new_zeros(3)   # meanshape False: dims absolute
    tfl_b, mask_b = [], []
    for b in range(match_idx.shape[0]):
        qidx, qvalid = tfl_aux.gather_matched_queries(match_idx[b], k)
        calib = add.calib[b]
        boxes7 = tfl_aux.decode_pred_boxes7(
            out["pred_boxes"][b, qidx], out["pred_depth"][b, qidx],
            out["pred_3d_dim"][b, qidx], out["pred_angle"][b, qidx], calib,
            add.resolution, add.canonical_scale[b], mean_size,
            add.trans_inv[b], add.flip[b], add.img_w[b])
        pts, pmask = add.car_points[b], add.car_pmask[b]
        cvalid, cmoving = add.car_valid[b], add.car_moving[b]
        if cfg.use_tfl:
            tfl_b.append(tfl_aux.loss_tfl_aux(
                boxes7, qvalid, pts, pmask, cvalid, cmoving, add.templates,
                add.template_dims_hwl, steepness=cfg.tfl_steepness,
                match_dist=cfg.tfl_match_dist))
        if not cfg.use_mask_loss:
            continue
        # per-query matched car (same nearest-center rule as the TFL)
        cmasks = add.car_masks[b]
        centers = tfl_aux.masked_median(pts, pmask)
        d = torch.linalg.vector_norm(
            boxes7[:, None, :3].detach() - centers[None], dim=-1)
        d = torch.where(cvalid[None, :], d, tfl_aux.BIG)
        match = d.argmin(1)
        has_mask = (cmasks > 0.5).any(2).any(1)
        ok = qvalid & (d.amin(1) < cfg.tfl_match_dist) & has_mask[match]
        posed = tfl_aux.pose_templates(
            boxes7, add.templates[:1], add.template_dims_hwl,
            cmoving[match])[:, 0]                        # (K, T, 3)
        # original-image px -> mask grid: augmentation affine / stride
        stride = torch.stack([add.resolution[0] / wm,
                              add.resolution[1] / hm])
        grid_affine = add.trans[b] / stride[:, None]
        sil = mask_aux.splat_silhouette(posed, calib, grid_affine, hm, wm,
                                        sigma_px=cfg.mask_sigma_px)
        mask_b.append(mask_aux.mask_loss(sil, cmasks[match], ok,
                                         kind=cfg.mask_kind))
    losses = {}
    if cfg.use_tfl:
        losses["loss_tfl"] = torch.stack(tfl_b).sum()
    if cfg.use_mask_loss:
        losses["loss_mask"] = torch.stack(mask_b).sum()
    return losses


FLOAT_HEADS = (torch.float32, torch.float64)


def criterion(outputs: Dict[str, Any], targets: Targets,
              cfg: CriterionConfig = CriterionConfig(),
              training: bool = True,
              add_data: Optional[AddData] = None,
              group=None) -> Dict[str, torch.Tensor]:
    """Full loss dict; 'loss_total' is the weighted sum the trainer steps
    on.  The auxiliary losses against pseudo-label cars are added when
    ``add_data`` is given and ``use_tfl`` or ``use_mask_loss`` is set.
    With a process ``group``, this rank's share of the group's global
    batch loss (module docstring)."""
    enc = outputs.get("enc_outputs")
    # the heads stay float32 under the bf16 policy (the JAX package's
    # tests/test_mixed_precision.py:40): no bf16 tensor reaches a loss
    for out in [outputs] + list(outputs.get("aux_outputs", [])) \
            + ([enc] if enc is not None else []):
        for key, val in out.items():
            if key.startswith("pred_") and val.dtype not in FLOAT_HEADS:
                raise TypeError(f"{key} is {val.dtype}: the losses take "
                                f"heads in {FLOAT_HEADS}")
    group_num = cfg.group_num if training else 1
    num_boxes = (global_sum(targets.valid.sum().to(torch.float32), group)
                 * group_num).clamp(min=1.0)

    def match(out):
        return hungarian_match(out["pred_logits"], out["pred_boxes"],
                               targets.labels, targets.boxes_3d,
                               targets.valid, cfg.matcher, cfg.num_queries)

    use_add = add_data is not None and (cfg.use_tfl or cfg.use_mask_loss)

    idx_final = match(outputs)
    losses = _layer_losses(outputs, targets, idx_final, num_boxes, cfg,
                           group)
    losses["loss_depth_map"] = ddn_depth_map_loss(
        outputs["pred_depth_map_logits"], targets, cfg, group)
    if use_add:
        losses.update(_add_data_losses(outputs, idx_final, add_data, cfg))
    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        idx_aux = match(aux)
        aux_l = _layer_losses(aux, targets, idx_aux, num_boxes, cfg, group)
        if use_add and cfg.tfl_on_aux:
            aux_l.update(_add_data_losses(aux, idx_aux, add_data, cfg))
        for k, v in aux_l.items():
            losses[f"{k}_{i}"] = v

    if enc is not None:
        # one group over all S encoder tokens (the JAX criterion's
        # hungarian_match(..., 1, s_tok)): a tall problem for the solver
        enc_idx = hungarian_match(enc["pred_logits"], enc["pred_boxes"],
                                  targets.labels, targets.boxes_3d,
                                  targets.valid, cfg.matcher,
                                  enc["pred_logits"].shape[1])
        for k, v in _class_box_losses(enc, targets, enc_idx, num_boxes,
                                      cfg).items():
            losses[f"{k}_enc"] = v

    total = 0.0
    for k, v in losses.items():
        base = k[:-4] if k.endswith("_enc") else (
            k.rsplit("_", 1)[0] if k[-1].isdigit() else k)
        total = total + getattr(cfg, WEIGHT_OF[base]) * v
    losses["loss_total"] = total
    return losses
