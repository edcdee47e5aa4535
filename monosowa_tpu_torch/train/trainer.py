"""The train step and the evaluation step.

Behavioral contract (MonoDETR/lib/helpers/trainer_helper.py:15-191,
tester_helper.py:80-108; the JAX package's ``train/trainer.py``): targets
filtered by mask_2d before the criterion (prepare_targets :180-191); loss =
weighted sum of the criterion dict; one AdamW update per step; the eval step
is the forward, then detection extraction.  The matcher is the exact JV
solver on the card (``MatcherConfig(backend="jv")``) unless a criterion
config says otherwise, as in the JAX trainer.  When the config uses the TFL
or the silhouette-mask loss and the batch carries pseudo-label cars
(use_add_data), the step moves them to the device with the canonical
templates and passes them to the criterion.  Under data parallelism
(``parallel.dist``) each rank steps on its slice of the global batch and
the step is the one a single process takes on the whole batch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from monosowa_tpu_torch.models.criterion import (AddData, CriterionConfig,
                                                 Targets, criterion)
from monosowa_tpu_torch.models.matcher import MatcherConfig
from monosowa_tpu_torch.models.monodetr import MonoDETR
from monosowa_tpu_torch.parallel.dist import (DataParallel, all_reduce_grads,
                                              global_sum)
from monosowa_tpu_torch.train.decode import extract_dets
from monosowa_tpu_torch.train.optim import optimizer_step

MODEL_INPUTS = ("image", "calib", "img_size")


def _inputs(batch: Dict[str, Any], dev: torch.device):
    return [torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
            for k in MODEL_INPUTS]


def targets_from_batch(batch: Dict[str, Any], dev: torch.device) -> Targets:
    """Batch dict -> padded Targets on ``dev``; validity gated by mask_2d
    like the reference's prepare_targets (trainer_helper.py:180-191)."""
    def t(key, dtype):
        return torch.as_tensor(np.asarray(batch[key]), dtype=dtype,
                               device=dev)

    f32, i64 = torch.float32, torch.int64
    return Targets(labels=t("labels", i64), boxes_3d=t("boxes_3d", f32),
                   boxes_2d=t("boxes", f32), depth=t("depth", f32),
                   size_3d=t("size_3d", f32),
                   heading_bin=t("heading_bin", i64),
                   heading_res=t("heading_res", f32),
                   valid=t("valid", torch.bool) & t("mask_2d", torch.bool))


def add_data_from_batch(batch: Dict[str, Any], templates: torch.Tensor,
                        template_dims_hwl: torch.Tensor,
                        dev: torch.device) -> Optional[AddData]:
    """The TFL / mask auxiliary payload on ``dev`` when the dataset emitted
    pseudo-label cars (use_add_data, kitti_dataset.py:421-449), else
    None."""
    if "car_points" not in batch:
        return None

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.asarray(batch[key]), dtype=dtype,
                               device=dev)

    img = batch["image"]
    return AddData(
        car_points=t("car_points"), car_pmask=t("car_pmask", torch.bool),
        car_valid=t("car_valid", torch.bool),
        car_moving=t("car_moving", torch.bool), car_masks=t("car_masks"),
        calib=t("calib"),
        resolution=torch.tensor([img.shape[2], img.shape[1]],
                                dtype=torch.float32, device=dev),
        canonical_scale=t("canonical_scale"), trans=t("trans"),
        trans_inv=t("trans_inv"), flip=t("flip_flag", torch.bool),
        img_w=t("img_size")[:, 0], templates=templates,
        template_dims_hwl=template_dims_hwl)


def _tfl_templates(dev: torch.device, n_points: int = 256):
    """Canonical template clouds for the aux losses, subsampled to a fixed
    small point count (the TFL pairwise tensor is K x 4T x P), and their
    (h, w, l), on ``dev``."""
    from monosowa_tpu_torch.sowa.templates import TemplateBank

    bank = TemplateBank.default()
    pts = np.asarray(bank.points)                      # (4, T, 3)
    stride = max(1, pts.shape[1] // n_points)
    l, w, h = (float(v) for v in bank.dims_lwh)
    return (torch.as_tensor(pts[:, ::stride][:, :n_points],
                            dtype=torch.float32, device=dev),
            torch.tensor([h, w, l], dtype=torch.float32, device=dev))


def criterion_config_from_yaml(model: MonoDETR,
                               mcfg: Dict[str, Any]) -> CriterionConfig:
    """Reference-format model yaml keys -> CriterionConfig
    (configs/monodetr.yaml:96-115 coefficient names)."""
    return CriterionConfig(
        group_num=model.group_num, num_queries=model.num_queries,
        num_classes=model.num_classes,
        matcher=MatcherConfig(backend="jv"),
        focal_alpha=float(mcfg.get("focal_alpha", 0.25)),
        w_cls=float(mcfg.get("cls_loss_coef", 2)),
        w_bbox=float(mcfg.get("bbox_loss_coef", 5)),
        w_giou=float(mcfg.get("giou_loss_coef", 2)),
        w_center=float(mcfg.get("3dcenter_loss_coef", 10)),
        w_dim=float(mcfg.get("dim_loss_coef", 1)),
        w_angle=float(mcfg.get("angle_loss_coef", 1)),
        w_depth=float(mcfg.get("depth_loss_coef", 1)),
        w_depth_map=float(mcfg.get("depth_map_loss_coef", 1)),
        num_depth_bins=int(mcfg.get("num_depth_bins", 80)),
        depth_min=float(mcfg.get("depth_min", 1e-3)),
        depth_max=float(mcfg.get("depth_max", 60.0)),
        use_tfl=bool(mcfg.get("use_tfl", False)),
        use_mask_loss=bool(mcfg.get("use_mask_loss", False)),
        w_tfl=float(mcfg.get("tfl_loss_coef", 1)),
        w_mask=float(mcfg.get("mask_loss_coef", 1)),
        mask_kind=str(mcfg.get("mask_loss", "BCE")))


def make_train_step(model: MonoDETR, ccfg: Optional[CriterionConfig],
                    optimizer: torch.optim.Optimizer,
                    lr_schedule: Optional[Callable[[int], float]] = None,
                    data_parallel: Optional[DataParallel] = None
                    ) -> Callable[..., Dict[str, float]]:
    """``train_step(batch, generator=None) -> losses``: the forward in
    training mode, the criterion, ``loss_total.backward()`` and one
    ``optimizer.step()``.  ``losses`` holds the criterion dict and the
    gradients' global norm ``grad_norm``, as floats.

    ``lr_schedule(step)`` sets every group's learning rate from the number
    of updates made so far (``train.optim.make_lr_schedule``); without it
    the optimizer keeps its own.  Dropout draws from ``generator`` (a
    ``torch.Generator`` on the model's device) or, when it is None, from
    the device's default generator.  ccfg None means the reference loss
    weights with the exact JV matcher on the model's device.

    With ``data_parallel`` (a rank of a training group), ``batch`` is the
    rank's slice of the global batch (``DataParallel.shard``): the
    criterion's batch normalisers and the gradients are summed over the
    group, dropout keeps the rank's slice of the whole batch's draws, and
    ``losses`` is the global batch's loss dict on every rank."""
    if ccfg is None:
        ccfg = CriterionConfig(group_num=model.group_num,
                               num_queries=model.num_queries,
                               num_classes=model.num_classes,
                               matcher=MatcherConfig(backend="jv"))
    templates = None
    if ccfg.use_tfl or ccfg.use_mask_loss:
        templates = _tfl_templates(model.device)
    pg = data_parallel.group if data_parallel is not None else None
    shard = data_parallel.batch_shard if data_parallel is not None else None

    def train_step(batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        model.train()
        dev = model.device
        add_data = (add_data_from_batch(batch, *templates, dev)
                    if templates is not None else None)
        out = model(*_inputs(batch, dev), generator=generator,
                    batch_shard=shard)
        losses = criterion(out, targets_from_batch(batch, dev), ccfg,
                           training=True, add_data=add_data, group=pg)
        optimizer.zero_grad(set_to_none=True)
        losses["loss_total"].backward()
        all_reduce_grads(model.parameters(), pg)
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        if lr_schedule is not None:
            lr = lr_schedule(optimizer_step(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        names = list(losses) + ["grad_norm"]
        values = torch.cat([global_sum(torch.stack(
            [v.detach() for v in losses.values()]), pg),
            grad_norm[None]]).cpu().tolist()
        return dict(zip(names, values))

    return train_step


def make_eval_step(model: MonoDETR, topk: int = 50
                   ) -> Callable[[Dict[str, np.ndarray]], torch.Tensor]:
    """``eval_step(batch) -> (B, topk, 37)`` detections on the model's
    device, in eval mode; ``batch`` holds numpy arrays or tensors under
    ``image``, ``calib`` and ``img_size``."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, np.ndarray]) -> torch.Tensor:
        model.eval()
        return extract_dets(model(*_inputs(batch, model.device)), topk=topk)

    return eval_step
