"""The train step and the evaluation step.

Behavioral contract (MonoDETR/lib/helpers/trainer_helper.py:15-191,
tester_helper.py:80-108; the JAX package's ``train/trainer.py``): targets
filtered by mask_2d before the criterion (prepare_targets :180-191); loss =
weighted sum of the criterion dict; one AdamW update per step; the eval step
is the forward, then detection extraction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from monosowa_tpu_torch.models.criterion import (CriterionConfig, Targets,
                                                 criterion)
from monosowa_tpu_torch.models.matcher import MatcherConfig
from monosowa_tpu_torch.models.monodetr import MonoDETR
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


def criterion_config_from_yaml(model: MonoDETR,
                               mcfg: Dict[str, Any]) -> CriterionConfig:
    """Reference-format model yaml keys -> CriterionConfig
    (configs/monodetr.yaml:96-115 coefficient names)."""
    return CriterionConfig(
        group_num=model.group_num, num_queries=model.num_queries,
        num_classes=model.num_classes,
        matcher=MatcherConfig(),
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
        use_mask_loss=bool(mcfg.get("use_mask_loss", False)))


def make_train_step(model: MonoDETR, ccfg: Optional[CriterionConfig],
                    optimizer: torch.optim.Optimizer,
                    lr_schedule: Optional[Callable[[int], float]] = None
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
    weights."""
    if ccfg is None:
        ccfg = CriterionConfig(group_num=model.group_num,
                               num_queries=model.num_queries,
                               num_classes=model.num_classes)
    def train_step(batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        model.train()
        dev = model.device
        out = model(*_inputs(batch, dev), generator=generator)
        losses = criterion(out, targets_from_batch(batch, dev), ccfg,
                           training=True)
        optimizer.zero_grad(set_to_none=True)
        losses["loss_total"].backward()
        grad_norm = torch.nn.utils.get_total_norm(
            [p.grad for p in model.parameters() if p.grad is not None])
        if lr_schedule is not None:
            lr = lr_schedule(optimizer_step(optimizer))
            for group in optimizer.param_groups:
                group["lr"] = lr
        optimizer.step()
        names = list(losses) + ["grad_norm"]
        values = torch.stack([v.detach() for v in losses.values()]
                             + [grad_norm]).cpu().tolist()
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
