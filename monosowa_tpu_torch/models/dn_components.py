"""Contrastive denoising (DN-DETR) query machinery (torch).

Behavioral contract (MonoDETR/lib/models/monodetr/dn_components.py:44-391,
shipped with ``use_dn: False``; the JAX package's
``models/dn_components.py``): during training, ``scalar`` (5) groups of
noised ground-truth copies are prepended as extra decoder queries — labels
flipped with probability label_noise_scale (0.2), 6-dof boxes jittered by
box_noise_scale (0.4) x their extents and clamped to [0, 1]; a block
attention mask stops denoising groups from seeing each other or the
matchable queries (and vice versa); DN queries are supervised directly
against their own targets (no Hungarian matching).

Fixed shapes as in the JAX package: each DN group holds ``max_objs`` slots
per image with a validity mask.  ``prepare_dn`` draws from an explicit
``torch.Generator``; its numbers are not ``jax.random``'s, so a comparison
with the JAX package hands both models the same ``DNQueries``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from monosowa_tpu_torch.parallel.dist import global_sum


@dataclasses.dataclass(frozen=True)
class DNConfig:
    scalar: int = 5                 # number of denoising groups
    label_noise_scale: float = 0.2
    box_noise_scale: float = 0.4
    num_classes: int = 3


class DNQueries(NamedTuple):
    label_ids: torch.Tensor    # (B, G*M) noised class ids for label_enc
    refpoints: torch.Tensor    # (B, G*M, 6) noised boxes (sigmoid space)
    valid: torch.Tensor        # (B, G*M) slot validity
    attn_mask: torch.Tensor    # (G*M + Q, G*M + Q) True = blocked
    num_dn: int
    num_groups: int


def build_joint_attn_mask(num_dn_groups: int, dn_group_size: int,
                          num_match_groups: int, queries_per_group: int,
                          device=None) -> torch.Tensor:
    """(total, total) bool, True = blocked, for [dn groups | matchable
    groups] self-attention: a matchable query sees no DN slot, a DN slot
    no slot of another DN group (it does see the matchable queries), and
    a matchable query no other matchable group (Group-DETR's
    depthaware_transformer.py:480-498 as a mask).  Written as a comparison
    of group ids; equal to the JAX package's loops (:61-84)."""
    pad = num_dn_groups * dn_group_size
    total = pad + num_match_groups * queries_per_group
    idx = torch.arange(total, device=device)
    is_dn = idx < pad
    group = torch.where(is_dn, idx // max(dn_group_size, 1),
                        (idx - pad) // max(queries_per_group, 1))
    same_kind = is_dn[:, None] == is_dn[None, :]
    return ((~is_dn[:, None] & is_dn[None, :])
            | (same_kind & (group[:, None] != group[None, :])))


def build_dn_attn_mask(num_dn_groups: int, group_size: int,
                       num_queries: int, device=None) -> torch.Tensor:
    """True entries are masked out (dn_components.py:150-170): matchable
    queries cannot attend to any DN slot; DN group i attends only within
    itself (and to the matchable queries).  The matchable queries form one
    group here."""
    return build_joint_attn_mask(num_dn_groups, group_size, 1, num_queries,
                                 device)


def prepare_dn(generator: Optional[torch.Generator], labels: torch.Tensor,
               boxes_3d: torch.Tensor, valid: torch.Tensor, num_queries: int,
               cfg: DNConfig = DNConfig()) -> DNQueries:
    """Padded targets (B, M[, 6]) -> DN queries on their device.

    boxes_3d: (B, M, 6) normalized (cx, cy, l, r, t, b).  Every draw comes
    from ``generator`` (on the targets' device), or from the device's
    default generator when it is None."""
    b, m = labels.shape
    g = cfg.scalar
    dev = labels.device
    known_labels = labels.repeat(1, g)                       # (B, G*M)
    known_boxes = boxes_3d.repeat(1, g, 1)                   # (B, G*M, 6)
    known_valid = valid.repeat(1, g)

    # label flipping
    p = torch.rand(known_labels.shape, generator=generator, device=dev)
    rand_label = torch.randint(0, cfg.num_classes, known_labels.shape,
                               generator=generator, device=dev,
                               dtype=known_labels.dtype)
    noised_labels = torch.where(p < cfg.label_noise_scale, rand_label,
                                known_labels)

    # box jitter scaled by the box extent (dn_components.py:125-135):
    # centers jitter by (l+r)/2, (t+b)/2; edge offsets by themselves
    diff = torch.cat(
        [((known_boxes[..., 2] + known_boxes[..., 3]) / 2)[..., None],
         ((known_boxes[..., 4] + known_boxes[..., 5]) / 2)[..., None],
         known_boxes[..., 2:]], -1)
    uni = torch.rand(known_boxes.shape, generator=generator, device=dev,
                     dtype=known_boxes.dtype)
    noise = (uni * 2 - 1) * diff * cfg.box_noise_scale
    noised_boxes = (known_boxes + noise).clamp(0.0, 1.0)

    attn = build_dn_attn_mask(g, m, num_queries, dev)
    return DNQueries(label_ids=noised_labels, refpoints=noised_boxes,
                     valid=known_valid, attn_mask=attn, num_dn=g * m,
                     num_groups=g)


def dn_loss(outputs_dn: Dict[str, torch.Tensor], labels: torch.Tensor,
            boxes_3d: torch.Tensor, valid: torch.Tensor,
            cfg: DNConfig = DNConfig(), focal_alpha: float = 0.25,
            focal_gamma: float = 2.0, group=None
            ) -> Dict[str, torch.Tensor]:
    """Direct (match-free) supervision of the DN slots: slot (g, j) of
    image b answers for target (b, j) (dn_components.py tgt_* losses).

    outputs_dn: dict with pred_logits (B, G*M, C), pred_boxes (B, G*M, 6).
    With a process ``group``, the valid slots are counted over the group's
    whole batch (``parallel.dist``): this rank's share of the global loss.
    """
    g = cfg.scalar
    tgt_labels = labels.repeat(1, g).long()
    tgt_boxes = boxes_3d.repeat(1, g, 1)
    tgt_valid = valid.repeat(1, g)
    num = global_sum(tgt_valid.sum(), group).clamp(min=1).to(torch.float32)

    logits = outputs_dn["pred_logits"]
    onehot = F.one_hot(torch.where(tgt_valid, tgt_labels, cfg.num_classes),
                       cfg.num_classes + 1)[..., :-1].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(p + 1e-8)
           + (1 - onehot) * torch.log(1 - p + 1e-8))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    a_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    loss_ce = (a_t * (1 - p_t) ** focal_gamma * ce).sum() / num

    l1 = (outputs_dn["pred_boxes"] - tgt_boxes).abs().sum(-1)
    loss_bbox = (l1 * tgt_valid).sum() / num
    return {"tgt_loss_ce": loss_ce, "tgt_loss_bbox": loss_bbox}
