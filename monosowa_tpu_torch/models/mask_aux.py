"""Silhouette mask auxiliary loss (use_mask_loss path).

Behavioral contract (MonoDETR monodetr.py:577-804; the JAX package's
``models/mask_aux.py``): posed car templates are rendered to soft
silhouettes and compared to the pseudo-label instance masks with BCE or
DICE.  As in the JAX package, the silhouette is differentiable gaussian
point splatting of the posed template clouds onto the downsampled mask grid
(the reference rasterises meshes with PyTorch3D's SoftSilhouetteShader):
the same gradient pathway, mask -> projected point positions -> 3D pose.
"""

from __future__ import annotations

import torch


def splat_silhouette(points: torch.Tensor, calib: torch.Tensor,
                     grid_affine: torch.Tensor, out_h: int, out_w: int,
                     sigma_px: float = 1.5) -> torch.Tensor:
    """(Q, T, 3) camera points -> (Q, out_h, out_w) soft silhouettes.

    Projects through the full P2 (baseline terms included), maps into the
    mask grid with ``grid_affine`` (2, 3) — the augmentation affine composed
    with the 1/stride downsample — and accumulates isotropic gaussians,
    separable in y and x; the silhouette is a soft OR over points,
    1 - exp(-sum)."""
    z = points[..., 2].clamp(min=1e-3)
    u_img = (calib[0, 0] * points[..., 0] + calib[0, 1] * points[..., 1]
             + calib[0, 2] * points[..., 2] + calib[0, 3]) / z
    v_img = (calib[1, 0] * points[..., 0] + calib[1, 1] * points[..., 1]
             + calib[1, 2] * points[..., 2] + calib[1, 3]) / z
    u = grid_affine[0, 0] * u_img + grid_affine[0, 1] * v_img \
        + grid_affine[0, 2]
    v = grid_affine[1, 0] * u_img + grid_affine[1, 1] * v_img \
        + grid_affine[1, 2]

    gy = torch.arange(out_h, dtype=points.dtype, device=points.device)
    gx = torch.arange(out_w, dtype=points.dtype, device=points.device)
    # (Q, T, H) and (Q, T, W) separable gaussians
    wy = torch.exp(-((gy - v[..., None]) ** 2) / (2 * sigma_px ** 2))
    wx = torch.exp(-((gx - u[..., None]) ** 2) / (2 * sigma_px ** 2))
    acc = torch.einsum("qth,qtw->qhw", wy, wx)
    return 1.0 - torch.exp(-acc)


def mask_loss(pred_sil: torch.Tensor, target_mask: torch.Tensor,
              valid: torch.Tensor, kind: str = "BCE") -> torch.Tensor:
    """(Q, H, W) silhouettes vs (Q, H, W) target masks, per-query valid;
    the mean over the valid queries.

    kind: 'BCE' (the configs' default) or 'DICE' (monodetr.py mask_loss)."""
    eps = 1e-6
    if kind == "BCE":
        per_px = -(target_mask * torch.log(pred_sil + eps)
                   + (1 - target_mask) * torch.log(1 - pred_sil + eps))
        per_q = per_px.mean((1, 2))
    elif kind == "DICE":
        inter = (pred_sil * target_mask).sum((1, 2))
        denom = pred_sil.sum((1, 2)) + target_mask.sum((1, 2))
        per_q = 1.0 - (2 * inter + eps) / (denom + eps)
    else:
        raise ValueError(f"unknown mask loss {kind!r}")
    n = valid.sum().clamp(min=1)
    return torch.where(valid, per_q, 0.0).sum() / n
