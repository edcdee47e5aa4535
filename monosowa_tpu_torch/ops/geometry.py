"""Batched 3D geometry primitives on torch tensors.

Counterparts of the JAX package's ``ops/geometry.py``: yaw rotations, rigid
transforms, pinhole projection, depth back-projection, the masked median,
3D box corners, oriented-box containment, the voxel downsample of
region growing and the random downsample.  Point sets are padded to
fixed shapes with a validity mask; batch dimensions are explicit (leading
``...``).
"""

from __future__ import annotations

from typing import Optional

import torch

BIG = 1e9


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about the camera y (yaw) axis; (...,) -> (..., 3, 3).

    Matches scipy ``R.from_euler('zyx', [0, theta, 0])`` used by the
    reference's template posing (optimizer.py:468-472)."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(theta), torch.zeros_like(theta)
    return torch.stack([
        torch.stack([c, z, s], -1),
        torch.stack([z, o, z], -1),
        torch.stack([-s, z, c], -1),
    ], -2)


def transform_points(tmat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (or batch of) rigid transform to (..., N, 3) points."""
    return (pts @ tmat[..., :3, :3].transpose(-1, -2)
            + tmat[..., None, :3, 3])


def project_to_image(pts: torch.Tensor, p2: torch.Tensor):
    """(..., N, 3) cam points -> pixel (u, v) and depth via P2 (3, 4)."""
    hom = pts @ p2[:3, :3].T + p2[:3, 3]
    uv = hom[..., :2] / hom[..., 2:3].clamp_min(1e-6)
    return uv, hom[..., 2]


def backproject_depth(depth: torch.Tensor, fu, fv, cu, cv) -> torch.Tensor:
    """Depth map (H, W) -> (H*W, 3) camera-frame points.

    Equivalent of the meshgrid back-projection in metric3d.py:330-341.
    Give the intrinsics as tensors on the depth's device: a division by a
    host scalar may become a product with the reciprocal on the card."""
    h, w = depth.shape
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)
    x = (u - cu) * depth / fu
    y = (v - cv) * depth / fv
    return torch.stack([x, y, depth], -1).reshape(-1, 3)


def masked_median(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-axis median of the valid points; (..., N, 3), (..., N) ->
    (..., 3).

    The midpoint of the two middle values of the sorted valid prefix
    (invalid entries sort to the end), zero for an empty mask.
    ``torch.median`` returns the lower middle value, so it is not used."""
    n = mask.sum(-1)                                         # (...,)
    big = torch.where(mask[..., None, :], pts.transpose(-1, -2),
                      pts.new_tensor(BIG))                   # (..., 3, N)
    srt = torch.sort(big, dim=-1).values
    lo = ((n - 1).clamp_min(0) // 2)[..., None, None].expand(
        *n.shape, 3, 1)
    hi = (n // 2)[..., None, None].expand(*n.shape, 3, 1)
    med = (torch.gather(srt, -1, lo) + torch.gather(srt, -1, hi))[..., 0] \
        / 2.0
    return torch.where((n > 0)[..., None], med, torch.zeros_like(med))


def voxel_downsample_mask(pts: torch.Tensor, mask: torch.Tensor,
                          voxel: float) -> torch.Tensor:
    """Keep one representative point per occupied voxel, the first in scan
    order among equal hashes; (N, 3), (N,) bool -> (N,) bool, a refined
    mask over the same padded array (the JAX package's mask, bit for bit).

    The voxel key is ``floor(pts / voxel)`` with a true division by a
    tensor (a division by a host scalar may become a product with its
    reciprocal on the card, and a point on a voxel face would change
    voxel).  The int32 spatial hash wraps in two's complement, as XLA's
    does; valid rows sort first, each group of equal hashes in scan order
    (the JAX ``lexsort((h, ~mask))`` as two stable sorts)."""
    key = torch.floor(pts / pts.new_tensor(voxel)).to(torch.int32)
    h = ((key[:, 0] * 73856093) ^ (key[:, 1] * 19349663)
         ^ (key[:, 2] * 83492791))
    order = torch.sort(h, stable=True).indices
    order = order[torch.sort((~mask[order]).to(torch.int8),
                             stable=True).indices]
    sorted_h = h[order]
    sorted_valid = mask[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                       (sorted_h[1:] != sorted_h[:-1]) | ~sorted_valid[:-1]])
    keep = torch.zeros_like(mask)
    keep[order] = first
    return keep & mask


def random_downsample_mask(mask: torch.Tensor, max_points: int,
                           scores: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Keep at most ``max_points`` valid entries of ``mask`` at random,
    the JAX package's ``random_downsample_mask`` (:100): the valid entries
    whose uniform score is at or below the ``max_points``-th smallest (all
    of them where there are no more).  The scores are given (``scores``,
    e.g. the JAX key's draws, so that both packages keep the same points)
    or drawn from ``generator``; torch cannot repeat the JAX key's
    stream.  No host sync."""
    if scores is None:
        scores = torch.rand(mask.shape, generator=generator,
                            device=mask.device)
    scores = torch.where(mask, scores, torch.full_like(scores, 2.0))
    n = mask.sum()
    kth_idx = (torch.clamp(n, max=max_points) - 1).clamp(min=0)
    kth = torch.sort(scores.reshape(-1)).values.gather(0, kth_idx[None])[0]
    keep = (scores <= kth) & mask
    return torch.where(n <= max_points, mask, keep)


def box3d_corners(center: torch.Tensor, lwh: torch.Tensor,
                  ry: torch.Tensor) -> torch.Tensor:
    """(..., 3) center (box middle), (..., 3) l/w/h, (...,) yaw -> (..., 8, 3)
    corners in camera coords (x right, y down, z forward); yaw about y."""
    l, w, h = lwh[..., 0], lwh[..., 1], lwh[..., 2]
    sx = torch.stack([l, l, -l, -l, l, l, -l, -l], -1) / 2.0
    sy = torch.stack([h, h, h, h, -h, -h, -h, -h], -1) / 2.0
    sz = torch.stack([w, -w, -w, w, w, -w, -w, w], -1) / 2.0
    corners = torch.stack([sx, sy, sz], -1)                  # (..., 8, 3)
    return corners @ rot_y(ry).transpose(-1, -2) + center[..., None, :]


def points_in_obb(pts: torch.Tensor, center: torch.Tensor, lwh: torch.Tensor,
                  ry: torch.Tensor) -> torch.Tensor:
    """Boolean mask of points inside an oriented (yaw-only) box.

    Templates and the fitter put width on camera x, height on y and length
    on z at ry = 0, so the local-frame half extents are (w/2, h/2, l/2)."""
    local = (pts - center) @ rot_y(ry)   # R^T applied from the right
    half = torch.stack([lwh[..., 1], lwh[..., 2], lwh[..., 0]], -1) / 2.0
    return (local.abs() <= half).all(-1)


def points_in_obb_r(pts: torch.Tensor, center: torch.Tensor,
                    lwh: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Containment for a general-rotation OBB (columns of ``rot`` are the
    box axes): the scale-lidar gather carries a yaw box through an
    arbitrary SE(3) ego-motion, so the carried box is no longer yaw-only
    (scale_detector.py:67-78)."""
    local = (pts - center) @ rot                    # R^T (p - c) per row
    half = torch.stack([lwh[..., 1], lwh[..., 2], lwh[..., 0]], -1) / 2.0
    return (local.abs() <= half).all(-1)
