"""Car dimension estimation (rotating-calipers style), in torch.

Behavioral contract (pseudo_label_generator/3d/scripts/dimension_estimator.py):

* ``estimate_best_params`` (:189-238): for theta in 0..89 deg project XZ
  onto the rotated axes; closeness-to-edge score = -sum sigmoid(steepness *
  min(distance to 10th/90th-percentile edges)); pick the best theta and the
  min/max extent rectangle;
* ``get_3D_bbox`` (:122-149): PCA OBB of the 8 rectangle corners with the
  y-extent from the point heights;
* degenerate-view handling (:77-100): when the viewing direction nearly
  aligns with the car axis (|sin diff| < 0.09) only width/height are
  estimable (length forced to template); |cos diff| < 0.2 similarly for
  width;
* per-car result = median over the k=3 closest frames (:111-114); sanity
  clamps (l/w > 4, l < 2, w < 1 ... ) fall back to template dims.  The
  reference's line 115 carries an ``or True`` that forces template dims
  ALWAYS; ``force_template_dims=True`` reproduces that shipped behavior.

Counterpart of the JAX package's ``sowa/dimensions.py``: the 90 thetas of
a frame are one batched computation; ``estimate_car_dimensions`` takes and
returns numpy, as its callers do, and computes on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

BIG = 1e9


@dataclasses.dataclass(frozen=True)
class DimConfig:
    steepness: float = 10.0
    template_length: float = 3.88
    template_width: float = 1.63
    template_height: float = 1.526
    k_frames: int = 3
    force_template_dims: bool = True  # reference dimension_estimator.py:115


def _percentile_sorted(sorted_vals: torch.Tensor, n: torch.Tensor,
                       q: float) -> torch.Tensor:
    """Linear-interpolated percentile over the valid (sorted) prefix of
    each row: sorted_vals (..., N), n the valid count (int tensor)."""
    pos = (q / 100.0) * (n - 1).to(sorted_vals.dtype)
    lo = torch.floor(pos).long()
    hi = torch.minimum(lo + 1, n - 1)
    w = pos - lo.to(pos.dtype)
    take = lambda i: torch.gather(  # noqa: E731
        sorted_vals, -1, i.expand(*sorted_vals.shape[:-1], 1))[..., 0]
    return take(lo.reshape(1)) * (1 - w) + take(hi.reshape(1)) * w


def estimate_rectangle(points: torch.Tensor, mask: torch.Tensor,
                       cfg: DimConfig = DimConfig()):
    """(N, 3) padded points -> (theta_best, extent_xz (2,), score).

    theta is the in-plane rotation of the best-fit rectangle in [0, pi/2).
    """
    xz = points[:, [0, 2]]
    mask = mask.bool()
    n = mask.sum().clamp_min(1)
    thetas = torch.deg2rad(torch.arange(0, 90, dtype=torch.float32,
                                        device=points.device))
    cos, sin = torch.cos(thetas), torch.sin(thetas)
    e1 = torch.stack([cos, sin], -1)                     # (90, 2)
    e2 = torch.stack([-sin, cos], -1)
    c1 = e1 @ xz.T                                       # (90, N)
    c2 = e2 @ xz.T
    big = points.new_full((), BIG)
    c1s = torch.sort(torch.where(mask, c1, big), -1).values
    c2s = torch.sort(torch.where(mask, c2, big), -1).values
    p90_1 = _percentile_sorted(c1s, n, 90)[:, None]
    p10_1 = _percentile_sorted(c1s, n, 10)[:, None]
    p90_2 = _percentile_sorted(c2s, n, 90)[:, None]
    p10_2 = _percentile_sorted(c2s, n, 10)[:, None]
    d1 = torch.minimum((c1 - p10_1).abs(), (p90_1 - c1).abs())
    d2 = torch.minimum((c2 - p10_2).abs(), (p90_2 - c2).abs())
    d1 = torch.sigmoid(d1 * cfg.steepness)
    d2 = torch.sigmoid(d2 * cfg.steepness)
    scores = -torch.where(mask, torch.minimum(d1, d2), 0.0).sum(-1)
    ext1 = (torch.where(mask, c1, -big).amax(-1)
            - torch.where(mask, c1, big).amin(-1))
    ext2 = (torch.where(mask, c2, -big).amax(-1)
            - torch.where(mask, c2, big).amin(-1))
    best = int(scores.argmax())          # the first maximum, as jnp.argmax
    return thetas[best], torch.stack([ext1[best], ext2[best]]), scores[best]


def estimate_dimensions_one(points: torch.Tensor, mask: torch.Tensor,
                            center: torch.Tensor,
                            cfg: DimConfig = DimConfig()):
    """One frame's points -> (l, h, w) with degenerate-view handling.

    points are car-local (centered); center is the camera-frame car center
    used for the viewing-angle test (dimension_estimator.py:77-100).
    Returns (dims_lhw (3,), est_theta).
    """
    theta, ext_xz, _ = estimate_rectangle(points, mask, cfg)
    mask = mask.bool()
    big = points.new_full((), BIG)
    y_min = torch.where(mask, points[:, 1], big).amin()
    y_max = torch.where(mask, points[:, 1], -big).amax()
    height = y_max - y_min

    # order extents so index 0 = long axis (length candidate)
    long_first = ext_xz[0] >= ext_xz[1]
    ext0 = torch.where(long_first, ext_xz[0], ext_xz[1])
    ext1 = torch.where(long_first, ext_xz[1], ext_xz[0])
    theta_long = torch.where(long_first, theta, theta + np.pi / 2)

    # the reference's OBB angle is the NEGATED 2D long-axis angle
    # (get_3D_bbox: angle = -arctan2(ez, ex)), so angle_of_car =
    # -angle - pi/2 = theta_long - pi/2 in our scan coordinates
    angle_of_car = theta_long - np.pi / 2.0
    viewing = torch.atan2(center[2], center[0]) - np.pi / 2.0
    diff = angle_of_car - viewing

    tl = height.new_full((), cfg.template_length)
    tw = height.new_full((), cfg.template_width)
    normal = torch.stack([ext0, height, ext1])
    degen_length = torch.stack([tl, height, ext1])
    degen_width = torch.stack([ext0, height, tw])
    degen_weird = torch.stack([tl, height, ext0])

    dims = torch.where(torch.sin(diff).abs() < 0.09, degen_length,
                       torch.where(torch.cos(diff).abs() < 0.2,
                                   torch.where(ext0 > 2.5, degen_width,
                                               degen_weird),
                                   normal))
    # est_theta convention = reference angle - pi/2 (estimate_dimensions
    # est_theta branch) with angle = -theta_long
    return dims, -theta_long - np.pi / 2.0


def estimate_car_dimensions(frames_points, frames_masks, center,
                            cfg: DimConfig = DimConfig(), device=None
                            ) -> Tuple[np.ndarray, float]:
    """Median over up to k frames (host orchestration).

    frames_points: (F, N, 3) car-local per-frame clouds; frames_masks (F, N)
    (numpy); each frame's estimate runs on ``device`` (None: the card).
    Returns ((l, w, h), theta_est) with the reference's sanity clamps.
    """
    from monosowa_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    k = min(len(frames_points), cfg.k_frames)
    dims_all = np.zeros((k, 3), np.float32)
    thetas = np.zeros(k, np.float32)
    c = torch.as_tensor(np.asarray(center, np.float32), device=dev)
    for i in range(k):
        d, t = estimate_dimensions_one(
            torch.as_tensor(np.asarray(frames_points[i], np.float32),
                            device=dev),
            torch.as_tensor(np.asarray(frames_masks[i]), device=dev), c, cfg)
        packed = torch.cat([d, t.reshape(1)]).cpu().numpy()
        dims_all[i] = packed[:3]
        thetas[i] = packed[3]
    l = float(np.median(dims_all[:, 0]))
    h = float(np.median(dims_all[:, 1]))
    w = float(np.median(dims_all[:, 2]))

    bad = (w <= 0 or l / max(w, 1e-6) > 4.0 or l < 2.0 or w < 1.0
           or h < 1.0 or w > 2.5 or l > 6.0
           or np.isnan(l) or np.isnan(w) or np.isnan(h))
    if bad or cfg.force_template_dims:
        l, w, h = cfg.template_length, cfg.template_width, cfg.template_height
    return np.array([l, w, h], np.float32), float(np.median(thetas))
