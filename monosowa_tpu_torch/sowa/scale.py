"""Scale detector: template/size grid search + bbox reducer.

Behavioral contract (pseudo_label_generator/3d/scripts/optimizer.py:179-290
optimize_scale and scale_detector.py:14-259):

* second grid search over 4 template models x 8 length scales
  (x optional 8 width scales) x 10x10 translations whose ranges are
  modulated by |cos/sin theta| (optimizer.py:204-209), height scale fixed
  from the point y-extent clipped to [0.75, 1.25]; then an 8x20
  height-scale x shift pass (optimizer.py:259-290);
* ``bbox_reducer``: gather points inside the fitted box bloated by
  width_bloat/0.4 (scale_detector.py:150-175), shrink to the axis-aligned
  extent of contained points in the box frame, +0.1 m length offset,
  falling back to template dims when the reduced length deviates beyond
  [max_length_diff_scale, 1.1] x the fitted length (:223-240).

Counterpart of the JAX package's ``sowa/scale.py``: each pass poses all
of its templates at once (3,200 poses, then 160) and scores them in one
call of the exact coverage (``ops.tfl.binary_both_way_loss``: the
hand-written kernel on the card).  Off by default (use_scale_detector
False, configs/config.yaml:90) like the reference; the CLI's ``demo`` and
``dimensions_output`` actions turn it on.

DOCUMENTED DEVIATION (the JAX package's): the reference's KITTI scale
branch (optimizer.py:438-463 get_template(scale=True)) applies
``[:, 0] *= scale_length; [:, 1] *= scale_width; [:, 2] *= scale_height``
to camera-frame templates whose axes are x=width (1.63 m extent),
y=height (1.53), z=length (3.88), i.e. its "length" scale varies the
car's WIDTH, its height-extent-derived scale varies the LENGTH, and the
"width" scale (a no-op [1.0] in the shipped config) would vary the
HEIGHT; `lidar_car_template_scale` is the same list as the main
templates (loader.py:3498).  This module scales the geometrically
intended axes instead: width*x, height*y, length*z.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from monosowa_tpu_torch.ops import tfl
from monosowa_tpu_torch.ops.geometry import (points_in_obb, points_in_obb_r,
                                             rot_y)

BIG = 1e9


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    scale_min: float = 0.75
    scale_max: float = 1.25
    n_scale: int = 8            # scale_num_scale_iters
    n_width: int = 8            # width_num_scale_iters
    n_trans: int = 10           # opt_param{1,2}_scale_iters
    independent_width: bool = False
    num_templates: int = 4
    radius: float = 0.2
    template_length: float = 3.88
    template_width: float = 1.63
    template_height: float = 1.526
    height_n: int = 8
    height_trans_n: int = 20


class ScaleResult(NamedTuple):
    template_index: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    theta: torch.Tensor
    loss: torch.Tensor


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int
              ) -> torch.Tensor:
    """``jnp.linspace`` (endpoint included) in float32: start * (1 - s) +
    stop * s with s = i / (num - 1), the last entry ``stop`` itself."""
    i = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    s = i / i.new_full((), float(num - 1))
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def optimize_scale(scan: torch.Tensor, scan_mask: torch.Tensor,
                   templates: torch.Tensor, base_pose: torch.Tensor,
                   cfg: ScaleConfig = ScaleConfig()) -> ScaleResult:
    """scan (S, 3) camera coords; templates (4, T, 3) canonical;
    base_pose = [x, y, z, theta] from the main fit (float32 tensors on one
    device)."""
    dev = scan.device
    scan_mask = scan_mask.bool()
    x0, y0, z0, theta = base_pose[0], base_pose[1], base_pose[2], base_pose[3]
    big = scan.new_full((), BIG)

    # height scale from the point extent (optimizer.py:196-201)
    y_ext = (torch.where(scan_mask, scan[:, 1], -big).amax()
             - torch.where(scan_mask, scan[:, 1], big).amin())
    h_scale = torch.clamp(
        y_ext / y_ext.new_full((), cfg.template_height), 0.75, 1.25)

    # translation ranges modulated by theta (optimizer.py:204-207)
    amp = (torch.cos(theta) + torch.sin(theta)).abs()
    t1 = _linspace(-amp, amp, cfg.n_trans)
    t2 = _linspace(-amp, amp, cfg.n_trans)
    scales = torch.as_tensor(
        np.linspace(cfg.scale_min, cfg.scale_max, cfg.n_scale), device=dev
    ).float()
    widths = torch.as_tensor(
        np.linspace(cfg.scale_min, cfg.scale_max, cfg.n_width)
        if cfg.independent_width else np.array([1.0]), device=dev).float()

    # pose table: (template, l_scale, w_scale, t1, t2)
    grids = np.meshgrid(
        np.arange(cfg.num_templates), np.arange(len(scales)),
        np.arange(len(widths)), np.arange(cfg.n_trans),
        np.arange(cfg.n_trans), indexing="ij")
    ti, li, wi, ai, bi = (torch.as_tensor(g.reshape(-1), device=dev)
                          for g in grids)

    rot = rot_y(theta)
    sl = scales[li]
    sw = widths[wi] if cfg.independent_width else sl
    hs = h_scale.expand_as(sl)
    scaled = templates[ti] * torch.stack([sw, hs, sl], -1)[:, None, :]
    off = torch.stack([t1[ai] + x0, y0.expand_as(sl), t2[bi] + z0], -1)
    posed_all = scaled @ rot.T + off[:, None, :]        # (3200, T, 3)
    losses = tfl.binary_both_way_loss(scan, scan_mask, posed_all,
                                      cfg.radius)
    best = losses.argmin()                  # the first minimum
    bt = ti[best]
    bl = sl[best]
    bw = sw[best]
    bx = t1[ai[best]] + x0
    bz = t2[bi[best]] + z0

    # second pass: height scale x y-shift (optimizer.py:259-290)
    h_scales = _linspace(scan.new_full((), cfg.scale_min),
                         scan.new_full((), cfg.scale_max), cfg.height_n)
    y_shifts = _linspace(-amp, amp, cfg.height_trans_n)
    hi, yi = (g.reshape(-1) for g in torch.meshgrid(
        torch.arange(cfg.height_n, device=dev),
        torch.arange(cfg.height_trans_n, device=dev), indexing="ij"))
    n2 = hi.shape[0]
    scaled2 = templates[bt][None] * torch.stack(
        [bw.expand(n2), h_scales[hi], bl.expand(n2)], -1)[:, None, :]
    off2 = torch.stack([bx.expand(n2), y_shifts[yi] + y0, bz.expand(n2)], -1)
    posed2 = scaled2 @ rot.T + off2[:, None, :]         # (160, T, 3)
    losses2 = tfl.binary_both_way_loss(scan, scan_mask, posed2, cfg.radius)
    best2 = losses2.argmin()

    return ScaleResult(
        template_index=bt,
        length=bl * cfg.template_length,
        width=bw * cfg.template_width,
        height=h_scales[hi[best2]] * cfg.template_height,
        x=bx, y=y_shifts[yi[best2]] + y0, z=bz, theta=theta,
        loss=losses2[best2])


def extract_scale_lidar_scans(center, lwh, theta, scans, transforms,
                              bbox_scale: float = 1.5, device=None
                              ) -> np.ndarray:
    """Re-aggregate a standing car's points from live per-frame scans for
    the scale optimizer: the real-LiDAR branch of
    ``extract_lidar_data_from_bbox_tracker`` (scale_detector.py:14-104).
    With ``use_pseudo_lidar: True`` the reference short-circuits to
    ``scale_lidar = lidar`` (:17-21), which the pipeline's default path
    already matches by fitting on the aggregated cloud.

    Per neighbor frame: the fitted yaw box (dims x ``bbox_scale``,
    scale_detector.bbox_scale / create_bboxes :121) is carried into the
    frame with the inverse ego transform (:67-78: the box center is
    moved by T_inv and its rotation becomes T_inv[:3,:3] @ R_y(theta),
    no longer yaw-only), live-scan points inside are gathered and
    returned to the reference frame with T (:85-91).  The containment
    test runs in float32 on ``device`` (None: the card), as the JAX
    package's does on its device.

    ``scans``: list of (N_i, >=3) camera-frame arrays (one per frame);
    ``transforms``: (T, 4, 4) T_cur_to_ref.  Returns (M, 3) ref-frame
    points (possibly empty).
    """
    from monosowa_tpu_torch.device import resolve_device

    device = resolve_device(device)
    center = np.asarray(center, np.float64)
    lwh = np.asarray(lwh, np.float64) * bbox_scale
    ry = rot_y(torch.tensor(float(theta), dtype=torch.float32)
               ).double().numpy()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    out = []
    for scan, t in zip(scans, np.asarray(transforms, np.float64)):
        if scan is None or len(scan) == 0:
            continue
        t_inv = np.linalg.inv(t)
        c_cur = t_inv[:3, :3] @ center + t_inv[:3, 3]
        r_cur = t_inv[:3, :3] @ ry
        pts = np.asarray(scan, np.float64)[:, :3]
        inside = points_in_obb_r(f32(pts), f32(c_cur), f32(lwh),
                                 f32(r_cur)).cpu().numpy()
        if not inside.any():
            continue
        sel = pts[inside]
        out.append(sel @ t[:3, :3].T + t[:3, 3])
    if not out:
        return np.zeros((0, 3))
    return np.concatenate(out, 0)


def _local_aabb(scan, inside, gather_center, theta):
    """Axis-aligned extents/centers of the inside points in the gather
    box's local frame (x=width, y=height, z=length)."""
    local = (scan - gather_center) @ rot_y(theta)
    big = scan.new_full((), BIG)
    lo = torch.where(inside[:, None], local, big).amin(0)
    hi = torch.where(inside[:, None], local, -big).amax(0)
    return lo, hi


def bbox_reduce(scan: torch.Tensor, scan_mask: torch.Tensor,
                center: torch.Tensor, lwh: torch.Tensor, theta: torch.Tensor,
                width_bloat: float = 0.5, length_offset: float = 0.1,
                max_length_diff: float = 0.75,
                template_dims: tuple = (3.88, 1.63, 1.526)):
    """Shrink a fitted box to the axis-aligned extent of contained points
    (scale_detector.py:135-259 ``bbox_reducer_tracked``, KITTI branch):

    1. gather points in the fitted box bloated by |cos|/|sin|-modulated
       ``width_bloat`` on the width/length axes and 0.4 on height, the box
       shifted up by 0.4 (:154-158);
    2. new length = local-z extent of the gathered points; the new center
       keeps the gathered AABB's y and z (length-axis) offsets but zeroes
       the cross (width) shift (:178-187);
    3. a second gather bloated 0.8 in height and shifted up only 0.2 gives
       the refined height (:197-218);
    4. fall back to template dims at the original center when the reduced
       length is outside [max_length_diff, 1.1] x the fitted length
       (:223-240); otherwise width is kept and length gets +0.1 m (:241-246).

    Returns (center', lwh', used_reduction flag).  scan in camera coords;
    float32 tensors on one device.
    """
    scan_mask = scan_mask.bool()
    sin_b = torch.sin(theta).abs() * width_bloat
    cos_b = torch.cos(theta).abs() * width_bloat
    up = center.new_tensor

    g1_lwh = torch.stack([lwh[0] + sin_b, lwh[1] + cos_b, lwh[2] + 0.4])
    g1_center = center + up([0.0, -0.4, 0.0])
    inside1 = points_in_obb(scan, g1_center, g1_lwh, theta) & scan_mask
    lo1, hi1 = _local_aabb(scan, inside1, g1_center, theta)

    new_len = hi1[2] - lo1[2]
    mid1 = (hi1 + lo1) / 2.0
    # zero the width-axis shift (scale_detector.py:184 center[0] = 0)
    shift_local = torch.stack([torch.zeros_like(mid1[1]), mid1[1], mid1[2]])
    new_center = g1_center + rot_y(theta) @ shift_local

    g2_lwh = torch.stack([lwh[0] + sin_b, lwh[1] + cos_b, lwh[2] + 0.8])
    g2_center = center + up([0.0, -0.2, 0.0])
    inside2 = points_in_obb(scan, g2_center, g2_lwh, theta) & scan_mask
    lo2, hi2 = _local_aabb(scan, inside2, g2_center, theta)
    new_h = hi2[1] - lo2[1]

    ratio = new_len / torch.clamp_min(lwh[0], 1e-6)
    ok = (ratio >= max_length_diff) & (ratio <= 1.1) & inside1.any() \
        & inside2.any()
    out_center = torch.where(ok, new_center, center)
    out_lwh = torch.where(ok,
                          torch.stack([new_len + length_offset, lwh[1],
                                       new_h]),
                          up(list(template_dims)))
    return out_center, out_lwh, ok
