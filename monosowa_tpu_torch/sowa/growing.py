"""Context-aware region growing (CAAR): ground removal + region growing.

Behavioral contract (pseudo_label_generator/3d/scripts/context_growing.py):

* ``segment_plane`` (:12-53): RANSAC ground plane on a 0.2-voxel-downsampled
  cloud (distance_threshold 0.1, 10k iterations via open3d); points farther
  than 0.2 m from the plane survive;
* ``growing_algorithm`` (:67-119): region growing from the mask-frustum
  ("car") points at 7 thresholds (config growing_thresholds); a grown
  region is kept when >= 95% of its points are frustum points;
* ``perform_growing`` (:121-234): per-mask frame flow: median center of
  the mask-frustum points, 10 m XY-distance crop of the whole scan, plane
  removal, growing, the LARGEST accepted region across all thresholds,
  then a second 5 m round around that region's median.

Counterpart of the JAX package's ``sowa/growing.py``, with the same
results:

* RANSAC evaluates all hypotheses at once.  ``jax.random`` draws cannot be
  repeated in torch, so the hypotheses' point triples come from ``draw``:
  ``draw(mask, num_hypotheses) -> (H, 3)`` indices of valid points.  The
  default (``make_draw``) draws uniformly over the valid points, with
  replacement, from an explicit ``torch.Generator``; passing a ``draw``
  that repeats ``jax.random.choice`` with the JAX package's keys gives its
  planes.
* ``connected_components`` repeats the JAX package's 24 steps of min-label
  propagation with pointer jumping, whose labels are the JAX dense
  result's, converged or not, but never forms the N x N distance matrix:
  the edges within the threshold are found in row blocks over the points
  sorted along x (a column window of +-threshold), kept as index pairs
  with their squared distances, and a step is two ``scatter_reduce``
  "amin" over them (the minimum does not depend on the order).  A pair is
  an edge when ((dx^2 + dy^2) + dz^2) <= t^2, each step rounded to
  float32 as ``ops/tfl.pairwise_sq_dists`` rounds it, with t^2 the float32
  product of the float32 threshold (the JAX function takes the threshold
  as a traced float32).  The steps stop early only at a fixed point,
  after which no step changes anything.  ``largest_region`` builds the
  edges once at its largest threshold and filters them for each smaller
  one.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from monosowa_tpu_torch.ops.geometry import voxel_downsample_mask
from monosowa_tpu_torch.ops.tfl import pairwise_sq_dists

BIG = 1e9
THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7)

# elements of one block's (rows, window) distance tensor
_BLOCK_ELEMS = 1 << 24
# edges a scatter of propagate_labels takes at once
_EDGE_CHUNK = 1 << 26
# elements of ransac_plane's (points, hypotheses) distance tensor a chunk
_RANSAC_ELEMS = 1 << 24

Draw = Callable[[torch.Tensor, int], torch.Tensor]


def make_draw(seed: int = 0, device=None) -> Draw:
    """The default hypothesis draw: (H, 3) indices uniform over the valid
    points, with replacement (``jax.random.choice`` with p = mask / sum
    draws from the same distribution), from one ``torch.Generator``
    seeded with ``seed`` across calls.  The generator lives on ``device``
    (default: the first mask's device); ``make_draw(seed, "cpu")`` gives
    the same triples whatever device the points are on."""
    gen = None

    def draw(mask: torch.Tensor, num_hypotheses: int) -> torch.Tensor:
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device or mask.device).manual_seed(seed)
        valid = torch.nonzero(mask)[:, 0]
        pick = torch.randint(valid.numel(), (num_hypotheses, 3),
                             generator=gen, device=gen.device)
        return valid[pick.to(mask.device)]
    return draw


def _sq_threshold(t: float) -> float:
    """t^2 as the JAX function forms it from a traced float32 threshold:
    float32(float32(t) * float32(t))."""
    return float(np.float32(np.float32(t) * np.float32(t)))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """((a0 b0 + a1 b1) + a2 b2) over the last axis, each step rounded:
    the same bits on the card and the CPU (a matrix product's order and
    fused multiply-adds are the library's)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def ransac_plane(pts: torch.Tensor, mask: torch.Tensor,
                 draw: Optional[Draw] = None,
                 distance_threshold: float = 0.1,
                 num_hypotheses: int = 1024
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-hypothesis RANSAC plane fit: (abcd normalized (4,), inlier
    count).  The inliers of every hypothesis are counted over the valid
    points at once, in chunks of points; a degenerate hypothesis (normal
    shorter than 1e-9) counts -1, and the first maximum wins, as
    ``jnp.argmax``."""
    draw = draw or make_draw(0)
    tri = draw(mask, num_hypotheses)
    p0, p1, p2 = (pts[tri[:, k]] for k in range(3))         # (H, 3)
    normal = torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)
    norm = torch.sqrt(_dot3(normal, normal))[:, None]
    normal = normal / norm.clamp_min(1e-9)
    d = -_dot3(normal, p0)                                  # (H,)
    valid = pts[mask]
    inliers = torch.zeros(num_hypotheses, dtype=torch.int64,
                          device=pts.device)
    rows = max(1, _RANSAC_ELEMS // num_hypotheses)
    for r0 in range(0, valid.shape[0], rows):
        dist = (_dot3(valid[r0:r0 + rows, None, :], normal[None])
                + d[None, :]).abs()
        inliers += (dist < distance_threshold).sum(0)
    inliers = torch.where(norm[:, 0] < 1e-9, -1, inliers)
    best = torch.argmax(inliers)
    abcd = torch.cat([normal[best], d[best][None]])
    return abcd, inliers[best]


def remove_plane_points(pts: torch.Tensor, mask: torch.Tensor,
                        abcd: torch.Tensor,
                        keep_distance: float = 0.2) -> torch.Tensor:
    """Refined mask keeping points farther than ``keep_distance`` from the
    plane (context_growing.py:34-40).  Like a comparison with a
    weak-typed JAX scalar, a float32 tensor against a Python float
    compares in float32."""
    dist = (_dot3(pts, abcd[:3]) + abcd[3]).abs()
    return mask & (dist > keep_distance)


def neighbor_edges(pts: torch.Tensor, mask: torch.Tensor, threshold: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every pair i < j of valid points with d2 <= t^2 (t^2 as
    ``_sq_threshold``), as (i, j) int32 and d2 float32 tensors, each (E,).

    The valid points are sorted along x; a block of rows is compared with
    the window of sorted points from its first row to the last point
    within the threshold (plus a margin) of its last row, so a pair is
    tested once and a block's distance tensor holds at most 2^24
    elements.  d2 is ``ops/tfl.pairwise_sq_dists``: ((dx^2 + dy^2) + dz^2)."""
    t2 = _sq_threshold(threshold)
    reach = float(np.float32(threshold)) * (1.0 + 2.0 ** -9) + 1e-6
    idx = torch.nonzero(mask)[:, 0]
    x = pts[idx, 0]
    order = torch.sort(x, stable=True).indices
    idx = idx[order]
    p = pts[idx]
    xs = p[:, 0].contiguous()
    n = idx.numel()
    hi_all = torch.searchsorted(xs, xs + reach, right=True).cpu()
    out_i, out_j, out_d = [], [], []
    r0 = 0
    while r0 < n:
        # about as many rows as the first row's window is wide (a block's
        # tensor is rows x (rows + window)), halved while over budget
        w0 = int(hi_all[r0]) - r0
        r1 = min(n, r0 + max(64, min(w0, _BLOCK_ELEMS // max(w0, 1))))
        while r1 - r0 > 64 and (r1 - r0) * (int(hi_all[r1 - 1]) - r0) \
                > _BLOCK_ELEMS:
            r1 = r0 + (r1 - r0) // 2
        c1 = int(hi_all[r1 - 1])
        d2 = pairwise_sq_dists(p[r0:r1], p[r0:c1])
        rr = torch.arange(r0, r1, device=pts.device)[:, None]
        cc = torch.arange(r0, c1, device=pts.device)[None, :]
        hit = (d2 <= t2) & (cc > rr)
        ri, ci = torch.nonzero(hit, as_tuple=True)
        out_d.append(d2[ri, ci])
        out_i.append(idx[ri + r0].to(torch.int32))
        out_j.append(idx[ci + r0].to(torch.int32))
        r0 = r1
    if not out_i:
        empty = torch.zeros(0, dtype=torch.int32, device=pts.device)
        return empty, empty, pts.new_zeros(0)
    return torch.cat(out_i), torch.cat(out_j), torch.cat(out_d)


def propagate_labels(n: int, mask: torch.Tensor, ei: torch.Tensor,
                     ej: torch.Tensor, num_iters: int = 24) -> torch.Tensor:
    """The JAX ``connected_components`` steps over an edge list (each
    undirected edge once): labels start at the point index (n for invalid
    points); a step takes the minimum of each point's label and its
    neighbours' previous labels, then jumps each label to its label's
    label.  Stops early at a fixed point (one comparison a step).  The
    edges go through ``scatter_reduce`` in chunks of 2^26, so the int64
    copies of their indices stay bounded."""
    dev = mask.device
    labels = torch.where(mask, torch.arange(n, device=dev),
                         torch.full((n,), n, device=dev))
    for _ in range(num_iters):
        new = labels.clone()
        for e0 in range(0, ei.numel(), _EDGE_CHUNK):
            ci = ei[e0:e0 + _EDGE_CHUNK].long()
            cj = ej[e0:e0 + _EDGE_CHUNK].long()
            new.scatter_reduce_(0, ci, labels[cj], "amin")
            new.scatter_reduce_(0, cj, labels[ci], "amin")
        safe = new.clamp(0, n - 1)
        new = torch.where(new < n, torch.minimum(new, new[safe]), new)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def connected_components(pts: torch.Tensor, mask: torch.Tensor,
                         threshold: float,
                         num_iters: int = 24) -> torch.Tensor:
    """Component label per point (min point index in its component) of the
    eps-graph, after ``num_iters`` steps of min-label propagation with
    pointer jumping; invalid points get label n.  (N, 3), (N,) bool ->
    (N,) int64, the JAX function's labels."""
    ei, ej, _ = neighbor_edges(pts, mask, threshold)
    return propagate_labels(pts.shape[0], mask, ei, ej, num_iters)


def grow_mask(pts: torch.Tensor, mask: torch.Tensor, car_mask: torch.Tensor,
              threshold: float, overlap_min: float = 0.95) -> torch.Tensor:
    """One growing pass: keep points of components that (a) contain car
    points and (b) have >= overlap_min fraction of car points (float32
    shares, as the JAX function's)."""
    n = pts.shape[0]
    labels = connected_components(pts, mask, threshold)
    car = car_mask & mask
    total = torch.zeros(n + 1, device=pts.device).index_add_(
        0, labels, mask.float())
    fg = torch.zeros(n + 1, device=pts.device).index_add_(
        0, labels, car.float())
    comp_ok = (fg > 0) & (fg / total.clamp_min(1.0)
                          >= overlap_min)
    return mask & comp_ok[labels]


def largest_region(pts, mask, car_mask, thresholds,
                   overlap_min: float = 0.95, device=None,
                   stats: Optional[dict] = None) -> Optional[torch.Tensor]:
    """Boolean mask (on the points' device) of the single largest accepted
    region across all growing thresholds (context_growing.py:164-175
    top-candidates scan: a region is accepted when >= overlap_min of its
    points are frustum points, in float64 as the JAX function's numpy;
    size counts ALL grown points), or None.  The first threshold and the
    lowest label reaching the largest size win, as the JAX loop's strict
    ``>``.  The edges are built once, at the largest threshold (their
    count goes to ``stats["edges"]`` when a dict is given)."""
    dev = torch.device(device) if device is not None else (
        pts.device if torch.is_tensor(pts) else torch.device("cpu"))
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, device=dev).bool()
    car = torch.as_tensor(car_mask, device=dev).bool() & mask
    n = pts.shape[0]
    if len(thresholds) == 0:
        return None
    ei, ej, d2 = neighbor_edges(pts, mask, max(thresholds))
    if stats is not None:
        stats["edges"] = int(ei.numel())
    best_size, best = -1, None
    t2_max = _sq_threshold(max(thresholds))
    for t in thresholds:
        t2 = _sq_threshold(t)
        if t2 >= t2_max:
            labels = propagate_labels(n, mask, ei, ej)
        else:
            keep = d2 <= t2
            labels = propagate_labels(n, mask, ei[keep], ej[keep])
            del keep
        total = torch.bincount(labels[mask], minlength=n + 1)
        fg = torch.bincount(labels[mask & car], minlength=n + 1)
        ok = (fg > 0) & (fg.double() / total.clamp_min(1).double()
                         >= overlap_min)
        size = torch.where(ok, total, -1)
        top = int(size.max())
        if top > best_size:
            best_size = top
            best = labels == torch.argmax(size)
    return best


def _plane_filter(scan_xyz, draw: Draw, distance_threshold=0.1,
                  keep_distance=0.2, voxel=0.2, device=None):
    """segment_plane (context_growing.py:12-53): RANSAC on the 0.2-voxel
    downsample, keep points farther than keep_distance.  Returns a boolean
    numpy keep mask (None when degenerate)."""
    from monosowa_tpu_torch.device import resolve_device

    pts = torch.as_tensor(np.asarray(scan_xyz, np.float32),
                          device=resolve_device(device))
    if pts.shape[0] < 3:
        return None
    full = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    ds = voxel_downsample_mask(pts, full, voxel)
    if int(ds.sum()) < 3:
        return None
    abcd, _ = ransac_plane(pts, ds, draw,
                           distance_threshold=distance_threshold)
    return remove_plane_points(pts, full, abcd,
                               keep_distance=keep_distance).cpu().numpy()


def perform_growing_frame(scan, mask_img, camera_idx, draw: Draw = None,
                          thresholds: Sequence[float] = THRESHOLDS,
                          device=None, stats: Optional[list] = None):
    """Reference-exact per-mask frame flow (context_growing.py:121-234).

    scan: (N, 6) numpy [x, y, z, camera_idx, px, py] (loader.py:3354-3376
    layout, pixel rows already cropped to the image); mask_img: (H, W)
    bool.  Returns the grown (M, 3) xyz points or None, matching every
    early-out of the reference (empty frustum, < 3 crop points, degenerate
    plane, no accepted region).  ``draw`` is called once a round (two
    rounds; the default ``make_draw(0)``); the crops and the plane's keep
    mask are numpy as in the JAX function, the plane and the growing run
    on ``device`` (the card unless the caller names another).  ``stats``,
    when a list, gets one dict a round: the crop's points, the points left
    after the plane, the edges at the largest threshold."""
    from monosowa_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    draw = draw or make_draw(0)
    scan = np.asarray(scan)
    cam = scan[scan[:, 3] == camera_idx]
    in_mask = mask_img[cam[:, 4].astype(int), cam[:, 5].astype(int)]
    if in_mask.sum() == 0:
        return None
    center = np.median(cam[in_mask, :3], axis=0)

    def _round(center, radius):
        d = np.hypot(center[0] - scan[:, 0], center[1] - scan[:, 1])
        crop = scan[d < radius]
        if crop.shape[0] < 3:
            return None
        keep = _plane_filter(crop[:, :3], draw, device=dev)
        if keep is None:
            return None
        seg = crop[keep]
        cam_sel = seg[:, 3] == camera_idx
        seg_cam = seg[cam_sel]
        if seg_cam.shape[0] == 0:
            return None
        car = mask_img[seg_cam[:, 4].astype(int), seg_cam[:, 5].astype(int)]
        if car.sum() == 0:
            return None
        info = {"crop": int(crop.shape[0]),
                "after_plane": int(seg_cam.shape[0])}
        region = largest_region(seg_cam[:, :3].astype(np.float32),
                                np.ones(seg_cam.shape[0], bool), car,
                                thresholds, device=dev, stats=info)
        if stats is not None:
            stats.append(info)
        if region is None:
            return None
        return seg_cam[region.cpu().numpy(), :3]

    first = _round(center, 10.0)
    if first is None:
        return None
    return _round(np.median(first, axis=0), 5.0)


def perform_growing(pts: torch.Tensor, mask: torch.Tensor,
                    car_mask: torch.Tensor, draw: Draw = None,
                    thresholds: Sequence[float] = THRESHOLDS,
                    remove_ground: bool = True) -> torch.Tensor:
    """Full CAAR pass: optional RANSAC ground removal (over the whole
    mask, one ``draw``), then the union of accepted regions across all
    thresholds (context_growing.py:121-234 keeps the per-threshold
    regions; the pipeline consumes their union)."""
    if remove_ground:
        abcd, _ = ransac_plane(pts, mask, draw)
        mask = remove_plane_points(pts, mask, abcd)
    out = torch.zeros_like(mask)
    for t in thresholds:
        out = out | grow_mask(pts, mask, car_mask, t)
    return out
