"""Waymo raw-camera stages: pair stitching, 2D mask tracking across the pair
canvases, and un-warping tracked masks back to the cameras.

Counterpart of the JAX package's ``sowa/waymo2d.py`` (reference
stitching.py:80-312, tracker_ODTrack.py:60-375, filtering.py:164-425,
loader.py:701-754), with the same contract:

* 5 cameras a frame in slot order [SIDE_LEFT, FRONT_LEFT, FRONT,
  FRONT_RIGHT, SIDE_RIGHT] (Waymo camera ids 4/2/1/3/5); side cameras (886
  rows) are zero-padded at the top to the front height;
* four stitched pair canvases a frame: for z = 0, 1 the left image warped
  by H into the canvas and the right one pasted at the right slot, for
  z = 2, 3 mirrored; canvas (cam_h + height_pad, 2 cam_w + width_pad);
* the per-sequence best homography of each pair (``sowa/stitching.py``);
* tracking with the reference's camera-switch and track-break rules, and
  re-association to detections by xywh IoU > 0.25;
* a pair-canvas mask maps to BOTH cameras of the pair (the fixed one by
  slicing, the warped one by the inverse homography); the fused LiDAR
  points whose projection lands in either mask form the observation.

The warps run on the device of their image (``ops/warp.py``, OpenCV's
rule): numpy images go to ``device`` (default the card), and the canvases
stay there from the stitch to the mask backend and the tracker.  Masks
come back to the host, where the LiDAR gather and the labeller's host
stages read them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops.warp import cv2_warp_perspective
from monosowa_tpu_torch.sowa import stitching as stitch_mod
from monosowa_tpu_torch.sowa.lomm import Track
from monosowa_tpu_torch.sowa.stitching import as_image
from monosowa_tpu_torch.sowa.tracker2d import TemplateMatchTracker

# camera slot -> waymo camera id (FRONT=1, FRONT_LEFT=2, FRONT_RIGHT=3,
# SIDE_LEFT=4, SIDE_RIGHT=5); slots follow get_imgs order
CAM_SLOT_TO_WAYMO_ID = (4, 2, 1, 3, 5)

# pair z -> (left slot, right slot, left_to_right) per stitching.py:80-96
PAIRS = ((0, 1, True), (1, 2, True), (2, 3, False), (3, 4, False))

# vehicle -> camera-like axis permutation (waymo_to_kitti_projected.py:235)
# so the KITTI-frame fitting runs unchanged on waymo points
VEHICLE_TO_CAM = np.array([[0.0, -1.0, 0.0],
                           [0.0, 0.0, -1.0],
                           [1.0, 0.0, 0.0]])


@dataclasses.dataclass(frozen=True)
class PairLayout:
    """Pair-canvas geometry (config image_stitching.* + waymo image sizes).

    Defaults are the production Waymo values; tests shrink them."""

    cam_h: int = 1280
    cam_w: int = 1920
    side_h: int = 886          # SIDE_* camera height before top-padding
    height_pad: int = 100
    width_pad: int = 750

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        return (self.cam_h + self.height_pad,
                2 * self.cam_w + self.width_pad)

    @property
    def paste_y0(self) -> int:
        return self.height_pad // 2

    def paste_slice(self, left_to_right: bool):
        """Canvas region of the un-warped (pasted) camera."""
        ys = slice(self.paste_y0, self.paste_y0 + self.cam_h)
        xs = (slice(self.canvas_hw[1] - self.cam_w, self.canvas_hw[1])
              if left_to_right else slice(0, self.cam_w))
        return ys, xs


def pad_side_image(img, layout: PairLayout):
    """Zero-pad a side camera image (numpy or tensor) at the TOP to the
    front-camera height (stitching.py:294-296)."""
    if img.shape[0] >= layout.cam_h:
        return img
    pad = layout.cam_h - img.shape[0]
    if isinstance(img, torch.Tensor):
        top = img.new_zeros((pad,) + tuple(img.shape[1:]))
        return torch.cat([top, img], 0)
    width = [(pad, 0)] + [(0, 0)] * (img.ndim - 1)
    return np.pad(img, width)


def stitch_pair(img_a, img_b, homo: Optional[np.ndarray],
                left_to_right: bool, layout: PairLayout,
                device=None) -> torch.Tensor:
    """One stitched pair canvas (stitching.py:112-130) on the device: the
    warped camera (left image for left_to_right pairs, right otherwise)
    fills the canvas via H; the other camera overwrites its fixed slot."""
    h, w = layout.canvas_hw
    src = as_image(img_a if left_to_right else img_b, device)
    fixed = as_image(img_b if left_to_right else img_a, src.device)
    if homo is None:
        # a pair with < 4 matches over the whole sequence has no homography
        # (the NaN sentinel): the canvas holds only the pasted camera
        canvas = src.new_zeros((h, w) + tuple(src.shape[2:]))
    else:
        canvas = cv2_warp_perspective(src, np.asarray(homo, np.float64),
                                      (w, h))
        if canvas.dim() < src.dim():   # cv2 drops trailing singleton channels
            canvas = canvas[..., None]
    ys, xs = layout.paste_slice(left_to_right)
    canvas[ys, xs] = fixed.to(canvas.dtype)
    return canvas


def unwarp_pair_mask(mask, homo: Optional[np.ndarray], left_to_right: bool,
                     layout: PairLayout, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pair-canvas mask -> (warped-camera mask, fixed-camera mask) on the
    host, both in padded camera coords (inverse_of_mask_img01/23,
    filtering.py:405-425): the FULL canvas mask inverse-warped (on the
    device) and cropped to the camera window."""
    ys, xs = layout.paste_slice(left_to_right)
    m = as_image(mask, device)
    fixed_mask = m[ys, xs].bool().cpu().numpy()
    if homo is None:
        return np.zeros((layout.cam_h, layout.cam_w), bool), fixed_mask
    inv = np.linalg.inv(np.asarray(homo, np.float64))
    warped = cv2_warp_perspective(m.float(), inv, (m.shape[1], m.shape[0]),
                                  crop_hw=(layout.cam_h, layout.cam_w)) > 0.5
    return warped.cpu().numpy(), fixed_mask


def _camera_masks(warped_m, fixed_m, pair_idx: int, layout: PairLayout):
    """((warped mask, slot), (fixed mask, slot)), side cameras cropped to
    their bottom side_h rows."""
    left_slot, right_slot, ltr = PAIRS[pair_idx]
    warped_slot = left_slot if ltr else right_slot
    fixed_slot = right_slot if ltr else left_slot
    if warped_slot in (0, 4):
        warped_m = warped_m[-layout.side_h:, :]
    return (warped_m, warped_slot), (fixed_m, fixed_slot)


def _larger(warped, fixed):
    """The larger un-warped area claims the observation
    (convert_stitched_img_to_normal, loader.py:701-754)."""
    return warped if warped[0].sum() > fixed[0].sum() else fixed


def _both(warped, fixed, layout: PairLayout):
    fm, fs = fixed
    if fs in (0, 4):
        fm = fm[-layout.side_h:, :]
    return [(m, s) for m, s in (warped, (fm, fs)) if m.any()]


def pano_mask_to_camera(mask, pair_idx: int, homos: Sequence,
                        layout: PairLayout, device=None
                        ) -> Tuple[Optional[np.ndarray], int]:
    """Pair-canvas mask -> (camera-frame mask, camera SLOT): the larger
    un-warped area claims it.  Side-camera masks (slots 0/4) are cropped to
    the bottom side_h rows (the fixed one is not, as in the JAX package)."""
    ltr = PAIRS[pair_idx][2]
    warped_m, fixed_m = unwarp_pair_mask(mask, homos[pair_idx], ltr, layout,
                                         device)
    return _larger(*_camera_masks(warped_m, fixed_m, pair_idx, layout))


def pano_mask_to_both_cameras(mask, pair_idx: int, homos: Sequence,
                              layout: PairLayout, device=None
                              ) -> List[Tuple[np.ndarray, int]]:
    """Pair-canvas mask -> BOTH camera-frame masks [(mask, slot), ...]
    (extract_lidar_features unions in-mask points from the two cameras of
    the pair, filtering.py:164-280); side-camera masks cropped to the
    bottom side_h rows; empty masks dropped."""
    ltr = PAIRS[pair_idx][2]
    warped_m, fixed_m = unwarp_pair_mask(mask, homos[pair_idx], ltr, layout,
                                         device)
    return _both(*_camera_masks(warped_m, fixed_m, pair_idx, layout),
                 layout)


def estimate_pair_homographies(get_imgs, n_frames: int, matcher=None,
                               layout: PairLayout = PairLayout(),
                               threshold: float = 3.0,
                               iterations: int = 500
                               ) -> List[Optional[np.ndarray]]:
    """Per-sequence best homography for each of the 4 pairs: each frame's
    matches give a candidate H, scored by its inliers over every frame's
    matches.  ``get_imgs(i)`` -> the 5 slot-ordered images (side images
    padded here).  H maps the warped camera (left for left_to_right pairs)
    into canvas coords: the fixed camera's keypoints are lifted by its
    paste offset."""
    matcher = matcher or stitch_mod.OrbMatcherBackend()
    per_pair_matches: List[List[Tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in PAIRS]
    for i in range(n_frames):
        imgs = [pad_side_image(im, layout) for im in get_imgs(i)]
        for z, (a, b, ltr) in enumerate(PAIRS):
            src = imgs[a] if ltr else imgs[b]
            dst = imgs[b] if ltr else imgs[a]
            kp_src, kp_dst = matcher.match(src, dst)
            if len(kp_src) >= 4:
                ys, xs = layout.paste_slice(ltr)
                kp_dst = kp_dst + np.array([xs.start, ys.start], float)
                per_pair_matches[z].append((kp_src, kp_dst))
    out: List[Optional[np.ndarray]] = []
    for z in range(len(PAIRS)):
        if not per_pair_matches[z]:
            out.append(None)
            continue
        out.append(stitch_mod.select_best_homography(
            per_pair_matches[z], threshold, iterations))
    return out


def stitch_frame(imgs: Sequence, homos: Sequence,
                 layout: PairLayout = PairLayout(), device=None
                 ) -> List[torch.Tensor]:
    """All 4 pair canvases of one frame's 5 slot-ordered images, on the
    device."""
    padded = [pad_side_image(as_image(im, device), layout) for im in imgs]
    return [stitch_pair(padded[a], padded[b], homos[z], ltr, layout)
            for z, (a, b, ltr) in enumerate(PAIRS)]


# ---------------------------------------------------------------------------
# tracking across pair canvases (tracker_ODTrack.py)
# ---------------------------------------------------------------------------

def _iou_xywh(b1, b2) -> float:
    """Reference IoU with the +1 pixel convention (compute_iou :283-302)."""
    x1, y1, w1, h1 = b1
    x2, y2, w2, h2 = b2
    xa, ya = max(x1, x2), max(y1, y2)
    xb, yb = min(x1 + w1, x2 + w2), min(y1 + h1, y2 + h2)
    inter = max(0, xb - xa + 1) * max(0, yb - ya + 1)
    return inter / float(w1 * h1 + w2 * h2 - inter)


def mask_bbox_xywh(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(np.asarray(mask))
    if len(xs) == 0:
        return None
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], float)


def check_for_image_switch(bbox_xywh, pair_idx: int, rdy: int, switched: int,
                           homos: Sequence, layout: PairLayout,
                           min_pixels: int = 50, device=None
                           ) -> Tuple[int, int, int]:
    """Camera-switch logic (check_for_image_switch :304-375): the box mask
    on the pair canvas (on the device) tells which slot the object
    occupies; 2 consecutive off-slot frames switch the pair, which then
    holds for a 3-frame grace period (switched = 3)."""
    h, w = layout.canvas_hw
    x, y, bw, bh = (int(v) for v in bbox_xywh)
    y0 = layout.paste_y0
    cw, ch = layout.cam_w, layout.cam_h

    def box_mask():
        m = torch.zeros((h, w), dtype=torch.float32,
                        device=resolve_device(device))
        m[max(y, 0):y + bh, max(x, 0):x + bw] = 1.0
        return m

    def warp_region(region, homo):
        full = region.new_zeros((h, w))
        full[:region.shape[0], :region.shape[1]] = region
        return cv2_warp_perspective(full, np.asarray(homo, np.float64),
                                    (w, h))

    if pair_idx == 0:
        # does the fixed (front-left) part land in pair 1's canvas?
        region = box_mask()[y0:y0 + ch, -cw:]
        if homos[1] is not None and float(
                warp_region(region, homos[1])[:, -cw:].sum()) > min_pixels:
            rdy += 1
            if rdy >= 2:
                return 1, 0, 3
        else:
            rdy = 0
    elif pair_idx in (1, 2):
        m = box_mask()
        part = m[:, -cw:] if pair_idx == 1 else m[:, :cw]
        if float(part.sum()) > min_pixels:
            cols = torch.nonzero(part)[:, 1].double().mean()
            off_slot = (float(cols) > cw / 2) if pair_idx == 1 else \
                (float(cols) <= cw / 2)
            if off_slot:
                rdy += 1
                if rdy >= 2:
                    return (2, 0, 3) if pair_idx == 1 else (1, 0, 3)
            else:
                rdy = 0
        else:
            rdy += 1
            if rdy >= 2:
                return (0, 0, 3) if pair_idx == 1 else (3, 0, 3)
    else:
        region = box_mask()[y0:y0 + ch, :cw]
        if homos[2] is not None and float(
                warp_region(region, homos[2])[:, :cw].sum()) > min_pixels:
            rdy += 1
            if rdy >= 2:
                return 2, 0, 3
        else:
            rdy = 0
    return pair_idx, rdy, switched


def track_single(stitched: Sequence[Sequence], init_bbox: np.ndarray,
                 frame_start: int, pair_start: int, homos: Sequence,
                 layout: PairLayout, tracker_factory=TemplateMatchTracker,
                 device=None) -> Tuple[List[np.ndarray], List[int]]:
    """Track one object from (frame_start, pair_start) to the sequence end
    (perform_tracking_of_single :201-280): per-frame tracker updates with
    camera-switch bookkeeping and the iou / centre-jump break rule."""
    tracker = tracker_factory()
    tracker.init(stitched[frame_start][pair_start], list(init_bbox))
    boxes = [np.asarray(init_bbox, float)]
    pair_idxs = [pair_start]
    pair_idx, rdy, switched = pair_start, 0, 0
    old_bbox = np.asarray(init_bbox, float)
    old_center = old_bbox[:2] + old_bbox[2:] / 2
    old_diff = np.zeros(2)
    for f in range(frame_start + 1, len(stitched)):
        if switched > 0:
            switched -= 1
        pred = np.asarray(tracker.track(stitched[f][pair_idx]), float)
        pair_idx, rdy, switched = check_for_image_switch(
            pred, pair_idx, rdy, switched, homos, layout, device=device)
        new_center = pred[:2] + pred[2:] / 2
        new_diff = new_center - old_center
        if switched == 0:
            iou = _iou_xywh(old_bbox, pred)
            jump = (np.linalg.norm(new_diff - old_diff)
                    if np.any(old_diff) else 0.0)
            old_bbox, old_center, old_diff = pred, new_center, new_diff
            if iou < 0.5 and jump > 100:
                break
        else:
            old_bbox, old_center, old_diff = pred, new_center, new_diff
        boxes.append(pred)
        pair_idxs.append(pair_idx)
    return boxes, pair_idxs


def track_pair_sequence(stitched: Sequence[Sequence],
                        det_masks: Sequence[Sequence[Sequence[np.ndarray]]],
                        homos: Sequence, layout: PairLayout = PairLayout(),
                        tracker_factory=TemplateMatchTracker,
                        match_iou: float = 0.25, device=None
                        ) -> List[List[Tuple[int, int, int]]]:
    """The full perform_tracking flow (:60-155): every unmatched detection
    seeds a track; tracked boxes re-associate to detections by IoU >
    ``match_iou``; per-car observation lists of (frame, pair, mask)."""
    n_frames = len(stitched)
    det_bboxes = [[[mask_bbox_xywh(m) for m in det_masks[f][z]]
                   for z in range(len(PAIRS))] for f in range(n_frames)]
    matched = [[[False] * len(det_masks[f][z])
                for z in range(len(PAIRS))] for f in range(n_frames)]
    cars: List[List[Tuple[int, int, int]]] = []
    for f0 in range(n_frames):
        for z0 in range(len(PAIRS)):
            for m0 in range(len(det_masks[f0][z0])):
                if matched[f0][z0][m0] or det_bboxes[f0][z0][m0] is None:
                    continue
                matched[f0][z0][m0] = True
                boxes, pair_idxs = track_single(
                    stitched, det_bboxes[f0][z0][m0], f0, z0, homos,
                    layout, tracker_factory, device)
                obs = [(f0, z0, m0)]
                for k in range(1, len(boxes)):
                    f, z = f0 + k, pair_idxs[k]
                    best, best_iou = None, match_iou
                    for mi, cand in enumerate(det_bboxes[f][z]):
                        if cand is None or matched[f][z][mi]:
                            continue
                        iou = _iou_xywh(boxes[k], cand)
                        if iou > best_iou:
                            best, best_iou = mi, iou
                    if best is not None:
                        matched[f][z][best] = True
                        obs.append((f, z, best))
                cars.append(obs)
    return cars


# ---------------------------------------------------------------------------
# tracked pano masks -> per-frame 3D points -> lomm Tracks
# ---------------------------------------------------------------------------

def gather_mask_points(mask_cam: np.ndarray, cam_slot: int,
                       fused_lidar: np.ndarray) -> np.ndarray:
    """Vehicle-frame points whose camera projection lands in the mask
    (extract_lidar_features, filtering.py:194-204): fused_lidar (N, 6) =
    xyz + camera id + (u, v)."""
    cam_id = CAM_SLOT_TO_WAYMO_ID[cam_slot]
    rows = fused_lidar[fused_lidar[:, 3] == cam_id]
    if len(rows) == 0:
        return np.zeros((0, 3), np.float32)
    u = rows[:, 4].astype(int)
    v = rows[:, 5].astype(int)
    ok = ((u >= 0) & (u < mask_cam.shape[1])
          & (v >= 0) & (v < mask_cam.shape[0]))
    ok[ok] &= mask_cam[v[ok], u[ok]]
    return rows[ok, :3].astype(np.float32)


def tracks_from_2d(cars: Sequence[Sequence[Tuple[int, int, int]]],
                   det_masks, fused_lidars, homos,
                   transforms_cam: np.ndarray, ref_frame: int,
                   window: Sequence[int],
                   layout: PairLayout = PairLayout(),
                   min_points: int = 10, device=None) -> List[Track]:
    """2D-tracked observations -> lomm ``Track``s in the KITTI-style camera
    frame, window-relative and ref-frame-aligned: pano mask -> camera
    masks -> fused-lidar gather -> VEHICLE_TO_CAM -> T_cur_to_ref ->
    per-frame median.  ``transforms_cam``: (len(window), 4, 4)
    T_cur_to_ref in the camera frame.  Observations outside the window and
    under ``min_points`` points are dropped; so are tracks left empty.
    Each mask is un-warped once (the JAX package un-warps it twice, with
    the same result)."""
    lo, hi = window[0], window[-1]
    out: List[Track] = []
    for obs in cars:
        frames: List[int] = []
        locations: List[np.ndarray] = []
        points: List[Optional[np.ndarray]] = []
        masks: List[Optional[object]] = []
        for (f, z, mi) in obs:
            k = f - ref_frame
            if k < lo or k > hi:
                continue
            warped_m, fixed_m = unwarp_pair_mask(
                det_masks[f][z][mi], homos[z], PAIRS[z][2], layout, device)
            cams = _camera_masks(warped_m, fixed_m, z, layout)
            # union in-mask points from BOTH cameras of the pair; the
            # larger-mask camera decides only the ref-frame mask payload
            both = _both(*cams, layout)
            if not both:
                continue
            pts_v = np.concatenate(
                [gather_mask_points(m, s, fused_lidars[f])
                 for m, s in both], axis=0)
            if len(pts_v) < min_points:
                continue
            mask_cam, slot = _larger(*cams)
            pts_c = pts_v @ VEHICLE_TO_CAM.T
            t = transforms_cam[k - lo]
            pts_r = pts_c @ t[:3, :3].T + t[:3, 3]
            frames.append(k)
            locations.append(np.median(pts_r, axis=0))
            points.append(pts_r.astype(np.float32))
            # only the FRONT camera (slot 2) feeds the label writer's 2D box
            masks.append(mask_cam if (k == 0 and slot == 2) else None)
        if frames:
            order = np.argsort(frames)
            out.append(Track(
                frames=[frames[i] for i in order],
                locations=[locations[i] for i in order],
                points=[points[i] for i in order],
                masks=[masks[i] for i in order]))
    return out


def camera_transforms_from_vehicle(poses_w_vehicle: np.ndarray,
                                   ref_idx: int) -> np.ndarray:
    """Per-frame vehicle poses T_world<-vehicle -> (T, 4, 4) camera-frame
    T_cur_to_ref: inv(pose_ref) @ pose_cur conjugated by VEHICLE_TO_CAM."""
    poses = np.asarray(poses_w_vehicle, np.float64)
    perm = np.eye(4)
    perm[:3, :3] = VEHICLE_TO_CAM
    inv_ref = np.linalg.inv(poses[ref_idx])
    out = np.empty_like(poses)
    inv_perm = np.linalg.inv(perm)
    for i in range(len(poses)):
        out[i] = perm @ inv_ref @ poses[i] @ inv_perm
    return out
