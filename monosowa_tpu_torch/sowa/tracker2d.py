"""Single-object 2D tracking across the stitched Waymo pair canvases.

Counterpart of the JAX package's ``sowa/tracker2d.py`` (reference
tracker_ODTrack.py): the ``SingleObjectTracker`` protocol with two
implementations, both on the device of the canvas they are given (numpy
images go to ``device``, default the card):

* ``TemplateMatchTracker``: the checkpoint-free tracker, OpenCV's
  ``matchTemplate`` TM_SQDIFF and ``minMaxLoc`` over a search window
  (``ops/warp.py`` ``match_template_sqdiff``);
* ``ViTTrackerBackend`` (the JAX ``FlaxViTTrackerBackend``): the port's
  one-stream ViT tracker (``models/vit_tracker.py``) with ODTrack's track
  tokens carried across frames and OSTrack's crops (template 2x, search 4x
  the box side, zero-padded at the image border, resized as OpenCV's
  ``INTER_LINEAR`` resizes uint8, byte for byte, ``ops/resize.py``).

``box_iou``, ``filter_overlapping_detections``, ``track_masks`` and
``camera_of_box`` are the JAX package's host functions.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops.resize import cv2_resize_linear
from monosowa_tpu_torch.ops.warp import match_template_sqdiff
from monosowa_tpu_torch.sowa.stitching import as_image


def box_iou(a: np.ndarray, b: np.ndarray) -> float:
    """xyxy IoU."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / ua if ua > 0 else 0.0


class SingleObjectTracker(Protocol):
    def init(self, image, box_xywh: Sequence[float]) -> None: ...

    def track(self, image) -> Sequence[float]:
        """-> box xywh in the new frame."""
        ...


def _gray(img: torch.Tensor) -> torch.Tensor:
    """The JAX tracker's ``image.mean(-1)`` (float64 for uint8 and float64
    images, as numpy computes it) as float32."""
    if img.dim() == 3:
        work = torch.float32 if img.dtype == torch.float32 else torch.float64
        img = img.to(work).mean(-1)
    return img.float()


class TemplateMatchTracker:
    """Checkpoint-free tracker: squared-difference template matching over a
    search window of ``search_margin`` box sides around the last box."""

    def __init__(self, search_margin: float = 1.0, device=None):
        self.search_margin = search_margin
        self.device = device
        self._tmpl = None
        self._box = None

    def init(self, image, box_xywh: Sequence[float]) -> None:
        x, y, w, h = (int(v) for v in box_xywh)
        img = as_image(image, self.device)
        self._tmpl = _gray(img[y:y + h, x:x + w])
        self._box = [x, y, w, h]

    def track(self, image):
        img = as_image(image, self.device)
        x, y, w, h = self._box
        mx = int(w * self.search_margin)
        my = int(h * self.search_margin)
        x0, y0 = max(x - mx, 0), max(y - my, 0)
        x1 = min(x + w + mx, img.shape[1])
        y1 = min(y + h + my, img.shape[0])
        window = _gray(img[y0:y1, x0:x1])
        if (window.shape[0] < self._tmpl.shape[0]
                or window.shape[1] < self._tmpl.shape[1]):
            return self._box
        _, loc = match_template_sqdiff(window, self._tmpl)
        self._box = [x0 + loc[0], y0 + loc[1], w, h]
        return self._box


class ViTTrackerBackend:
    """One-stream ViT tracker on the card (``SingleObjectTracker``).  One
    network serves every track: ``zoo.tracker_factory`` hands each track a
    shallow copy with fresh state."""

    IMAGENET01_MEAN = (0.485, 0.456, 0.406)
    IMAGENET01_STD = (0.229, 0.224, 0.225)

    def __init__(self, params, cfg, template_factor: float = 2.0,
                 search_factor: float = 4.0, device=None):
        """``params``: the zoo's param tree (``sowa/zoo.py``
        ``load_checkpoint``); the network is built on ``device`` (default
        ``cuda``)."""
        from monosowa_tpu_torch.convert import load_zoo_params
        from monosowa_tpu_torch.models.vit_tracker import ViTTracker

        self.device = resolve_device(device)
        self.cfg = cfg
        self.template_factor = template_factor
        self.search_factor = search_factor
        self.model = load_zoo_params(ViTTracker(cfg, device=self.device),
                                     params)
        self._mean = torch.tensor(self.IMAGENET01_MEAN, device=self.device)
        self._std = torch.tensor(self.IMAGENET01_STD, device=self.device)
        self._template = None
        self._track_tokens = None
        self._box = None  # xywh

    def _crop(self, image: torch.Tensor, cx: float, cy: float, side: float,
              out_size: int) -> torch.Tensor:
        h, w = image.shape[:2]
        x0, y0 = int(round(cx - side / 2)), int(round(cy - side / 2))
        x1, y1 = int(round(cx + side / 2)), int(round(cy + side / 2))
        pad = torch.zeros((y1 - y0, x1 - x0, 3), dtype=torch.uint8,
                          device=self.device)
        sx0, sy0 = max(x0, 0), max(y0, 0)
        sx1, sy1 = min(x1, w), min(y1, h)
        if sx1 > sx0 and sy1 > sy0:
            pad[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = \
                image[sy0:sy1, sx0:sx1]
        crop = cv2_resize_linear(pad, (out_size, out_size))
        return (crop.float() / 255.0 - self._mean) / self._std

    def init(self, image, box_xywh: Sequence[float]) -> None:
        img = as_image(image, self.device).to(self.device)
        x, y, w, h = (float(v) for v in box_xywh)
        side = self.template_factor * float(np.sqrt(max(w * h, 1.0)))
        self._template = self._crop(img, x + w / 2, y + h / 2, side,
                                    self.cfg.template_size)
        self._track_tokens = self.model.track_token.detach().clone()
        self._box = [x, y, w, h]

    def step(self, image):
        """One forward on the search crop around the last box -> (box
        (4,) normalised cxcywh, new track tokens (1, K, C), the crop's
        centre and side)."""
        img = as_image(image, self.device).to(self.device)
        x, y, w, h = self._box
        cx, cy = x + w / 2, y + h / 2
        side = self.search_factor * float(np.sqrt(max(w * h, 1.0)))
        search = self._crop(img, cx, cy, side, self.cfg.search_size)
        with torch.no_grad():
            box, _, tok = self.model(
                self._template[None], search[None],
                self._track_tokens.reshape(1, -1, self.cfg.hidden_size))
        return box[0], tok, (cx, cy, side)

    def track(self, image):
        box, tok, (cx, cy, side) = self.step(image)
        self._track_tokens = tok
        bcx, bcy, bw, bh = (float(v) for v in box.cpu().numpy())
        # normalised search-crop coords -> image coords
        ox, oy = cx - side / 2, cy - side / 2
        nw, nh = bw * side, bh * side
        nx = ox + bcx * side - nw / 2
        ny = oy + bcy * side - nh / 2
        self._box = [nx, ny, nw, nh]
        return self._box


@dataclasses.dataclass
class TrackedObject:
    track_id: int
    boxes: List[Optional[np.ndarray]]     # per-frame xyxy or None
    matched_mask_idx: List[Optional[int]]


def filter_overlapping_detections(boxes: List[np.ndarray],
                                  iou_threshold: float = 0.25
                                  ) -> List[int]:
    """Keep-first filtering of overlapping detections (:414-462)."""
    keep: List[int] = []
    for i, b in enumerate(boxes):
        if all(box_iou(b, boxes[j]) < iou_threshold for j in keep):
            keep.append(i)
    return keep


def track_masks(frames: Sequence, initial_boxes: Sequence[np.ndarray],
                per_frame_mask_boxes: Sequence[Sequence[np.ndarray]],
                tracker_factory=TemplateMatchTracker,
                match_iou: float = 0.25) -> List[TrackedObject]:
    """Track each initial box through the frames, matching back to detected
    mask boxes by IoU >= match_iou (perform_tracking_of_single :201-280)."""
    out = []
    for tid, box0 in enumerate(initial_boxes):
        tracker = tracker_factory()
        x0, y0, x1, y1 = box0
        tracker.init(frames[0], [x0, y0, x1 - x0, y1 - y0])
        boxes: List[Optional[np.ndarray]] = [np.asarray(box0, float)]
        matched: List[Optional[int]] = [None]
        for f in range(1, len(frames)):
            x, y, w, h = tracker.track(frames[f])
            cur = np.array([x, y, x + w, y + h], float)
            boxes.append(cur)
            best, best_iou = None, match_iou
            for mi, mb in enumerate(per_frame_mask_boxes[f]):
                iou = box_iou(cur, mb)
                if iou >= best_iou:
                    best, best_iou = mi, iou
            matched.append(best)
        out.append(TrackedObject(tid, boxes, matched))
    return out


def camera_of_box(box_xyxy: np.ndarray, pano_width: int,
                  cam_w: int = 1920, width_pad: int = 750) -> int:
    """Which source camera a panorama box belongs to (-1 left, 0 front,
    1 right): the coordinate bookkeeping behind check_for_image_switch."""
    cx = (box_xyxy[0] + box_xyxy[2]) / 2
    front_x0 = (pano_width - cam_w) / 2
    if cx < front_x0:
        return -1
    if cx >= front_x0 + cam_w:
        return 1
    return 0
