"""Instance masks: the live Mask2Former backend and the cache, per frame
the car masks bit-packed in one npz under ``masks_raw/`` (the reference
keeps Detectron2 car masks with score > 0.7 per frame,
filtering.py:97-110, loader.py:1703-1790).

Counterpart of the JAX package's ``sowa/masks.py``: ``Mask2FormerBackend``
(its ``FlaxMask2FormerBackend``), ``SamRefineBackend`` (its
``FlaxSamRefineBackend``: the reference's SAM ViT-H box refinement,
run_SAM_batch filtering.py:112-148), ``refine_masks`` and the cache I/O.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device

SCORE_THRESHOLD = 0.7  # filtering.score_detectron_thresh


class Mask2FormerBackend:
    """Instance segmentation on the card: the port's Mask2Former
    (``models/mask2former.py``, its pixel decoder on the MSDA kernel) with
    the reference's detection contract (filtering.py:97-110): keep the
    queries whose class probability for the car labels exceeds
    ``score_threshold``.  A query's score is P(car class) of the softmaxed
    class logits (null class dropped); its mask is the mask logits resized
    to the image and thresholded at 0 (sigmoid > 0.5).

    The image is encoded as the JAX backend encodes it with OpenCV
    (``INTER_LINEAR`` on uint8, byte for byte, ``ops/resize.py``), then
    scaled to [0, 1] and ImageNet-normalised; the mask logits are resized
    as OpenCV resizes float images.  Both resizes run on the card."""

    IMAGENET01_MEAN = (0.485, 0.456, 0.406)
    IMAGENET01_STD = (0.229, 0.224, 0.225)

    def __init__(self, params, cfg, car_label_ids=(2,),
                 score_threshold: float = SCORE_THRESHOLD,
                 input_hw=(384, 1280), device=None):
        """``params``: the zoo's param tree (``sowa/zoo.py``
        ``load_checkpoint``); the network is built on ``device`` (default
        ``cuda``)."""
        from monosowa_tpu_torch.convert import load_zoo_params
        from monosowa_tpu_torch.models.mask2former import Mask2Former

        self.device = resolve_device(device)
        self.cfg = cfg
        self.car_label_ids = tuple(car_label_ids)
        self.score_threshold = float(score_threshold)
        self.input_hw = (input_hw[0] // 32 * 32, input_hw[1] // 32 * 32)
        self.model = load_zoo_params(Mask2Former(cfg, device=self.device),
                                     params)
        self._mean = torch.tensor(self.IMAGENET01_MEAN, device=self.device)
        self._std = torch.tensor(self.IMAGENET01_STD, device=self.device)

    def _encode(self, image) -> torch.Tensor:
        """(H, W, 3) uint8 RGB, numpy or a tensor (a Waymo pair canvas
        stays on the card) -> (h, w, 3) normalised float32 on the
        device."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_linear

        img = image.to(self.device) if isinstance(image, torch.Tensor) \
            else torch.tensor(np.asarray(image), device=self.device)
        img = cv2_resize_linear(img, self.input_hw)
        return (img.float() / 255.0 - self._mean) / self._std

    def forward(self, image: np.ndarray):
        """One forward: (class logits (Q, labels + 1), mask logits (Q,
        h/4, w/4)) on the device."""
        with torch.no_grad():
            classes, masks = self.model(self._encode(image)[None])
        return classes[0], masks[0]

    def predict_masks_multi(self, image: np.ndarray, label_groups):
        """ONE forward, several class filters: for each group of label ids
        the (masks, scores) of the queries whose largest class probability
        over the group clears the threshold (the car classes and, with
        extract_pedestrians, the person class from the same forward)."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_linear

        h, w = image.shape[:2]
        classes, mask_logits = self.forward(image)
        probs = torch.softmax(classes.float(), -1)[:, :-1]  # drop null
        out = []
        for ids in label_groups:
            prob = probs[:, list(ids)].max(-1).values
            keep = torch.nonzero(prob > self.score_threshold)[:, 0]
            g_masks, g_scores = [], []
            if len(keep):
                with torch.no_grad():
                    full = cv2_resize_linear(
                        mask_logits[keep].permute(1, 2, 0).contiguous(),
                        (h, w)) > 0.0     # sigmoid(x) > 0.5 <=> x > 0
                full = full.permute(2, 0, 1).cpu().numpy()
                scores = prob[keep].cpu().numpy()
                for m, s in zip(full, scores):
                    if m.any():
                        g_masks.append(m)
                        g_scores.append(float(s))
            out.append((g_masks, g_scores))
        return out

    def predict_masks_scores(self, image: np.ndarray):
        return self.predict_masks_multi(image, [self.car_label_ids])[0]

    def predict_masks(self, image: np.ndarray) -> List[np.ndarray]:
        return self.predict_masks_scores(image)[0]


class SamRefineBackend:
    """Box-prompted mask refinement on the card: the port's SAM
    (``models/sam.py``) as the reference uses it, one box prompt a
    detection and ``multimask_output=False`` (filtering.py:133-146).

    ``refine(image, boxes)`` follows the SAM predictor and the JAX
    backend: the longest side resized to the model's input size
    (``int(h * s + 0.5)``, OpenCV's ``INTER_LINEAR`` on uint8, byte for
    byte, ``ops/resize.py``), ImageNet-normalised, zero-padded to a square;
    the low-res mask logits resized (``F.interpolate``'s bilinear) to the
    input size, cropped to the resized image, resized to the frame as
    OpenCV resizes float images, and thresholded at 0.  The boxes go
    through the decoder in chunks of at most ``max_boxes``, as the JAX
    backend batches its prompts; the image embedding is computed once a
    frame rather than once a chunk, because every prompt is independent
    in the decoder (the JAX backend runs the whole network for each
    chunk).  Everything runs on the device; the frame's masks are copied
    to the host once."""

    IMAGENET01_MEAN = (0.485, 0.456, 0.406)
    IMAGENET01_STD = (0.229, 0.224, 0.225)

    def __init__(self, params, cfg, max_boxes: int = 16, device=None):
        """``params``: the zoo's param tree (``sowa/zoo.py``
        ``load_checkpoint``); the network is built on ``device`` (default
        ``cuda``)."""
        from monosowa_tpu_torch.convert import load_zoo_params
        from monosowa_tpu_torch.models.sam import Sam

        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_boxes = int(max_boxes)
        self.model = load_zoo_params(Sam(cfg, device=self.device), params)
        self._mean = torch.tensor(self.IMAGENET01_MEAN, device=self.device)
        self._std = torch.tensor(self.IMAGENET01_STD, device=self.device)

    def _encode(self, image: np.ndarray):
        """(H, W, 3) uint8 RGB -> ((S, S, 3) normalised and zero-padded
        float32 on the device, the resized (h, w), the scale)."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_linear

        s = self.cfg.vision.image_size
        h, w = image.shape[:2]
        scale = s / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        img = cv2_resize_linear(torch.tensor(np.asarray(image),
                                             device=self.device), (nh, nw))
        img = (img.float() / 255.0 - self._mean) / self._std
        padded = torch.zeros((s, s, 3), dtype=torch.float32,
                             device=self.device)
        padded[:nh, :nw] = img
        return padded, (nh, nw), scale

    def decode(self, emb: torch.Tensor, boxes: np.ndarray, scale: float):
        """(low-res logits (n, 4g, 4g), iou (n,)) on the device of the
        boxes (n, 4) in frame pixels, through the decoder in chunks of
        ``max_boxes``."""
        lows, ious = [], []
        for start in range(0, len(boxes), self.max_boxes):
            chunk = np.asarray(boxes[start:start + self.max_boxes],
                               np.float32) * scale
            with torch.no_grad():
                low, iou = self.model.decode_boxes(
                    emb, torch.from_numpy(chunk).to(self.device)[None])
            lows.append(low[0, :, 0])
            ious.append(iou[0, :, 0])
        return torch.cat(lows), torch.cat(ious)

    def refine(self, image: np.ndarray, boxes: np.ndarray
               ) -> List[np.ndarray]:
        """image (H, W, 3) uint8; boxes (N, 4) [x1, y1, x2, y2] ->
        N (H, W) bool masks."""
        from monosowa_tpu_torch.ops.resize import (cv2_resize_linear,
                                                   resize_bilinear_torch)

        if not len(boxes):
            return []
        h, w = image.shape[:2]
        padded, (nh, nw), scale = self._encode(image)
        with torch.no_grad():
            emb = self.model.vision_forward(padded[None])
        low, _ = self.decode(emb, boxes, scale)
        s = self.cfg.vision.image_size
        with torch.no_grad():
            up = resize_bilinear_torch(low[..., None], (s, s))[:, :nh, :nw, 0]
            full = cv2_resize_linear(up.permute(1, 2, 0).contiguous(),
                                     (h, w)) > 0.0
        return list(full.permute(2, 0, 1).cpu().numpy())


def mask_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return np.zeros(4, np.int64)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.int64)


def refine_masks(masks: List[np.ndarray], scores: List[float],
                 image: np.ndarray, backend,
                 score_thresh: float = SCORE_THRESHOLD) -> List[np.ndarray]:
    """Replace each above-threshold detection's mask with the backend's
    box-prompted refinement (run_SAM_batch :133-146: boxes come from the
    detector's masks; low-score masks pass through untouched)."""
    eligible = [i for i, s in enumerate(scores)
                if s > score_thresh and np.any(masks[i])]
    if not eligible:
        return list(masks)
    boxes = np.stack([mask_box(masks[i]) for i in eligible])
    refined = backend.refine(image, boxes)
    out = list(masks)
    for j, i in enumerate(eligible):
        out[i] = np.asarray(refined[j], bool)
    return out


def save_masks(cache_dir: str, frame: str, masks: List[np.ndarray],
               img_hw) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    h, w = img_hw
    if masks:
        arr = np.stack([m.astype(bool) for m in masks])
    else:
        arr = np.zeros((0, h, w), bool)
    np.savez_compressed(os.path.join(cache_dir, f"{frame}.npz"),
                        packed=np.packbits(arr, axis=-1),
                        shape=np.array(arr.shape))


def load_masks(cache_dir: str, frame: str) -> Optional[List[np.ndarray]]:
    path = os.path.join(cache_dir, f"{frame}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        shape = z["shape"]
        packed = z["packed"]
    arr = np.unpackbits(packed, axis=-1, count=int(shape[-1])).astype(bool)
    return [arr[i] for i in range(int(shape[0]))]
