"""Instance masks: the live Mask2Former backend and the cache, per frame
the car masks bit-packed in one npz under ``masks_raw/`` (the reference
keeps Detectron2 car masks with score > 0.7 per frame,
filtering.py:97-110, loader.py:1703-1790).

Counterpart of the JAX package's ``sowa/masks.py``: ``Mask2FormerBackend``
(its ``FlaxMask2FormerBackend``) and the cache I/O.  The SAM refinement
backend is not ported (``sowa/zoo.py`` ``sam_refine_backend`` raises).
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

    def _encode(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> (h, w, 3) normalised float32 on the
        device."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_linear

        img = cv2_resize_linear(torch.tensor(np.asarray(image),
                                                device=self.device),
                                self.input_hw)
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


def mask_box(mask: np.ndarray) -> np.ndarray:
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return np.zeros(4, np.int64)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.int64)


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
