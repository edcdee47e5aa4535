"""Waymo panorama stitching: homography estimation and side-camera warping.

Counterpart of the JAX package's ``sowa/stitching.py`` (reference
stitching.py:29-379):

* keypoint matches between neighbouring cameras through a pluggable
  ``MatcherBackend``: ``LoFTRMatcherBackend`` runs the port's
  EfficientLoFTR on the card, ``OrbMatcherBackend`` runs OpenCV's ORB on
  the host where OpenCV is installed;
* RANSAC homographies scored by forward transfer error (numpy, the same
  ``default_rng(seed)`` draws as the JAX package) and the per-sequence
  best homography over every frame's matches;
* warping into the 1380 x (2 * 1920 + 1500) panorama and back, on the
  device of the image (``ops/warp.py``: OpenCV's rule).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Tuple

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops.warp import (cv2_resize_area, cv2_rgb2gray,
                                         cv2_warp_perspective)


class MatcherBackend(Protocol):
    def match(self, img_a, img_b) -> Tuple[np.ndarray, np.ndarray]:
        """Two images -> matched keypoints (N, 2), (N, 2)."""
        ...


def _normalize_points(pts: np.ndarray):
    mean = pts.mean(0)
    scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(pts - mean, axis=1)),
                               1e-9)
    t = np.array([[scale, 0, -scale * mean[0]],
                  [0, scale, -scale * mean[1]],
                  [0, 0, 1.0]])
    hom = np.hstack([pts, np.ones((len(pts), 1))]) @ t.T
    return hom[:, :2], t


def homography_dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Normalised DLT from >= 4 correspondences -> 3x3 H (src -> dst)."""
    sn, t_s = _normalize_points(src)
    dn, t_d = _normalize_points(dst)
    n = len(src)
    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = sn[i]
        u, v = dn[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(a)
    h_norm = vt[-1].reshape(3, 3)
    h = np.linalg.inv(t_d) @ h_norm @ t_s
    return h / h[2, 2]


def transfer_error(h: np.ndarray, src: np.ndarray,
                   dst: np.ndarray) -> np.ndarray:
    """Forward transfer error per correspondence (the reference's kornia
    one-way re-implementation)."""
    hom = np.hstack([src, np.ones((len(src), 1))]) @ h.T
    proj = hom[:, :2] / np.maximum(np.abs(hom[:, 2:3]), 1e-9) \
        * np.sign(hom[:, 2:3])
    return np.linalg.norm(proj - dst, axis=1)


def ransac_homography(src: np.ndarray, dst: np.ndarray,
                      threshold: float = 3.0, iterations: int = 2000,
                      seed: int = 0) -> Tuple[Optional[np.ndarray], int]:
    """RANSAC H(src->dst); returns (H refit on inliers, inlier count)."""
    n = len(src)
    if n < 4:
        return None, 0
    rng = np.random.default_rng(seed)
    best_mask = None
    best_count = 0
    for _ in range(iterations):
        idx = rng.choice(n, 4, replace=False)
        try:
            h = homography_dlt(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        err = transfer_error(h, src, dst)
        mask = err < threshold
        c = int(mask.sum())
        if c > best_count:
            best_count = c
            best_mask = mask
    if best_mask is None or best_count < 4:
        return None, 0
    h = homography_dlt(src[best_mask], dst[best_mask])
    return h, best_count


@dataclasses.dataclass
class PanoramaLayout:
    """Waymo 5-camera panorama geometry (config image_stitching.*)."""

    height_pad: int = 100
    width_pad: int = 750
    cam_w: int = 1920
    cam_h: int = 1280

    @property
    def pano_shape(self) -> Tuple[int, int]:
        return (self.cam_h + self.height_pad,
                2 * self.cam_w + 2 * self.width_pad)

    def center_offset(self) -> np.ndarray:
        """Translation placing the front camera at the panorama centre."""
        t = np.eye(3)
        t[0, 2] = (self.pano_shape[1] - self.cam_w) / 2
        t[1, 2] = self.height_pad / 2
        return t


def select_best_homography(per_frame_matches: List[Tuple[np.ndarray,
                                                         np.ndarray]],
                           threshold: float = 3.0,
                           iterations: int = 500) -> Optional[np.ndarray]:
    """Per-sequence best homography: a RANSAC candidate per frame, each
    scored by its inliers over EVERY frame's matches (the JAX package's
    deliberate reading of find_the_best_homo, stitching.py:153-216)."""
    candidates = []
    for i, (src, dst) in enumerate(per_frame_matches):
        h, _ = ransac_homography(src, dst, threshold, iterations, seed=i)
        if h is not None:
            candidates.append(h)
    if not candidates:
        return None
    best_h, best_score = None, -1
    for h in candidates:
        score = 0
        for src, dst in per_frame_matches:
            if len(src):
                score += int((transfer_error(h, src, dst) < threshold).sum())
        if score > best_score:
            best_score, best_h = score, h
    return best_h


def as_image(img, device) -> torch.Tensor:
    """A numpy image on ``device``, or a tensor where it lies."""
    if isinstance(img, torch.Tensor):
        return img
    return torch.as_tensor(np.asarray(img), device=resolve_device(device))


def warp_into_panorama(pano, image, h: np.ndarray, layout: PanoramaLayout,
                       device=None) -> torch.Tensor:
    """Warp a side camera into the panorama via H composed with the centre
    offset; non-zero warped pixels overwrite."""
    pano = as_image(pano, device)
    image = as_image(image, pano.device)
    full_h = layout.center_offset() @ h
    warped = cv2_warp_perspective(image, full_h,
                                  (pano.shape[1], pano.shape[0]))
    mask = warped.sum(-1) > 0 if warped.dim() == 3 else warped > 0
    out = pano.clone()
    out[mask] = warped[mask]
    return out


def unwarp_mask(mask_pano, h: np.ndarray, layout: PanoramaLayout,
                cam_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """Panorama-space mask -> original camera frame (inverse warp,
    filtering.py:405-425)."""
    m = as_image(mask_pano, device).to(torch.uint8)
    full_h = layout.center_offset() @ h
    return cv2_warp_perspective(m, np.linalg.inv(full_h),
                                (cam_hw[1], cam_hw[0])).bool()


class OrbMatcherBackend:
    """Checkpoint-free correspondence backend: OpenCV's ORB and a ratio
    test, on the host.  It is not rebuilt: without OpenCV it raises
    ``ImportError`` (``backends.matcher: loftr`` runs on the card)."""

    def __init__(self, n_features: int = 4000, ratio: float = 0.75):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "backends.matcher 'orb' needs OpenCV (cv2), which is not "
                "installed; set backends.matcher: loftr with a "
                "matcher_checkpoint to match on the card") from e
        self.orb = cv2.ORB_create(nfeatures=n_features)
        self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
        self.ratio = ratio

    def match(self, img_a, img_b):
        import cv2

        def gray(im):
            if isinstance(im, torch.Tensor):
                im = im.cpu().numpy()
            if im.ndim == 3:
                return cv2.cvtColor(im.astype(np.uint8), cv2.COLOR_RGB2GRAY)
            return im.astype(np.uint8)

        ka, da = self.orb.detectAndCompute(gray(img_a), None)
        kb, db = self.orb.detectAndCompute(gray(img_b), None)
        if da is None or db is None or len(ka) < 4 or len(kb) < 4:
            return np.zeros((0, 2)), np.zeros((0, 2))
        pairs = self.matcher.knnMatch(da, db, k=2)
        src, dst = [], []
        for pair in pairs:
            if len(pair) < 2:
                continue
            m, n = pair
            if m.distance < self.ratio * n.distance:
                src.append(ka[m.queryIdx].pt)
                dst.append(kb[m.trainIdx].pt)
        return np.asarray(src, np.float64), np.asarray(dst, np.float64)


class LoFTRMatcherBackend:
    """Detector-free matcher on the card (``MatcherBackend``; the JAX
    package's ``FlaxLoFTRMatcherBackend``): the port's EfficientLoFTR
    (``models/efficientloftr.py``) returns the mutually nearest matches
    above the coarse confidence threshold.  Images are encoded as the JAX
    backend encodes them with OpenCV (grey, then ``INTER_AREA`` to
    ``input_hw`` rounded down to multiples of 32, byte for byte,
    ``ops/warp.py``), on the card; keypoints map back to the original
    pixel grid."""

    def __init__(self, params, cfg, input_hw: Tuple[int, int] = (480, 640),
                 min_confidence: Optional[float] = None, device=None):
        """``params``: the zoo's param tree (``sowa/zoo.py``
        ``load_checkpoint``); the network is built on ``device`` (default
        ``cuda``)."""
        from monosowa_tpu_torch.convert import load_zoo_params
        from monosowa_tpu_torch.models.efficientloftr import EfficientLoFTR

        self.device = resolve_device(device)
        self.cfg = cfg
        self.min_confidence = (cfg.coarse_matching_threshold
                               if min_confidence is None else min_confidence)
        self.input_hw = (input_hw[0] // 32 * 32, input_hw[1] // 32 * 32)
        self.model = load_zoo_params(EfficientLoFTR(cfg, device=self.device),
                                     params)

    def _gray(self, im) -> torch.Tensor:
        """(H, W, 3) or (H, W) image -> (h, w) float32 in [0, 1] on the
        device."""
        t = as_image(im, self.device).to(self.device)
        if t.dim() == 3:
            t = cv2_rgb2gray(t.to(torch.uint8))
        return cv2_resize_area(t.to(torch.uint8), self.input_hw).float() \
            / 255.0

    def forward(self, img_a, img_b):
        """The network's outputs on one pair: keypoints (2, L, 2)
        normalised, scores (2, L), matches (2, L), on the device."""
        pair = torch.stack([self._gray(img_a), self._gray(img_b)])[None]
        with torch.no_grad():
            kp, scores, matches = self.model(pair)
        return kp[0], scores[0], matches[0]

    def match(self, img_a, img_b) -> Tuple[np.ndarray, np.ndarray]:
        kp, scores, matches = (t.cpu().numpy()
                               for t in self.forward(img_a, img_b))
        # direction 0: slot j (an image-B cell) holds the matched image-A
        # cell index i = matches[0][j]; by mutual-nearest symmetry the
        # refined image-B coordinates of that same pair live at kp[1][i]
        keep = np.flatnonzero((matches[0] >= 0)
                              & (scores[0] > self.min_confidence))
        if keep.size == 0:
            return np.zeros((0, 2)), np.zeros((0, 2))
        src = kp[0][keep] * [img_a.shape[1], img_a.shape[0]]
        dst = kp[1][matches[0][keep]] * [img_b.shape[1], img_b.shape[0]]
        return src.astype(np.float64), dst.astype(np.float64)


def estimate_sequence_homography(frames_a, frames_b,
                                 matcher: Optional[MatcherBackend] = None,
                                 threshold: float = 3.0,
                                 iterations: int = 500):
    """Per-sequence best homography A->B from frame pair lists
    (perform_img_stitching + find_the_best_homo)."""
    matcher = matcher or OrbMatcherBackend()
    per_frame = []
    for ia, ib in zip(frames_a, frames_b):
        src, dst = matcher.match(ia, ib)
        if len(src) >= 4:
            per_frame.append((src, dst))
    if not per_frame:
        return None
    return select_best_homography(per_frame, threshold, iterations)
