"""Pseudo-LiDAR from cached depth maps: monocular depth -> camera-frame
point clouds.

Behavioural contract (pseudo_label_generator/3d/scripts/metric3d.py): the
depth network predicts canonical depth at a 1000-focal camera; the decode
de-canonicalises with the intrinsic (``depth * fx / 1000``), clamps to
[0, 300] m, and back-projects the full pixel grid through the intrinsics;
per-frame outputs are cached as npz with skip-if-exists resumability
(:82-83, :97).

Deviation kept from the JAX package: ``pseudo_lidar_from_depth`` drops
z <= 0 points (they carry no geometry and downstream projection divides
by z).

Counterpart of the JAX package's ``sowa/depth.py``: ``CachedDepthBackend``
reads precomputed depth maps, so the pipeline runs without a depth
checkpoint; ``DepthAnythingBackend`` (its ``FlaxDepthAnythingBackend``)
runs Depth Anything on the card from a zoo checkpoint (``sowa/zoo.py``);
``TorchHubMetric3DBackend`` runs the reference's Metric3D model from
``torch.hub`` on the card.  Canonical-depth protocol: ``predict_depth_for``
/ ``predict_depth`` return canonical depth at the ORIGINAL resolution, so
metric depth = value * fx / 1000.

The Metric3D route (metric3d.py:280-345) runs on the image's device:
``encode_image`` keeps the aspect ratio into 616 x 1064, scales all four
intrinsics by the same factor, pads to the centre with the ImageNet mean
and normalises (values in 0-255).  OpenCV's ``resize`` and
``copyMakeBorder`` are rebuilt in torch (``ops/resize.py``'s INTER_LINEAR
rules; the card's machine may have no OpenCV): on a uint8 image the border
value is rounded to uint8, [124, 116, 104], as ``copyMakeBorder`` rounds
it.  ``metric3d_decode_lift`` crops the padding, resizes bilinearly with
half-pixel centres to the image (antialiased where it shrinks, as
``jax.image.resize``), de-canonicalises with the SCALED focal length,
clamps to [0, 300] m and back-projects the full pixel grid through the
ORIGINAL intrinsics.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.ops.geometry import backproject_depth

MAX_DEPTH = 300.0
CANONICAL_FOCAL = 1000.0
METRIC3D_INPUT_SIZE = (616, 1064)  # ViT models (metric3d.py:294)
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def encode_image(img, intrinsic, device=None):
    """``Metric3D.encode_img`` (metric3d.py:290-317) on ``device`` (None:
    the card).

    img: (H, W, 3) RGB, uint8 or float32 (0-255), numpy or a tensor;
    intrinsic: [fx, fy, cx, cy].  Returns (normalised float32 (3, 616,
    1064) tensor on the device, pad_info [top, bottom, left, right],
    intrinsic_scaled, scale)."""
    from monosowa_tpu_torch.ops.resize import cv2_resize_linear

    dev = resolve_device(device)
    ih, iw = METRIC3D_INPUT_SIZE
    x = torch.as_tensor(img, device=dev)
    h, w = x.shape[:2]
    scale = min(ih / h, iw / w)
    rgb = cv2_resize_linear(x, (int(h * scale), int(w * scale)))
    intrinsic_scaled = [float(v) * scale for v in intrinsic[:4]]
    hs, ws = rgb.shape[:2]
    pad_h, pad_w = ih - hs, iw - ws
    ph0, pw0 = pad_h // 2, pad_w // 2
    pad_info = [ph0, pad_h - ph0, pw0, pad_w - pw0]
    fill = np.asarray(IMAGENET_MEAN, np.float32)
    if rgb.dtype == torch.uint8:
        fill = np.clip(np.rint(fill), 0, 255)     # copyMakeBorder's rounding
    padded = torch.as_tensor(fill, device=dev).to(rgb.dtype).expand(
        ih, iw, 3).clone()
    padded[ph0:ph0 + hs, pw0:pw0 + ws] = rgb
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=dev)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32,
                       device=dev)[:, None, None]
    chw = (padded.permute(2, 0, 1).float() - mean) / std
    return chw, pad_info, intrinsic_scaled, scale


def metric3d_decode_lift(pred_depth: torch.Tensor, pad_info, orig_hw,
                         fx_scaled: torch.Tensor,
                         intrinsic_orig: torch.Tensor):
    """``Metric3D.decode_img`` geometry (metric3d.py:319-345) on the
    prediction's device.

    pred_depth: (616, 1064) canonical depth from the model; fx_scaled =
    fx * encode scale and intrinsic_orig = [fx, fy, cx, cy] as float32
    tensors on its device.  Returns (points (H*W, 3) over the FULL pixel
    grid, depth-0 pixels kept as the reference keeps them, metric depth
    (H, W))."""
    from monosowa_tpu_torch.ops.resize import resize_bilinear_torch

    t, b, l, r = pad_info
    h616, w1064 = pred_depth.shape
    cropped = pred_depth[t:h616 - b, l:w1064 - r]
    # the crop shrinks on both axes or on neither (one scale for both);
    # torch's antialiased path matches jax.image.resize only where it
    # shrinks
    shrink = cropped.shape[0] > orig_hw[0] or cropped.shape[1] > orig_hw[1]
    depth = resize_bilinear_torch(cropped[..., None], orig_hw,
                                  antialias=shrink)[..., 0]
    metric = torch.clamp(depth * fx_scaled / CANONICAL_FOCAL, 0.0,
                         MAX_DEPTH)
    fu, fv, cu, cv = intrinsic_orig.unbind()
    return backproject_depth(metric, fu, fv, cu, cv), metric


def compute_pseudo_lidar(img, intrinsic, model_fn, device=None):
    """``Metric3D.compute_pseudo_lidar`` (metric3d.py:280-288) on
    ``device`` (None: the card).

    model_fn: normalised (3, 616, 1064) tensor -> (616, 1064) canonical
    depth (a tensor or array).  Returns (points (H*W, 3), metric depth
    (H, W)), float32 numpy."""
    dev = resolve_device(device)
    chw, pad_info, intr_s, _ = encode_image(img, intrinsic, dev)
    pred = torch.as_tensor(model_fn(chw), dtype=torch.float32, device=dev)
    pts, metric = metric3d_decode_lift(
        pred, pad_info, tuple(img.shape[:2]),
        torch.tensor(np.float32(intr_s[0]), device=dev),
        torch.tensor([float(v) for v in intrinsic[:4]], dtype=torch.float32,
                     device=dev))
    return pts.cpu().numpy(), metric.cpu().numpy()


class CachedDepthBackend:
    """Reads precomputed depth maps (``<depth_dir>/<frame>.npz`` with key
    'depth'), the phase-1 operating mode."""

    def __init__(self, depth_dir: str, key: str = "depth"):
        self.depth_dir = depth_dir
        self.key = key

    def predict_depth_for(self, frame: str) -> Optional[np.ndarray]:
        path = os.path.join(self.depth_dir, f"{frame}.npz")
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return np.asarray(z[self.key], np.float32)


class TorchHubMetric3DBackend:
    """The reference's Metric3D (yvanyin/metric3d through ``torch.hub``,
    metric3d.py:17-37) on ``device`` (None: the card), with the encode and
    decode above.  Needs the hub's files on disk (or a network); raises
    ``RuntimeError`` with guidance otherwise."""

    def __init__(self, model_name: str = "metric3d_vit_giant2",
                 device=None):
        self.device = resolve_device(device)
        try:
            self.model = torch.hub.load("yvanyin/metric3d", model_name,
                                        pretrain=True)
        except Exception as e:  # zero-egress environments
            raise RuntimeError(
                "Metric3D weights unavailable (offline). Use "
                "CachedDepthBackend with precomputed depth maps.") from e
        self.model = self.model.to(self.device).eval()

    def _infer_canonical(self, chw: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            depth, *_ = self.model.inference({"input": chw[None].float()})
        return torch.as_tensor(depth, device=self.device).squeeze().float()

    def predict_depth(self, image: np.ndarray) -> np.ndarray:
        """Canonical depth at the original resolution, the encode factor
        folded in (metric = result * fx_orig / 1000, the reference's
        upsampled * fx_scaled / 1000); the crop resized with OpenCV's
        float32 INTER_LINEAR rule on the card."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_linear

        h, w = image.shape[:2]
        # the intrinsics do not change the canonical prediction: a unit
        # intrinsic reuses the resize / pad / normalise
        chw, pad_info, _, scale = encode_image(image, [1.0, 1.0, 0.0, 0.0],
                                               self.device)
        pred = self._infer_canonical(chw)
        t, b, l, r = pad_info
        d = pred[t:pred.shape[0] - b, l:pred.shape[1] - r]
        d = cv2_resize_linear(d[..., None].contiguous(), (h, w))[..., 0]
        return (d * np.float32(scale)).cpu().numpy().astype(np.float32)


class DepthAnythingBackend:
    """Monocular depth on the card: Depth Anything
    (``models/depth_anything.py``) behind the pipeline's canonical-depth
    contract.  Needs a METRIC checkpoint: ``predict_depth`` converts metric
    metres to canonical depth (metric = value * fx / 1000, the reference's
    Metric3D decode at metric3d.py:327-333).

    Preprocessing as the JAX backend's: keep-ratio resize of the shorter
    side to ``input_size``, rounded to a multiple of the patch size, with
    OpenCV's ``INTER_CUBIC`` on uint8 (reproduced in ``ops/resize.py``),
    rescale 1/255, ImageNet-normalise; the prediction is resized back to
    the image with torch's bicubic.  Both resizes run on the card."""

    IMAGENET01_MEAN = (0.485, 0.456, 0.406)
    IMAGENET01_STD = (0.229, 0.224, 0.225)

    def __init__(self, params, cfg, fx: float, input_size: int = 518,
                 device=None):
        """``params``: the zoo's param tree (``sowa/zoo.py``
        ``load_checkpoint``); the network is built on ``device`` (default
        ``cuda``)."""
        from monosowa_tpu_torch.convert import load_zoo_params
        from monosowa_tpu_torch.models.depth_anything import DepthAnything

        if cfg.depth_estimation_type != "metric":
            raise ValueError(
                "pseudo-LiDAR needs a metric depth checkpoint "
                "(depth_estimation_type='metric'); relative depth has no "
                "scale to canonicalize")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.fx = float(fx)
        self.input_size = int(input_size)
        self.model = load_zoo_params(
            DepthAnything(cfg, device=self.device), params)
        self._mean = torch.tensor(self.IMAGENET01_MEAN, device=self.device)
        self._std = torch.tensor(self.IMAGENET01_STD, device=self.device)

    def _encode(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) uint8 RGB -> (h, w, 3) normalised float32 on the
        device."""
        from monosowa_tpu_torch.ops.resize import cv2_resize_cubic

        p = self.cfg.backbone.patch_size
        h, w = image.shape[:2]
        scale = self.input_size / min(h, w)
        hw = (max(p, int(round(h * scale / p)) * p),
              max(p, int(round(w * scale / p)) * p))
        img = cv2_resize_cubic(torch.tensor(np.asarray(image),
                                            device=self.device), hw)
        return (img.float() / 255.0 - self._mean) / self._std

    def predict_metric_depth(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (H, W) float32 metric depth [m]."""
        from monosowa_tpu_torch.ops.resize import resize_bicubic_torch

        with torch.no_grad():
            pred = self.model(self._encode(image)[None])[0]
            out = resize_bicubic_torch(pred[..., None],
                                       image.shape[:2])[..., 0]
        return torch.clamp(out, min=0.0).cpu().numpy()

    def predict_depth(self, image: np.ndarray) -> np.ndarray:
        """Canonical depth per the module contract (metric * 1000 / fx)."""
        return (self.predict_metric_depth(image)
                * (CANONICAL_FOCAL / self.fx)).astype(np.float32)


def lift_depth_to_points(depth: torch.Tensor, fu, fv, cu, cv,
                         fx_scale) -> torch.Tensor:
    """Canonical depth map (H, W) -> (H*W, 3) metric camera points.

    fx_scale = fx / 1000 de-canonicalises depth (metric3d.py:327-333);
    depth clamped to MAX_DEPTH.  Scalars as tensors on the depth's device
    (see ``backproject_depth``)."""
    metric = torch.clamp(depth * fx_scale, 0.0, MAX_DEPTH)
    return backproject_depth(metric, fu, fv, cu, cv)


def pseudo_lidar_from_depth(depth: np.ndarray, p2: np.ndarray,
                            canonical: bool = True,
                            device=None) -> np.ndarray:
    """Host convenience wrapper -> (N, 3) float32 points (z > 0), computed
    on ``device`` (None: the card)."""
    dev = resolve_device(device)
    fu, fv = p2[0, 0], p2[1, 1]
    cu, cv = p2[0, 2], p2[1, 2]
    scale = fu / CANONICAL_FOCAL if canonical else 1.0
    f32 = [torch.tensor(np.float32(v), device=dev)
           for v in (fu, fv, cu, cv, scale)]
    pts = lift_depth_to_points(
        torch.as_tensor(np.asarray(depth, np.float32), device=dev),
        *f32).cpu().numpy()
    return pts[pts[:, 2] > 0].astype(np.float32)


def generate_pseudo_lidar_cache(frames, images_or_depths, p2: np.ndarray,
                                out_dir: str, backend=None,
                                canonical: bool = True, device=None) -> int:
    """Write per-frame pseudo-lidar npz caches (skip-if-exists).
    frames: frame name list; images_or_depths: matching (H, W[, 3]) arrays:
    depth maps when backend is None, RGB images for a live ``backend``
    (``predict_depth``).  Returns the number of frames newly generated."""
    os.makedirs(out_dir, exist_ok=True)
    done = 0
    for frame, arr in zip(frames, images_or_depths):
        out = os.path.join(out_dir, f"{frame}.npz")
        if os.path.exists(out):
            continue
        depth = backend.predict_depth(arr) if backend is not None else arr
        pts = pseudo_lidar_from_depth(np.asarray(depth, np.float32), p2,
                                      canonical, device)
        np.savez_compressed(out, points=pts)
        done += 1
    return done


def load_pseudo_lidar(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        key = "points" if "points" in z else list(z.keys())[0]
        pts = np.asarray(z[key], np.float32)
    return pts.reshape(-1, pts.shape[-1])[:, :3]
