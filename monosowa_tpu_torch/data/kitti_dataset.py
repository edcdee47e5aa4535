"""KITTI object-detection dataset with the Canonical Object Space module.

Behavioral contract (MonoDETR/lib/datasets/kitti/kitti_dataset.py:27-741):

* resolution 1280x384, max 50 objects, ImageNet normalization;
* augmentation: photometric distort (optional), random flip 0.5, optional
  random crop/scale, affine warp to the fixed resolution (:181-206);
* label encoding (:287-394): 2D box through the affine; projected 3D center
  (cx, cy); 6-dof (cx, cy, l, r, t, b) normalized; depth (optionally
  crop-scaled); heading -> alpha -> 12-bin class+residual; size_3d minus
  per-class mean shape; mask_2d gates truncation <= 0.5 & occlusion <= 2;
* Canonical Object Space (:232-245, :365-366, :491-525): adjusted
  intrinsics through flip/scale/crop/resize; canonical_scale =
  canonical_focal_length / fu_adj multiplies GT depth; height_crop =
  cy_adj / (H/2) corrects the vertical crop at decode time.

Output is one SoA sample dict of fixed-shape numpy arrays; ``collate``
stacks samples into the padded batch the model consumes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from monosowa_tpu_torch.data.affine import (affine_transform,
                                            get_affine_transform,
                                            warp_affine_nearest)
from monosowa_tpu_torch.kittiio import Calibration, read_label_file

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)

# per-class mean shapes (kitti_dataset.py:90-94), order: Pedestrian, Car,
# Cyclist -> but cls2id is {'Pedestrian': 0, 'Car': 1, 'Cyclist': 2}
CLS_MEAN_SIZE = np.array([[1.76255119, 0.66068622, 0.84422524],
                          [1.52563191, 1.62856739, 3.88311640],
                          [1.73698127, 0.59706367, 1.76282397]], np.float32)
CLS2ID = {"Pedestrian": 0, "Car": 1, "Cyclist": 2}
NUM_HEADING_BIN = 12


def angle2class(angle: float):
    """Continuous angle -> (bin, residual) (lib/datasets/utils.py:8-17)."""
    angle = angle % (2 * np.pi)
    per = 2 * np.pi / NUM_HEADING_BIN
    shifted = (angle + per / 2) % (2 * np.pi)
    cls = int(shifted / per)
    res = shifted - (cls * per + per / 2)
    return cls, res


def class2angle(cls, residual, to_label_format=False):
    per = 2 * np.pi / NUM_HEADING_BIN
    angle = cls * per + residual
    if to_label_format and angle > np.pi:
        angle -= 2 * np.pi
    return angle


class KittiDetectionDataset:
    """File-backed KITTI object dataset producing fixed-shape samples."""

    def __init__(self, root_dir: str, split: str = "train",
                 cfg: Optional[dict] = None):
        self.root_dir = root_dir
        self.split = split
        self._configure(cfg)

        self.data_dir = os.path.join(
            root_dir, "testing" if split == "test" else "training")
        split_file = os.path.join(root_dir, "ImageSets", split + ".txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.idx_list = [x.strip() for x in f.readlines() if x.strip()]
        else:
            imgs = sorted(os.listdir(os.path.join(self.data_dir, "image_2")))
            self.idx_list = [os.path.splitext(x)[0] for x in imgs]
        self.data_augmentation = split in ("train", "trainval")

    def _configure(self, cfg: Optional[dict]) -> None:
        """The dataset section of the config -> attributes (everything but
        the files)."""
        cfg = cfg or {}
        self.resolution = np.array(cfg.get("resolution", [1280, 384]))
        self.max_objs = int(cfg.get("max_objs", 50))
        self.use_3d_center = cfg.get("use_3d_center", True)
        self.writelist = cfg.get("writelist", ["Car"])
        if cfg.get("class_merging", False):
            self.writelist.extend(["Van", "Truck"])
        if cfg.get("use_dontcare", False):
            self.writelist.extend(["DontCare"])
        self.clip_2d = cfg.get("clip_2d", False)
        self.random_flip = float(cfg.get("random_flip", 0.5))
        self.random_crop = float(cfg.get("random_crop", 0.5))
        self.scale = float(cfg.get("scale", 0.05))
        self.shift = float(cfg.get("shift", 0.05))
        self.aug_pd = bool(cfg.get("aug_pd", False))
        self.aug_crop = bool(cfg.get("aug_crop", False))
        self.aug_calib = bool(cfg.get("aug_calib", False))
        self.depth_scale = cfg.get("depth_scale", "normal")
        self.use_canonical_module = bool(cfg.get("use_canonical_module", False))
        self.canonical_focal_length = float(
            cfg.get("canonical_focal_length", 500.0))
        self.meanshape = bool(cfg.get("meanshape", False))
        self.cls_mean_size = (CLS_MEAN_SIZE if self.meanshape
                              else np.zeros((3, 3), np.float32))
        # use_depth: dense depth appended as a 4th input channel
        # (reference kitti_dataset.py:49-51, 173-230; encode :224-230:
        # clip 0..150, /75, -1)
        self.use_depth = bool(cfg.get("use_depth", False))
        self.depth_path = cfg.get("depth_path", "")
        # use_add_data: pseudo-label cars for the TFL/mask aux losses
        # (reference kitti_dataset.py:421-449 -> fixed-shape SoA)
        self.use_add_data = bool(cfg.get("use_add_data", False))
        self.add_data_path = cfg.get("add_data_path", "")
        self.add_data_points = int(cfg.get("add_data_points", 512))
        self.max_add_cars = int(cfg.get("max_add_cars", 16))
        self.add_mask_stride = int(cfg.get("add_mask_stride", 8))

    def __len__(self):
        return len(self.idx_list)

    # -- raw accessors ----------------------------------------------------
    def get_image(self, idx: str) -> "Image.Image":
        from PIL import Image

        return Image.open(os.path.join(self.data_dir, "image_2",
                                       f"{idx}.png")).convert("RGB")

    def get_calib(self, idx: str) -> Calibration:
        return Calibration(os.path.join(self.data_dir, "calib", f"{idx}.txt"))

    def get_label(self, idx: str):
        return read_label_file(os.path.join(self.data_dir, "label_2",
                                            f"{idx}.txt"))

    def get_depth(self, idx: str) -> np.ndarray:
        """(H, W) float32 dense depth (meters) from depth_path/<idx>.npz
        (key 'depth') or .npy — the zstd-dill blobs of the reference
        (:130-137) swapped for a dependency-free format."""
        base = os.path.join(self.depth_path, idx)
        if os.path.exists(base + ".npz"):
            with np.load(base + ".npz") as z:
                return z["depth"].astype(np.float32)
        return np.load(base + ".npy").astype(np.float32)

    # -- canonical module --------------------------------------------------
    def adjust_intrinsics(self, fx, fy, cx, cy, img_size, center, crop_scale,
                          crop_size, flip):
        """kitti_dataset.py:491-525 verbatim math."""
        fx_adj, fy_adj, cx_adj, cy_adj = fx, fy, cx, cy
        if flip:
            cx_adj = img_size[0] - 1 - cx_adj
        fx_adj *= crop_scale
        fy_adj *= crop_scale
        cx_adj *= crop_scale
        cy_adj *= crop_scale
        cx_adj -= center[0] - img_size[0] / 2.0
        cy_adj -= center[1] - img_size[1] / 2.0
        scale_x = self.resolution[0] / crop_size[0]
        fx_adj *= scale_x
        fy_adj *= scale_x
        cx_adj *= scale_x
        cy_adj *= scale_x
        height_cropped = cy_adj / (self.resolution[1] / 2.0)
        return fx_adj, fy_adj, cx_adj, cy_adj, height_cropped

    # -- sample construction ----------------------------------------------
    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        # imported here: the serving image need not have PIL
        from PIL import Image

        idx = self.idx_list[item]
        img = self.get_image(idx)
        calib = self.get_calib(idx)
        img_size = np.array(img.size, np.float64)

        center = img_size / 2.0
        crop_size, crop_scale = img_size.copy(), 1.0
        flip = False
        depth_map = self.get_depth(idx) if self.use_depth else None

        if self.data_augmentation:
            if self.aug_pd:
                from monosowa_tpu_torch.data.pd import photometric_distort
                img = Image.fromarray(
                    photometric_distort(np.array(img).astype(np.float32))
                    .astype(np.uint8))
            if np.random.random() < self.random_flip:
                flip = True
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
                if depth_map is not None:
                    depth_map = np.fliplr(depth_map)
            if self.aug_crop and np.random.random() < self.random_crop:
                crop_scale = float(np.clip(np.random.randn() * self.scale + 1,
                                           1 - self.scale, 1 + self.scale))
                crop_size = img_size * crop_scale
                center[0] += img_size[0] * np.clip(
                    np.random.randn() * self.shift, -2 * self.shift,
                    2 * self.shift)
                center[1] += img_size[1] * np.clip(
                    np.random.randn() * self.shift, -2 * self.shift,
                    2 * self.shift)

        trans, trans_inv = get_affine_transform(
            center, crop_size, 0, self.resolution, inv=1)
        img = img.transform(tuple(int(v) for v in self.resolution),
                            method=Image.AFFINE,
                            data=tuple(trans_inv.reshape(-1).tolist()),
                            resample=Image.BILINEAR)
        image = np.array(img).astype(np.float32) / 255.0
        image = (image - MEAN) / STD            # HWC (NHWC model input)
        if depth_map is not None:
            dimg = Image.fromarray(np.ascontiguousarray(depth_map), mode="F")
            dimg = dimg.transform(tuple(int(v) for v in self.resolution),
                                  method=Image.AFFINE,
                                  data=tuple(trans_inv.reshape(-1).tolist()),
                                  resample=Image.BILINEAR)
            d = np.asarray(dimg, np.float32)
            d = np.clip(d, 0.0, 150.0) / 75.0 - 1.0    # (:224-230)
            image = np.concatenate([image, d[..., None]], axis=-1)

        sample, canonical_scale = self._encode(
            idx, image, calib, img_size, center, crop_size, crop_scale, flip,
            trans, trans_inv)
        if self.use_add_data:
            sample.update(self._load_add_data(idx, trans_inv))
        if self.split != "test":
            self._encode_objects(sample, self.get_label(idx).objects, calib,
                                 img_size, crop_scale, canonical_scale, flip,
                                 trans)
        return sample

    def _encode(self, idx: str, image: np.ndarray, calib: Calibration,
                img_size: np.ndarray, center, crop_size, crop_scale: float,
                flip: bool, trans, trans_inv):
        """(sample, canonical_scale): the sample dict of one warped image,
        its targets still empty, and the depth scale of the Canonical Object
        Space in full precision."""
        fu, fv, cu, cv, height_crop = self.adjust_intrinsics(
            calib.fu, calib.fv, calib.cu, calib.cv, img_size, center,
            crop_scale, crop_size, flip)
        canonical_scale = (self.canonical_focal_length / fu
                           if self.use_canonical_module else 1.0)

        sample = {
            "image": image.astype(np.float32),
            "calib": calib.P2.astype(np.float32),
            "img_id": np.int64(int(idx)),
            "img_size": img_size.astype(np.float32),
            "canonical_scale": np.float32(canonical_scale),
            "height_crop": np.float32(height_crop),
            "trans": trans.astype(np.float32),
            "trans_inv": trans_inv.astype(np.float32),
            "flip_flag": np.bool_(flip),
            "crop_scale": np.float32(crop_scale),
        }
        m = self.max_objs
        sample.update({
            "labels": np.zeros(m, np.int32),
            "boxes": np.zeros((m, 4), np.float32),
            "boxes_3d": np.zeros((m, 6), np.float32),
            "depth": np.zeros(m, np.float32),
            "size_2d": np.zeros((m, 2), np.float32),
            "size_3d": np.zeros((m, 3), np.float32),
            "src_size_3d": np.zeros((m, 3), np.float32),
            "heading_bin": np.zeros(m, np.int32),
            "heading_res": np.zeros(m, np.float32),
            "mask_2d": np.zeros(m, bool),
            "valid": np.zeros(m, bool),
        })
        return sample, canonical_scale

    def _encode_objects(self, sample: Dict[str, np.ndarray], objects,
                        calib: Calibration, img_size: np.ndarray,
                        crop_scale: float, canonical_scale: float,
                        flip: bool, trans) -> None:
        """Fills ``sample``'s targets from the label rows (:287-394)."""
        if flip:
            if self.aug_calib:
                calib.flip(img_size)
            for obj in objects:
                x1, _, x2, _ = obj.box2d
                obj.box2d[0], obj.box2d[2] = img_size[0] - x2, img_size[0] - x1
                obj.alpha = np.pi - obj.alpha
                obj.ry = np.pi - obj.ry
                if self.aug_calib:
                    obj.pos[0] *= -1
                for attr in ("alpha", "ry"):
                    v = getattr(obj, attr)
                    if v > np.pi:
                        setattr(obj, attr, v - 2 * np.pi)
                    elif v < -np.pi:
                        setattr(obj, attr, v + 2 * np.pi)

        for i, obj in enumerate(objects[:self.max_objs]):
            if obj.cls_type not in self.writelist:
                continue
            if obj.level == 4 or obj.pos[-1] < 2:
                continue
            if obj.pos[-1] > 65:   # hard depth threshold (:296-298)
                continue

            bbox_2d = obj.box2d.copy().astype(np.float64)
            bbox_2d[:2] = affine_transform(bbox_2d[:2], trans)
            bbox_2d[2:] = affine_transform(bbox_2d[2:], trans)
            center_2d = np.array([(bbox_2d[0] + bbox_2d[2]) / 2,
                                  (bbox_2d[1] + bbox_2d[3]) / 2])

            center_3d = obj.pos + [0, -obj.h / 2, 0]
            proj, _ = calib.rect_to_img(center_3d.reshape(1, 3))
            center_3d = proj[0]
            if flip and not self.aug_calib:
                center_3d[0] = img_size[0] - center_3d[0]
            center_3d = affine_transform(center_3d, trans)
            if not (0 <= center_3d[0] < self.resolution[0]
                    and 0 <= center_3d[1] < self.resolution[1]):
                continue

            # the reference writes labels/size_2d BEFORE the lrtb check
            # (kitti_dataset.py:334-340 vs :354-360): a negative-lrtb row
            # dropped without clip_2d leaves a GHOST slot — label + size_2d
            # set, everything else zero, mask_2d False (so it never reaches
            # the loss; prepare_targets gathers by mask_2d)
            cls_id = CLS2ID.get(obj.cls_type, 1)
            w = bbox_2d[2] - bbox_2d[0]
            h = bbox_2d[3] - bbox_2d[1]
            sample["labels"][i] = cls_id
            sample["size_2d"][i] = [w, h]
            sample["valid"][i] = True

            c2n = center_2d / self.resolution
            s2n = np.array([w, h]) / self.resolution
            corner = bbox_2d / np.concatenate([self.resolution,
                                               self.resolution])
            c3n = center_3d / self.resolution
            l = c3n[0] - corner[0]
            r = corner[2] - c3n[0]
            t = c3n[1] - corner[1]
            b = corner[3] - c3n[1]
            if min(l, r, t, b) < 0:
                if self.clip_2d:
                    l, r, t, b = (np.clip(v, 0, 1) for v in (l, r, t, b))
                else:
                    continue
            depth_val = obj.pos[-1]
            if self.use_canonical_module:
                depth_val = depth_val * canonical_scale
            if self.depth_scale == "normal":
                depth_val = depth_val * crop_scale
            elif self.depth_scale == "inverse":
                depth_val = depth_val / crop_scale

            heading = self._ry2alpha(calib, obj.ry,
                                     (obj.box2d[0] + obj.box2d[2]) / 2)
            hb, hr = angle2class(heading)

            src_dims = np.array([obj.h, obj.w, obj.l], np.float32)
            sample["boxes"][i] = [c2n[0], c2n[1], s2n[0], s2n[1]]
            sample["boxes_3d"][i] = [c3n[0], c3n[1], l, r, t, b]
            sample["depth"][i] = depth_val
            sample["src_size_3d"][i] = src_dims
            sample["size_3d"][i] = src_dims - self.cls_mean_size[cls_id]
            sample["heading_bin"][i] = hb
            sample["heading_res"][i] = hr
            sample["mask_2d"][i] = obj.truncation <= 0.5 and obj.occlusion <= 2
            sample["valid"][i] = True

    # -- use_add_data -------------------------------------------------------
    def _load_add_data(self, idx: str, trans_inv: np.ndarray
                       ) -> Dict[str, np.ndarray]:
        """Fixed-shape pseudo-label car payload for the TFL/mask aux losses.

        Reads the pipeline's optimized_cars cache (sowa.cache), downsamples
        each car cloud to ``add_data_points``, and warps each instance mask
        through the sample's augmentation affine into the network resolution
        (nearest neighbour, PIL's pixel rule in numpy) then max-pools it by
        ``add_mask_stride`` (reference loads 10k-pt clouds + full masks,
        kitti_dataset.py:421-449; the caps keep the shapes static and
        small).  The subsample draws from ``abs(hash(idx))``, which Python
        salts per process, as the JAX package does."""
        from monosowa_tpu_torch.sowa.cache import load_optimized_cars

        c, p, s = self.max_add_cars, self.add_data_points, self.add_mask_stride
        res_w, res_h = int(self.resolution[0]), int(self.resolution[1])
        mh, mw = res_h // s, res_w // s
        out = {
            "car_points": np.zeros((c, p, 3), np.float32),
            "car_pmask": np.zeros((c, p), bool),
            "car_valid": np.zeros(c, bool),
            "car_moving": np.zeros(c, bool),
            "car_theta": np.zeros(c, np.float32),
            "car_masks": np.zeros((c, mh, mw), np.float32),
        }
        cars = load_optimized_cars(
            os.path.join(self.add_data_path, "optimized_cars"), idx)
        if not cars:
            return out
        rng = np.random.default_rng(abs(hash(idx)) % (2 ** 31))
        for i, car in enumerate(cars[:c]):
            pts = np.asarray(car["points"], np.float32).reshape(-1, 3)
            if pts.shape[0] == 0:
                continue
            if pts.shape[0] > p:
                pts = pts[rng.choice(pts.shape[0], p, replace=False)]
            out["car_points"][i, :pts.shape[0]] = pts
            out["car_pmask"][i, :pts.shape[0]] = True
            out["car_valid"][i] = True
            out["car_moving"][i] = bool(car.get("moving", False))
            out["car_theta"][i] = float(car.get("theta", 0.0))
            m = car.get("mask")
            if m is not None and np.any(m):
                mt = warp_affine_nearest(m.astype(np.uint8) * 255,
                                         (res_w, res_h),
                                         trans_inv.reshape(-1).tolist())
                out["car_masks"][i] = (mt > 127).reshape(
                    mh, s, mw, s).max(axis=(1, 3)).astype(np.float32)
        return out

    @staticmethod
    def _ry2alpha(calib, ry, u):
        alpha = ry - np.arctan2(u - calib.cu, calib.fu)
        if alpha > np.pi:
            alpha -= 2 * np.pi
        if alpha < -np.pi:
            alpha += 2 * np.pi
        return alpha


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
