"""Synthetic detector data: a training batch (the JAX package's
``__graft_entry__._sample_batch``, the same numpy draws, numpy out), an
in-memory dataset with KITTI labels and a pseudo-label car cache for it,
for driving the train / test / AP loop, with or without the TFL and mask
losses, on a machine that has neither KITTI nor PIL."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from monosowa_tpu_torch.data.affine import get_affine_transform
from monosowa_tpu_torch.data.kitti_dataset import (CLS_MEAN_SIZE,
                                                   KittiDetectionDataset)
from monosowa_tpu_torch.kittiio import Calibration
from monosowa_tpu_torch.kittiio.labels import KittiObject
from monosowa_tpu_torch.sowa.cache import save_optimized_cars
from monosowa_tpu_torch.sowa.templates import TemplateBank


def sample_batch(b: int, h: int, w: int, max_objs: int = 8,
                 seed: int = 0) -> Dict[str, np.ndarray]:
    """``b`` normalised noise images of ``h`` x ``w`` with the KITTI-like P2
    (f = 700, principal point at the centre) and ``max_objs`` padded
    targets per image, of which the first 3 are valid."""
    rng = np.random.default_rng(seed)
    calib = np.tile(np.array([[700.0, 0, w / 2, 0],
                              [0, 700.0, h / 2, 0],
                              [0, 0, 1, 0]], np.float32), (b, 1, 1))
    boxes_3d = np.zeros((b, max_objs, 6), np.float32)
    boxes_3d[..., :2] = rng.uniform(0.3, 0.7, (b, max_objs, 2))
    boxes_3d[..., 2:] = rng.uniform(0.02, 0.2, (b, max_objs, 4))
    boxes = np.concatenate([boxes_3d[..., :2],
                            boxes_3d[..., 2:3] + boxes_3d[..., 3:4],
                            boxes_3d[..., 4:5] + boxes_3d[..., 5:6]], -1)
    valid = np.zeros((b, max_objs), bool)
    valid[:, :3] = True
    return {
        "image": rng.normal(size=(b, h, w, 3)).astype(np.float32),
        "calib": calib,
        "img_size": np.tile(np.array([w, h], np.float32), (b, 1)),
        "labels": rng.integers(0, 3, (b, max_objs)).astype(np.int32),
        "boxes": boxes,
        "boxes_3d": boxes_3d,
        "depth": rng.uniform(5, 50, (b, max_objs)).astype(np.float32),
        "size_3d": rng.uniform(-0.3, 0.3, (b, max_objs, 3)).astype(
            np.float32),
        "heading_bin": rng.integers(0, 12, (b, max_objs)).astype(np.int32),
        "heading_res": rng.uniform(-0.2, 0.2, (b, max_objs)).astype(
            np.float32),
        "mask_2d": valid.copy(),
        "valid": valid,
    }


class SampleDataset(KittiDetectionDataset):
    """A seeded in-memory stand-in for ``KittiDetectionDataset``: ``n``
    noise images at the network resolution, each with ``n_cars`` cars
    standing on the ground before a KITTI-like camera.  ``__getitem__``
    returns the keys and encodings of the file-backed dataset (its own
    label encoder, no augmentation, no image warp; with ``use_add_data``
    the car payload of ``_load_add_data``, through the identity affine);
    ``idx_list`` holds the ids, ``first_id`` and up.
    ``write_sample_labels`` writes the cars as KITTI ``label_2`` files, the
    ground truth of the AP evaluation; ``write_sample_cars`` writes them as
    the pseudo-labeller's ``optimized_cars`` cache.  Cars
    lie between 8 m and ``max_depth`` at KITTI's resolution (nearer in a
    narrower image); up to 20 m a car is Easy there (KITTI's AP needs 41
    valid boxes to reach 100)."""

    def __init__(self, n: int, cfg: Optional[dict] = None, n_cars: int = 3,
                 first_id: int = 0, seed: int = 0, max_depth: float = 40.0):
        self.root_dir, self.split = "", "val"
        self._configure(cfg)
        self.data_augmentation = False
        self.idx_list = [f"{first_id + i:06d}" for i in range(n)]
        self.seed = int(seed)
        w, h = (int(v) for v in self.resolution)
        f = 0.55 * w                        # 704 px at KITTI's 1280
        self.p2 = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0],
                            [0, 0, 1, 0]], np.float64)
        rng = np.random.default_rng([self.seed, first_id])
        self.objects: List[List[KittiObject]] = [
            self._draw_cars(rng, n_cars, max_depth) for _ in range(n)]

    def _draw_cars(self, rng, n_cars: int,
                   max_depth: float) -> List[KittiObject]:
        """Cars of about the mean KITTI shape on the ground plane (camera
        1.65 m above it), the first one near enough to count as Easy at
        KITTI's resolution; every value rounded to the label file's two
        decimals."""
        calib = Calibration({"P2": self.p2})
        w, h = (float(v) for v in self.resolution)
        cars = []
        for k in range(n_cars):
            # depths shrink with the focal length, so that a narrower
            # image sees cars of the same share of its height; the dataset
            # drops cars nearer than 2 m
            z = rng.uniform(8, 20 if k == 0 else max(max_depth, 20))
            z = max(2.5, z * self.p2[0, 0] / 704.0)
            x = rng.uniform(-0.3, 0.3) * z * (w / h) / 3.3
            hwl = CLS_MEAN_SIZE[1] * rng.uniform(0.9, 1.1, 3)
            ry = rng.uniform(-np.pi, np.pi)
            obj = KittiObject("Car", 0.0, 0.0, 0.0, np.zeros(4, np.float32),
                              *(round(float(v), 2) for v in hwl),
                              np.round([x, 1.65, z], 2).astype(np.float32),
                              round(float(ry), 2))
            box, _ = calib.corners3d_to_img_boxes(obj.corners3d()[None])
            box = np.clip(box[0], 0, [w - 1, h - 1, w - 1, h - 1])
            obj.box2d = np.round(box, 2).astype(np.float32)
            obj.alpha = round(float(calib.ry2alpha(
                obj.ry, (box[0] + box[2]) / 2)), 2)
            cars.append(obj)
        return cars

    def get_image(self, idx: str) -> np.ndarray:
        """(H, W, 3) float32, normalised noise."""
        w, h = (int(v) for v in self.resolution)
        rng = np.random.default_rng([self.seed, int(idx), 1])
        return rng.normal(size=(h, w, 3)).astype(np.float32)

    def get_calib(self, idx: str) -> Calibration:
        return Calibration({"P2": self.p2})

    def __getitem__(self, item: int) -> Dict[str, np.ndarray]:
        idx = self.idx_list[item]
        calib = self.get_calib(idx)
        img_size = self.resolution.astype(np.float64)
        center, crop_size = img_size / 2.0, img_size.copy()
        trans, trans_inv = get_affine_transform(center, crop_size, 0,
                                                self.resolution, inv=1)
        sample, canonical_scale = self._encode(
            idx, self.get_image(idx), calib, img_size, center, crop_size,
            1.0, False, trans, trans_inv)
        if self.use_add_data:
            sample.update(self._load_add_data(idx, trans_inv))
        self._encode_objects(sample, self.objects[item], calib, img_size,
                             1.0, canonical_scale, False, trans)
        return sample


def write_sample_labels(label_dir: str, dataset: SampleDataset) -> None:
    """One KITTI ``label_2`` file per image of ``dataset`` in
    ``label_dir``."""
    os.makedirs(label_dir, exist_ok=True)
    for item, idx in enumerate(dataset.idx_list):
        with open(os.path.join(label_dir, f"{idx}.txt"), "w") as f:
            for obj in dataset.objects[item]:
                f.write(obj.to_kitti_line() + "\n")


def write_sample_cars(add_data_path: str, dataset: SampleDataset,
                      noise: float = 0.02, seed: int = 0) -> None:
    """The pseudo-labeller's cache of fitted cars for every image of
    ``dataset``, in ``add_data_path/optimized_cars`` (``save_optimized_cars``,
    what ``use_add_data`` reads): for each car a template cloud (the
    default bank's, cycling through its four shapes) scaled to the car's
    dimensions, turned by ry + pi/2 about y and centred on the box, with
    gaussian noise of ``noise`` m; every second car ``moving``; its mask
    the car's 2D box at the image's resolution."""
    bank = TemplateBank.default()
    l_t, w_t, h_t = (float(v) for v in bank.dims_lwh)
    w, h = (int(v) for v in dataset.resolution)
    rng = np.random.default_rng([seed, 2])
    cache_dir = os.path.join(add_data_path, "optimized_cars")
    for item, idx in enumerate(dataset.idx_list):
        cars = []
        for k, obj in enumerate(dataset.objects[item]):
            tmpl = bank.points[k % len(bank.points)].astype(np.float64)
            pts = tmpl * np.array([obj.w / w_t, obj.h / h_t, obj.l / l_t])
            c, s = np.cos(obj.ry + np.pi / 2), np.sin(obj.ry + np.pi / 2)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            center = obj.pos + np.array([0.0, -obj.h / 2, 0.0])
            pts = pts @ rot.T + center + rng.normal(0, noise, pts.shape)
            x1, y1, x2, y2 = obj.box2d
            mask = np.zeros((h, w), bool)
            mask[int(np.floor(y1)):int(np.ceil(y2)) + 1,
                 int(np.floor(x1)):int(np.ceil(x2)) + 1] = True
            cars.append({"points": pts.astype(np.float32), "mask": mask,
                         "moving": k % 2 == 1, "theta": float(obj.ry)})
        save_optimized_cars(cache_dir, idx, cars)
