"""Pseudo-label generator CLI: the ``lidar_scans``, ``mask_tracking`` and
``optimization`` actions.

    python -m monosowa_tpu_torch.sowa.cli --config <yaml> \
        --action {lidar_scans,mask_tracking,optimization} \
        [--seq_start N] [--seq_end M] [--device cpu]

CLI contract (pseudo_label_generator/3d/scripts/main.py:5-17): ``--dataset``,
``--action``, ``--config``, ``--seq_start/--seq_end`` work-sharding.
Multi-machine scaling stays share-nothing: N processes over disjoint
[seq_start, seq_end) shards with skip-if-exists idempotency
(main_class.py:606-646); file existence is the completion marker.

Counterpart of the JAX package's ``sowa/cli.py`` for the KITTI object
layout (``training/image_2`` + ``calib``) with caches under
``paths.merged_frames_path``.  ``lidar_scans`` writes ``lidar_raw/<frame>
.npz`` from cached depth maps (``depth_maps/<frame>.npz``) or from the
frame's image through the zoo's depth network (``backends.depth``);
``mask_tracking`` writes ``masks_raw/<frame>.npz`` (and, with
``extract_pedestrians``, ``pedestrians/``) through the zoo's Mask2Former
(``backends.mask``).  ``optimization`` labels from ``masks_raw/``,
``transformations/``, ``lidar_raw/`` and ``depth_maps/<frame>/<offset>
.npz``: where a frame has a depth-map window, its job extracts on the
device (bank mode under the default config); a merged-cars cache
(``merged_cars/``) is fitted directly.  Networks and labelling run on the
card unless ``--device`` names another.  The other actions, the raw
Waymo driver and the KITTI-360 shuffled draw raise ``NotImplementedError``
naming the JAX module they need.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

import numpy as np

from monosowa_tpu_torch.config import (Config, PipelineFlags, known_actions,
                                       load_config)
from monosowa_tpu_torch.sowa import depth as depth_mod
from monosowa_tpu_torch.sowa import masks as masks_mod
from monosowa_tpu_torch.sowa import transforms as transforms_mod
from monosowa_tpu_torch.sowa.fitting import FitConfig
from monosowa_tpu_torch.sowa.pipeline import PipelineConfig, PseudoLabeler

# action -> the module of the JAX package that it needs
_OTHER_ACTIONS = {
    "transformations": "sowa/transforms.py pose sources with kittiio/oxts.py",
    "homographies": "sowa/stitching.py",
    "candidates": "the candidates action of sowa/cli.py",
    "frames_aggregation": "the frames_aggregation action of sowa/cli.py",
    "dimensions_output": "sowa/dimensions.py and sowa/scale.py",
    "demo": "sowa/dimensions.py and sowa/scale.py",
}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("monosowa-tpu pseudo-label generator (torch)")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--dataset", type=str, default="kitti",
                   choices=["kitti", "kitti360", "waymo", "all",
                            "waymo_converted"])
    p.add_argument("--action", type=str, required=True,
                   choices=known_actions())
    p.add_argument("--seq_start", type=int, default=None)
    p.add_argument("--seq_end", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default: the card (cuda)")
    return p.parse_args(argv)


def pipeline_config_from(cfg: Config) -> PipelineConfig:
    fc = cfg.frames_creation or Config({})
    opt = cfg.optimization or Config({})
    filt = cfg.filtering or Config({})
    lf = cfg.loss_functions or Config({})
    tpl = cfg.templates or Config({})
    return PipelineConfig(
        template_mesh_dir=tpl.get("mesh_dir") or None,
        nscans_before=int(fc.get("nscans_before", 30)),
        nscans_after=int(fc.get("nscans_after", 30)),
        min_standing_points=int(filt.get("lidar_threshold_during_optim", 1000)),
        keep_k_frames=10,
        nms_iou=float(opt.get("nms_threshold", 0.1)),
        dist_threshold_tracking=float(fc.get("dist_treshold_tracking", 10.0)),
        fit=FitConfig(
            dx_min=float(opt.get("opt_param1_min", -2.0)),
            dx_max=float(opt.get("opt_param1_max", 2.0)),
            dz_min=float(opt.get("opt_param2_min", -1.0)),
            dz_max=float(opt.get("opt_param2_max", 3.0)),
            n_dx=int(opt.get("opt_param1_iters", 40)),
            n_dz=int(opt.get("opt_param2_iters", 40)),
            n_theta=int(opt.get("opt_param3_iters", 40)),
            # fine theta pass: hardcoded 360 in the reference
            # (optimizer.py:103); exposed here for small-grid test runs
            n_theta_fine=int(opt.get("opt_fine_iters", 360)),
            radius=float(lf.get("binary_loss_threshold", 0.2)),
            # loss_functions.loss_function dispatch (loss.py:98-116)
            loss_function=str(lf.get("loss_function", "binary2way")),
            sigmoid_steepness=float(lf.get("sigmoid_steepness", 10.0)),
            # the yaml ships trim_threshold; compute_loss reads the
            # misspelled trim_treshold: honour either spelling
            trim_threshold=float(lf.get("trim_treshold",
                                        lf.get("trim_threshold", 0.3)))),
        max_cars=int(opt.get("max_cars_per_frame", 32)),
        max_points=int(filt.get("max_points_per_car", 2048)),
        skip_non_visible=bool(opt.get("skip_non_visible_cars", True)),
        use_pseudo_lidar=bool(fc.get("use_pseudo_lidar", True)),
        use_clever_aggregation=bool(fc.get("use_clever_aggregation", True)),
        use_robust_optimization=bool(opt.get("robust_optimization", False)),
        extract_pedestrians=bool(fc.get("extract_pedestrians", False)),
    )


class KittiObjectDriver:
    """Drives the KITTI object-detection layout: training/image_2 + calib,
    with caches under merged_frames_path (lidar_raw/, masks_raw/,
    transformations/, depth_maps/) and outputs under labels_path."""

    def __init__(self, cfg: Config, flags: PipelineFlags,
                 dataset: str = "kitti", device=None):
        self.cfg = cfg
        self.flags = flags
        self.dataset = dataset
        self.device = device
        paths = cfg.paths or Config({})
        self.kitti_path = paths.get("kitti_path", ".")
        self.cache = paths.get("merged_frames_path", "./cache")
        self.labels_path = paths.get("labels_path", "./labels")
        self.pcfg = pipeline_config_from(cfg)

    # cache directories (output.py:127-172 taxonomy)
    @property
    def pcd_dir(self):
        return os.path.join(self.cache, "lidar_raw")

    @property
    def masks_dir(self):
        return os.path.join(self.cache, "masks_raw")

    @property
    def transforms_dir(self):
        return os.path.join(self.cache, "transformations")

    @property
    def merged_dir(self):
        return os.path.join(self.cache, "merged_cars")

    def frame_ids(self) -> List[str]:
        img_dir = os.path.join(self.kitti_path, "training", "image_2")
        return sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir))

    def run(self, seq_start: Optional[int], seq_end: Optional[int]) -> int:
        action = self.flags.action
        if action in _OTHER_ACTIONS:
            raise NotImplementedError(
                f"action {action!r}: {_OTHER_ACTIONS[action]} of the JAX "
                "package is not ported")
        ids = self.frame_ids()
        lo = seq_start or 0
        hi = min(seq_end if seq_end is not None else len(ids), len(ids))
        ids = ids[lo:hi]
        if self.flags.generate_raw_lidar:
            return sum(self._lidar_frame(fid) for fid in ids)
        if self.flags.generate_raw_masks_or_tracking:
            from monosowa_tpu_torch.sowa import zoo
            backend = zoo.mask_backend(self.cfg, device=self.device)
            if backend is None:
                raise NotImplementedError(
                    "action 'mask_tracking' on frame datasets needs a live "
                    "instance-segmentation backend: set backends.mask "
                    "(e.g. mask2former + mask_checkpoint) in the config, "
                    "or precompute masks_raw/ artifacts")
            zoo.sam_refine_backend(self.cfg)    # use_SAM raises
            return sum(self._masks_frame(fid, backend) for fid in ids)
        n_done = 0
        labeler = PseudoLabeler(self.pcfg, device=self.device)
        group = int((self.cfg.general or Config({}))
                    .get("frames_per_batch", 8))
        pending = []
        for fid in ids:
            used_cache = self._optimize_frame_cached(labeler, fid)
            if used_cache is not None:
                n_done += used_cache
                continue
            job = self._optimize_job(fid)
            if job is None:
                continue
            pending.append(job)
        # 2-deep pipelined groups: group k+1's extraction dispatch
        # overlaps group k's fit and label writing
        n_done += labeler.label_frames_stream(pending, group_size=group)
        return n_done

    def _calib(self, fid: str):
        from monosowa_tpu_torch.kittiio import Calibration
        return Calibration(os.path.join(self.kitti_path, "training",
                                        "calib", f"{fid}.txt"))

    def _depth_backend(self):
        """The configured depth source, one per driver (a live backend
        holds its network)."""
        if not hasattr(self, "_depth_backend_cache"):
            from monosowa_tpu_torch.sowa import zoo
            self._depth_backend_cache = zoo.depth_backend(
                self.cfg, os.path.join(self.cache, "depth_maps"),
                device=self.device)
        return self._depth_backend_cache

    def _lidar_frame(self, fid: str) -> int:
        """`--action lidar_scans`: depth map -> pseudo-lidar cache
        (metric3d.py:39-279).  ``backends.depth`` selects the source:
        cached reads <merged_frames_path>/depth_maps/<fid>.npz; the live
        mode runs on the frame's image with its calib fx."""
        out = os.path.join(self.pcd_dir, f"{fid}.npz")
        if os.path.exists(out):
            return 0
        backend = self._depth_backend()
        calib = self._calib(fid)
        if hasattr(backend, "predict_depth_for"):
            dmap = backend.predict_depth_for(fid)
        else:
            img = self._image(fid)
            if img is None:
                return 0
            # canonical contract: metric = canonical * fx / 1000, with fx
            # from this frame's calib (metric3d.py:327-333)
            backend.fx = float(calib.P2[0, 0])
            dmap = backend.predict_depth(img)
        if dmap is None:
            return 0
        pts = depth_mod.pseudo_lidar_from_depth(dmap, calib.P2,
                                                device=self.device)
        os.makedirs(self.pcd_dir, exist_ok=True)
        np.savez_compressed(out, points=pts)
        return 1

    def _masks_frame(self, fid: str, backend) -> int:
        """`--action mask_tracking` for frame datasets: live instance
        segmentation -> masks_raw cache (precompute_detectron_kitti,
        loader.py:1703-1790).  With extract_pedestrians, person-class masks
        land in the pedestrians/ cache (output.py:141-143) from the SAME
        forward."""
        if masks_mod.load_masks(self.masks_dir, fid) is not None:
            return 0
        img = self._image(fid)
        if img is None:
            return 0
        if self.pcfg.extract_pedestrians:
            person_ids = tuple((self.cfg.backends or Config({}))
                               .get("mask_person_labels", (0,)))
            (masks, _), (ped_masks, _) = backend.predict_masks_multi(
                img, [backend.car_label_ids, person_ids])
            masks_mod.save_masks(os.path.join(self.cache, "pedestrians"),
                                 fid, ped_masks, img.shape[:2])
        else:
            masks, _ = backend.predict_masks_scores(img)
        masks_mod.save_masks(self.masks_dir, fid, masks, img.shape[:2])
        return 1

    def _window_accessors(self, fid: str):
        before, after = self.pcfg.nscans_before, self.pcfg.nscans_after
        window = list(range(-before, after + 1))
        seq_pcds = os.path.join(self.pcd_dir, fid, "pcds")

        def get_points(k):
            path = os.path.join(seq_pcds, f"{window[k]:+d}.npz")
            if not os.path.exists(path) and window[k] == 0:
                path = os.path.join(self.pcd_dir, f"{fid}.npz")
            return depth_mod.load_pseudo_lidar(path)

        def get_masks(k):
            name = fid if window[k] == 0 else f"{fid}{window[k]:+d}"
            return masks_mod.load_masks(self.masks_dir, name)

        full = transforms_mod.load_window_transforms(self.transforms_dir, fid)
        if full is None:
            transforms = np.tile(np.eye(4), (len(window), 1, 1))
        else:
            rng_full = (full.shape[0] - 1) // 2
            transforms = transforms_mod.slice_window(full, rng_full, before,
                                                     after)
        return window, get_points, get_masks, transforms

    def _optimize_frame_cached(self, labeler: PseudoLabeler, fid: str):
        """Skip-if-done / merged-cache fast path.  Returns frames written
        (0 or 1) or None when the frame needs the full pipeline."""
        out = os.path.join(self.labels_path, f"{fid}.txt")
        if os.path.exists(out):
            return 0
        from monosowa_tpu_torch.kittiio.labels import write_pseudo_label_file
        from monosowa_tpu_torch.sowa import cache as cache_mod
        merged = cache_mod.load_merged_cars(self.merged_dir, fid)
        if merged is not None:
            tracks, points, ref_masks = merged
            before, after = self.pcfg.nscans_before, self.pcfg.nscans_after
            window = list(range(-before, after + 1))
            cars = labeler.label_from_cars(tracks, points, ref_masks, window)
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            write_pseudo_label_file(out, cars)
            return 1
        return None

    def _optimize_job(self, fid: str):
        """Build a label_frames job dict for a frame (full pipeline)."""
        window, get_points, get_masks, transforms = self._window_accessors(fid)
        calib = self._calib(fid)
        img_hw = self._image_hw(fid)
        job = dict(out_path=os.path.join(self.labels_path, f"{fid}.txt"),
                   window_frames=window, get_points=get_points,
                   get_masks=get_masks, transforms=transforms,
                   p2=calib.P2, img_hw=img_hw)
        # global window-frame ids: overlapping windows (and consecutive
        # stream groups) then share each frame's candidate extraction
        try:
            base = int(fid)
            job["frame_ids"] = [base + k for k in window]
        except ValueError:
            job["frame_ids"] = [f"{fid}{k:+d}" for k in window]
        # per-window depth-map cache (depth_maps/<fid>/{offset:+d}.npz,
        # canonical scale like the flat per-frame maps) -> the extraction
        # runs on the device, in bank mode under the default config
        dm_dir = os.path.join(self.cache, "depth_maps", fid)
        if os.path.isdir(dm_dir):
            fu = float(calib.P2[0, 0])

            def get_depth(k, dm_dir=dm_dir, fu=fu, window=window):
                p = os.path.join(dm_dir, f"{window[k]:+d}.npz")
                if not os.path.exists(p):
                    return None
                with np.load(p) as z:
                    d = z["depth"]
                return np.clip(
                    d.astype(np.float32) * (fu / depth_mod.CANONICAL_FOCAL),
                    0.0, depth_mod.MAX_DEPTH)

            job["get_depth"] = get_depth
        return job

    def _image_hw(self, fid: str):
        p = os.path.join(self.kitti_path, "training", "image_2", f"{fid}.png")
        if os.path.exists(p):
            from PIL import Image
            with Image.open(p) as im:
                return im.size[1], im.size[0]
        return (375, 1242)

    def _image(self, fid: str) -> Optional[np.ndarray]:
        """(H, W, 3) uint8 RGB frame image, or None when absent."""
        p = os.path.join(self.kitti_path, "training", "image_2", f"{fid}.png")
        if not os.path.exists(p):
            return None
        from PIL import Image
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config)
    flags = PipelineFlags(args.action)
    if args.dataset == "waymo":
        raise NotImplementedError(
            "--dataset waymo: the raw Waymo driver (WaymoSegmentDriver of "
            "sowa/cli.py, sowa/waymo2d.py) is not ported")
    if args.dataset in ("kitti360", "all"):
        raise NotImplementedError(
            f"--dataset {args.dataset}: the KITTI-360 seed-360 shuffled "
            "frame draw (shuffled_frame_order of sowa/cli.py) is not ported")
    t0 = time.time()
    driver = KittiObjectDriver(cfg, flags, dataset=args.dataset,
                               device=args.device)
    n = driver.run(args.seq_start, args.seq_end)
    print(f"[{args.action}] processed {n} frames in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
