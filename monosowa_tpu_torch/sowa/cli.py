"""Pseudo-label generator CLI.

    python -m monosowa_tpu_torch.sowa.cli --config <yaml> \
        --action {lidar_scans,transformations,homographies,mask_tracking,
                  candidates,frames_aggregation,optimization,
                  dimensions_output,demo} \
        [--dataset {kitti,kitti360,all,waymo_converted,waymo}] \
        [--seq_start N] [--seq_end M] [--device cpu]

CLI contract (pseudo_label_generator/3d/scripts/main.py:5-17): ``--dataset``,
``--action``, ``--config``, ``--seq_start/--seq_end`` work-sharding.
Multi-machine scaling stays share-nothing: N processes over disjoint
[seq_start, seq_end) shards with skip-if-exists idempotency
(main_class.py:606-646); file existence is the completion marker.

Counterpart of the JAX package's ``sowa/cli.py`` for the KITTI object
layout (``training/image_2`` + ``calib``) with caches under
``paths.merged_frames_path``; ``--dataset kitti``, ``kitti360``, ``all``
and ``waymo_converted`` all take this layout (KITTI-360 frame ids are
``<sequence>_<number>``, and its workers draw the seed-360 shuffled
frame order).  ``lidar_scans`` writes ``lidar_raw/<frame>.npz`` from
cached depth maps (``depth_maps/<frame>.npz``) or from the frame's image
through the zoo's depth network (``backends.depth``); ``transformations``
writes ``transformations/<frame>.npy`` (KITTI-360 ``cam0_to_world.txt``
poses under ``paths.all_dataset_path``, waymo_converted ``Cur_pose`` calib
rows, identity windows for the object layout); ``mask_tracking`` writes
``masks_raw/<frame>.npz`` (and, with ``extract_pedestrians``,
``pedestrians/``) through the zoo's Mask2Former (``backends.mask``), its
car masks refined by the zoo's SAM with ``frames_creation.use_SAM``;
``candidates`` and ``frames_aggregation`` write the ``candidates/`` and
``merged_cars/`` caches on the host.  ``optimization`` labels from
``masks_raw/``, ``transformations/``, ``lidar_raw/`` and
``depth_maps/<frame>/<offset>.npz``: where a frame has a depth-map window,
its job extracts on the device (bank mode under the default config); a
merged-cars cache (``merged_cars/``) is fitted directly.  ``demo`` and
``dimensions_output`` label the same way with the scale detector (and box
reducer) on; with ``extract_pedestrians`` every label file also holds the
``Pedestrian`` rows of the frame's ``pedestrians/`` masks.  Networks and
labelling run on the card unless ``--device`` names another.

``--dataset waymo`` drives raw Waymo segments (``WaymoSegmentDriver``, the
JAX driver's files): ``homographies`` (pair homographies through ORB on
the host or EfficientLoFTR on the card, ``backends.matcher``),
``mask_tracking`` (pair canvases stitched on the card, Mask2Former on them
or a ``masks_raw/`` cache, the template or ViT tracker,
``backends.tracker``), ``transformations`` (vehicle poses) and
``optimization`` (the fit on the card).  ``homographies`` on the frame
datasets raises ``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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
from monosowa_tpu_torch.utils import timing


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


def png_size(path: str):
    """(height, width) of a PNG file from its IHDR chunk, the first of
    every PNG (what PIL's ``Image.size`` reports, reversed)."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def shuffled_frame_order(n: int, seq_start: Optional[int],
                         seq_end: Optional[int]) -> np.ndarray:
    """The KITTI-360 fleet draw (main_class.py:636-646
    limit_sequences_all_random): a FIXED seed-360 shuffle of the frame
    index space, sliced by [seq_start:seq_end]: concurrent share-nothing
    workers with disjoint slices draw disjoint random frame subsets, so a
    partial fleet run still covers the dataset uniformly.  Seeds numpy's
    global generator, as the reference does."""
    np.random.seed(360)
    indexes = np.arange(0, n)
    np.random.shuffle(indexes)
    return indexes[seq_start:seq_end]


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
        self.all_dataset_path = paths.get("all_dataset_path", None)
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
    def candidates_dir(self):
        return os.path.join(self.cache, "candidates")

    @property
    def merged_dir(self):
        return os.path.join(self.cache, "merged_cars")

    def frame_ids(self) -> List[str]:
        img_dir = os.path.join(self.kitti_path, "training", "image_2")
        return sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir))

    def run(self, seq_start: Optional[int], seq_end: Optional[int],
            shuffle: bool = False) -> int:
        action = self.flags.action
        if action == "homographies":
            raise NotImplementedError(
                "action 'homographies' estimates the Waymo pair homographies "
                "(sowa/stitching.py, sowa/waymo2d.py) and runs with "
                "--dataset waymo only")
        ids = self.frame_ids()
        if shuffle:
            # KITTI-360 fleet draw: disjoint random subsets per worker
            ids = [ids[i] for i in shuffled_frame_order(
                len(ids), seq_start, seq_end)]
        else:
            lo = seq_start or 0
            hi = min(seq_end if seq_end is not None else len(ids), len(ids))
            ids = ids[lo:hi]
        flags = self.flags
        if flags.do_optim or flags.compute_dimensions:
            return self._optimize_frames(ids)
        if flags.generate_transformations_only:
            return sum(self._transforms_frame(fid) for fid in ids)
        if flags.generate_candidates:
            return sum(self._candidates_frame(fid) for fid in ids)
        if flags.generate_merged_frames_only:
            return sum(self._merge_frame(fid) for fid in ids)
        if flags.generate_raw_lidar:
            return sum(self._lidar_frame(fid) for fid in ids)
        # mask_tracking, the last action (homographies raised above)
        from monosowa_tpu_torch.sowa import zoo
        backend = zoo.mask_backend(self.cfg, device=self.device)
        if backend is None:
            raise NotImplementedError(
                "action 'mask_tracking' on frame datasets needs a live "
                "instance-segmentation backend: set backends.mask "
                "(e.g. mask2former + mask_checkpoint) in the config, "
                "or precompute masks_raw/ artifacts")
        refine = zoo.sam_refine_backend(self.cfg, device=self.device)
        return sum(self._masks_frame(fid, backend, refine) for fid in ids)

    def _optimize_frames(self, ids: List[str]) -> int:
        """`optimization`, `dimensions_output`, `demo`: label each frame
        from its merged-cars cache, or through the full pipeline in
        streamed groups.  The last two actions turn the size stages on
        (the scale detector, or the dimension estimator)."""
        import dataclasses

        pcfg = self.pcfg
        if self.flags.do_optim_scale or self.flags.compute_dimensions:
            pcfg = dataclasses.replace(
                pcfg, use_scale_detector=self.flags.do_optim_scale,
                use_dimensions_estimation=self.flags.compute_dimensions
                and not self.flags.do_optim_scale)
        n_done = 0
        labeler = PseudoLabeler(pcfg, device=self.device)
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

    @staticmethod
    def _read_calib_safe(path: str):
        from monosowa_tpu_torch.kittiio import Calibration
        try:
            return Calibration(path)
        except (OSError, KeyError):
            return None

    def _transforms_frame(self, fid: str) -> int:
        """`--action transformations`, dataset-dispatched pose sources
        (loader.py:901-1013):

        * kitti360 / all: ``data_poses/<seq>/cam0_to_world.txt`` windows
          (calculate_transformations_all :942-982); frame ids are
          ``<sequence>_<number>``;
        * waymo_converted: per-frame calib ``Cur_pose`` rows
          (calculate_transformations_waymoc :984-1013), sequence layout
          ``training/<seq>/calib/`` under all_dataset_path when the frame
          id carries a sequence prefix, else the flat object-layout calib
          dir (numeric neighbour frames);
        * kitti (object layout): identity windows: single-shot frames have
          no pose chain; raw-sequence OXTS chains come through
          tools/kitti_raw_transforms.py.
        """
        out = transforms_mod.transforms_cache_path(self.transforms_dir, fid)
        if os.path.exists(out):
            return 0
        rng = int((self.cfg.frames_creation or Config({}))
                  .get("nscans_transformation_range", 130))
        t = None
        if self.dataset in ("kitti360", "all") and self.all_dataset_path:
            folder, _, number = fid.rpartition("_")
            pose_file = os.path.join(self.all_dataset_path, "data_poses",
                                     folder, "cam0_to_world.txt")
            if folder and os.path.exists(pose_file):
                poses = transforms_mod.read_cam0_to_world(pose_file)
                t = transforms_mod.k360_window_transforms(
                    poses, int(number), rng, rng)
        elif self.dataset == "waymo_converted":
            folder, _, number = fid.rpartition("_")
            seq_calib = (os.path.join(self.all_dataset_path, "training",
                                      folder, "calib")
                         if self.all_dataset_path and folder else None)
            if seq_calib and os.path.isdir(seq_calib):
                t = transforms_mod.waymoc_window_transforms(
                    seq_calib, int(number), rng, rng)
            else:
                flat_calib = os.path.join(self.kitti_path, "training",
                                          "calib")
                ref = self._read_calib_safe(os.path.join(flat_calib,
                                                         f"{fid}.txt"))
                if ref is not None and ref.pose is not None:
                    width = len(fid)
                    t = transforms_mod.waymoc_window_transforms(
                        flat_calib, int(fid), rng, rng,
                        name_fn=lambda i: str(i).zfill(width))
        if t is None:
            t = np.tile(np.eye(4), (2 * rng + 1, 1, 1))
        transforms_mod.save_window_transforms(self.transforms_dir, fid, t)
        return 1

    def _candidates_frame(self, fid: str) -> int:
        """`--action candidates`: extract + cache the reference frame's
        candidates (loader.py:1535-1649 precompute path)."""
        from monosowa_tpu_torch.sowa import cache as cache_mod
        from monosowa_tpu_torch.sowa import candidates as cand_mod

        if cache_mod.stage_done(self.candidates_dir, fid):
            return 0
        window, get_points, get_masks, transforms = self._window_accessors(fid)
        calib = self._calib(fid)
        img_hw = self._image_hw(fid)
        ref_k = window.index(0)
        pts = get_points(ref_k)
        masks = get_masks(ref_k)
        if pts is None or masks is None:
            return 0
        cand = cand_mod.extract_candidates(pts, calib.P2, img_hw, masks,
                                           transforms[ref_k],
                                           self.pcfg.candidate)
        cache_mod.save_candidates(self.candidates_dir, fid, cand)
        return 1

    def _merge_frame(self, fid: str) -> int:
        """`--action frames_aggregation`: candidates -> tracking ->
        classification -> aggregation over the window, on the host, and
        cache the merged cars."""
        from monosowa_tpu_torch.sowa import aggregation
        from monosowa_tpu_torch.sowa import cache as cache_mod
        from monosowa_tpu_torch.sowa import candidates as cand_mod
        from monosowa_tpu_torch.sowa import lomm

        if cache_mod.stage_done(self.merged_dir, fid):
            return 0
        window, get_points, get_masks, transforms = self._window_accessors(fid)
        calib = self._calib(fid)
        img_hw = self._image_hw(fid)
        cands = []
        for k in range(len(window)):
            pts = get_points(k)
            masks = get_masks(k)
            if pts is None or masks is None or len(masks) == 0:
                cands.append(None)
                continue
            cands.append(cand_mod.extract_candidates(
                pts, calib.P2, img_hw, masks, transforms[k],
                self.pcfg.candidate))
        tracks = lomm.greedy_track(cands, window,
                                   self.pcfg.dist_threshold_tracking)
        lomm.classify_all(tracks, method=self.pcfg.moving_method)
        kept, points, ref_masks = aggregation.aggregate_tracks(
            tracks, transforms, window, self.pcfg.keep_k_frames,
            self.pcfg.min_standing_points)
        cache_mod.save_merged_cars(self.merged_dir, fid, kept, points,
                                   ref_masks)
        return 1

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

    def _masks_frame(self, fid: str, backend, refine=None) -> int:
        """`--action mask_tracking` for frame datasets: live instance
        segmentation -> masks_raw cache (precompute_detectron_kitti,
        loader.py:1703-1790), each car mask above the score threshold
        refined by SAM when ``refine`` is given (use_SAM,
        loader.py:1727-1739).  With extract_pedestrians, person-class masks
        land in the pedestrians/ cache (output.py:141-143) from the SAME
        forward, unrefined."""
        if masks_mod.load_masks(self.masks_dir, fid) is not None:
            return 0
        img = self._image(fid)
        if img is None:
            return 0
        if self.pcfg.extract_pedestrians:
            person_ids = tuple((self.cfg.backends or Config({}))
                               .get("mask_person_labels", (0,)))
            (masks, scores), (ped_masks, _) = backend.predict_masks_multi(
                img, [backend.car_label_ids, person_ids])
            masks_mod.save_masks(os.path.join(self.cache, "pedestrians"),
                                 fid, ped_masks, img.shape[:2])
        else:
            masks, scores = backend.predict_masks_scores(img)
        if refine is not None:
            masks = masks_mod.refine_masks(masks, scores, img, refine)
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
            if self.pcfg.extract_pedestrians:
                _, get_points, _, _ = self._window_accessors(fid)
                cars = cars + labeler.pedestrian_labels(
                    window, get_points, self._calib(fid).P2,
                    self._image_hw(fid), self._ped_masks(fid))
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
        if self.pcfg.extract_pedestrians:
            job["ped_masks"] = self._ped_masks(fid)
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

    def _optimize_frame(self, labeler: PseudoLabeler, fid: str) -> int:
        """One frame through the full pipeline on its own (the JAX
        driver's ``_optimize_frame``, the per-frame route beside the
        grouped ``_optimize_frames``): the merged-cars cache or a finished
        label file first, else ``label_and_write`` over the window's
        pseudo-LiDAR (``pcds/<offset>.npz``, the reference frame's flat
        ``<fid>.npz`` where the window has none) and masks.  Returns the
        frames written (0 or 1)."""
        cached = self._optimize_frame_cached(labeler, fid)
        if cached is not None:
            return cached
        window, get_points, get_masks, transforms = \
            self._window_accessors(fid)
        ped_masks = (self._ped_masks(fid)
                     if self.pcfg.extract_pedestrians else None)
        labeler.label_and_write(
            os.path.join(self.labels_path, f"{fid}.txt"), window,
            self.pcfg.nscans_before, get_points, get_masks, transforms,
            self._calib(fid).P2, self._image_hw(fid), ped_masks=ped_masks)
        return 1

    def _ped_masks(self, fid: str):
        """The frame's person-class masks from the pedestrians/ cache
        (prepare_dirs taxonomy, output.py:141-143), or None."""
        return masks_mod.load_masks(os.path.join(self.cache, "pedestrians"),
                                    fid)

    def _image_hw(self, fid: str):
        """(height, width) of the frame's PNG, from its header (no image
        library needed); KITTI's 375 x 1242 without one."""
        p = os.path.join(self.kitti_path, "training", "image_2", f"{fid}.png")
        if os.path.exists(p):
            return png_size(p)
        return (375, 1242)

    def _image(self, fid: str) -> Optional[np.ndarray]:
        """(H, W, 3) uint8 RGB frame image, or None when absent."""
        p = os.path.join(self.kitti_path, "training", "image_2", f"{fid}.png")
        if not os.path.exists(p):
            return None
        from PIL import Image
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB"))


class WaymoSegmentDriver:
    """Drives raw multi-camera Waymo segments through the 2D-tracker path
    (main_class.main_waymo :39-150, tracker_for_merging: '2D'); the JAX
    package's ``WaymoSegmentDriver``, with the same files.

    On-disk segment layout (one dir per segment under paths.waymo_path):

      <segment>/camera_{0..4}/{frame:06d}.png   slot-ordered images
                                                (SIDE_LEFT, FRONT_LEFT,
                                                FRONT, FRONT_RIGHT,
                                                SIDE_RIGHT)
      <segment>/lidar/{frame:06d}.npz           key "points": (N, 6) fused
                                                vehicle-frame xyz + cam id
                                                + (u, v) pixel
      <segment>/poses.npy                       (T, 4, 4) T_world<-vehicle

    Caches under merged_frames_path: ``homographies/<seg>.npz`` (NaN for
    a pair without one), ``detandtracked/<seg>.npz`` (bit-packed pair
    masks and the object array of tracks), ``masks_raw/<seg>/`` for
    precomputed pair-canvas masks, ``transformations/<seg>/``; labels under
    ``labels_path/<seg>/``.  The canvases, the mask network
    (``backends.mask``), the tracker (``backends.tracker``), the LoFTR
    matcher (``backends.matcher: loftr``) and the fit run on ``device``
    (default the card); RANSAC, the LiDAR gather, tracking bookkeeping and
    the cache files on the host.  Each stage is a span of the tracer
    (``utils/timing.py``), ``waymo.<stage>``, and ``stage_seconds`` sums the
    wall seconds of each; the ``masks`` stage holds the mask network's
    ``masks.frame`` units."""

    def __init__(self, cfg: Config, flags: PipelineFlags, device=None):
        from monosowa_tpu_torch.sowa import waymo2d

        self.cfg = cfg
        self.flags = flags
        self.device = device
        self.w2d = waymo2d
        paths = cfg.paths or Config({})
        self.waymo_path = paths.get("waymo_path", ".")
        self.cache = paths.get("merged_frames_path", "./cache")
        self.labels_path = paths.get("labels_path", "./labels")
        self.pcfg = pipeline_config_from(cfg)
        self.stage_seconds = collections.defaultdict(float)

    @contextlib.contextmanager
    def _stage(self, name: str):
        span = timing.span(f"waymo.{name}")
        try:
            with span:
                yield
        finally:
            self.stage_seconds[name] += span.seconds

    def segments(self) -> List[str]:
        return sorted(d for d in os.listdir(self.waymo_path)
                      if os.path.isdir(os.path.join(self.waymo_path, d)))

    def run(self, seq_start: Optional[int], seq_end: Optional[int]) -> int:
        segs = self.segments()[seq_start or 0:seq_end]
        n = 0
        for seg in segs:
            if self.flags.generate_homographies:
                n += self._homographies_segment(seg)
            elif self.flags.generate_raw_masks_or_tracking:
                n += self._tracking_segment(seg)
            elif self.flags.generate_transformations_only:
                n += self._transforms_segment(seg)
            elif (self.flags.do_optim
                  or self.flags.generate_merged_frames_only):
                n += self._optimize_segment(seg)
            else:
                raise NotImplementedError(
                    f"action {self.flags.action!r} for raw waymo segments")
        return n

    # -- segment data accessors -----------------------------------------
    def _seg_dir(self, seg):
        return os.path.join(self.waymo_path, seg)

    def _n_frames(self, seg) -> int:
        cam0 = os.path.join(self._seg_dir(seg), "camera_2")
        return len([f for f in os.listdir(cam0) if f.endswith(".png")])

    def _get_imgs(self, seg):
        """``get(i)`` -> frame i's 5 slot-ordered images (PIL reads the
        PNGs)."""
        from PIL import Image

        def get(i):
            out = []
            for slot in range(5):
                p = os.path.join(self._seg_dir(seg), f"camera_{slot}",
                                 f"{i:06d}.png")
                with Image.open(p) as im:
                    out.append(np.asarray(im))
            return out
        return get

    def _layout(self, seg):
        imgs = self._get_imgs(seg)(0)
        ist = self.cfg.image_stitching or Config({})
        return self.w2d.PairLayout(
            cam_h=imgs[2].shape[0], cam_w=imgs[2].shape[1],
            side_h=imgs[0].shape[0],
            height_pad=int(ist.get("height_pxl_pad", 100)),
            width_pad=int(ist.get("width_pxl_pad", 750)))

    def _lidar(self, seg, i) -> np.ndarray:
        p = os.path.join(self._seg_dir(seg), "lidar", f"{i:06d}.npz")
        with np.load(p) as z:
            return z["points"]

    def _poses(self, seg) -> np.ndarray:
        return np.load(os.path.join(self._seg_dir(seg), "poses.npy"))

    def _homos_path(self, seg):
        return os.path.join(self.cache, "homographies", f"{seg}.npz")

    def _tracked_path(self, seg):
        return os.path.join(self.cache, "detandtracked", f"{seg}.npz")

    # -- stages ----------------------------------------------------------
    def _homographies_segment(self, seg) -> int:
        """`--action homographies` (perform_img_stitching homography branch
        + find_the_best_homo, stitching.py:29-216)."""
        out = self._homos_path(seg)
        if os.path.exists(out):
            return 0
        layout = self._layout(seg)
        matcher = self._matcher()
        with self._stage("homographies"):
            homos = self.w2d.estimate_pair_homographies(
                self._get_imgs(seg), self._n_frames(seg), matcher, layout)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(
            out, homos=np.stack([h if h is not None else np.full((3, 3),
                                                                 np.nan)
                                 for h in homos]))
        return 1

    def _matcher(self):
        """The configured matcher (``backends.matcher``)."""
        return stitching_matcher_backend(self.cfg, self.device)

    def _load_homos(self, seg):
        with np.load(self._homos_path(seg)) as z:
            hs = z["homos"]
        return [None if np.isnan(h).any() else h for h in hs]

    def _pair_masks(self, seg, i, z, canvas) -> List[np.ndarray]:
        """Detection masks for one pair canvas: the masks_raw cache first,
        else the configured live mask backend (the canvas on the card)."""
        cached = masks_mod.load_masks(
            os.path.join(self.cache, "masks_raw", seg), f"{i:06d}_{z}")
        if cached is not None:
            return cached
        if not hasattr(self, "_mask_backend_cache"):
            from monosowa_tpu_torch.sowa import zoo
            self._mask_backend_cache = zoo.mask_backend(self.cfg,
                                                        device=self.device)
        backend = self._mask_backend_cache
        if backend is None:
            return []
        return backend.predict_masks(canvas)

    def _tracking_segment(self, seg) -> int:
        """`--action mask_tracking` (perform_stitching_and_trackingV2 +
        perform_tracking, main_class.py:60-66, tracker_ODTrack.py:60-155):
        the pair canvases stay on the card from the stitch to the mask
        network and the tracker."""
        from monosowa_tpu_torch.sowa import zoo

        out = self._tracked_path(seg)
        if os.path.exists(out):
            return 0
        layout = self._layout(seg)
        homos = self._load_homos(seg)
        get_imgs = self._get_imgs(seg)
        n = self._n_frames(seg)
        stitched, det_masks = [], []
        for i in range(n):
            with self._stage("read"):
                imgs = get_imgs(i)
            with self._stage("stitch"):
                canvases = self.w2d.stitch_frame(imgs, homos, layout,
                                                 device=self.device)
            stitched.append(canvases)
            with self._stage("masks"):
                det_masks.append([self._pair_masks(seg, i, z, canvases[z])
                                  for z in range(4)])
        with self._stage("track"):
            cars = self.w2d.track_pair_sequence(
                stitched, det_masks, homos, layout,
                tracker_factory=zoo.tracker_factory(self.cfg, self.device),
                device=self.device)
        with self._stage("write"):
            obs_arr = np.empty(len(cars), object)   # ragged-safe
            for ci, o in enumerate(cars):
                obs_arr[ci] = np.asarray(o, int)
            payload = {"cars": obs_arr}
            for i in range(n):
                for z in range(4):
                    ms = det_masks[i][z]
                    if ms:
                        stack = np.stack([np.asarray(m, bool) for m in ms])
                        payload[f"m_{i}_{z}"] = np.packbits(stack, axis=-1)
                        payload[f"s_{i}_{z}"] = np.asarray(stack.shape)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.savez_compressed(out, **payload)
        return 1

    def _load_tracked(self, seg, n_frames):
        with np.load(self._tracked_path(seg), allow_pickle=True) as z:
            cars = [[tuple(row) for row in obs] for obs in z["cars"]]
            det_masks = []
            for i in range(n_frames):
                frame = []
                for zi in range(4):
                    key = f"m_{i}_{zi}"
                    if key in z:
                        shape = z[f"s_{i}_{zi}"]
                        packed = z[key]
                        unpacked = np.unpackbits(
                            packed, axis=-1)[..., :shape[-1]]
                        frame.append(list(unpacked.astype(bool)))
                    else:
                        frame.append([])
                det_masks.append(frame)
        return cars, det_masks

    def _transforms_segment(self, seg) -> int:
        """`--action transformations`: vehicle poses -> camera-frame
        T_cur_to_ref windows (calculate_transformations_waymo)."""
        out_dir = os.path.join(self.cache, "transformations", seg)
        poses = self._poses(seg)
        rng = int((self.cfg.frames_creation or Config({}))
                  .get("nscans_transformation_range", 130))
        n = 0
        for i in range(len(poses)):
            fid = f"{i:06d}"
            out = transforms_mod.transforms_cache_path(out_dir, fid)
            if os.path.exists(out):
                continue
            lo, hi = max(0, i - rng), min(len(poses), i + rng + 1)
            t_cam = self.w2d.camera_transforms_from_vehicle(
                poses[lo:hi], i - lo)
            full = np.tile(np.eye(4), (2 * rng + 1, 1, 1))
            full[rng - (i - lo):rng + (hi - i)] = t_cam
            transforms_mod.save_window_transforms(out_dir, fid, full)
            n += 1
        return n

    def _optimize_segment(self, seg) -> int:
        """`--action optimization` through the 2D-tracked path
        (load_and_prepare_lidar_scan_from_multiple_waymo_tracker + the
        main_waymo per-frame fit loop): the fit on the card (K5)."""
        from monosowa_tpu_torch.kittiio.labels import write_pseudo_label_file
        from monosowa_tpu_torch.sowa import aggregation, lomm

        layout = self._layout(seg)
        homos = self._load_homos(seg)
        n_frames = self._n_frames(seg)
        with self._stage("read"):
            cars2d, det_masks = self._load_tracked(seg, n_frames)
            poses = self._poses(seg)
            lidars = [self._lidar(seg, i) for i in range(n_frames)]
        labeler = PseudoLabeler(self.pcfg, device=self.device)
        before, after = self.pcfg.nscans_before, self.pcfg.nscans_after
        n_done = 0
        for ref in range(n_frames):
            out = os.path.join(self.labels_path, seg, f"{ref:06d}.txt")
            if os.path.exists(out):
                continue
            lo, hi = max(0, ref - before), min(n_frames, ref + after + 1)
            window = list(range(lo - ref, hi - ref))
            t_cam = self.w2d.camera_transforms_from_vehicle(
                poses[lo:hi], ref - lo)
            with self._stage("gather"):
                tracks = self.w2d.tracks_from_2d(
                    cars2d, det_masks, lidars, homos, t_cam, ref, window,
                    layout, device=self.device)
            with self._stage("track_aggregate"):
                lomm.classify_all(tracks, method=self.pcfg.moving_method)
                kept, points, ref_masks = aggregation.aggregate_tracks(
                    tracks, t_cam, window, self.pcfg.keep_k_frames,
                    self.pcfg.min_standing_points)
            with self._stage("fit"):
                cars = labeler.label_from_cars(kept, points, ref_masks,
                                               window)
            with self._stage("write"):
                os.makedirs(os.path.dirname(out), exist_ok=True)
                write_pseudo_label_file(out, cars)
            n_done += 1
        return n_done


def stitching_matcher_backend(cfg: Config, device=None):
    """Matcher for the homographies: ORB on the host by default (OpenCV);
    ``backends.matcher: loftr`` + ``matcher_checkpoint`` runs the port's
    EfficientLoFTR on ``device`` (``zoo.matcher_backend``)."""
    from monosowa_tpu_torch.sowa import zoo
    return zoo.matcher_backend(cfg, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    cfg = load_config(args.config)
    flags = PipelineFlags(args.action)
    t0 = time.time()
    if args.dataset == "waymo":
        # raw waymo: the 2D-tracker stitching path over extracted segments
        driver = WaymoSegmentDriver(cfg, flags, device=args.device)
        n = driver.run(args.seq_start, args.seq_end)
    else:
        driver = KittiObjectDriver(cfg, flags, dataset=args.dataset,
                                   device=args.device)
        # KITTI-360 workers draw seed-360-shuffled disjoint random frames
        # (main_class.py:360, 636-646); the other datasets iterate in order
        n = driver.run(args.seq_start, args.seq_end,
                       shuffle=args.dataset in ("kitti360", "all"))
    print(f"[{args.action}] processed {n} frames in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
