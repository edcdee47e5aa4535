"""The pseudo-label pipeline per frame: candidates -> tracking ->
classification -> aggregation -> batched fitting on the device -> 3D NMS +
merge/re-fit -> writer.

Behavioral contract (pseudo_label_generator/3d/scripts/main_class.py:152-270,
``main_kitti`` optimization path): per reference frame, aggregate the
+-nscans window, fit every car with the TFL grid search, run 3D NMS with
IoU > 0.1 merging the loser's points into the winner and re-optimizing the
winner (:227-235), then write the KITTI label txt (output.py:12-91), with
skip-if-output-exists resumability (:180-184).

Counterpart of the JAX package's ``sowa/pipeline.py``.  Jobs that give
points (``get_points``) take the host-candidate path: candidate
extraction, tracking and aggregation run on the host in numpy
(``candidates``, ``lomm``, ``aggregation``); all cars of a frame, or of a
group of frames (``label_frames``), are fitted in one ``fit_cars_conv``
call on the labeller's device, the NMS of all frames is one batched call,
and the merge re-fit is a second, smaller fit.  Jobs that give depth maps
(``get_depth``) take the device extraction (``candidates_device``) and,
under the JAX package's condition, bank mode (``bank``): the points stay
on the card, the host tracks candidate centres only, and one device
function fits, suppresses and re-fits a whole group before one copy to the
host.  The optional stages of ``label_from_cars`` follow the JAX
package: the outlier ensemble (``filtering``), the robust optimisation
(``fitting.fit_cars_robust`` at the dimension estimator's yaw), and per
standing car the scale detector with the box reducer (``scale``) or the
dimension estimator (``dimensions``).  With ``extract_pedestrians`` a
job's person masks (``ped_masks``) add ``Pedestrian`` rows
(``pedestrians``); on real LiDAR (``use_pseudo_lidar=False``) the
reference frame's scan is handed to the aggregation for the strict
hidden-standing check (``strict_hidden_standing``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from monosowa_tpu_torch.device import resolve_device
from monosowa_tpu_torch.kittiio.labels import write_pseudo_label_file
from monosowa_tpu_torch.ops import box3d
from monosowa_tpu_torch.sowa import aggregation, candidates, lomm
from monosowa_tpu_torch.sowa import bank as bank_mod
from monosowa_tpu_torch.sowa import pedestrians as pedestrians_mod
from monosowa_tpu_torch.sowa.fitting import (FitConfig, fit_cars_conv,
                                             make_conv_kernels)
from monosowa_tpu_torch.sowa.templates import TemplateBank


@dataclasses.dataclass
class PipelineConfig:
    nscans_before: int = 30
    nscans_after: int = 30
    max_cars: int = 32
    max_points: int = 2048
    # batched-fit padding granularity of the JAX package (car batches padded
    # up to a multiple of this for its compile cache); kept so configs
    # compare, the port fits exactly the cars there are
    fit_bucket: int = 8
    min_standing_points: int = 1000
    keep_k_frames: int = 10
    nms_iou: float = 0.1
    dist_threshold_tracking: float = 10.0
    moving_method: str = "both5"
    fit: FitConfig = dataclasses.field(default_factory=FitConfig)
    candidate: candidates.CandidateConfig = dataclasses.field(
        default_factory=candidates.CandidateConfig)
    template_dims_lwh: tuple = (3.88, 1.63, 1.526)
    skip_non_visible: bool = True
    # real-LiDAR branch (frames_creation.use_pseudo_lidar: False): points
    # come from velodyne scans (kittiio.velodyne), the 75 m pseudo-lidar
    # gates are off, and hidden standing cars are filtered against the
    # live reference scan (aggregation.hidden_standing_keep_real; the
    # reference's shipped filter is a no-op; strict_hidden_standing=True
    # enables the evidently intended range check); the scale detector
    # re-gathers its points from the live window scans
    use_pseudo_lidar: bool = True
    strict_hidden_standing: bool = False
    # frames_creation.use_clever_aggregation: keep-k-closest frame
    # selection (True, shipped default) vs concat-every-observation
    use_clever_aggregation: bool = True
    # frames_creation.extract_pedestrians (output.py:141): person-class
    # masks -> Pedestrian label rows (sowa/pedestrians.py)
    extract_pedestrians: bool = False
    pedestrian: pedestrians_mod.PedestrianConfig = dataclasses.field(
        default_factory=pedestrians_mod.PedestrianConfig)
    # optional stages (reference flags in parentheses)
    use_ensemble_filter: bool = False   # frames_creation.use_hdbscan
    use_scale_detector: bool = False    # scale_detector.use_scale_detector
    use_bbox_reducer: bool = True       # scale_detector.use_bbox_reducer
    scale_bbox_scale: float = 1.5       # scale_detector.bbox_scale
    use_dimensions_estimation: bool = False
    # optimization.use_dimensions_estimation_during_optim
    # optimization.robust_optimization (config.yaml:68, default False):
    # dims-estimator yaw first, then translation-only grid
    # (optimize_car_robust / optimize_loc_only, optimizer.py:27-44,114-155)
    use_robust_optimization: bool = False
    # persist fitted cars for use_add_data detector training (the
    # reference's optimized_cars/ blobs, main_class.py:780-816)
    cars_cache_dir: Optional[str] = None
    # directory with the 4 car CAD meshes (fiat2/passat2/suv/minivan.gltf);
    # when set the template bank is built from them exactly like the
    # reference (loader.py:3465-3840) instead of the procedural profiles
    template_mesh_dir: Optional[str] = None
    # device-resident window aggregation (sowa/bank.py): when jobs supply
    # per-frame depth maps, keep every candidate's points ON THE DEVICE as
    # a compacted bank and fit straight from it; the host only tracks
    # candidate centres.  Slot geometry: n_slots observations x
    # (max_points // n_slots) evenly-subsampled points each.
    device_bank: bool = True
    bank_slots: int = 10
    # NMS-merge re-fit slots carried INSIDE the fused bank function (one
    # copy to the host for fit + NMS + re-fit); groups with more merge
    # targets than this fit the overflow in one more call
    bank_refit_cap: int = 8


# sentinel marking a frame whose device extraction is dispatched but not
# yet collected (see _label_frames_staged / label_frames_stream)
_EXT_PENDING = object()


class PseudoLabeler:
    """Holds the template bank and the conv kernels on its device; labels
    one reference frame at a time, or a group of frames, from per-frame
    point/mask/transform accessors.  ``device`` None means the card."""

    def __init__(self, cfg: PipelineConfig = PipelineConfig(),
                 bank: Optional[TemplateBank] = None, device=None):
        if cfg.candidate.use_pseudo_lidar != cfg.use_pseudo_lidar:
            cfg = dataclasses.replace(cfg, candidate=dataclasses.replace(
                cfg.candidate, use_pseudo_lidar=cfg.use_pseudo_lidar))
        self.cfg = cfg
        self.device = resolve_device(device)
        if bank is None:
            bank = (TemplateBank.from_gltf(cfg.template_mesh_dir)
                    if cfg.template_mesh_dir else TemplateBank.default())
        self.bank = bank
        self.template = torch.as_tensor(self.bank.points[0],
                                        device=self.device)
        self.conv_spec, self.occ_kernels, self.memb_kernels = \
            make_conv_kernels(self.bank.points[0], cfg.fit, self.device)
        # host-clock seconds of the last label_frames group, by stage
        self.stage_seconds: Dict[str, float] = {}
        # cross-group device-extraction cache (bank mode): fid -> bank
        # candidates, plus the arena holding their points; the stream
        # evicts finished fids, plain label_frames clears it per call
        self._ext_cache = None

    def evict_extractions(self, keep_fids=None) -> None:
        """Drop cached per-frame extractions and release their arena rows
        (a block frees once its whole chunk is dead).  keep_fids=None
        clears every entry but keeps the arena buffer."""
        if self._ext_cache is None:
            return
        cands = self._ext_cache["cands"]
        arena = self._ext_cache.get("arena")
        drop = (list(cands) if keep_fids is None
                else [f for f in cands if f not in keep_fids])
        for fid in drop:
            del cands[fid]
            if arena is not None:
                arena.release(fid)

    def _fit(self, batch):
        return fit_cars_conv(batch, self.template, self.occ_kernels,
                             self.memb_kernels, self.conv_spec, self.cfg.fit)

    # ------------------------------------------------------------------
    def label_frame(self, window_frames: Sequence[int], ref_offset_index: int,
                    get_points: Callable[[int], Optional[np.ndarray]],
                    get_masks: Callable[[int], Optional[list]],
                    transforms: np.ndarray, p2: np.ndarray,
                    img_hw, ped_masks: Optional[list] = None) -> List[dict]:
        """window_frames: window-relative offsets (0 = reference);
        get_points/get_masks take the window index; transforms: (W, 4, 4)
        T_cur_to_ref.  Returns car dicts ready for the label writer;
        ``ped_masks`` (person-class reference-frame masks) append
        Pedestrian rows when extract_pedestrians is on."""
        cfg = self.cfg
        # the real-LiDAR scale branch re-gathers from the live scans
        # (scale_detector.py:14-104): keep them only when that path is on
        keep_scans = self._keeps_scans()
        window_scans = [] if keep_scans else None
        cands = []
        for k in range(len(window_frames)):
            pts = get_points(k)
            masks = get_masks(k)
            if keep_scans:
                window_scans.append(pts)
            if pts is None or masks is None or len(masks) == 0:
                cands.append(None)
                continue
            cands.append(candidates.extract_candidates(
                pts, p2, img_hw, masks, transforms[k], cfg.candidate))
        kept, points, ref_masks = self._track_and_aggregate(
            cands, window_frames, transforms,
            self._ref_scan(window_frames, get_points))
        peds = self.pedestrian_labels(window_frames, get_points, p2, img_hw,
                                      ped_masks)
        if not kept:
            return peds
        return self.label_from_cars(
            kept, points, ref_masks, window_frames,
            scale_scan_source=((window_scans, transforms)
                               if keep_scans else None)) + peds

    def pedestrian_labels(self, window_frames, get_points, p2, img_hw,
                          ped_masks) -> List[dict]:
        """Pedestrian rows from the reference frame's points + person masks
        (extract_pedestrians branch, sowa/pedestrians.py)."""
        if not self.cfg.extract_pedestrians or not ped_masks:
            return []
        try:
            k = list(window_frames).index(0)
        except ValueError:
            return []
        pts = get_points(k)
        if pts is None:
            return []
        return pedestrians_mod.extract_pedestrian_labels(
            pts, p2, img_hw, ped_masks, self.cfg.pedestrian)

    def _ref_scan(self, window_frames, get_points):
        """The reference frame's cam-frame scan, only when the real-LiDAR
        strict hidden-standing check needs it (one more accessor call)."""
        if self.cfg.use_pseudo_lidar or not self.cfg.strict_hidden_standing:
            return None
        try:
            k = list(window_frames).index(0)
        except ValueError:
            return None
        return get_points(k)

    def _keeps_scans(self) -> bool:
        """Whether the scale detector re-gathers from the window's live
        scans (real LiDAR); pseudo-LiDAR short-circuits to the aggregated
        cloud (scale_detector.py:17-21)."""
        return self.cfg.use_scale_detector and not self.cfg.use_pseudo_lidar

    def _track_and_aggregate(self, cands, window_frames, transforms,
                             ref_scan=None):
        cfg = self.cfg
        tracks = lomm.greedy_track(cands, window_frames,
                                   cfg.dist_threshold_tracking)
        lomm.classify_all(tracks, method=cfg.moving_method)
        return aggregation.aggregate_tracks(
            tracks, transforms, window_frames, cfg.keep_k_frames,
            cfg.min_standing_points,
            use_pseudo_lidar=cfg.use_pseudo_lidar,
            max_distance=cfg.candidate.max_distance_pseudo_lidar,
            ref_scan=ref_scan, strict_hidden=cfg.strict_hidden_standing,
            clever=cfg.use_clever_aggregation)

    # ------------------------------------------------------------------
    def label_from_cars(self, kept, points, ref_masks,
                        window_frames, precomputed=None,
                        precomputed_nms=None,
                        precomputed_refit=None,
                        npts_override=None,
                        scale_scan_source=None) -> List[dict]:
        """Fit + NMS + assemble from aggregated per-car point clouds: the
        `optimization` stage when the `frames_aggregation` cache is already
        on disk (cache.load_merged_cars).

        ``precomputed``: optional (center (N,3), theta (N,)) from an
        external batched fit (label_frames): skips the per-frame fit.
        ``precomputed_nms``: optional (keep (max_cars,), merged (max_cars,))
        from a cross-frame batched NMS: skips the per-frame NMS.
        ``precomputed_refit``: optional {target_index: (center (3,), theta)}
        from a cross-frame batched merge re-fit: skips the per-frame re-fit
        (may be an empty dict).
        ``scale_scan_source``: optional (window scans, transforms) from
        which the scale detector re-gathers each standing car's points
        (real LiDAR).
        """
        cfg = self.cfg
        if not kept:
            return []
        if ref_masks is None:
            ref_masks = [aggregation.choose_ref_mask(t) for t in kept]

        if cfg.use_ensemble_filter:
            from monosowa_tpu_torch.sowa.filtering import \
                ensemble_inlier_mask_host
            points = [p[ensemble_inlier_mask_host(p, device=self.device)]
                      for p in points]

        # the padded batch is needed for a fit here or for the per-car
        # refinement below, not when the batched path fitted already
        n = min(len(kept), cfg.max_cars)
        need_batch = (precomputed is None or cfg.use_scale_detector
                      or cfg.use_dimensions_estimation)
        batch = (aggregation.build_car_batch(
            kept, points, window_frames, n, cfg.max_points)
            if need_batch else None)
        l, w, h = cfg.template_dims_lwh
        if precomputed is not None:
            center, theta = precomputed
            center = np.asarray(center)[:n].copy()
            theta = np.asarray(theta)[:n].copy()
        elif cfg.use_robust_optimization:
            center, theta = self._fit_robust(kept, batch, n)
        else:
            center, theta = _pull_fit(self._fit(batch))
            center, theta = center[:n], theta[:n]
        lwh = np.tile(np.array([l, w, h], np.float32), (n, 1))
        npts = (np.asarray(npts_override[:n], np.float32)
                if npts_override is not None else
                np.array([p.shape[0] for p in points[:n]], np.float32))

        # ---- 3D NMS + merge/re-fit (loader.py:2727-2800) --------------
        if precomputed_nms is not None:
            keep, merged = precomputed_nms
        else:
            mc = cfg.max_cars
            center_p = np.zeros((1, mc, 3), np.float32)
            center_p[0, :n] = center
            theta_p = np.zeros((1, mc), np.float32)
            theta_p[0, :n] = theta
            npts_p = np.zeros((1, mc), np.float32)
            npts_p[0, :n] = npts
            valid_p = np.zeros((1, mc), bool)
            valid_p[0, :n] = True
            keep, merged = self._nms(center_p, theta_p, npts_p, valid_p)
            keep, merged = keep[0], merged[0]
        keep = np.asarray(keep)[:n]
        merged = np.asarray(merged)[:n]

        if precomputed_refit is not None:
            for t, (c_t, th_t) in precomputed_refit.items():
                center[t] = c_t
                theta[t] = th_t
        else:
            targets = _refit_targets(keep, merged, n)
            if targets:
                sub_batch = aggregation.build_car_batch(
                    [kept[t] for t in targets],
                    [_merged_points(points, keep, merged, n, t)
                     for t in targets],
                    window_frames, max_cars=len(targets),
                    max_points=cfg.max_points)
                sub_center, sub_theta = _pull_fit(self._fit(sub_batch))
                for j, t in enumerate(targets):
                    center[t] = sub_center[j]
                    theta[t] = sub_theta[j]

        # ---- optional per-car refinement (scale detector / reducer /
        # dimension estimation: main_class.py dimensions_output path) ----
        per_car_lwh = lwh.copy()
        if cfg.use_scale_detector or cfg.use_dimensions_estimation:
            for i in range(n):
                if keep[i] and not kept[i].moving:
                    self._refine_car(i, batch, center, theta, per_car_lwh,
                                     scale_scan_source)

        # ---- assemble output cars -------------------------------------
        cars = []
        for i in range(n):
            if not keep[i]:
                continue
            mask = ref_masks[i]
            if mask is None and cfg.skip_non_visible:
                continue
            cars.append({
                "cls": "Car",
                "box2d": mask_bbox(mask) if mask is not None else None,
                "h": float(per_car_lwh[i, 2]), "w": float(per_car_lwh[i, 1]),
                "l": float(per_car_lwh[i, 0]),
                "x": float(center[i, 0]), "y": float(center[i, 1]),
                "z": float(center[i, 2]), "theta": float(theta[i]),
                "moving": bool(kept[i].moving),
                "num_points": int(npts[i]),
                # use_add_data payload (cars_cache_dir)
                "points": points[i] if points is not None else None,
                "mask": mask,
            })
        return cars

    def _fit_robust(self, kept, batch, n: int):
        """optimize_car_robust (optimizer.py:27-44): the dimension
        estimator's yaw of each standing car first, then a translation-only
        grid at it; NaN estimates keep the standard coarse + fine fit
        (``fitting.fit_cars_robust``).  Returns (center (n, 3), theta
        (n,)) as numpy."""
        from monosowa_tpu_torch.sowa import dimensions as dims_mod
        from monosowa_tpu_torch.sowa.fitting import fit_cars_robust

        th_rob = np.zeros(n, np.float32)
        rob_valid = np.zeros(n, bool)
        for i in range(n):
            if kept[i].moving:
                continue
            pts_i, mask_i = batch.points[i], batch.mask[i]
            c = np.median(pts_i[mask_i], axis=0) if mask_i.any() else \
                np.zeros(3)
            _, th = dims_mod.estimate_car_dimensions(
                (pts_i - c)[None], mask_i[None], c, device=self.device)
            if np.isfinite(th):
                th_rob[i] = th
                rob_valid[i] = True
        res = fit_cars_robust(batch, self.template, self.occ_kernels,
                              self.memb_kernels, self.conv_spec, self.cfg.fit,
                              th_rob, rob_valid)
        center, theta = _pull_fit(res)
        return center[:n], theta[:n]

    def _refine_car(self, i: int, batch, center, theta, per_car_lwh,
                    scale_scan_source) -> None:
        """Standing car i's size stages, in place on ``center`` and
        ``per_car_lwh``: the scale detector and the box reducer, or the
        dimension estimator."""
        from monosowa_tpu_torch.sowa import dimensions as dims_mod
        from monosowa_tpu_torch.sowa import scale as scale_mod

        cfg, dev = self.cfg, self.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        pts_i, mask_i = batch.points[i], batch.mask[i]
        if not cfg.use_scale_detector:
            d, _ = dims_mod.estimate_car_dimensions(
                (pts_i - center[i])[None], mask_i[None], center[i],
                device=dev)
            per_car_lwh[i] = d
            return
        # scale_lidar feeds ONLY optimize_scale (optimizer.py:186-188); the
        # bbox reducer always gathers from the AGGREGATED cloud
        # cars[i].lidar (bbox_reducer_tracked, scale_detector.py:161,204)
        scale_pts_i, scale_mask_i = pts_i, mask_i
        if scale_scan_source is not None:
            # real-LiDAR branch: re-gather the standing car's points from
            # the live window scans inside the bbox_scale-bloated fitted
            # box (extract_lidar_data_from_bbox_tracker,
            # scale_detector.py:14-104)
            scans, tmats = scale_scan_source
            sl = scale_mod.extract_scale_lidar_scans(
                center[i], per_car_lwh[i], theta[i], scans, tmats,
                bbox_scale=cfg.scale_bbox_scale, device=dev)
            if len(sl) == 0:
                # empty scale_lidar: the reference skips both the scale
                # optimizer and the reducer for this car (optimizer.py:47,
                # scale_detector.py:139): the grid-fit pose/dims stay
                return
            scale_pts_i = np.zeros((cfg.max_points, 3), np.float32)
            scale_mask_i = np.zeros(cfg.max_points, bool)
            if len(sl) > cfg.max_points:
                sl = sl[np.linspace(0, len(sl) - 1,
                                    cfg.max_points).astype(int)]
            scale_pts_i[:len(sl)] = sl
            scale_mask_i[:len(sl)] = True
        sres = scale_mod.optimize_scale(
            f32(scale_pts_i), torch.as_tensor(scale_mask_i, device=dev),
            f32(self.bank.points),
            f32([center[i, 0], center[i, 1], center[i, 2], theta[i]]))
        vals = torch.stack([sres.x, sres.y, sres.z, sres.length,
                            sres.width, sres.height]).cpu().numpy()
        center[i], per_car_lwh[i] = vals[:3], vals[3:]
        if cfg.use_bbox_reducer:
            c2, lwh2, _ = scale_mod.bbox_reduce(
                f32(pts_i), torch.as_tensor(mask_i, device=dev),
                f32(center[i]), f32(per_car_lwh[i]), f32(theta[i]))
            center[i] = c2.cpu().numpy()
            per_car_lwh[i] = lwh2.cpu().numpy()

    def _nms(self, center, theta, npts, valid):
        """Batched NMS of (F, max_cars) padded boxes with the template's
        dimensions, scored by point count; numpy in, numpy out."""
        dev = self.device
        lwh = torch.tensor(self.cfg.template_dims_lwh, dtype=torch.float32,
                           device=dev).expand(*center.shape[:2], 3)
        keep, merged = box3d.nms_3d(
            torch.as_tensor(center, device=dev), lwh,
            torch.as_tensor(theta, device=dev),
            torch.as_tensor(npts, device=dev),
            torch.as_tensor(valid, device=dev), self.cfg.nms_iou)
        packed = torch.stack([keep.long(), merged]).cpu().numpy()
        return packed[0].astype(bool), packed[1]

    # ------------------------------------------------------------------
    def _save_cars_cache(self, out_path: str, cars: List[dict]) -> None:
        if self.cfg.cars_cache_dir is None:
            return
        from monosowa_tpu_torch.sowa import cache
        frame = os.path.splitext(os.path.basename(out_path))[0]
        cache.save_optimized_cars(self.cfg.cars_cache_dir, frame, cars)

    def _write(self, out_path: str, cars: List[dict]) -> None:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_pseudo_label_file(out_path, cars)
        self._save_cars_cache(out_path, cars)

    # ------------------------------------------------------------------
    def label_and_write(self, out_path: str, *args, overwrite: bool = False,
                        **kwargs) -> Optional[List[dict]]:
        """Skip-if-exists wrapper (main_class.py:180-184)."""
        if os.path.exists(out_path) and not overwrite:
            return None
        cars = self.label_frame(*args, **kwargs)
        self._write(out_path, cars)
        return cars

    # ------------------------------------------------------------------
    def label_frames(self, frame_jobs: Sequence[dict],
                     overwrite: bool = False) -> int:
        """Whole-group batched labelling: aggregate all frames' cars, fit
        them in ONE call, then run NMS, re-fit and writing.  Each job dict
        needs the label_frame arguments plus ``out_path``; an optional
        ``frame_ids`` list (one global id per window index) lets
        overlapping windows SHARE each frame's camera-space candidate
        extraction instead of recomputing it per window; jobs that also
        give ``get_depth`` (one depth map a window index) extract on the
        device, in bank mode where the config allows it; ``ped_masks``
        (the reference frame's person masks) add Pedestrian rows with
        extract_pedestrians.

        Returns the number of frames written."""
        todo = [j for j in frame_jobs
                if overwrite or not os.path.exists(j["out_path"])]
        gen = self._label_frames_staged(todo)
        next(gen)
        try:
            return next(gen)
        finally:
            self.evict_extractions()

    def label_frames_stream(self, frame_jobs: Sequence[dict],
                            group_size: int = 8,
                            overwrite: bool = False) -> int:
        """Labelling of a long job list in groups of ``group_size`` frames,
        two deep: group k+1's extraction is dispatched before group k's
        results are collected, so the card extracts while the host tracks
        (bank mode), and overlapping windows of consecutive groups share
        cached extractions.  Output is identical to per-group
        :meth:`label_frames` calls; only the dispatch order changes."""
        todo = [j for j in frame_jobs
                if overwrite or not os.path.exists(j["out_path"])]
        groups = [todo[g0:g0 + group_size]
                  for g0 in range(0, len(todo), group_size)]
        # fids still needed AFTER group gi finishes (groups > gi + the one
        # already dispatched); everything else is evicted as we go
        needed_after = [set() for _ in groups]
        for gi in range(len(groups) - 2, -1, -1):
            needed_after[gi] = set(needed_after[gi + 1])
            for j in groups[gi + 1]:
                needed_after[gi].update(j.get("frame_ids", ()))
        n = 0
        prev = None
        try:
            for gi, group in enumerate(groups):
                cur = self._label_frames_staged(group)
                next(cur)                   # stage A: dispatch extraction
                if prev is not None:
                    n += next(prev)         # stages B + C of the previous
                    # keep = the dispatched group + everything later
                    self.evict_extractions(needed_after[gi - 1])
                prev = cur
            if prev is not None:
                n += next(prev)
        finally:
            self.evict_extractions()
        return n

    def _use_bank(self, todo) -> bool:
        """The JAX package's condition for bank mode."""
        cfg = self.cfg
        return (cfg.device_bank and cfg.use_pseudo_lidar
                and cfg.use_clever_aggregation
                and all("get_depth" in j for j in todo)
                and cfg.cars_cache_dir is None
                and not cfg.use_ensemble_filter
                and not cfg.use_scale_detector
                and not cfg.use_dimensions_estimation)

    def _label_frames_staged(self, todo: Sequence[dict]):
        """Generator body of label_frames: yields once after stage A (host
        extraction, or the device extraction's dispatch), then runs
        collect/track/fit/write and yields the number of frames written.
        Worker threads run numpy and scipy only; every torch call is made
        from the calling thread.  Stage A of bank mode only enqueues work
        on the card: nothing in it waits for the device."""
        cfg = self.cfg
        stages = self.stage_seconds = {}
        clock = time.perf_counter
        t0 = clock()
        # stage A: camera-frame candidates, once per DISTINCT frame
        cam_cache = {}
        use_bank = False
        ext = ext_state = None
        new_fids = []
        arena_rows = {}     # chunk bank id -> its arena row0
        have_ids = bool(todo) and all("frame_ids" in j for j in todo)
        if have_ids:
            tasks = {}
            for j in todo:
                for k, fid in enumerate(j["frame_ids"]):
                    tasks.setdefault(fid, (j, k))
            fids = list(tasks)
            use_bank = self._use_bank(todo)
            if all("get_depth" in j for j in todo):
                from monosowa_tpu_torch.sowa.candidates_device import \
                    DeviceExtractor
                j0 = todo[0]
                p2 = np.asarray(j0["p2"], np.float32)
                ext = DeviceExtractor(p2, tuple(j0["img_hw"]), cfg.candidate,
                                      max_masks=cfg.max_cars,
                                      device=self.device)
                if use_bank:
                    # overlapping windows of CONSECUTIVE stream groups
                    # share most frames: only fids never extracted (under
                    # this calibration) are dispatched
                    sig = (p2.tobytes(), tuple(j0["img_hw"]),
                           cfg.max_points)
                    if not (self._ext_cache
                            and self._ext_cache["sig"] == sig):
                        self._ext_cache = {"sig": sig, "cands": {}}
                    cached = self._ext_cache["cands"]
                    new_fids = [f for f in fids if f not in cached]
                    # mark in-flight fids so the NEXT group's stage A (which
                    # runs before this group's collect in the stream) does
                    # not dispatch them again; this group's stage B runs
                    # first and replaces the sentinel
                    for f in new_fids:
                        cached[f] = _EXT_PENDING
                else:
                    new_fids = list(fids)
                depths, masks_pf = [], []
                for fid in new_fids:
                    j, k = tasks[fid]
                    depths.append(j["get_depth"](k))
                    mk = j["get_masks"](k)
                    masks_pf.append(list(mk) if mk else [])
                if use_bank:
                    ext_state = ext.extract_frames_banked_begin(
                        depths, masks_pf, cap=cfg.max_points)
                    # copy each chunk into the persistent arena now (still
                    # stage A): BankRef rows become global arena rows
                    pending = ext_state[1]
                    if pending is not None:
                        arena = self._ext_cache.get("arena")
                        if arena is None:
                            nb = 2 * (-(-len(fids) // ext.frame_bucket)) + 4
                            arena = bank_mod.BankArena(
                                ext.frame_bucket, ext.max_masks,
                                cfg.max_points, nb, device=self.device)
                            self._ext_cache["arena"] = arena
                        arena_rows = {
                            id(bank_dev): arena.write(
                                bank_dev, [new_fids[fi] for fi in chunk])
                            for (chunk, _m, bank_dev) in pending}
                else:
                    for fid, c in zip(new_fids,
                                      ext.extract_frames(depths, masks_pf)):
                        cam_cache[fid] = c
            else:
                use_bank = False

                def extract_one(fid):
                    j, k = tasks[fid]
                    pts = j["get_points"](k)
                    masks_k = j["get_masks"](k)
                    if pts is None or masks_k is None or len(masks_k) == 0:
                        return fid, None
                    return fid, candidates.extract_candidates_cam(
                        pts, j["p2"], j["img_hw"], masks_k, cfg.candidate)

                cam_cache = dict(_map_threads(extract_one, fids))
        stages["extract"] = clock() - t0

        yield None          # --- stage boundary: extraction dispatched ---

        bank = None
        if ext_state is not None:
            t0 = clock()
            BankRef = bank_mod.BankRef
            new_res, _ = ext.extract_frames_banked_finish_chunks(ext_state)
            cached = self._ext_cache["cands"]
            # cached entries carry FINAL BankRefs: rows are global arena
            # rows (chunk row0 from stage A's arena.write + in-chunk k),
            # valid for the frame's whole cache lifetime
            for fid, c in zip(new_fids, new_res):
                if c is not None:
                    c = {"locations": c["locations"], "masks": c["masks"],
                         "points": [BankRef(row=arena_rows[id(bdev)] + k,
                                            mi=mi, count=cnt, trunc=tr)
                                    for (bdev, k, mi, cnt, tr)
                                    in c["chunk_refs"]]}
                cached[fid] = c
            arena = self._ext_cache.get("arena")
            bank = arena.buf if arena is not None else None
            for fid in fids:
                c = cached.get(fid)
                assert c is not _EXT_PENDING, fid
                cam_cache[fid] = c
            use_bank = bank is not None
            stages["meta_pull"] = clock() - t0
        stages["bank_path"] = float(use_bank)

        quota = cfg.max_points // cfg.bank_slots
        # the real-LiDAR scale detector re-gathers from the live window
        # scans (scale_detector.py:14-104): kept per prepared item so this
        # batched entry point matches label_frame
        keep_scans = self._keeps_scans()

        def prep(job):
            window_frames = job["window_frames"]
            window_scans = ([job["get_points"](k)
                             for k in range(len(window_frames))]
                            if keep_scans else None)
            cands = []
            for k in range(len(window_frames)):
                if have_ids:
                    cand_cam = cam_cache[job["frame_ids"][k]]
                    if use_bank:
                        cands.append(bank_mod.transform_candidates_bank(
                            cand_cam, job["transforms"][k],
                            cfg.candidate.moving_detection_threshold))
                    else:
                        cands.append(None if cand_cam is None else
                                     candidates.transform_candidates(
                                         cand_cam, job["transforms"][k],
                                         cfg.candidate))
                    continue
                pts = job["get_points"](k)
                masks_k = job["get_masks"](k)
                if pts is None or masks_k is None or len(masks_k) == 0:
                    cands.append(None)
                    continue
                cands.append(candidates.extract_candidates(
                    pts, job["p2"], job["img_hw"], masks_k,
                    job["transforms"][k], cfg.candidate))
            if use_bank:
                tracks = lomm.greedy_track(cands, window_frames,
                                           cfg.dist_threshold_tracking)
                lomm.classify_all(tracks, method=cfg.moving_method)
                kept, ref_masks, slots = bank_mod.select_car_slots(
                    tracks, job["transforms"], window_frames,
                    cfg.keep_k_frames, cfg.min_standing_points,
                    cfg.bank_slots, quota,
                    use_pseudo_lidar=cfg.use_pseudo_lidar,
                    max_distance=cfg.candidate.max_distance_pseudo_lidar)
                return dict(job=job, kept=kept, points=None,
                            ref_masks=ref_masks, window=window_frames,
                            slots=slots, scans=window_scans,
                            npts=[s.npts for s in slots])
            kept, points, ref_masks = self._track_and_aggregate(
                cands, window_frames, job["transforms"],
                self._ref_scan(window_frames, job["get_points"]))
            return dict(job=job, kept=kept, points=points,
                        ref_masks=ref_masks, window=window_frames,
                        slots=None, scans=window_scans,
                        npts=[p.shape[0] for p in points])

        # host prep (tracking / aggregation or slot selection: numpy +
        # scipy) in threads across frames, ahead of the one big device fit
        t0 = clock()
        prepared = _map_threads(prep, todo)
        stages["track_aggregate"] = clock() - t0

        # one cross-frame batched fit for every prepared car
        all_tracks, all_points, all_slots, all_windows, owners = \
            [], [], [], [], []
        for fi, item in enumerate(prepared):
            n_i = min(len(item["kept"]), cfg.max_cars)
            all_tracks.extend(item["kept"][:n_i])
            if use_bank:
                all_slots.extend(item["slots"][:n_i])
            else:
                all_points.extend(item["points"][:n_i])
            # each track's frame offsets are relative to its OWN frame's
            # window: edge frames have truncated/shifted windows, so the
            # moving-car trajectory theta must index with the right base
            all_windows.extend([item["window"]] * n_i)
            owners.extend([fi] * n_i)
        owners = np.asarray(owners, np.int64)
        nms_by_frame = {}
        refit_by_frame = {fi: {} for fi in range(len(prepared))}
        bank_refits = {}
        bank_targets = 0
        if all_tracks and use_bank:
            # fit + NMS + the first bank_refit_cap merge re-fits on the
            # card, one copy to the host
            t0 = clock()
            (centers, thetas, nms_by_frame, bank_targets,
             bank_refits) = bank_mod.fit_and_nms_slots(
                bank, all_slots, all_tracks, all_windows, owners,
                len(prepared), cfg.max_cars,
                np.asarray(cfg.template_dims_lwh, np.float32), cfg.nms_iou,
                self.template, self.occ_kernels, self.memb_kernels,
                self.conv_spec, cfg.fit, quota,
                refit_cap=cfg.bank_refit_cap)
            stages["fused_fit"] = clock() - t0
            # the re-fits' batch order is frame-major = the group order
            frame_first = {}
            for b_idx, fi in enumerate(owners):
                frame_first.setdefault(int(fi), b_idx)
            for b_idx, val in bank_refits.items():
                fi = int(owners[b_idx])
                refit_by_frame[fi][b_idx - frame_first[fi]] = val
        elif all_tracks:
            t0 = clock()
            big = aggregation.build_car_batch(
                all_tracks, all_points, prepared[0]["window"],
                max_cars=len(all_tracks), max_points=cfg.max_points,
                per_track_windows=all_windows)
            centers, thetas = _pull_fit(self._fit(big))
            stages["fit"] = clock() - t0
            t0 = clock()

            # one batched NMS over all frames
            mc = cfg.max_cars
            f_n = len(prepared)
            c_f = np.zeros((f_n, mc, 3), np.float32)
            t_f = np.zeros((f_n, mc), np.float32)
            np_f = np.zeros((f_n, mc), np.float32)
            v_f = np.zeros((f_n, mc), bool)
            for fi, item in enumerate(prepared):
                sel = np.where(owners == fi)[0]
                n_i = len(sel)
                c_f[fi, :n_i] = centers[sel]
                t_f[fi, :n_i] = thetas[sel]
                np_f[fi, :n_i] = item["npts"][:n_i]
                v_f[fi, :n_i] = True
            keep_f, merged_f = self._nms(c_f, t_f, np_f, v_f)
            for fi in range(f_n):
                nms_by_frame[fi] = (keep_f[fi], merged_f[fi])
            stages["nms"] = clock() - t0

        # cross-frame batched merge re-fit: every frame's merge targets in
        # ONE fit.  Bank mode re-fit the first bank_refit_cap targets in
        # its fused call; only the overflow is fitted here.
        need_refit = ((not use_bank) or cfg.bank_refit_cap == 0
                      or bank_targets > cfg.bank_refit_cap)
        if all_tracks and need_refit:
            t0 = clock()
            groups = []   # (fi, t, merged points | slots, track, window)
            for fi, item in enumerate(prepared):
                keep_i, merged_i = nms_by_frame[fi]
                n_i = min(len(item["kept"]), cfg.max_cars)
                for t in _refit_targets(keep_i, merged_i, n_i):
                    if use_bank:
                        payload = item["slots"][t]
                        for i in range(n_i):
                            if not keep_i[i] and merged_i[i] == t:
                                payload = bank_mod.merge_slots(
                                    payload, item["slots"][i])
                    else:
                        payload = _merged_points(item["points"], keep_i,
                                                 merged_i, n_i, t)
                    groups.append((fi, t, payload, item["kept"][t],
                                   item["window"]))
            if use_bank:
                # the fused call covered the first bank_refit_cap targets
                # in this exact order
                groups = groups[cfg.bank_refit_cap:]
            if groups:
                if use_bank:
                    rres = bank_mod.fit_slots(
                        bank, [g[2] for g in groups], [g[3] for g in groups],
                        [g[4] for g in groups], self.template,
                        self.occ_kernels, self.memb_kernels, self.conv_spec,
                        cfg.fit, quota)
                else:
                    rres = self._fit(aggregation.build_car_batch(
                        [g[3] for g in groups], [g[2] for g in groups],
                        prepared[0]["window"], max_cars=len(groups),
                        max_points=cfg.max_points,
                        per_track_windows=[g[4] for g in groups]))
                rcenters, rthetas = _pull_fit(rres)
                for gi, (fi, t, _, _, _) in enumerate(groups):
                    refit_by_frame[fi][t] = (rcenters[gi],
                                             float(rthetas[gi]))
            stages["refit"] = clock() - t0

        t0 = clock()
        n_written = 0
        for fi, item in enumerate(prepared):
            sel = np.where(owners == fi)[0]
            pre = ((centers[sel], thetas[sel]) if len(sel) else
                   (np.zeros((0, 3)), np.zeros(0)))
            cars = self.label_from_cars(
                item["kept"], item["points"],
                item["ref_masks"], item["window"],
                precomputed=pre,
                precomputed_nms=nms_by_frame.get(fi),
                precomputed_refit=refit_by_frame[fi],
                npts_override=item["npts"],
                scale_scan_source=((item["scans"], item["job"]["transforms"])
                                   if item["scans"] is not None else None))
            job = item["job"]
            cars = cars + self.pedestrian_labels(
                item["window"], job["get_points"], job["p2"],
                job["img_hw"], job.get("ped_masks"))
            self._write(job["out_path"], cars)
            n_written += 1
        stages["write"] = clock() - t0
        stages["cars_fitted"] = len(all_tracks)
        yield n_written


def _map_threads(fn, items) -> list:
    """[fn(x) for x in items], in up to 8 threads when there is more than
    one item (the work is numpy and scipy, which release the GIL)."""
    if len(items) > 1:
        with ThreadPoolExecutor(max_workers=min(8, len(items))) as pool:
            return list(pool.map(fn, items))
    return [fn(x) for x in items]


def _pull_fit(res):
    """(center (B, 3), theta (B,)) of a BatchFitResult as numpy, in one
    copy from the device."""
    packed = torch.stack([res.x, res.y, res.z, res.theta]).cpu().numpy()
    return packed[:3].T.copy(), packed[3].copy()


def _refit_targets(keep, merged, n: int) -> List[int]:
    """The surviving boxes that suppressed another one."""
    return sorted({int(merged[i]) for i in range(n)
                   if not keep[i] and keep[merged[i]]})


def _merged_points(points, keep, merged, n: int, t: int) -> np.ndarray:
    """Target t's points plus those of the boxes merged into it, capped."""
    parts = [points[t]] + [points[i] for i in range(n)
                           if not keep[i] and merged[i] == t]
    return aggregation.cap_points(np.concatenate(parts, 0))


def mask_bbox(mask: np.ndarray) -> np.ndarray:
    """2D bbox [x1, y1, x2, y2] of a boolean mask (output.py:201-212)."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)
