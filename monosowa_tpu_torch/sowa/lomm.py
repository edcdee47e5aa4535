"""Local Object Motion Model: frame-to-frame 3D tracking of candidate
centroids and the moving/standing statistical classifier.

Behavioral contract (pseudo_label_generator/3d/scripts/loader.py):

* ``greedy_track`` = perform_3D_tracking_kitti (2118-2245): greedy
  frame-to-frame association across the aggregation window; predicted
  location = last location + mean of up to 4 most recent deltas
  (1994-2018-style velocity estimate); a match requires mutual-nearest and
  distance < dist_treshold_tracking (10 m); unmatched detections start new
  tracks; tracks are never terminated.
* ``classify_moving`` = decide_if_standing_or_moving_both5 (2516-2579,
  KITTI default) and _both (2283-2351, KITTI-360): per-axis std of
  consecutive-location deltas / sqrt(2) as the noise estimate; a car moves
  iff the z-score exceeds the threshold AND net displacement >
  dist_treshold_moving (5 m).

This stage is tiny, sequential, and data-dependent (tens of candidates over
~61 frames): it runs on the host in numpy and feeds padded arrays to the
fitting kernels.  Copy of the JAX package's ``sowa/lomm.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
from scipy import stats as scipy_stats


@dataclasses.dataclass
class Track:
    """One tracked object across the aggregation window.

    Parallel per-observation lists; ``frames`` holds the window-relative
    frame offset of each observation (0 = reference frame).
    """

    frames: List[int]
    locations: List[np.ndarray]          # (3,) centroids in ref-frame coords
    points: List[Optional[np.ndarray]]   # (N_i, 3) per-frame points, ref frame
    masks: List[Optional[object]]        # per-frame mask payloads
    moving: bool = False

    def location_array(self, window: Sequence[int]):
        """Dense (W, 3) locations + (W,) valid over the given frame window."""
        w = len(window)
        locs = np.zeros((w, 3), np.float32)
        valid = np.zeros(w, bool)
        base = window[0]
        for f, loc in zip(self.frames, self.locations):
            locs[f - base] = loc[:3]
            valid[f - base] = True
        return locs, valid


def _predict_location(track: Track) -> np.ndarray:
    """Velocity-extrapolated next location: mean of up to 4 recent deltas
    added to the last location (loader.py:2161-2183).

    The consecutive deltas telescope, so the mean is
    (locs[-1] - locs[-1-K]) / K with K = min(4, n-1) — O(1) per track
    (this runs per candidate-frame inside the tracker's hot loop)."""
    locs = track.locations
    n = len(locs)
    if n == 1:
        return np.asarray(locs[0][:3], np.float64)
    k = min(4, n - 1)
    last = np.asarray(locs[-1][:3], np.float64)
    return last + (last - np.asarray(locs[-1 - k][:3], np.float64)) / k


def greedy_track(candidates: Sequence[Optional[dict]],
                 window: Sequence[int],
                 dist_threshold: float = 10.0) -> List[Track]:
    """Associate per-frame candidates into tracks.

    candidates[k] describes frame window[k]: dict with keys ``locations``
    ((K, 3) array), ``points`` (list of (N, 3)), ``masks`` (list) — or None.
    """
    tracks: List[Track] = []
    first = candidates[0]
    if first is not None and len(first["locations"]) > 0:
        for z in range(len(first["locations"])):
            tracks.append(Track(frames=[window[0]],
                                locations=[np.asarray(first["locations"][z])],
                                points=[first["points"][z]],
                                masks=[first["masks"][z]]))

    for k in range(1, len(window)):
        cur = candidates[k]
        if cur is None or len(cur["locations"]) == 0:
            continue
        cur_locs = np.asarray(cur["locations"], np.float64)
        new_tracks: List[Track] = []
        if tracks:
            preds = np.stack([_predict_location(t) for t in tracks])
            dists = np.linalg.norm(cur_locs[:, None, :] - preds[None, :, :],
                                   axis=-1)
            min_cur_to_trk = np.argmin(dists, axis=1)
            min_trk_to_cur = np.argmin(dists, axis=0)
            for z in range(len(cur_locs)):
                t = min_cur_to_trk[z]
                if min_trk_to_cur[t] == z and dists[z, t] < dist_threshold:
                    tracks[t].frames.append(window[k])
                    tracks[t].locations.append(cur_locs[z])
                    tracks[t].points.append(cur["points"][z])
                    tracks[t].masks.append(cur["masks"][z])
                else:
                    new_tracks.append(Track(frames=[window[k]],
                                            locations=[cur_locs[z]],
                                            points=[cur["points"][z]],
                                            masks=[cur["masks"][z]]))
        else:
            for z in range(len(cur_locs)):
                new_tracks.append(Track(frames=[window[k]],
                                        locations=[cur_locs[z]],
                                        points=[cur["points"][z]],
                                        masks=[cur["masks"][z]]))
        tracks.extend(new_tracks)
    return tracks


def _consecutive_deltas(frames: Sequence[int],
                        locations: Sequence[np.ndarray],
                        reset_on_gap: bool = False) -> np.ndarray:
    """Deltas between consecutive observations.

    The reference's KITTI tracks hold only actual observations, so deltas
    span frame gaps (loader.py:2518-2529 iterates the observation list);
    ``reset_on_gap`` reproduces the Waymo dense-list-with-None behavior
    where a hole resets the chain."""
    diffs = []
    for i in range(1, len(frames)):
        if reset_on_gap and frames[i] != frames[i - 1] + 1:
            continue
        diffs.append(np.asarray(locations[i][:3])
                     - np.asarray(locations[i - 1][:3]))
    if not diffs:
        return np.zeros((0, 3))
    return np.stack(diffs)


def classify_moving(track: Track, method: str = "both5",
                    dist_threshold_moving: float = 5.0,
                    z_threshold: float = 0.2,
                    alpha: float = 1e-3,
                    dist_moving: float = 15.0,
                    speed_moving: float = 0.75,
                    ratio_moving: float = 1.0,
                    spread_radius: float = 5.0,
                    spread_fraction: float = 0.95) -> bool:
    """Moving/standing decision; mutates track.moving and returns it.

    The reference ships 7 variants (loader.py:2247-2641); the KITTI config
    calls _both5 (:164) and KITTI-360 _both (:244).  All are available:

    * "simple" = decide_if_standing_or_moving (:2247): start-to-end xz
      distance > dist_threshold_moving.
    * "both"   (:2283): p-value of net displacement under a random-walk
      noise model (sigma_net * sqrt(N)) < alpha AND net > threshold.
    * "both2"  (:2353): xz-plane ratio test; defaults to MOVING on short
      tracks; moving iff xz net > dist_moving OR mean-delta speed >
      speed_moving OR speed/sigma >= ratio_moving.
    * "bothv3" (:2413): LiDAR-spread test — moving iff < spread_fraction
      of the track's concatenated points lie within spread_radius of
      their centroid (needs host point arrays; unavailable in bank mode).
    * "both4"  (:2451): z = net / (sigma_net * sqrt(N)) > 1 AND net >
      threshold.
    * "both5"  (:2516): z = |mean delta| / sigma_net > 0.2 AND net >
      threshold (the shipped KITTI default).
    * "both6"  (:2581): |mean delta| - sigma_net > 2 AND net > threshold.
    """
    if method == "simple":
        s = np.asarray(track.locations[0][:3], np.float64)
        e = np.asarray(track.locations[-1][:3], np.float64)
        track.moving = bool(np.hypot(e[0] - s[0], e[2] - s[2])
                            > dist_threshold_moving)
        return track.moving
    if method == "bothv3":
        pts = [p for p in track.points
               if isinstance(p, np.ndarray) and p.ndim == 2]
        if not pts:
            raise ValueError("bothv3 needs per-observation point arrays "
                             "(unavailable in device-bank mode)")
        cat = np.concatenate(pts, axis=0)
        d = np.linalg.norm(cat - cat.mean(axis=0), axis=1)
        track.moving = bool((d < spread_radius).sum()
                            < spread_fraction * cat.shape[0])
        return track.moving

    diffs = _consecutive_deltas(track.frames, track.locations)
    if len(diffs) <= 1:
        # both2 assumes MOVING by default on short tracks (:2364)
        track.moving = method == "both2"
        return track.moving
    sigma = np.std(diffs, axis=0) / np.sqrt(2.0)
    sigma_net = np.linalg.norm(sigma)
    net = np.linalg.norm(np.asarray(track.locations[-1][:3])
                         - np.asarray(track.locations[0][:3]))
    if method == "both2":
        mean_xz = np.mean(diffs, axis=0)
        speed = np.hypot(mean_xz[0], mean_xz[2])
        sig_xz = np.hypot(sigma[0], sigma[2])
        whole = np.asarray(track.locations[-1][:3], np.float64) \
            - np.asarray(track.locations[0][:3], np.float64)
        whole_dist = np.hypot(whole[0], whole[2])
        track.moving = bool(
            whole_dist > dist_moving or speed > speed_moving
            or (sig_xz > 1e-12 and speed / sig_xz >= ratio_moving)
            or (sig_xz <= 1e-12 and speed > 0))
        return track.moving
    if sigma_net < 1e-12:
        # perfectly consistent motion: moving iff it actually went somewhere
        track.moving = bool(net > dist_threshold_moving)
        return track.moving

    if method == "both5":
        z = np.linalg.norm(np.mean(diffs, axis=0)) / sigma_net
        track.moving = bool(z > z_threshold and net > dist_threshold_moving)
    elif method == "both6":
        z = np.linalg.norm(np.mean(diffs, axis=0)) - sigma_net
        track.moving = bool(z > 2.0 and net > dist_threshold_moving)
    elif method == "both4":
        z = net / (sigma_net * np.sqrt(len(diffs)))
        track.moving = bool(z > 1.0 and net > dist_threshold_moving)
    elif method == "both":
        std_net = sigma_net * np.sqrt(len(diffs))
        z = net / std_net
        p = 1.0 - scipy_stats.norm.cdf(z)
        track.moving = bool(p < alpha and net > dist_threshold_moving)
    else:
        raise ValueError(f"unknown moving classifier {method!r}")
    return track.moving


def classify_all(tracks: Sequence[Track], method: str = "both5",
                 **kw) -> None:
    for t in tracks:
        classify_moving(t, method=method, **kw)
