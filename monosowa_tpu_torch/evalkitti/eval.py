"""KITTI AP / AP_R40 evaluation.

Behavioral contract (MonoDETR/lib/datasets/kitti/kitti_eval_python/eval.py —
the standard KITTI python evaluator the reference trains/reports against):

* ``get_thresholds`` (:10-27): 41 recall-sampled score thresholds;
* ``clean_data`` (:30-83): class/difficulty validity (MIN_HEIGHT 40/25/25,
  MAX_OCCLUSION 0/1/2, MAX_TRUNCATION .15/.3/.5, neighbor-class ignores,
  DontCare boxes);
* ``compute_statistics`` (:234-350): per-image greedy TP/FP/FN assignment
  with ignored-det / DontCare handling and AOS similarity;
* ``eval_class`` (:524-...): threshold collection pass, precision-recall
  accumulation, precision envelope; AP = 11-point (indices 0::4) and
  AP_R40 = 40-point (indices 1:) averages.

Rotated BEV / 3D overlaps and the per-image statistics go through the
native library (``evalkitti/native.py``, host C++ built at first use),
which replaces the numba rotate_iou and statistics kernels.  ``use_native=
False`` takes the python route instead: the polygon clipping of
``ops/box3d.py`` on CPU tensors and ``compute_statistics`` below.  That
route is the tests' oracle and is reached in no other way; a native library
that fails to build raises.  A numpy copy of the JAX package's
``evalkitti/eval.py``, whose one use of JAX (``_jax_bev_inter``) is
``_torch_bev_inter`` here.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting",
               "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
NO_DETECTION = -10000000


def _thread_map(fn, n_items: int, min_items: int = 16):
    """Map ``fn`` over range(n_items), threading when it can pay off.

    The native kernels release the GIL for the duration of each ctypes
    call, so per-image statistics parallelize across host cores (the
    reference reaches the same goal with numba ``parallel=True`` loops,
    eval.py:415-455).  Results come back in index order — accumulation
    stays deterministic.  Single-core hosts (and tiny inputs) take the
    plain loop."""
    workers = min(8, os.cpu_count() or 1)
    if workers <= 1 or n_items < min_items:
        return [fn(k) for k in range(n_items)]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, range(n_items)))


# ---------------------------------------------------------------------------
# annotation loading
# ---------------------------------------------------------------------------

def anno_from_label_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI label txt -> annotation dict (kitti_common.py get_label_anno
    layout: dimensions reordered to (l, h, w))."""
    name, truncated, occluded, alpha, bbox = [], [], [], [], []
    dims, loc, rot, score = [], [], [], []
    if os.path.exists(path):
        with open(path) as f:
            lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    else:
        lines = []
    for x in lines:
        name.append(x[0])
        truncated.append(float(x[1]))
        occluded.append(float(x[2]))
        alpha.append(float(x[3]))
        bbox.append([float(v) for v in x[4:8]])
        h, w, l = float(x[8]), float(x[9]), float(x[10])
        dims.append([l, h, w])
        loc.append([float(v) for v in x[11:14]])
        rot.append(float(x[14]))
        score.append(float(x[15]) if len(x) == 16 else 0.0)
    n = len(name)
    return {
        "name": np.array(name),
        "truncated": np.array(truncated, np.float64).reshape(n),
        "occluded": np.array(occluded, np.float64).reshape(n),
        "alpha": np.array(alpha, np.float64).reshape(n),
        "bbox": np.array(bbox, np.float64).reshape(n, 4),
        "dimensions": np.array(dims, np.float64).reshape(n, 3),
        "location": np.array(loc, np.float64).reshape(n, 3),
        "rotation_y": np.array(rot, np.float64).reshape(n),
        "score": np.array(score, np.float64).reshape(n),
    }


def annos_from_label_dir(label_dir: str, ids: Sequence[str]
                         ) -> List[Dict[str, np.ndarray]]:
    return [anno_from_label_file(os.path.join(label_dir, f"{i}.txt"))
            for i in ids]


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------

def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """2D axis-aligned overlap (eval.py image_box_overlap), vectorized."""
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        denom = area_b + area_q - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_b, inter.shape)
    else:
        denom = np.broadcast_to(area_q, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _torch_bev_inter(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """Raw rotated BEV intersection areas by ``ops/box3d.py``'s polygon
    clipping, in float32 on CPU tensors (host code).

    boxes: (N, 5) [x, z, l, w, ry]."""
    import torch

    from monosowa_tpu_torch.ops.box3d import _pairwise_inter, bev_corners

    if boxes.shape[0] == 0 or qboxes.shape[0] == 0:
        return np.zeros((boxes.shape[0], qboxes.shape[0]))

    def corners(b):
        t = torch.as_tensor(np.asarray(b), dtype=torch.float32)
        return bev_corners(t[:, :2], t[:, 2:4], t[:, 4])

    return _pairwise_inter(corners(boxes), corners(qboxes)).numpy().astype(
        np.float64)


def bev_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """(N, 5) x (K, 5) rotated BEV overlap."""
    inter = _torch_bev_inter(boxes, qboxes)
    area_a = (boxes[:, 2] * boxes[:, 3])[:, None]
    area_b = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area_a + area_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(area_a, inter.shape)
    else:
        denom = np.broadcast_to(area_b, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    """(N, 7) x (K, 7) camera-frame [x, y, z, l, h, w, ry] 3D IoU
    (eval.py d3_box_overlap + d3_box_overlap_kernel: y is the box bottom)."""
    inter_bev = _torch_bev_inter(boxes[:, [0, 2, 3, 5, 6]],
                                 qboxes[:, [0, 2, 3, 5, 6]])
    # vertical overlap: y down, y = bottom face
    ymax = np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
    ymin = np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                      qboxes[None, :, 1] - qboxes[None, :, 4])
    ih = np.clip(ymax - ymin, 0, None)
    inter = inter_bev * ih
    vol_a = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol_b = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    if criterion == -1:
        denom = vol_a + vol_b - inter
    elif criterion == 0:
        denom = np.broadcast_to(vol_a, inter.shape)
    else:
        denom = np.broadcast_to(vol_b, inter.shape)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = 41) -> List[float]:
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    cls_name = CLASS_NAMES[current_class]
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(num_dt):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


MAX_DISTANCE = [30, 50, 70]


def clean_data_by_distance(gt_anno, dt_anno, current_class: int,
                           difficulty: int, distance_cover: bool = False):
    """Distance-stratified validity (eval.py:85-160 clean_data_by_distance):
    'difficulty' becomes a distance BAND — 0-30 m, 30-50 m, 50-70 m (or
    cumulative bands with ``distance_cover``) — while occlusion/truncation/
    height gates are fixed at the 'hard' settings."""
    cls_name = CLASS_NAMES[current_class]
    num_gt = len(gt_anno["name"])
    num_dt = len(dt_anno["name"])
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(num_gt):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        dis = float(np.linalg.norm(gt_anno["location"][i]))
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[2]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[2]
                  or height <= MIN_HEIGHT[2]
                  or dis > MAX_DISTANCE[difficulty])
        if not distance_cover and difficulty > 0:
            ignore = ignore or dis <= MAX_DISTANCE[difficulty - 1]
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(num_dt):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[2]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """eval.py:234-350 port.  overlaps: (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned_detection = [False] * det_size
    ignored_threshold = [dt_scores[i] < thresh if compute_fp else False
                         for i in range(det_size)]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if (ignored_det[j] == -1 or assigned_detection[j]
                    or ignored_threshold[j]):
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION
                  and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned_detection[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned_detection[det_idx] = True

    if compute_fp:
        for i in range(det_size):
            if not (assigned_detection[i] or ignored_det[i] in (-1, 1)
                    or ignored_threshold[i]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            overlaps_dt_dc = image_box_overlap(
                dt_bboxes, np.asarray(dc_bboxes, np.float64), 0)
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned_detection[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned_detection[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def _prepare_data(gt_annos, dt_annos, current_class, difficulty,
                  by_distance: bool = False):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_dc_num = []
    total_num_valid_gt = 0
    clean = clean_data_by_distance if by_distance else clean_data
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ign_gt, ign_dt, dc = clean(
            gt, dt, current_class, difficulty)
        ignored_gts.append(np.array(ign_gt, np.int64))
        ignored_dets.append(np.array(ign_dt, np.int64))
        dc = (np.stack(dc).astype(np.float64) if dc
              else np.zeros((0, 4)))
        total_dc_num.append(dc.shape[0])
        dontcares.append(dc)
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt["bbox"], gt["alpha"][:, None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt["bbox"], dt["alpha"][:, None], dt["score"][:, None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_dc_num, total_num_valid_gt)


def _overlaps(gt_annos, dt_annos, metric, use_native: bool = True):
    from monosowa_tpu_torch.evalkitti import native

    def one(k):
        gt, dt = gt_annos[k], dt_annos[k]
        if metric == 0:
            ov = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            dt_b = np.concatenate([dt["location"][:, [0, 2]],
                                   dt["dimensions"][:, [0, 2]],
                                   dt["rotation_y"][:, None]], 1)
            gt_b = np.concatenate([gt["location"][:, [0, 2]],
                                   gt["dimensions"][:, [0, 2]],
                                   gt["rotation_y"][:, None]], 1)
            ov = (native.rotated_overlap(dt_b, gt_b) if use_native
                  else bev_box_overlap(dt_b, gt_b))
        else:
            dt_b = np.concatenate([dt["location"], dt["dimensions"],
                                   dt["rotation_y"][:, None]], 1)
            gt_b = np.concatenate([gt["location"], gt["dimensions"],
                                   gt["rotation_y"][:, None]], 1)
            ov = (native.d3_overlap(dt_b, gt_b) if use_native
                  else d3_box_overlap(dt_b, gt_b))
        return ov.astype(np.float64)

    return _thread_map(one, len(gt_annos))


def eval_class(gt_annos, dt_annos, current_class: int, difficulty: int,
               metric: int, min_overlap: float, compute_aos: bool = False,
               num_sample_pts: int = 41, by_distance: bool = False,
               use_native: bool = True):
    """One (class, difficulty, metric, overlap) evaluation.

    ``by_distance`` switches difficulty to distance bands (0-30/30-50/
    50-70 m, eval.py clean_data_by_distance — the eval_updated.py variant).
    ``use_native=False`` takes the python route (the tests' oracle).
    Returns dict with precision/recall/aos arrays of length num_sample_pts.
    """
    from monosowa_tpu_torch.evalkitti import native

    stats_fn = native.compute_statistics if use_native else compute_statistics

    overlaps = _overlaps(gt_annos, dt_annos, metric, use_native)
    (gt_datas, dt_datas, ignored_gts, ignored_dets, dontcares, _,
     total_num_valid_gt) = _prepare_data(gt_annos, dt_annos, current_class,
                                         difficulty, by_distance)
    # pass 1: collect tp scores
    all_thresholds = _thread_map(
        lambda k: stats_fn(
            overlaps[k], gt_datas[k], dt_datas[k], ignored_gts[k],
            ignored_dets[k], dontcares[k], metric, min_overlap,
            compute_fp=False)[4],
        len(gt_annos))
    all_scores = np.concatenate(all_thresholds) if all_thresholds else \
        np.zeros(0)
    if total_num_valid_gt == 0:
        z = np.zeros(num_sample_pts)
        return {"precision": z, "recall": z, "aos": z}
    thresholds = np.array(get_thresholds(all_scores, total_num_valid_gt,
                                         num_sample_pts))
    pr = np.zeros((len(thresholds), 4))
    if use_native:
        # per-image buffers summed in index order: bitwise identical to the
        # serial accumulation regardless of thread completion order
        def one_pr(k):
            pr_k = np.zeros((len(thresholds), 4))
            native.accumulate_pr(
                overlaps[k], gt_datas[k], dt_datas[k], ignored_gts[k],
                ignored_dets[k], dontcares[k], metric, min_overlap,
                thresholds, compute_aos, pr_k)
            return pr_k

        for pr_k in _thread_map(one_pr, len(gt_annos)):
            pr += pr_k
    else:
        for k in range(len(gt_annos)):
            for t, th in enumerate(thresholds):
                tp, fp, fn, sim, _ = compute_statistics(
                    overlaps[k], gt_datas[k], dt_datas[k], ignored_gts[k],
                    ignored_dets[k], dontcares[k], metric, min_overlap,
                    thresh=th, compute_fp=True, compute_aos=compute_aos)
                pr[t, 0] += tp
                pr[t, 1] += fp
                pr[t, 2] += fn
                if sim != -1:
                    pr[t, 3] += sim

    precision = np.zeros(num_sample_pts)
    recall = np.zeros(num_sample_pts)
    aos = np.zeros(num_sample_pts)
    for i in range(len(thresholds)):
        precision[i] = pr[i, 0] / max(pr[i, 0] + pr[i, 1], 1e-12)
        recall[i] = pr[i, 0] / max(pr[i, 0] + pr[i, 2], 1e-12)
        if compute_aos:
            aos[i] = pr[i, 3] / max(pr[i, 0] + pr[i, 1], 1e-12)
    # precision envelope (recall stays raw, matching eval.py)
    for i in range(num_sample_pts):
        precision[i] = precision[i:].max()
        if compute_aos:
            aos[i] = aos[i:].max()
    return {"precision": precision, "recall": recall, "aos": aos}


def ap11(values: np.ndarray) -> float:
    return float(np.mean(values[0::4]) * 100)


def ap40(values: np.ndarray) -> float:
    return float(np.mean(values[1:]) * 100)


# overlap thresholds: metric x class (car, ped, cyc) — eval.py:821-840
OVERLAP_MOD = np.array([[0.7, 0.5, 0.5], [0.7, 0.5, 0.5], [0.7, 0.5, 0.5]])
OVERLAP_EASY = np.array([[0.5, 0.5, 0.5], [0.5, 0.25, 0.25],
                         [0.5, 0.25, 0.25]])


def get_official_eval_result(gt_annos, dt_annos,
                             current_classes=(0,),
                             compute_aos: bool = False,
                             overlap_sets=None,
                             by_distance: bool = False,
                             use_native: bool = True) -> Dict[str, Dict]:
    """AP_R40 for bbox/bev/3d per class, difficulty, and the two standard
    overlap settings (moderate 0.7, loose 0.5 for cars).

    ``by_distance``: difficulty columns become 0-30 / 30-50 / 50-70 m
    distance bands (the reference's eval_updated/get_distance_eval_result
    protocol)."""
    if overlap_sets is None:
        overlap_sets = {"strict": OVERLAP_MOD, "loose": OVERLAP_EASY}
    results = {}
    for cls in current_classes:
        cls_name = CLASS_NAMES[cls]
        for set_name, overlaps in overlap_sets.items():
            for metric, metric_name in ((0, "bbox"), (1, "bev"), (2, "3d")):
                min_ov = overlaps[metric, cls if cls < 3 else 0]
                aps40, aps11 = [], []
                for difficulty in (0, 1, 2):
                    r = eval_class(gt_annos, dt_annos, cls, difficulty,
                                   metric, min_ov, compute_aos,
                                   by_distance=by_distance,
                                   use_native=use_native)
                    aps40.append(ap40(r["precision"]))
                    aps11.append(ap11(r["precision"]))
                key = f"{cls_name}_{metric_name}_{set_name}"
                results[key] = {"ap40": aps40, "ap11": aps11,
                                "min_overlap": float(min_ov)}
    return results


def get_distance_eval_result(gt_annos, dt_annos, current_classes=(0,),
                             compute_aos: bool = False,
                             use_native: bool = True) -> Dict[str, Dict]:
    """Distance-stratified AP (get_distance_eval_result, eval.py:935)."""
    return get_official_eval_result(gt_annos, dt_annos, current_classes,
                                    compute_aos, by_distance=True,
                                    use_native=use_native)
