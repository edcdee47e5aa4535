"""Tester: inference -> KITTI result files -> AP evaluation.

Behavioral contract (MonoDETR/lib/helpers/tester_helper.py:14-188, the JAX
package's ``train/tester.py``): batch inference with decode
(canonical-module inversion), per-image KITTI result txt under
<save_path>/outputs/data, dataset eval via the KITTI AP stack
(``evalkitti``), a per-image s/img report, and with ``visu`` or
``tester.visu_predictions`` the BEV renders of predictions against the
ground truth (``visualize_results``, tester_helper.py:196-254's headless
analog; matplotlib is needed then).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Iterator, Optional, Sequence

import numpy as np

from monosowa_tpu_torch.data.kitti_dataset import CLS_MEAN_SIZE, collate
from monosowa_tpu_torch.kittiio import Calibration
from monosowa_tpu_torch.kittiio.labels import write_detection_file
from monosowa_tpu_torch.train.decode import decode_detections
from monosowa_tpu_torch.train.trainer import make_eval_step

CLASS_NAMES = ("Pedestrian", "Car", "Cyclist")


def dataset_batches(dataset, batch_size: int
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """The dataset in index order as collated batches of ``batch_size``
    samples; the last one may be smaller."""
    for i in range(0, len(dataset), batch_size):
        yield collate([dataset[j]
                       for j in range(i, min(i + batch_size, len(dataset)))])


def run_inference(model, batches: Iterable[Dict[str, np.ndarray]],
                  cfg: Dict, logger=print, visu: bool = False) -> str:
    """Runs the model over collated numpy batches (``data.collate``) and
    writes result files; returns the results dir.  With ``visu`` or
    ``tester.visu_predictions``, then renders the first images' results
    (``visualize_results``)."""
    tester_cfg = cfg.get("tester", {})
    threshold = float(tester_cfg.get("threshold", 0.2))
    out_dir = os.path.join(cfg["trainer"].get("save_path", "outputs"),
                           "outputs", "data")
    os.makedirs(out_dir, exist_ok=True)
    eval_step = make_eval_step(model, topk=int(tester_cfg.get("topk", 50)))
    mean_size = (CLS_MEAN_SIZE if cfg["dataset"].get("meanshape", False)
                 else np.zeros((3, 3), np.float32))

    img_ids = []
    t0 = time.time()
    for batch in batches:
        dets = eval_step(batch).cpu().numpy()
        infos = {k: batch[k] for k in ("img_size", "img_id",
                                       "canonical_scale", "height_crop")}
        calibs = [Calibration({"P2": np.asarray(c)}) for c in batch["calib"]]
        results = decode_detections(dets, infos, calibs, mean_size,
                                    threshold)
        for img_id, rows in results.items():
            write_detection_file(os.path.join(out_dir, f"{img_id:06d}.txt"),
                                 rows, CLASS_NAMES)
        img_ids.extend(int(i) for i in batch["img_id"])
    n = len(img_ids)
    logger(f"inference on {n} images, {(time.time() - t0) / max(n, 1):.3f}"
           " s/img")

    if visu or tester_cfg.get("visu_predictions", False):
        visualize_results(img_ids, out_dir, cfg, logger)
    return out_dir


def visualize_results(img_ids: Sequence[int], results_dir: str, cfg: Dict,
                      logger=print, max_images: int = 20) -> None:
    """BEV renders of the first ``max_images`` images' result files against
    ``<root_dir>/training/label_2`` (unless ``tester.visu_ground_truth`` is
    False), one PNG an image under <save_path>/outputs/visu
    (tester_helper.py:196-254 headless analog)."""
    from monosowa_tpu_torch.sowa.visualization import compare_label_dirs

    visu_dir = os.path.join(cfg["trainer"].get("save_path", "outputs"),
                            "outputs", "visu")
    os.makedirs(visu_dir, exist_ok=True)
    gt_dir = os.path.join(cfg["dataset"]["root_dir"], "training", "label_2")
    show_gt = cfg.get("tester", {}).get("visu_ground_truth", True)
    for idx in img_ids[:max_images]:
        fid = f"{int(idx):06d}"
        compare_label_dirs(fid, os.path.join(visu_dir, fid + ".png"),
                           pred_dir=results_dir,
                           gt_dir=gt_dir if show_gt else None)
    logger(f"visualisations under {visu_dir}")


def evaluate_results(dataset, results_dir: str, cfg: Dict,
                     logger=print) -> Dict:
    """KITTI AP of the result files against ``<root_dir>/training/label_2``
    for the dataset's ids (class Car)."""
    from monosowa_tpu_torch.evalkitti import (annos_from_label_dir,
                                              get_official_eval_result)

    gt_dir = os.path.join(cfg["dataset"]["root_dir"], "training", "label_2")
    ids = [f"{int(i):06d}" for i in dataset.idx_list]
    res = get_official_eval_result(annos_from_label_dir(gt_dir, ids),
                                   annos_from_label_dir(results_dir, ids),
                                   current_classes=(0,))
    for k, v in res.items():
        logger(f"{k}: AP40 {['%.2f' % a for a in v['ap40']]}")
    return res


def test(model, dataset, cfg: Dict, logger=print, visu: bool = False,
         seconds: Optional[Dict[str, float]] = None) -> Dict:
    """Inference over the whole dataset, then its AP dict.  A ``seconds``
    dict receives the host seconds of the two stages (``inference``: model,
    decode and result files; ``ap``: the KITTI evaluation)."""
    batch_size = int(cfg["dataset"].get("batch_size", 16))
    t0 = time.perf_counter()
    out_dir = run_inference(model, dataset_batches(dataset, batch_size), cfg,
                            logger, visu)
    t1 = time.perf_counter()
    res = evaluate_results(dataset, out_dir, cfg, logger)
    if seconds is not None:
        seconds["inference"] = t1 - t0
        seconds["ap"] = time.perf_counter() - t1
    return res
