"""Offline KITTI AP evaluation of a prediction directory.

The thin command line of the AP stack, mirroring the reference's
``kitti_eval_python/evaluate.py`` (argparse instead of fire, which is not
in this image): point it at a ground-truth label dir and a prediction
label dir and it prints the official AP / AP_R40 result block, optionally
the distance-stratified variant.

    python -m monosowa_tpu_torch.evalkitti.evaluate <gt_dir> <pred_dir> \
        [--split imageset.txt] [--classes 0] [--score_thresh -1] [--distance]

Frame ids default to the *.txt stems present in the prediction dir (the
reference requires an ImageSets split file; ``--split`` provides the same
behavior).
"""

from __future__ import annotations

import argparse
import os
import sys

from monosowa_tpu_torch.evalkitti.eval import (annos_from_label_dir,
                                               get_distance_eval_result,
                                               get_official_eval_result)


def _ids_from(pred_dir: str, split_file: str | None):
    if split_file:
        with open(split_file) as f:
            return [line.strip().zfill(6) for line in f if line.strip()]
    ids = [f[:-4] for f in os.listdir(pred_dir) if f.endswith(".txt")]
    return sorted(ids)


def format_result(results: dict) -> str:
    """Render the AP dict as the reference-style printed block."""
    lines = []
    for key, r in results.items():
        ov = r.get("min_overlap")
        head = f"{key} AP@{ov:.2f}" if ov is not None else key
        a40 = "/".join(f"{v:.4f}" for v in r["ap40"])
        a11 = "/".join(f"{v:.4f}" for v in r["ap11"])
        lines.append(f"{head}:  AP_R40 {a40}  AP11 {a11}")
    return "\n".join(lines)


def evaluate(gt_dir: str, pred_dir: str, split_file: str | None = None,
             classes=(0,), score_thresh: float = -1.0,
             distance: bool = False) -> str:
    ids = _ids_from(pred_dir, split_file)
    if not ids:
        raise SystemExit(f"no prediction txt files under {pred_dir}")
    gt_annos = annos_from_label_dir(gt_dir, ids)
    dt_annos = annos_from_label_dir(pred_dir, ids)
    if score_thresh > 0:
        for anno in dt_annos:
            keep = anno["score"] > score_thresh
            for k in list(anno):
                anno[k] = anno[k][keep]
    if distance:
        return get_distance_eval_result(gt_annos, dt_annos,
                                        current_classes=tuple(classes))
    return get_official_eval_result(gt_annos, dt_annos,
                                    current_classes=tuple(classes))


def main(argv=None):
    p = argparse.ArgumentParser(
        "offline KITTI AP evaluation (AP11 + AP_R40, bbox/bev/3d/aos)")
    p.add_argument("gt_dir", help="ground-truth label dir (KITTI txt)")
    p.add_argument("pred_dir", help="prediction label dir (KITTI txt)")
    p.add_argument("--split", default=None,
                   help="ImageSets file restricting the evaluated ids")
    p.add_argument("--classes", type=int, nargs="+", default=[0],
                   help="class ids (0=Car, 1=Pedestrian, 2=Cyclist)")
    p.add_argument("--score_thresh", type=float, default=-1.0)
    p.add_argument("--distance", action="store_true",
                   help="distance-stratified result (0-30/30-50/50-inf)")
    a = p.parse_args(argv)
    print(format_result(evaluate(a.gt_dir, a.pred_dir, a.split,
                                 tuple(a.classes), a.score_thresh,
                                 a.distance)))


if __name__ == "__main__":
    main(sys.argv[1:])
