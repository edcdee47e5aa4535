#!/usr/bin/env python
"""Dimension-error evaluation: Hungarian-matched L1 errors on l/w/h, with
the port alone.

The counterpart of ``tools/eval_dimensions.py`` over the port's
``kittiio/labels.py`` (behavioural contract:
pseudo_label_generator/3d/eval/eval_dimensions.py): per frame, match
predicted Cars to GT Cars via linear_sum_assignment on centre distance,
keep pairs closer than 4 m, accumulate |dl|, |dw|, |dh|; report means and
medians (the reference also plots histograms).

Usage:
  eval_dimensions_torch.py <gt_dir> <pred_dir>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from scipy.optimize import linear_sum_assignment

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from monosowa_tpu_torch.kittiio import read_label_file  # noqa: E402

MATCH_DIST = 4.0


def frame_errors(gt_path: str, pred_path: str):
    out = []
    if not (os.path.exists(gt_path) and os.path.exists(pred_path)):
        return out
    gt = [o for o in read_label_file(gt_path) if o.cls_type == "Car"]
    pred = [o for o in read_label_file(pred_path) if o.cls_type == "Car"]
    if not gt or not pred:
        return out
    cost = np.zeros((len(pred), len(gt)))
    for i, p in enumerate(pred):
        for j, g in enumerate(gt):
            cost[i, j] = np.linalg.norm(p.pos - g.pos)
    rows, cols = linear_sum_assignment(cost)
    for i, j in zip(rows, cols):
        if cost[i, j] < MATCH_DIST:
            p, g = pred[i], gt[j]
            out.append((abs(p.l - g.l), abs(p.w - g.w), abs(p.h - g.h)))
    return out


def main(gt_dir: str, pred_dir: str) -> dict:
    errors = []
    for name in sorted(os.listdir(pred_dir)):
        if not name.endswith(".txt"):
            continue
        errors.extend(frame_errors(os.path.join(gt_dir, name),
                                   os.path.join(pred_dir, name)))
    if not errors:
        print("no matched pairs")
        return {}
    arr = np.asarray(errors)
    result = {"n_pairs": len(arr),
              "mean_length_err": float(arr[:, 0].mean()),
              "mean_width_err": float(arr[:, 1].mean()),
              "mean_height_err": float(arr[:, 2].mean()),
              "median_length_err": float(np.median(arr[:, 0])),
              "median_width_err": float(np.median(arr[:, 1])),
              "median_height_err": float(np.median(arr[:, 2]))}
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("gt_dir")
    p.add_argument("pred_dir")
    a = p.parse_args()
    main(a.gt_dir, a.pred_dir)
