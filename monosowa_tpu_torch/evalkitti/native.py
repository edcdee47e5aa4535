"""ctypes bindings for the C++ eval kernels (``csrc/eval_kernels.cpp``).

The port's own copy of the JAX package's ``native/eval_kernels.cpp``, built
at first use with the host compiler into ``build/monosowa_tpu_torch/`` by
``ops/_build.py`` (a hash of source and flags in the library's name, a
temporary file renamed into place).  A build that fails raises with the
compiler's output: the python route of ``eval.py`` is the tests' oracle,
not a fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
LIBRARY = "eval_kernels"


def build() -> str:
    """Compile the library unless it exists; returns the compiler's output
    ("" when nothing was built)."""
    from monosowa_tpu_torch.ops import _build

    return _build.build(LIBRARY, CSRC)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    from monosowa_tpu_torch.ops._build import load_library

    lib = load_library(LIBRARY, CSRC)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.rotated_overlap_matrix.argtypes = [dp, ctypes.c_int64, dp,
                                           ctypes.c_int64, ctypes.c_int, dp]
    lib.d3_overlap_matrix.argtypes = [dp, ctypes.c_int64, dp,
                                      ctypes.c_int64, ctypes.c_int, dp]
    lib.compute_statistics.argtypes = [
        dp, ctypes.c_int64, ctypes.c_int64, dp, dp, dp, dp, ip, ip, dp,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, dp, dp, ip]
    lib.accumulate_pr.argtypes = [
        dp, ctypes.c_int64, ctypes.c_int64, dp, dp, dp, dp, ip, ip, dp,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, dp, ctypes.c_int64,
        ctypes.c_int, dp]
    for fn in (lib.rotated_overlap_matrix, lib.d3_overlap_matrix,
               lib.compute_statistics, lib.accumulate_pr):
        fn.restype = None
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def rotated_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    out = np.zeros((boxes.shape[0], qboxes.shape[0]), np.float64)
    if boxes.size and qboxes.size:
        lib.rotated_overlap_matrix(_dp(boxes), boxes.shape[0], _dp(qboxes),
                                   qboxes.shape[0], criterion, _dp(out))
    return out


def d3_overlap(boxes: np.ndarray, qboxes: np.ndarray,
               criterion: int = -1) -> np.ndarray:
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    out = np.zeros((boxes.shape[0], qboxes.shape[0]), np.float64)
    if boxes.size and qboxes.size:
        lib.d3_overlap_matrix(_dp(boxes), boxes.shape[0], _dp(qboxes),
                              qboxes.shape[0], criterion, _dp(out))
    return out


def _pack(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes):
    ov = np.ascontiguousarray(overlaps, np.float64)
    gt_alphas = np.ascontiguousarray(gt_datas[:, 4], np.float64)
    dt_alphas = np.ascontiguousarray(dt_datas[:, 4], np.float64)
    dt_scores = np.ascontiguousarray(dt_datas[:, -1], np.float64)
    dt_bboxes = np.ascontiguousarray(dt_datas[:, :4], np.float64)
    ig = np.ascontiguousarray(ignored_gt, np.int64)
    idt = np.ascontiguousarray(ignored_det, np.int64)
    dc = np.ascontiguousarray(dc_bboxes, np.float64).reshape(-1, 4)
    return ov, gt_alphas, dt_alphas, dt_scores, dt_bboxes, ig, idt, dc


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Signature-compatible with evalkitti.eval.compute_statistics."""
    lib = _load()
    ov, ga, da, ds, db, ig, idt, dc = _pack(
        overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes)
    out = np.zeros(4, np.float64)
    scores = np.zeros(max(gt_datas.shape[0], 1), np.float64)
    ns = np.zeros(1, np.int64)
    lib.compute_statistics(
        _dp(ov), dt_datas.shape[0], gt_datas.shape[0], _dp(ga), _dp(da),
        _dp(ds), _dp(db), _ip(ig), _ip(idt), _dp(dc), dc.shape[0],
        int(metric), float(min_overlap), float(thresh), int(compute_fp),
        int(compute_aos), _dp(out), _dp(scores), _ip(ns))
    return (int(out[0]), int(out[1]), int(out[2]), float(out[3]),
            scores[:ns[0]].copy())


def accumulate_pr(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                  dc_bboxes, metric, min_overlap, thresholds,
                  compute_aos, pr: np.ndarray) -> None:
    lib = _load()
    ov, ga, da, ds, db, ig, idt, dc = _pack(
        overlaps, gt_datas, dt_datas, ignored_gt, ignored_det, dc_bboxes)
    th = np.ascontiguousarray(thresholds, np.float64)
    if not (pr.flags["C_CONTIGUOUS"] and pr.dtype == np.float64
            and pr.shape == (th.shape[0], 4)):
        raise ValueError(f"pr {pr.shape} {pr.dtype}: want a contiguous "
                         f"float64 ({th.shape[0]}, 4) array")
    lib.accumulate_pr(
        _dp(ov), dt_datas.shape[0], gt_datas.shape[0], _dp(ga), _dp(da),
        _dp(ds), _dp(db), _ip(ig), _ip(idt), _dp(dc), dc.shape[0],
        int(metric), float(min_overlap), _dp(th), th.shape[0],
        int(compute_aos), _dp(pr))
