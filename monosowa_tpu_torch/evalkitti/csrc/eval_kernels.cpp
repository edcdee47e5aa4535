// KITTI AP evaluation kernels (C++ native layer).
//
// Replaces the reference's numba kernels (SURVEY.md §2.4.2-3):
//  * rotate_iou.py:17-293 — rotated-BEV polygon-intersection IoU
//    (numba-CUDA) -> rotated_overlap_matrix / d3_overlap_matrix;
//  * eval.py:162-414 compute_statistics_jit / fused_compute_statistics
//    (numba-JIT) -> fused_statistics.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image);
// the torch port's own copy of the JAX package's native/eval_kernels.cpp,
// built at first use by monosowa_tpu_torch/ops/_build.py with the host
// compiler.  The algorithms mirror monosowa_tpu_torch/evalkitti/eval.py
// (the python oracle);
// tests assert bit-level agreement of TP/FP/FN counts.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kEps = 1e-8;

struct Pt {
  double x, z;
};

// Corners of a rotated BEV box [x, z, l, w, ry] (camera frame; matches
// monosowa_tpu_torch/ops/box3d.py bev_corners: x' = c*dx + s*dz, z' = -s*dx + c*dz).
void bev_corners(const double* b, Pt out[4]) {
  const double l = b[2] / 2.0, w = b[3] / 2.0;
  const double c = std::cos(b[4]), s = std::sin(b[4]);
  const double dx[4] = {l, l, -l, -l};
  const double dz[4] = {w, -w, -w, w};
  for (int i = 0; i < 4; ++i) {
    out[i].x = c * dx[i] + s * dz[i] + b[0];
    out[i].z = -s * dx[i] + c * dz[i] + b[1];
  }
}

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.z - o.z) - (a.z - o.z) * (b.x - o.x);
}

bool point_in_quad(const Pt& p, const Pt q[4]) {
  bool all_pos = true, all_neg = true;
  for (int i = 0; i < 4; ++i) {
    double cr = cross(q[i], q[(i + 1) % 4], p);
    all_pos &= (cr >= -kEps);
    all_neg &= (cr <= kEps);
  }
  return all_pos || all_neg;
}

// Intersection area of two convex quads: candidate vertices = contained
// corners + edge intersections, sorted by angle, shoelace.
double quad_intersection_area(const Pt a[4], const Pt b[4]) {
  Pt pts[24];
  int n = 0;
  for (int i = 0; i < 4; ++i)
    if (point_in_quad(a[i], b)) pts[n++] = a[i];
  for (int i = 0; i < 4; ++i)
    if (point_in_quad(b[i], a)) pts[n++] = b[i];
  for (int i = 0; i < 4; ++i) {
    const Pt &a0 = a[i], &a1 = a[(i + 1) % 4];
    for (int j = 0; j < 4; ++j) {
      const Pt &b0 = b[j], &b1 = b[(j + 1) % 4];
      const double dax = a1.x - a0.x, daz = a1.z - a0.z;
      const double dbx = b1.x - b0.x, dbz = b1.z - b0.z;
      const double denom = dax * dbz - daz * dbx;
      if (std::fabs(denom) < kEps) continue;
      const double dx = b0.x - a0.x, dz = b0.z - a0.z;
      const double t = (dx * dbz - dz * dbx) / denom;
      const double u = (dx * daz - dz * dax) / denom;
      if (t >= -kEps && t <= 1 + kEps && u >= -kEps && u <= 1 + kEps)
        pts[n++] = {a0.x + t * dax, a0.z + t * daz};
    }
  }
  if (n < 3) return 0.0;
  Pt c{0, 0};
  for (int i = 0; i < n; ++i) {
    c.x += pts[i].x;
    c.z += pts[i].z;
  }
  c.x /= n;
  c.z /= n;
  std::sort(pts, pts + n, [&](const Pt& p, const Pt& q) {
    return std::atan2(p.z - c.z, p.x - c.x) < std::atan2(q.z - c.z, q.x - c.x);
  });
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt &p = pts[i], &q = pts[(i + 1) % n];
    area += p.x * q.z - p.z * q.x;
  }
  return std::fabs(area) / 2.0;
}

}  // namespace

extern "C" {

// boxes: (n, 5) [x, z, l, w, ry]; qboxes: (k, 5); out: (n, k).
// criterion: -1 IoU, 0 inter/area_a, 1 inter/area_b, 2 raw intersection.
void rotated_overlap_matrix(const double* boxes, int64_t n,
                            const double* qboxes, int64_t k, int criterion,
                            double* out) {
  std::vector<std::array<Pt, 4>> qa(n), qb(k);
  for (int64_t i = 0; i < n; ++i) bev_corners(boxes + 5 * i, qa[i].data());
  for (int64_t j = 0; j < k; ++j) bev_corners(qboxes + 5 * j, qb[j].data());
  for (int64_t i = 0; i < n; ++i) {
    const double area_a = boxes[5 * i + 2] * boxes[5 * i + 3];
    for (int64_t j = 0; j < k; ++j) {
      const double inter = quad_intersection_area(qa[i].data(), qb[j].data());
      const double area_b = qboxes[5 * j + 2] * qboxes[5 * j + 3];
      double denom;
      switch (criterion) {
        case 0: denom = area_a; break;
        case 1: denom = area_b; break;
        case 2: denom = 1.0; break;
        default: denom = area_a + area_b - inter;
      }
      out[i * k + j] = denom > 0 ? inter / std::max(denom, 1e-12) : 0.0;
    }
  }
}

// Full 3D overlap of camera-frame boxes (n, 7) [x, y, z, l, h, w, ry]
// (y = bottom face, down axis). criterion as above.
void d3_overlap_matrix(const double* boxes, int64_t n, const double* qboxes,
                       int64_t k, int criterion, double* out) {
  std::vector<double> ba(5 * n), bb(5 * k);
  for (int64_t i = 0; i < n; ++i) {
    const double* s = boxes + 7 * i;
    double* d = ba.data() + 5 * i;
    d[0] = s[0]; d[1] = s[2]; d[2] = s[3]; d[3] = s[5]; d[4] = s[6];
  }
  for (int64_t j = 0; j < k; ++j) {
    const double* s = qboxes + 7 * j;
    double* d = bb.data() + 5 * j;
    d[0] = s[0]; d[1] = s[2]; d[2] = s[3]; d[3] = s[5]; d[4] = s[6];
  }
  std::vector<double> inter_bev(n * k);
  rotated_overlap_matrix(ba.data(), n, bb.data(), k, 2, inter_bev.data());
  for (int64_t i = 0; i < n; ++i) {
    const double* a = boxes + 7 * i;
    for (int64_t j = 0; j < k; ++j) {
      const double* b = qboxes + 7 * j;
      const double ymax = std::min(a[1], b[1]);
      const double ymin = std::max(a[1] - a[4], b[1] - b[4]);
      const double ih = std::max(ymax - ymin, 0.0);
      const double inter = inter_bev[i * k + j] * ih;
      const double va = a[3] * a[4] * a[5], vb = b[3] * b[4] * b[5];
      double denom;
      switch (criterion) {
        case 0: denom = va; break;
        case 1: denom = vb; break;
        case 2: denom = 1.0; break;
        default: denom = va + vb - inter;
      }
      out[i * k + j] = denom > 0 ? inter / std::max(denom, 1e-12) : 0.0;
    }
  }
}

// One-image TP/FP/FN statistics (port of eval.py:234-350 semantics, shared
// with monosowa_tpu_torch/evalkitti/eval.py compute_statistics).
//
// overlaps: (num_dt, num_gt) row-major; gt/dt datas give alphas + scores;
// ignored_* in {-1, 0, 1}; dc_bboxes (num_dc, 4).  When compute_fp == 0,
// tp_scores (capacity num_gt) receives the matched scores and *n_scores is
// set.  Returns via out[4] = {tp, fp, fn, similarity}.
void compute_statistics(const double* overlaps, int64_t num_dt,
                        int64_t num_gt, const double* gt_alphas,
                        const double* dt_alphas, const double* dt_scores,
                        const double* dt_bboxes, const int64_t* ignored_gt,
                        const int64_t* ignored_det, const double* dc_bboxes,
                        int64_t num_dc, int metric, double min_overlap,
                        double thresh, int compute_fp, int compute_aos,
                        double* out, double* tp_scores, int64_t* n_scores) {
  const double kNoDetection = -10000000.0;
  std::vector<char> assigned(num_dt, 0), ignored_thresh(num_dt, 0);
  if (compute_fp) {
    for (int64_t j = 0; j < num_dt; ++j)
      if (dt_scores[j] < thresh) ignored_thresh[j] = 1;
  }
  int64_t tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
  std::vector<double> delta;
  int64_t ns = 0;
  for (int64_t i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int64_t j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_thresh[j]) continue;
      const double overlap = overlaps[j * num_gt + i];
      const double score = dt_scores[j];
      if (!compute_fp && overlap > min_overlap && score > valid_detection) {
        det_idx = j;
        valid_detection = score;
      } else if (compute_fp && overlap > min_overlap &&
                 (overlap > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap &&
                 valid_detection == kNoDetection && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      tp += 1;
      if (tp_scores != nullptr) tp_scores[ns] = dt_scores[det_idx];
      ns += 1;
      if (compute_aos) delta.push_back(gt_alphas[i] - dt_alphas[det_idx]);
      assigned[det_idx] = 1;
    }
  }
  if (compute_fp) {
    for (int64_t j = 0; j < num_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
            ignored_thresh[j]))
        fp += 1;
    }
    int64_t nstuff = 0;
    if (metric == 0 && num_dc > 0) {
      for (int64_t d = 0; d < num_dc; ++d) {
        const double* dc = dc_bboxes + 4 * d;
        for (int64_t j = 0; j < num_dt; ++j) {
          if (assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
              ignored_thresh[j])
            continue;
          const double* b = dt_bboxes + 4 * j;
          const double iw = std::min(b[2], dc[2]) - std::max(b[0], dc[0]);
          const double ih = std::min(b[3], dc[3]) - std::max(b[1], dc[1]);
          if (iw > 0 && ih > 0) {
            const double inter = iw * ih;
            const double area = (b[2] - b[0]) * (b[3] - b[1]);
            if (area > 0 && inter / area > min_overlap) {
              assigned[j] = 1;
              nstuff += 1;
            }
          }
        }
      }
    }
    fp -= nstuff;
    if (compute_aos) {
      if (tp > 0 || fp > 0) {
        similarity = 0.0;
        for (double d : delta) similarity += (1.0 + std::cos(d)) / 2.0;
      } else {
        similarity = -1.0;
      }
    }
  }
  out[0] = static_cast<double>(tp);
  out[1] = static_cast<double>(fp);
  out[2] = static_cast<double>(fn);
  out[3] = similarity;
  if (n_scores != nullptr) *n_scores = ns;
}

// Precision-recall accumulation over all thresholds for one image (the fused loop of
// eval.py:366-414): pr is (num_thresholds, 4) accumulated in place.
void accumulate_pr(const double* overlaps, int64_t num_dt, int64_t num_gt,
                   const double* gt_alphas, const double* dt_alphas,
                   const double* dt_scores, const double* dt_bboxes,
                   const int64_t* ignored_gt, const int64_t* ignored_det,
                   const double* dc_bboxes, int64_t num_dc, int metric,
                   double min_overlap, const double* thresholds,
                   int64_t num_thresholds, int compute_aos, double* pr) {
  double out[4];
  for (int64_t t = 0; t < num_thresholds; ++t) {
    compute_statistics(overlaps, num_dt, num_gt, gt_alphas, dt_alphas,
                       dt_scores, dt_bboxes, ignored_gt, ignored_det,
                       dc_bboxes, num_dc, metric, min_overlap, thresholds[t],
                       1, compute_aos, out, nullptr, nullptr);
    pr[t * 4 + 0] += out[0];
    pr[t * 4 + 1] += out[1];
    pr[t * 4 + 2] += out[2];
    if (out[3] != -1.0) pr[t * 4 + 3] += out[3];
  }
}

}  // extern "C"
