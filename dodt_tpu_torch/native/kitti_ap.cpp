// Fast KITTI detection AP evaluator (C ABI, used via ctypes).
//
// Native twin of dodt_tpu_torch/eval/kitti_ap.py (the port's copy of
// dodt_tpu/native/kitti_ap.cpp) implementing the OFFICIAL
// scoring protocol of the KITTI benchmark (the reference ships the
// upstream C++ scorer at scripts/offline_eval/kitti_native_eval/
// evaluate_object_3d_offline.cpp; this is an independent
// implementation of the same published rules, parity-tested against
// the compiled official binary in tests/test_ap_parity.py):
//   * sequential GT matching with a shared assigned set
//     (computeStatistics:457-637): recall-threshold pass takes the
//     highest-SCORE overlapping candidate, the PR pass the
//     highest-overlap non-ignored candidate, small detections may
//     absorb a match without a TP,
//   * ignored GT (neighbor class / difficulty) absorb detections,
//   * DontCare absorption with criterion-0 overlap (image metric),
//   * thresholds at 41 recall steps, right-monotonized precision,
//     official 11-of-41-point AP average.
//
// Exposes one function:
//   double kitti_ap(metric, min_iou, n_frames,
//                   gt_counts, gt_boxes7, gt_bbox4, ignored_gt,
//                   dc_counts, dc_bbox4,
//                   det_counts, det_boxes7, det_bbox4, det_scores,
//                   ignored_det)
// where per-frame arrays are concatenated and counts give per-frame
// lengths; ignored_gt/ignored_det are the official 0/1/-1 codes
// (classification done host-side in Python, which owns the
// class/difficulty tables).
//
// Build: see build_native.sh (g++ -O3 -shared -fPIC).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kSamplePts = 41;
constexpr double kNoDetection = -10000000.0;

struct Pt { double x, z; };

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.z - o.z) - (a.z - o.z) * (b.x - o.x);
}

// Sutherland-Hodgman clip of convex polygon by half-plane left of a->b.
void clip(std::vector<Pt>& poly, const Pt& a, const Pt& b,
          std::vector<Pt>& out) {
  out.clear();
  const size_t n = poly.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt& cur = poly[i];
    const Pt& nxt = poly[(i + 1) % n];
    double dc = cross(a, b, cur);
    double dn = cross(a, b, nxt);
    if (dc >= 0) out.push_back(cur);
    if ((dc > 0) != (dn > 0) && (dc < 0 || dn < 0)) {
      double t = dc / (dc - dn);
      out.push_back({cur.x + t * (nxt.x - cur.x),
                     cur.z + t * (nxt.z - cur.z)});
    }
  }
  poly = out;
}

double polyArea(const std::vector<Pt>& p) {
  if (p.size() < 3) return 0.0;
  double s = 0.0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& a = p[i];
    const Pt& b = p[(i + 1) % p.size()];
    s += a.x * b.z - b.x * a.z;
  }
  return std::fabs(s) * 0.5;
}

void rectCorners(const double* b7, Pt out[4]) {
  // box7: x y z l w h ry  (camera frame, footprint in xz)
  double c = std::cos(b7[6]), s = std::sin(b7[6]);
  double l2 = b7[3] / 2, w2 = b7[4] / 2;
  double xs[4] = {l2, l2, -l2, -l2};
  double zs[4] = {w2, -w2, -w2, w2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = c * xs[i] + s * zs[i] + b7[0];
    out[i].z = -s * xs[i] + c * zs[i] + b7[2];
  }
}

double rotatedInter(const double* a7, const double* b7) {
  Pt pa[4], pb[4];
  rectCorners(a7, pa);
  rectCorners(b7, pb);
  std::vector<Pt> poly(pa, pa + 4), tmp;
  // orient clip rect CCW
  double area2 = 0;
  for (int i = 0; i < 4; ++i) {
    const Pt& p = pb[i];
    const Pt& q = pb[(i + 1) % 4];
    area2 += p.x * q.z - q.x * p.z;
  }
  Pt pbo[4];
  for (int i = 0; i < 4; ++i) pbo[i] = area2 < 0 ? pb[3 - i] : pb[i];
  for (int i = 0; i < 4 && !poly.empty(); ++i)
    clip(poly, pbo[i], pbo[(i + 1) % 4], tmp);
  return polyArea(poly);
}

// metric: 0 = image (2D bbox), 1 = ground (rotated BEV), 2 = 3d
double overlap(int metric, const double* d7, const double* d4,
               const double* g7, const double* g4) {
  if (metric == 0) {
    double x1 = std::max(d4[0], g4[0]);
    double y1 = std::max(d4[1], g4[1]);
    double x2 = std::min(d4[2], g4[2]);
    double y2 = std::min(d4[3], g4[3]);
    double inter = std::max(0.0, x2 - x1) * std::max(0.0, y2 - y1);
    double ua = (d4[2] - d4[0]) * (d4[3] - d4[1]) +
                (g4[2] - g4[0]) * (g4[3] - g4[1]) - inter;
    return ua > 0 ? inter / ua : 0.0;
  }
  double inter2d = rotatedInter(d7, g7);
  if (metric == 1) {
    double ua = d7[3] * d7[4] + g7[3] * g7[4] - inter2d;
    return ua > 0 ? inter2d / ua : 0.0;
  }
  // camera y points down; box spans [y-h, y]
  double hov = std::min(d7[1], g7[1]) -
               std::max(d7[1] - d7[5], g7[1] - g7[5]);
  double inter = inter2d * std::max(0.0, hov);
  double ua = d7[3] * d7[4] * d7[5] + g7[3] * g7[4] * g7[5] - inter;
  return ua > 0 ? inter / ua : 0.0;
}

// Official computeStatistics for one frame at one threshold.
struct Stat { long tp = 0, fp = 0, fn = 0; };

Stat computeStatistics(int n_gt, int n_det, const double* iou,
                       const double* dc_ov, int n_dc,
                       const double* scores, const int32_t* ignored_gt,
                       const int32_t* ignored_det, double min_overlap,
                       double thresh, bool compute_fp,
                       std::vector<double>* v,
                       std::vector<char>& assigned,
                       std::vector<char>& ignored_threshold) {
  Stat st;
  assigned.assign(n_det, 0);
  ignored_threshold.assign(n_det, 0);
  if (compute_fp)
    for (int j = 0; j < n_det; ++j)
      if (scores[j] < thresh) ignored_threshold[j] = 1;

  for (int i = 0; i < n_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;
    for (int j = 0; j < n_det; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j])
        continue;
      double ov = iou[j * n_gt + i];
      if (ov <= min_overlap) continue;
      if (!compute_fp) {
        if (scores[j] > valid_detection) {
          det_idx = j;
          valid_detection = scores[j];
        }
      } else if ((ov > max_overlap || assigned_ignored_det) &&
                 ignored_det[j] == 0) {
        max_overlap = ov;
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = false;
      } else if (valid_detection == kNoDetection &&
                 ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = true;
      }
    }
    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      ++st.fn;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      ++st.tp;
      if (v) v->push_back(scores[det_idx]);
      assigned[det_idx] = 1;
    }
  }

  if (compute_fp) {
    for (int j = 0; j < n_det; ++j)
      if (!assigned[j] && ignored_det[j] == 0 && !ignored_threshold[j])
        ++st.fp;
    long nstuff = 0;
    for (int k = 0; k < n_dc; ++k)
      for (int j = 0; j < n_det; ++j) {
        if (assigned[j] || ignored_det[j] != 0 || ignored_threshold[j])
          continue;
        if (dc_ov[j * n_dc + k] > min_overlap) {
          assigned[j] = 1;
          ++nstuff;
        }
      }
    st.fp -= nstuff;
  }
  return st;
}

}  // namespace

extern "C" {

double kitti_ap(int metric, double min_iou, int n_frames,
                const int32_t* gt_counts, const double* gt_boxes7,
                const double* gt_bbox4, const int32_t* ignored_gt,
                const int32_t* dc_counts, const double* dc_bbox4,
                const int32_t* det_counts, const double* det_boxes7,
                const double* det_bbox4, const double* det_scores,
                const int32_t* ignored_det) {
  std::vector<int> gt_off(n_frames + 1, 0), det_off(n_frames + 1, 0),
      dc_off(n_frames + 1, 0);
  for (int f = 0; f < n_frames; ++f) {
    gt_off[f + 1] = gt_off[f] + gt_counts[f];
    det_off[f + 1] = det_off[f] + det_counts[f];
    dc_off[f + 1] = dc_off[f] + dc_counts[f];
  }

  // Precompute IoU matrices per frame (det-major), plus criterion-0
  // DontCare overlaps (image metric only; for ground/3d the official
  // overlap with a DontCare row's degenerate 3D box is identically 0).
  std::vector<double> iou;
  std::vector<long> iou_pos(n_frames + 1, 0), dc_pos(n_frames + 1, 0);
  for (int f = 0; f < n_frames; ++f) {
    iou_pos[f + 1] = iou_pos[f] + (long)det_counts[f] * gt_counts[f];
    dc_pos[f + 1] = dc_pos[f] + (long)det_counts[f] * dc_counts[f];
  }
  iou.resize(iou_pos[n_frames]);
  std::vector<double> dc_ov(dc_pos[n_frames], 0.0);
  for (int f = 0; f < n_frames; ++f) {
    for (int d = 0; d < det_counts[f]; ++d) {
      int di = det_off[f] + d;
      for (int g = 0; g < gt_counts[f]; ++g) {
        int gi = gt_off[f] + g;
        iou[iou_pos[f] + (long)d * gt_counts[f] + g] =
            overlap(metric, det_boxes7 + 7 * di, det_bbox4 + 4 * di,
                    gt_boxes7 + 7 * gi, gt_bbox4 + 4 * gi);
      }
      if (metric == 0) {
        const double* db = det_bbox4 + 4 * di;
        double darea = (db[2] - db[0]) * (db[3] - db[1]);
        for (int k = 0; k < dc_counts[f]; ++k) {
          const double* r = dc_bbox4 + 4 * (dc_off[f] + k);
          double x1 = std::max(db[0], r[0]);
          double y1 = std::max(db[1], r[1]);
          double x2 = std::min(db[2], r[2]);
          double y2 = std::min(db[3], r[3]);
          double inter =
              std::max(0.0, x2 - x1) * std::max(0.0, y2 - y1);
          dc_ov[dc_pos[f] + (long)d * dc_counts[f] + k] =
              darea > 0 ? inter / darea : 0.0;
        }
      }
    }
  }

  // Pass 1: TP scores via highest-score matching -> thresholds.
  std::vector<double> tp_scores;
  long n_valid_gt = 0;
  std::vector<char> assigned, ign_thr;
  for (int f = 0; f < n_frames; ++f) {
    for (int g = 0; g < gt_counts[f]; ++g)
      if (ignored_gt[gt_off[f] + g] == 0) ++n_valid_gt;
    computeStatistics(gt_counts[f], det_counts[f], &iou[iou_pos[f]],
                      dc_counts[f] ? &dc_ov[dc_pos[f]] : nullptr,
                      dc_counts[f], det_scores + det_off[f],
                      ignored_gt + gt_off[f], ignored_det + det_off[f],
                      min_iou, 0.0, false, &tp_scores, assigned,
                      ign_thr);
  }
  if (n_valid_gt == 0) return 0.0;
  std::sort(tp_scores.begin(), tp_scores.end(), std::greater<double>());
  std::vector<double> thresholds;
  double cur_recall = 0.0;
  for (size_t i = 0; i < tp_scores.size(); ++i) {
    double l = double(i + 1) / n_valid_gt;
    double r = i < tp_scores.size() - 1 ? double(i + 2) / n_valid_gt : l;
    if ((r - cur_recall) < (cur_recall - l) &&
        i < tp_scores.size() - 1)
      continue;
    thresholds.push_back(tp_scores[i]);
    cur_recall += 1.0 / (kSamplePts - 1);
  }

  std::vector<double> precision(kSamplePts, 0.0);
  for (size_t ti = 0; ti < thresholds.size(); ++ti) {
    long tp = 0, fp = 0;
    for (int f = 0; f < n_frames; ++f) {
      Stat st = computeStatistics(
          gt_counts[f], det_counts[f], &iou[iou_pos[f]],
          dc_counts[f] ? &dc_ov[dc_pos[f]] : nullptr, dc_counts[f],
          det_scores + det_off[f], ignored_gt + gt_off[f],
          ignored_det + det_off[f], min_iou, thresholds[ti], true,
          nullptr, assigned, ign_thr);
      tp += st.tp;
      fp += st.fp;
    }
    precision[ti] = (tp + fp) > 0 ? double(tp) / (tp + fp) : 0.0;
  }

  // right-monotonize, then the official 11-of-41-point average
  for (size_t i = 0; i < thresholds.size(); ++i)
    precision[i] =
        *std::max_element(precision.begin() + i, precision.end());
  double ap = 0.0;
  for (int i = 0; i < kSamplePts; i += 4) ap += precision[i];
  return 100.0 * ap / 11.0;
}

}  // extern "C"
