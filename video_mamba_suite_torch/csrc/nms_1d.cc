// 1-D segment NMS on the host, C++ with a plain C interface (ctypes).
//
// Capability match for upstream's CPU op (video-mamba-suite
// temporal-action-localization/libs/utils/csrc/nms_cpu.cpp:19-182), and a
// copy of the JAX package's csrc/nms_1d.cc: hard NMS and soft NMS
// (linear method=1 / gaussian method=2), same semantics as the
// float32 plain versions in tasks/tal/nms.py (nms_1d_ref, soft_nms_1d_ref).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// segs: (n, 2) [start, end]; scores: (n). keep_out: caller-allocated (n).
// Returns number kept; keep_out holds indices sorted by descending score.
std::int64_t nms_1d(const float* segs, const float* scores, std::int64_t n,
                    float iou_threshold, std::int64_t* keep_out) {
  std::vector<std::int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](std::int64_t a, std::int64_t b) {
                     return scores[a] > scores[b];
                   });
  std::vector<char> alive(n, 1);
  std::int64_t kept = 0;
  for (std::int64_t oi = 0; oi < n; ++oi) {
    const std::int64_t i = order[oi];
    if (!alive[i]) continue;
    keep_out[kept++] = i;
    alive[i] = 0;
    const float s1 = segs[2 * i], e1 = segs[2 * i + 1];
    for (std::int64_t oj = oi + 1; oj < n; ++oj) {
      const std::int64_t j = order[oj];
      if (!alive[j]) continue;
      const float s2 = segs[2 * j], e2 = segs[2 * j + 1];
      const float inter = std::max(0.f, std::min(e1, e2) - std::max(s1, s2));
      const float uni = (e1 - s1) + (e2 - s2) - inter;
      if (uni > 0 && inter / uni > iou_threshold) alive[j] = 0;
    }
  }
  return kept;
}

// Soft NMS. segs/scores are modified in place (decayed scores).
// out_inds gets the pick order; returns number of kept segments.
std::int64_t soft_nms_1d(float* segs, float* scores, std::int64_t n,
                         float iou_threshold, float sigma, float min_score,
                         std::int64_t method, std::int64_t* out_inds) {
  std::vector<char> alive(n, 1);
  std::int64_t kept = 0;
  for (std::int64_t step = 0; step < n; ++step) {
    std::int64_t best = -1;
    float best_s = -1e30f;
    for (std::int64_t i = 0; i < n; ++i)
      if (alive[i] && scores[i] > best_s) { best_s = scores[i]; best = i; }
    if (best < 0 || best_s < min_score) break;
    out_inds[kept++] = best;
    alive[best] = 0;
    const float s1 = segs[2 * best], e1 = segs[2 * best + 1];
    for (std::int64_t j = 0; j < n; ++j) {
      if (!alive[j]) continue;
      const float s2 = segs[2 * j], e2 = segs[2 * j + 1];
      const float inter = std::max(0.f, std::min(e1, e2) - std::max(s1, s2));
      const float uni = (e1 - s1) + (e2 - s2) - inter;
      const float iou = uni > 0 ? inter / uni : 0.f;
      float w = 1.f;
      if (method == 1) w = iou > iou_threshold ? 1.f - iou : 1.f;       // linear
      else if (method == 2) w = std::exp(-(iou * iou) / sigma);          // gaussian
      else w = iou > iou_threshold ? 0.f : 1.f;                          // hard
      scores[j] *= w;
      if (scores[j] < min_score) alive[j] = 0;
    }
  }
  return kept;
}

}  // extern "C"
