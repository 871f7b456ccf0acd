// COCO evaluation core — native replacement for the pycocotools C
// extension the reference depends on (SURVEY.md §2.4: `_mask` RLE ops +
// COCOeval's per-image greedy matching loops, consumed at
// detection/coco_eval.py:10-12 / yolo/procedures/eval_results.py:1-3).
//
// Exposed via a plain C ABI for ctypes:
//   * evaluate_img  — the greedy detection<->GT matcher for one
//     (image, category, area-range) cell across all IoU thresholds.
//   * bbox_iou_xywh — crowd-aware IoU matrix.
//   * rle_encode / rle_decode / rle_area / rle_iou — run-length mask
//     ops (column-major Fortran order, pycocotools-compatible counts).
//
// A copy of the JAX package's native/coco_eval_core.cpp. It is host code,
// not a GPU kernel: eval/native.py builds it at first use with
// kernels/_build.py (g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC)
// into the package's _build/ directory, and a failed build raises.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// IoU of xywh boxes; gt_crowd uses union = det area.
void bbox_iou_xywh(const double* dt, int n_dt, const double* gt, int n_gt,
                   const uint8_t* gt_crowd, double* out) {
  for (int i = 0; i < n_dt; ++i) {
    const double dx1 = dt[i * 4], dy1 = dt[i * 4 + 1];
    const double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    const double dx2 = dx1 + dw, dy2 = dy1 + dh;
    const double da = dw * dh;
    for (int j = 0; j < n_gt; ++j) {
      const double gx1 = gt[j * 4], gy1 = gt[j * 4 + 1];
      const double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      const double gx2 = gx1 + gw, gy2 = gy1 + gh;
      const double iw = std::max(0.0, std::min(dx2, gx2) - std::max(dx1, gx1));
      const double ih = std::max(0.0, std::min(dy2, gy2) - std::max(dy1, gy1));
      const double inter = iw * ih;
      const double uni = gt_crowd[j] ? da : da + gw * gh - inter;
      out[i * n_gt + j] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// Greedy matcher for one (img, cat) cell.
//   iou:        [n_dt, n_gt] precomputed (dt score-desc, gt
//               non-ignored-first order)
//   gt_ignore:  [n_gt]
//   gt_crowd:   [n_gt]
//   thrs:       [n_thr]
// Outputs:
//   dt_match:   [n_thr, n_dt]  (0 = unmatched, else gt index + 1)
//   dt_ignore:  [n_thr, n_dt]
void evaluate_img(const double* iou, int n_dt, int n_gt,
                  const uint8_t* gt_ignore, const uint8_t* gt_crowd,
                  const double* thrs, int n_thr,
                  int64_t* dt_match, uint8_t* dt_ignore) {
  std::vector<int64_t> gt_match(n_gt);
  for (int t = 0; t < n_thr; ++t) {
    std::fill(gt_match.begin(), gt_match.end(), 0);
    const double thr = thrs[t];
    for (int d = 0; d < n_dt; ++d) {
      double best = std::min(thr, 1.0 - 1e-10);
      int best_g = -1;
      for (int g = 0; g < n_gt; ++g) {
        if (gt_match[g] > 0 && !gt_crowd[g]) continue;
        // once matched to a non-ignored gt, stop at ignored ones
        if (best_g > -1 && !gt_ignore[best_g] && gt_ignore[g]) break;
        const double v = iou[d * n_gt + g];
        if (v < best) continue;
        best = v;
        best_g = g;
      }
      if (best_g == -1) continue;
      dt_ignore[t * n_dt + d] = gt_ignore[best_g];
      dt_match[t * n_dt + d] = best_g + 1;
      gt_match[best_g] = d + 1;
    }
  }
}

// ------------------------- RLE mask ops ------------------------------
// Counts alternate runs of 0s and 1s over the mask flattened in
// Fortran (column-major) order, starting with zeros — the pycocotools
// convention.

// mask: [h, w] uint8 (C order in memory); counts out buffer must hold
// h*w+1 entries; returns the number of runs.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts) {
  int n = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      const uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        counts[n++] = run;
        run = 1;
        prev = v;
      }
    }
  }
  counts[n++] = run;
  return n;
}

void rle_decode(const uint32_t* counts, int n, int h, int w,
                uint8_t* mask) {
  std::memset(mask, 0, (size_t)h * w);
  uint8_t v = 0;
  long pos = 0;
  for (int i = 0; i < n; ++i) {
    for (uint32_t k = 0; k < counts[i]; ++k) {
      if (v) {
        const long x = pos / h, y = pos % h;
        mask[y * w + x] = 1;
      }
      ++pos;
    }
    v = !v;
  }
}

double rle_area(const uint32_t* counts, int n) {
  double area = 0;
  for (int i = 1; i < n; i += 2) area += counts[i];
  return area;
}

// IoU between two RLE masks without decoding (merge-run walk).
double rle_iou(const uint32_t* a, int na, const uint32_t* b, int nb,
               uint8_t a_crowd) {
  double inter = 0, area_a = 0, area_b = 0;
  long ai = 0, bi = 0;          // run indices
  long ar = na > 0 ? a[0] : 0;  // remaining in current run
  long br = nb > 0 ? b[0] : 0;
  uint8_t av = 0, bv = 0;       // current values
  for (int i = 1; i < na; i += 2) area_a += a[i];
  for (int i = 1; i < nb; i += 2) area_b += b[i];
  while (ai < na && bi < nb) {
    const long step = std::min(ar, br);
    if (av && bv) inter += step;
    ar -= step;
    br -= step;
    if (ar == 0 && ++ai < na) { ar = a[ai]; av = !av; }
    if (br == 0 && ++bi < nb) { br = b[bi]; bv = !bv; }
  }
  const double uni = a_crowd ? area_b : area_a + area_b - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // extern "C"
