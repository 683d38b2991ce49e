// Greedy one-to-one boundary matching (BSDS protocol hot loop).
//
// The BSDS benchmark assigns predicted boundary pixels to ground-truth
// boundary pixels one-to-one within a distance tolerance (CSA assignment in
// the original MATLAB bench; greedy-by-increasing-distance here, an
// approximation whose gap to the optimal matcher the tests measure). This is
// the host-side hot loop of the greedy matcher, O(candidate pairs log pairs);
// its Python version is metrics/boundary.py::_match_one_greedy_plain.
//
// Build: g++ -O3 -shared -fPIC boundary_match.cpp -o libboundary_match.so
// Loaded via ctypes (utils/native.py). Plain C ABI, no dependencies.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Cand {
    float d2;
    int32_t p;
    int32_t g;
};

}  // namespace

extern "C" {

// pred / gt: (n, 2) row-major int32 (y, x) boundary pixel coordinates.
// tol: matching tolerance (euclidean, pixels).
// pred_matched / gt_matched: out uint8 arrays (preallocated, zeroed by callee).
// Returns the number of matched pairs.
int64_t greedy_match(const int32_t* pred, int64_t n_pred,
                     const int32_t* gt, int64_t n_gt,
                     double tol,
                     uint8_t* pred_matched, uint8_t* gt_matched) {
    std::fill(pred_matched, pred_matched + n_pred, 0);
    std::fill(gt_matched, gt_matched + n_gt, 0);
    if (n_pred == 0 || n_gt == 0) return 0;

    // bucket gt points into a uniform grid with cell size >= tol
    const int cell = std::max(1, (int)std::ceil(tol));
    int32_t ymin = INT32_MAX, xmin = INT32_MAX, ymax = INT32_MIN, xmax = INT32_MIN;
    for (int64_t i = 0; i < n_gt; ++i) {
        ymin = std::min(ymin, gt[2 * i]);
        ymax = std::max(ymax, gt[2 * i]);
        xmin = std::min(xmin, gt[2 * i + 1]);
        xmax = std::max(xmax, gt[2 * i + 1]);
    }
    const int gh = (ymax - ymin) / cell + 1;
    const int gw = (xmax - xmin) / cell + 1;
    std::vector<std::vector<int32_t>> grid((size_t)gh * gw);
    for (int64_t i = 0; i < n_gt; ++i) {
        const int cy = (gt[2 * i] - ymin) / cell;
        const int cx = (gt[2 * i + 1] - xmin) / cell;
        grid[(size_t)cy * gw + cx].push_back((int32_t)i);
    }

    const double tol2 = tol * tol;
    std::vector<Cand> cands;
    cands.reserve((size_t)n_pred * 4);
    for (int64_t i = 0; i < n_pred; ++i) {
        const int32_t py = pred[2 * i], px = pred[2 * i + 1];
        const int cy = (py - ymin) / cell, cx = (px - xmin) / cell;
        for (int dy = -1; dy <= 1; ++dy) {
            const int yy = cy + dy;
            if (yy < 0 || yy >= gh) continue;
            for (int dx = -1; dx <= 1; ++dx) {
                const int xx = cx + dx;
                if (xx < 0 || xx >= gw) continue;
                for (int32_t j : grid[(size_t)yy * gw + xx]) {
                    const double ddy = py - gt[2 * j];
                    const double ddx = px - gt[2 * j + 1];
                    const double d2 = ddy * ddy + ddx * ddx;
                    if (d2 <= tol2)
                        cands.push_back({(float)d2, (int32_t)i, j});
                }
            }
        }
    }
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) {
                  if (a.d2 != b.d2) return a.d2 < b.d2;
                  if (a.p != b.p) return a.p < b.p;
                  return a.g < b.g;
              });
    int64_t matched = 0;
    for (const Cand& c : cands) {
        if (!pred_matched[c.p] && !gt_matched[c.g]) {
            pred_matched[c.p] = 1;
            gt_matched[c.g] = 1;
            ++matched;
        }
    }
    return matched;
}

}  // extern "C"
