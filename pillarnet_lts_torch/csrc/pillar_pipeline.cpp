// Host C++ of the data pipeline's hot loops (the port's own copy of the
// repository's `csrc/pillar_pipeline.cpp`).
//
// What is hot on the host is the per-sample numpy pipeline that feeds the
// card: point-in-box crops for GT-AUG sampling and database creation,
// gaussian heatmap target stamping, BEV corner collision tests and sweep
// assembly. These are their C++ equivalents, with a plain C ABI for ctypes
// (no pybind11, no PyTorch headers).
//
// Build: `pillarnet_lts_torch/native` compiles this file with the host
// compiler at first use (-O3 -march=native -fPIC -std=c++17, -shared
// -pthread) into the git-ignored `build/pillarnet_lts_torch/`.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(start, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn, int64_t grain = 4096) {
  int nt = hw_threads();
  if (total < grain * 2 || nt <= 1) {
    fn(0, total);
    return;
  }
  nt = static_cast<int>(std::min<int64_t>(nt, (total + grain - 1) / grain));
  std::vector<std::thread> threads;
  int64_t chunk = (total + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(total, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Points-in-rotated-boxes membership matrix.
//
// points: (n_points, point_stride) row-major, xyz in the first 3 columns.
// boxes:  (n_boxes, box_dim) det3d layout (x, y, z, w, l, h, ..., yaw) —
//         yaw is the LAST column (matches `box_np_ops.points_in_rbbox`,
//         reference `det3d/core/bbox/box_np_ops.py:641`).
// out:    (n_points, n_boxes) uint8 (1 = inside).
void points_in_rbbox(const float* points, int64_t n_points,
                     int64_t point_stride, const float* boxes,
                     int64_t n_boxes, int64_t box_dim, uint8_t* out) {
  std::vector<float> cx(n_boxes), cy(n_boxes), cz(n_boxes);
  std::vector<float> hw(n_boxes), hl(n_boxes), hh(n_boxes);
  std::vector<float> cosr(n_boxes), sinr(n_boxes);
  for (int64_t b = 0; b < n_boxes; ++b) {
    const float* bx = boxes + b * box_dim;
    cx[b] = bx[0];
    cy[b] = bx[1];
    cz[b] = bx[2];
    hw[b] = 0.5f * bx[3];
    hl[b] = 0.5f * bx[4];
    hh[b] = 0.5f * bx[5];
    float yaw = bx[box_dim - 1];
    cosr[b] = std::cos(yaw);
    sinr[b] = std::sin(yaw);
  }
  parallel_for(n_points, [&](int64_t lo, int64_t hi) {
    for (int64_t p = lo; p < hi; ++p) {
      const float* pt = points + p * point_stride;
      uint8_t* row = out + p * n_boxes;
      for (int64_t b = 0; b < n_boxes; ++b) {
        float dx = pt[0] - cx[b];
        float dy = pt[1] - cy[b];
        float dz = pt[2] - cz[b];
        // canonical frame: local = world @ R(yaw)^T convention used by
        // corners_nd/rotation_2d (see box_np_ops.points_in_rbbox)
        float lx = dx * cosr[b] - dy * sinr[b];
        float ly = dx * sinr[b] + dy * cosr[b];
        row[b] = (std::fabs(lx) <= hw[b] && std::fabs(ly) <= hl[b] &&
                  std::fabs(dz) <= hh[b])
                     ? 1
                     : 0;
      }
    }
  });
}

// Gaussian heatmap stamping: elementwise max of a truncated gaussian patch.
// heatmap: (H, W) row-major (one class plane).
// centers: (n, 2) float (x, y); radii: (n,) int32.
// Mirrors draw_umich_gaussian (`det3d/core/utils/center_utils.py:48-63`).
void draw_gaussians(float* heatmap, int64_t H, int64_t W,
                    const float* centers, const int32_t* radii, int64_t n,
                    float k) {
  for (int64_t i = 0; i < n; ++i) {
    int x = static_cast<int>(centers[i * 2 + 0]);
    int y = static_cast<int>(centers[i * 2 + 1]);
    int radius = radii[i];
    int diameter = 2 * radius + 1;
    float sigma = diameter / 6.0f;
    float inv = 1.0f / (2.0f * sigma * sigma);

    int left = std::min<int>(x, radius);
    int right = std::min<int>(static_cast<int>(W) - x, radius + 1);
    int top = std::min<int>(y, radius);
    int bottom = std::min<int>(static_cast<int>(H) - y, radius + 1);
    if (left + right <= 0 || top + bottom <= 0) continue;

    for (int dy = -top; dy < bottom; ++dy) {
      float* rowp = heatmap + (y + dy) * W;
      for (int dx = -left; dx < right; ++dx) {
        float g = std::exp(-(dx * dx + dy * dy) * inv) * k;
        float& cell = rowp[x + dx];
        cell = std::max(cell, g);
      }
    }
  }
}

// BEV corner-quad collision matrix; corners (n, 4, 2) / (m, 4, 2); out (n, m).
// Same decision procedure as the reference numba kernel
// (`det3d/core/sampler/preprocess.py:849-928`): standup prefilter, strict
// edge-orientation intersection tests, strict full-containment fallback.
static inline bool seg_side(const float* A, const float* C, const float* D) {
  return (D[1] - A[1]) * (C[0] - A[0]) > (C[1] - A[1]) * (D[0] - A[0]);
}

void box_collision_test(const float* boxes, int64_t n, const float* qboxes,
                        int64_t m, uint8_t* out) {
  std::vector<float> su_a(n * 4), su_b(m * 4);
  auto standup = [](const float* c, float* su) {
    su[0] = std::min(std::min(c[0], c[2]), std::min(c[4], c[6]));
    su[1] = std::min(std::min(c[1], c[3]), std::min(c[5], c[7]));
    su[2] = std::max(std::max(c[0], c[2]), std::max(c[4], c[6]));
    su[3] = std::max(std::max(c[1], c[3]), std::max(c[5], c[7]));
  };
  for (int64_t i = 0; i < n; ++i) standup(boxes + i * 8, su_a.data() + i * 4);
  for (int64_t j = 0; j < m; ++j) standup(qboxes + j * 8, su_b.data() + j * 4);

  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* A = boxes + i * 8;
      const float* sa = su_a.data() + i * 4;
      for (int64_t j = 0; j < m; ++j) {
        uint8_t& res = out[i * m + j];
        res = 0;
        const float* B = qboxes + j * 8;
        const float* sb = su_b.data() + j * 4;
        float iw = std::min(sa[2], sb[2]) - std::max(sa[0], sb[0]);
        if (iw <= 0) continue;
        float ih = std::min(sa[3], sb[3]) - std::max(sa[1], sb[1]);
        if (ih <= 0) continue;

        bool hit = false;
        for (int k = 0; k < 4 && !hit; ++k) {
          const float* a0 = A + k * 2;
          const float* a1 = A + ((k + 1) % 4) * 2;
          for (int l = 0; l < 4; ++l) {
            const float* c0 = B + l * 2;
            const float* c1 = B + ((l + 1) % 4) * 2;
            bool acd = seg_side(a0, c0, c1);
            bool bcd = seg_side(a1, c0, c1);
            if (acd != bcd) {
              // reference: abc = cross(A,B,C) > 0 via
              // (C1-A1)(B0-A0) > (B1-A1)(C0-A0)
              bool abc = (c0[1] - a0[1]) * (a1[0] - a0[0]) >
                         (a1[1] - a0[1]) * (c0[0] - a0[0]);
              bool abd = (c1[1] - a0[1]) * (a1[0] - a0[0]) >
                         (a1[1] - a0[1]) * (c1[0] - a0[0]);
              if (abc != abd) {
                hit = true;
                break;
              }
            }
          }
        }
        if (!hit) {
          // containment: all corners of one quad strictly inside the other
          auto contains = [](const float* poly, const float* pts) {
            for (int l = 0; l < 4; ++l) {
              const float* p = pts + l * 2;
              for (int k = 0; k < 4; ++k) {
                const float* c0 = poly + k * 2;
                const float* c1 = poly + ((k + 1) % 4) * 2;
                float vx = c1[0] - c0[0];
                float vy = c1[1] - c0[1];
                float cross = vy * (c0[0] - p[0]) - vx * (c0[1] - p[1]);
                if (cross >= 0) return false;
              }
            }
            return true;
          };
          hit = contains(A, B) || contains(B, A);
        }
        res = hit ? 1 : 0;
      }
    }
  });
}

// Multi-sweep assembly: transform sweep points into the keyframe and append
// a time-lag channel (`det3d/datasets/pipelines/loading.py:49-61` hot loop).
// src: (n, in_dim) float rows; tf: 4x4 row-major transform (or null);
// dst: (n, in_dim + 1) output rows (xyz transformed, extras copied,
// time appended).
void transform_sweep(const float* src, int64_t n, int64_t in_dim,
                     const float* tf, float time_lag, float* dst) {
  const bool has_tf = tf != nullptr;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* s = src + i * in_dim;
      float* d = dst + i * (in_dim + 1);
      if (has_tf) {
        float x = s[0], y = s[1], z = s[2];
        d[0] = tf[0] * x + tf[1] * y + tf[2] * z + tf[3];
        d[1] = tf[4] * x + tf[5] * y + tf[6] * z + tf[7];
        d[2] = tf[8] * x + tf[9] * y + tf[10] * z + tf[11];
      } else {
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
      }
      for (int64_t c = 3; c < in_dim; ++c) d[c] = s[c];
      d[in_dim] = time_lag;
    }
  });
}

}  // extern "C"
