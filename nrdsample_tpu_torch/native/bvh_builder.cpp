// Binned-SAH BVH order builder on the host: the triangle order that
// ops/cluster.build_clusters cuts into 128-triangle clusters. A copy of
// nrdsample_tpu/native/bvh_builder.cpp, so that both packages order a scene
// the same way (float32 arithmetic, the same splits and median fallback).
//
// C ABI, loaded with ctypes by nrdsample_tpu_torch/native/__init__.py:
//   build_bvh_order(tri_min, tri_max, n, leaf_size, order_out) -> depth
// scene/bvh.build_order is its plain numpy version; the two agree on small
// scenes, and this one takes about a second for a million triangles.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 bvh_builder.cpp -o libbvh_builder.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Aabb {
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  void grow(const float* lo, const float* hi) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], lo[k]);
      mx[k] = std::max(mx[k], hi[k]);
    }
  }
  void grow(const Aabb& o) { grow(o.mn, o.mx); }
  float area() const {
    float d0 = std::max(mx[0] - mn[0], 0.f);
    float d1 = std::max(mx[1] - mn[1], 0.f);
    float d2 = std::max(mx[2] - mn[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }
};

struct Task {
  int64_t lo, hi;
  int depth;
};

}  // namespace

extern "C" {

// Returns max tree depth (>0) on success, -1 on error.
// tri_min/tri_max: n*3 floats. order_out: n int64 (leaf-contiguous ordering).
int build_bvh_order(const float* tri_min, const float* tri_max, int64_t n,
                    int leaf_size, int64_t* order_out) {
  if (n <= 0 || leaf_size <= 0) return -1;
  std::vector<float> centroid(n * 3);
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k)
      centroid[i * 3 + k] = 0.5f * (tri_min[i * 3 + k] + tri_max[i * 3 + k]);

  for (int64_t i = 0; i < n; ++i) order_out[i] = i;

  int max_depth = 1;
  std::vector<Task> stack;
  stack.push_back({0, n, 1});
  std::vector<int64_t> tmp(n);

  while (!stack.empty()) {
    Task task = stack.back();
    stack.pop_back();
    const int64_t lo = task.lo, hi = task.hi;
    const int64_t cnt = hi - lo;
    max_depth = std::max(max_depth, task.depth);
    if (cnt <= leaf_size) continue;

    // centroid bounds
    Aabb cb;
    for (int64_t i = lo; i < hi; ++i) {
      const float* c = &centroid[order_out[i] * 3];
      cb.grow(c, c);
    }
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; ++k) ext[k] = cb.mx[k] - cb.mn[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int64_t mid;
    if (ext[axis] < 1e-12f) {
      mid = lo + cnt / 2;
    } else {
      // binned SAH
      const float scale = kNumBins * (1.f - 1e-6f) / ext[axis];
      Aabb bin_bounds[kNumBins];
      int64_t bin_count[kNumBins] = {0};
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t t = order_out[i];
        int b = (int)((centroid[t * 3 + axis] - cb.mn[axis]) * scale);
        b = std::min(std::max(b, 0), kNumBins - 1);
        bin_count[b]++;
        bin_bounds[b].grow(&tri_min[t * 3], &tri_max[t * 3]);
      }
      // sweep for best split
      float left_area[kNumBins], right_area[kNumBins];
      int64_t left_cnt[kNumBins], right_cnt[kNumBins];
      {
        Aabb acc;
        int64_t c = 0;
        for (int b = 0; b < kNumBins; ++b) {
          acc.grow(bin_bounds[b]);
          c += bin_count[b];
          left_area[b] = acc.area();
          left_cnt[b] = c;
        }
      }
      {
        Aabb acc;
        int64_t c = 0;
        for (int b = kNumBins - 1; b >= 0; --b) {
          acc.grow(bin_bounds[b]);
          c += bin_count[b];
          right_area[b] = acc.area();
          right_cnt[b] = c;
        }
      }
      int best_bin = -1;
      float best_cost = std::numeric_limits<float>::infinity();
      for (int b = 0; b < kNumBins - 1; ++b) {
        if (left_cnt[b] == 0 || right_cnt[b + 1] == 0) continue;
        const float cost =
            left_area[b] * left_cnt[b] + right_area[b + 1] * right_cnt[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
        }
      }
      if (best_bin < 0) {
        mid = lo + cnt / 2;
      } else {
        // stable partition by bin
        int64_t nl = 0;
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t t = order_out[i];
          int b = (int)((centroid[t * 3 + axis] - cb.mn[axis]) * scale);
          b = std::min(std::max(b, 0), kNumBins - 1);
          if (b <= best_bin) tmp[lo + nl++] = t;
        }
        int64_t nr = 0;
        for (int64_t i = lo; i < hi; ++i) {
          const int64_t t = order_out[i];
          int b = (int)((centroid[t * 3 + axis] - cb.mn[axis]) * scale);
          b = std::min(std::max(b, 0), kNumBins - 1);
          if (b > best_bin) tmp[lo + nl + nr++] = t;
        }
        std::memcpy(&order_out[lo], &tmp[lo], cnt * sizeof(int64_t));
        mid = lo + nl;
      }
    }
    if (mid == lo || mid == hi) {
      // median fallback: nth_element by centroid
      mid = lo + cnt / 2;
      std::nth_element(
          &order_out[lo], &order_out[mid], &order_out[hi],
          [&](int64_t a, int64_t b) {
            return centroid[a * 3 + axis] < centroid[b * 3 + axis];
          });
    }
    stack.push_back({mid, hi, task.depth + 1});
    stack.push_back({lo, mid, task.depth + 1});
  }
  return max_depth;
}

}  // extern "C"
