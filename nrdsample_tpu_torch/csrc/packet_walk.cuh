// The warp-granular walk shared by the two packet kernels (packet_hit.cu, the
// resident one, and packet_hit_stream.cu, the streamed one): the packet and
// cluster sizes, the ray and its per-ray cluster cull, the walk over a
// packet's worklist, the test of one cluster's 128 triangles, the warp's
// ring of tiles, and the whole walk of a packet (walk_packet), which both
// kernels run.
//
// A 128-thread block takes one packet and each of its four warps walks the
// packet's worklist on its own, over its own 32 rays. The keys bound every
// ray's entry, so they bound each warp's too. Per entry, each lane computes
// its ray's entry into the cluster's box with the plain scan's arithmetic
// (ops/cluster.py:_cluster_entry: the 1e-12 guard of the direction, the clamp
// at 0, tnear <= tfar and tnear < t_max); the warp tests the cluster's 128
// triangles only if some lane's entry is below its best t, and only those
// lanes fold hits in, with a strict t < best, so the first hit in walk order
// wins a tie. A warp stops when the next key is at or past its largest best
// t, in any-hit mode also once its 32 rays are all blocked inside their
// t_max. The worklist is read 32 entries at a time, one per lane (key,
// cluster id and box), and handed round by shuffles.
//
// The tile source: there is no block barrier, and each warp keeps a private
// ring of kStages shared-memory tiles (4.6 KB each, a cluster's 9 planes,
// plane-major as in the slab), filled by its own cp.async copies, 9
// sixteen-byte copies per lane, one candidate cluster ahead of its tests;
// the tests read each tile 4 triangles per 16-byte broadcast. 36 KB of
// shared memory per block.

#pragma once

#include <cuda_pipeline.h>
#include <math.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace nrd {

constexpr int kRays = 128;      // rays per packet = threads per block
constexpr int kTris = 128;      // triangles per cluster
constexpr int kSlabRows = 16;   // slab rows per cluster (rows 0..8 used)
constexpr int kWarps = kRays / 32;
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTMax = 1e5f;               // intersect.T_MAX: the entry of a missed box
constexpr float kDirEps = (float)1e-12;     // _cluster_entry's guard of |d|
constexpr int kTileFloats = 9 * kTris;      // slab rows 0..8 of one cluster
constexpr int kGroups = kTris / 4;          // float4 groups of 4 triangles per plane
constexpr int kStages = 2;                  // tiles in a warp's ring

// Order-preserving map of a float to an unsigned (and back), so that the
// warp max is an integer max even for negative values.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tm;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < kDirEps ? (d >= 0.0f ? kDirEps : -kDirEps) : d);
}

// Ray `ray` of the (R, 3) origins and directions and the (R,) t_max.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ direction,
                                        const float* __restrict__ t_max, int64_t ray) {
  Ray r;
  r.ox = origin[3 * ray];
  r.oy = origin[3 * ray + 1];
  r.oz = origin[3 * ray + 2];
  r.dx = direction[3 * ray];
  r.dy = direction[3 * ray + 1];
  r.dz = direction[3 * ray + 2];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  r.tm = t_max[ray];
  return r;
}

// _cluster_entry of one ray and one box: the entry distance, or kTMax where
// the ray misses the box or enters it at or past its t_max.
__device__ __forceinline__ float box_entry(const Ray& r, float x0, float y0, float z0, float x1,
                                           float y1, float z1) {
  float t0 = (x0 - r.ox) * r.ix, t1 = (x1 - r.ox) * r.ix;
  float tmin = fminf(t0, t1), tmax = fmaxf(t0, t1);
  t0 = (y0 - r.oy) * r.iy;
  t1 = (y1 - r.oy) * r.iy;
  tmin = fmaxf(tmin, fminf(t0, t1));
  tmax = fminf(tmax, fmaxf(t0, t1));
  t0 = (z0 - r.oz) * r.iz;
  t1 = (z1 - r.oz) * r.iz;
  tmin = fmaxf(tmin, fminf(t0, t1));
  tmax = fminf(tmax, fmaxf(t0, t1));
  const float tnear = fmaxf(tmin, 0.0f);
  return (tnear <= tmax && tnear < r.tm) ? tnear : kTMax;
}

__device__ __forceinline__ float warp_max(float bt) {
  return unordered(__reduce_max_sync(kFull, ordered(bt)));
}

// A warp's walk over its packet's worklist row: 32 entries in registers, entry
// base + lane on lane `lane`, and the next entry to look at.
struct Walk {
  const int* order;
  const float* keys;
  const float* bmin;
  const float* bmax;
  int n, next, base;
  float key, b[6];
  int cid;
  bool ended;

  // The walk of packet `packet` over its (n_clusters,) worklist row, with
  // its first 32 entries loaded.
  __device__ __forceinline__ Walk(const int* order_rows, const float* key_rows,
                                  const float* bounds_min, const float* bounds_max,
                                  int n_clusters, int64_t packet, int lane)
      : order(order_rows + packet * n_clusters),
        keys(key_rows + packet * n_clusters),
        bmin(bounds_min),
        bmax(bounds_max),
        n(n_clusters),
        next(0),
        ended(false) {
    load(0, lane);
  }

  __device__ __forceinline__ void load(int at, int lane) {
    base = at;
    const int i = at + lane;
    key = i < n ? __ldg(keys + i) : INFINITY;
    cid = i < n ? __ldg(order + i) : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b[k] = __ldg(bmin + 3 * cid + k);
      b[3 + k] = __ldg(bmax + 3 * cid + k);
    }
  }
};

// A cluster some lane of the warp has to test: its id, key and this lane's
// entry into its box.
struct Candidate {
  int cid;
  float key, entry;
};

__device__ __forceinline__ bool lane_active(float entry, float bt, float tm, int any_hit) {
  return entry < kTMax && entry < bt && !(any_hit && bt < tm);
}

// The next worklist entry that some lane has to test with the lanes' current
// best t, or false once the walk has ended: the next key is at or past the
// warp's largest best t, or (any hit) every ray is blocked. The keys only
// grow and the best t only falls, so an entry skipped here stays skipped
// and an end stays an end.
__device__ __forceinline__ bool next_candidate(Walk& w, const Ray& r, float bt, int any_hit,
                                               int lane, Candidate& c) {
  if (w.ended) return false;
  const float wmax = warp_max(bt);
  const bool open = __any_sync(kFull, bt >= r.tm);
  for (; w.next < w.n; ++w.next) {
    int j = w.next - w.base;
    if (j == kLanes) {
      w.load(w.next, lane);
      j = 0;
    }
    const float key = __shfl_sync(kFull, w.key, j);
    if (key >= wmax || (any_hit && !open)) break;
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = __shfl_sync(kFull, w.b[k], j);
    const float e = box_entry(r, b[0], b[1], b[2], b[3], b[4], b[5]);
    if (__any_sync(kFull, lane_active(e, bt, r.tm, any_hit))) {
      c.cid = __shfl_sync(kFull, w.cid, j);
      c.key = key;
      c.entry = e;
      ++w.next;
      return true;
    }
  }
  w.ended = true;
  return false;
}

// Test the lane's ray against the 128 triangles of the cluster in `tile`
// (plane r at tile[r * 128 + k]), 4 triangles per 16-byte read, folding hits
// in where `active`; with need_uv = 0 no u/v is kept (they stay 0).
__device__ __forceinline__ void test_cluster(const Ray& r, const float* tile, int base,
                                             bool active, int need_uv, float& bt, float& bu,
                                             float& bv, int& bi) {
  const float4* p4 = reinterpret_cast<const float4*>(tile);
#pragma unroll 2
  for (int g = 0; g < kGroups; ++g) {
    float q[9][4];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float4 x = p4[k * kGroups + g];
      q[k][0] = x.x;
      q[k][1] = x.y;
      q[k][2] = x.z;
      q[k][3] = x.w;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float t, u, v;
      if (mt_hit_values(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, q[0][s], q[1][s], q[2][s], q[3][s],
                        q[4][s], q[5][s], q[6][s], q[7][s], q[8][s], t, u, v) &&
          active && t < bt) {
        bt = t;
        if (need_uv) {
          bu = u;
          bv = v;
        }
        bi = base + 4 * g + s;
      }
    }
  }
}

// Start this lane's share of the copy of cluster cid's planes into dst.
__device__ __forceinline__ void fetch_cluster(float* dst, const float* __restrict__ slab, int cid,
                                              int lane) {
  const float* src = slab + (int64_t)cid * kSlabRows * kTris;
  for (int c = lane; c < kTileFloats / 4; c += kLanes)
    __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
}

// The walk of packet blockIdx.x by its block of kRays threads, one ray per
// thread: each warp's walk over its 32 rays, the tile of candidate c tested
// while the copy of the next candidate's tile is in flight. Writes the
// ray's (t, u, v, tri).
__device__ __forceinline__ void walk_packet(
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_max, const int* __restrict__ order, const float* __restrict__ keys,
    const float* __restrict__ slab, const float* __restrict__ bounds_min,
    const float* __restrict__ bounds_max, int n_clusters, int any_hit, int need_uv,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ tri_out) {
  __shared__ __align__(16) float tiles[kWarps * kStages * kTileFloats];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int64_t ray = (int64_t)blockIdx.x * kRays + threadIdx.x;
  const Ray r = load_ray(origin, direction, t_max, ray);
  float bt = r.tm, bu = 0.0f, bv = 0.0f;
  int bi = -1;
  Walk w(order, keys, bounds_min, bounds_max, n_clusters, blockIdx.x, lane);
  float* ring = tiles + warp * kStages * kTileFloats;
  Candidate c, nxt;
  bool has = next_candidate(w, r, bt, any_hit, lane, c);
  if (has) fetch_cluster(ring, slab, c.cid, lane);
  __pipeline_commit();
  bool has_nxt = has && next_candidate(w, r, bt, any_hit, lane, nxt);
  if (has_nxt) fetch_cluster(ring + kTileFloats, slab, nxt.cid, lane);
  __pipeline_commit();
  int stage = 0;
  while (has) {
    __pipeline_wait_prior(1);   // this lane's copies of the current tile have landed
    __syncwarp();               // and every other lane's
    // the lanes' best t may have fallen since the candidate was found
    const bool active = lane_active(c.entry, bt, r.tm, any_hit);
    if (c.key < warp_max(bt) && __any_sync(kFull, active))
      test_cluster(r, ring + stage * kTileFloats, c.cid * kTris, active, need_uv, bt, bu, bv, bi);
    __syncwarp();               // every lane is done with the tile before it is refilled
    has = has_nxt;
    c = nxt;
    has_nxt = has && next_candidate(w, r, bt, any_hit, lane, nxt);
    if (has_nxt) fetch_cluster(ring + stage * kTileFloats, slab, nxt.cid, lane);
    __pipeline_commit();
    stage ^= 1;
  }
  __pipeline_wait_prior(0);     // nothing in flight past the end
  t_out[ray] = bt;
  u_out[ray] = bu;
  v_out[ray] = bv;
  tri_out[ray] = bi;
}

}  // namespace nrd
