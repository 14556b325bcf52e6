// Packet closest hit (and any hit) over 128-triangle clusters.
//
// Replaces the resident Pallas TPU kernel
// nrdsample_tpu/ops/packet.py:_packet_kernel (its hoisted loop
// _one_packet_hoisted), reached through closest_hit_packet and
// any_hit_packet. Function: 128 rays form a packet; stage 1 (PyTorch, in
// ops/packet.py) gives each packet a worklist of the clusters its rays enter,
// sorted by the packet's nearest entry distance, with keys rounded down. The
// packet walks its list in order, testing every ray against the 128
// triangles of each cluster (Möller-Trumbore of moller_trumbore.cuh, the
// plain version's operation order), and folds hits into (t, u, v, tri) with a
// strict t < best, so the first hit in walk order wins. The walk stops when
// the next key is at or past the largest best t of the packet; in any-hit
// mode also once every ray is blocked inside its t_max. On a miss t = t_max,
// u = v = 0 and tri = -1.
//
// What bounds it on the card: each ray reads 28 bytes and writes 16, but
// tests 128 triangles per visited cluster at ~45 float32 operations and one
// IEEE divide each: operations, not bytes, bound it. The worklist walk is the
// other cost: a packet whose rays diverge visits many clusters.
//
// Design: one thread block of 128 threads per packet, one ray per thread.
// Per cluster, the block copies the 9 x 128 floats of the cluster's slab
// block into shared memory (4.6 KB), transposed so that triangle k's 9
// floats are contiguous; every thread then reads the same triangle at the
// same time (a broadcast) and the inner loop is register arithmetic. The
// stop test needs the packet's largest best t: a warp max (on an
// order-preserving unsigned image of the float) plus 4 partials in shared
// memory, once per cluster. The TPU kernel's grid of 8 packets per step, its
// unrolled groups of 8 or 2 clusters and its DMA of the worklist into SMEM
// have no counterpart here: blocks run in parallel and read their worklist
// row directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace {

constexpr int kRays = 128;      // rays per packet = threads per block
constexpr int kTris = 128;      // triangles per cluster
constexpr int kSlabRows = 16;   // slab rows per cluster (rows 0..8 used)
constexpr int kWarps = kRays / 32;

// Order-preserving map of a float to an unsigned (and back), so that the
// packet max is an integer max even for negative values.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Largest best t over the packet, and whether some ray is still open (not
// blocked inside its t_max). Every thread gets the same values.
__device__ __forceinline__ void packet_state(float bt, bool open, unsigned* s_max, int* s_open,
                                             float& pkt_max, bool& pkt_open) {
  const unsigned m = __reduce_max_sync(0xffffffffu, ordered(bt));
  const int o = __any_sync(0xffffffffu, open);
  if ((threadIdx.x & 31) == 0) {
    s_max[threadIdx.x >> 5] = m;
    s_open[threadIdx.x >> 5] = o;
  }
  __syncthreads();
  unsigned mx = s_max[0];
  int any = s_open[0];
  for (int w = 1; w < kWarps; ++w) {
    mx = max(mx, s_max[w]);
    any |= s_open[w];
  }
  pkt_max = unordered(mx);
  pkt_open = any != 0;
}

__global__ void __launch_bounds__(kRays)
packet_hit_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                  const float* __restrict__ t_max, const int* __restrict__ order,
                  const float* __restrict__ keys, const float* __restrict__ slab,
                  int n_clusters, int any_hit, float* __restrict__ t_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ tri_out) {
  __shared__ float tile[kTris * 9];   // triangle k at tile[9 k .. 9 k + 8]
  __shared__ unsigned s_max[kWarps];
  __shared__ int s_open[kWarps];
  const int lane = threadIdx.x;
  const int64_t ray = (int64_t)blockIdx.x * kRays + lane;
  const float ox = origin[3 * ray], oy = origin[3 * ray + 1], oz = origin[3 * ray + 2];
  const float dx = direction[3 * ray], dy = direction[3 * ray + 1], dz = direction[3 * ray + 2];
  const float tm = t_max[ray];
  float bt = tm, bu = 0.0f, bv = 0.0f;
  int bi = -1;
  const int* row_order = order + (int64_t)blockIdx.x * n_clusters;
  const float* row_keys = keys + (int64_t)blockIdx.x * n_clusters;

  float pkt_max;
  bool pkt_open;
  packet_state(bt, true, s_max, s_open, pkt_max, pkt_open);
  for (int i = 0; i < n_clusters; ++i) {
    // both tests read only values every thread shares: the break is uniform
    if (row_keys[i] >= pkt_max || (any_hit && !pkt_open)) break;
    const float* src = slab + (int64_t)row_order[i] * kSlabRows * kTris;
    __syncthreads();   // every thread is done with the previous tile
#pragma unroll
    for (int r = 0; r < 9; ++r) tile[9 * lane + r] = src[r * kTris + lane];
    __syncthreads();
    const int base = row_order[i] * kTris;
    for (int k = 0; k < kTris; ++k) {
      float t, u, v;
      if (nrd::mt_hit(ox, oy, oz, dx, dy, dz, tile + 9 * k, t, u, v) && t < bt) {
        bt = t;
        bu = u;
        bv = v;
        bi = base + k;
      }
    }
    packet_state(bt, bt >= tm, s_max, s_open, pkt_max, pkt_open);
  }
  t_out[ray] = bt;
  u_out[ray] = bu;
  v_out[ray] = bv;
  tri_out[ray] = bi;
}

}  // namespace

extern "C" int nrd_packet_hit(const void* origin, const void* direction, const void* t_max,
                              const void* order, const void* keys, const void* slab,
                              int n_clusters, int64_t n_packets, int any_hit, void* t_out,
                              void* u_out, void* v_out, void* tri_out, void* stream) {
  if (n_clusters <= 0 || n_packets < 0 || n_packets > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (n_packets == 0) return 0;
  packet_hit_kernel<<<(unsigned)n_packets, kRays, 0, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)t_max, (const int*)order,
      (const float*)keys, (const float*)slab, n_clusters, any_hit, (float*)t_out,
      (float*)u_out, (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}
