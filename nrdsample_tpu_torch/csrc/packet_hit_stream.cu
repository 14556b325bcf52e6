// Packet closest hit (and any hit) over 128-triangle clusters, streaming each
// cluster's triangles into shared memory with asynchronous copies.
//
// Replaces the HBM-streaming Pallas TPU kernel
// nrdsample_tpu/ops/packet.py:_packet_kernel_stream (_one_packet_stream),
// which closest_hit_packet picks when the cluster slab is larger than
// PACKET_VMEM_LIMIT. Function: the contract of packet_hit.cu. 128 rays form a
// packet; stage 1 (PyTorch, ops/packet.py) gives each packet a worklist of
// the clusters its rays may enter, sorted by a lower bound of the packet's
// entry distance. The packet walks its list in order, tests every ray
// against the 128 triangles of each cluster (moller_trumbore.cuh) and folds
// hits in with a strict t < best, so the first hit in walk order wins. The
// walk stops when the next key is at or past the largest best t of the
// packet; in any-hit mode also once every ray is blocked inside its t_max. On
// a miss t = t_max, u = v = 0 and tri = -1; with need_uv = 0, u = v = 0
// everywhere.
//
// What bounds it on the card: operations, as in the resident kernel (128
// tests of ~50 float32 operations per ray and visited cluster); the walk
// visits more clusters than each ray needs. The slab of a million-triangle
// scene (68 MB) does not fit in the 50 MB L2, so each visited cluster is a
// 4.6 KB read from device memory whose latency the tests must hide.
//
// Design: one 128-thread block per packet, one ray per thread, as in
// packet_hit.cu. A cluster's rows 0-8 are contiguous in the slab (9 x 128
// floats at cid * 16 * 128), so the block copies them as 288 16-byte
// cp.async transfers into a ring of kStages shared-memory tiles, kept
// plane-major (tile[r * 128 + k]; an async copy cannot transpose). While the
// block tests cluster i, the copies of clusters i+1 .. i+kStages-1 are in
// flight: the TPU kernel's double-buffered DMA of 8-cluster groups becomes a
// deeper ring of one-cluster stages. All threads read the same triangle at
// the same time, so the tile reads are broadcasts. The prefetch may run past
// the entry where the walk stops; what is in flight is drained before the
// block writes its results.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moller_trumbore.cuh"
#include "packet_walk.cuh"

namespace {

using nrd::kRays;
using nrd::kSlabRows;
using nrd::kTris;
using nrd::kWarps;
using nrd::packet_state;

constexpr int kStages = 4;                  // tiles in the ring: 3 clusters in flight
constexpr int kTileFloats = 9 * kTris;      // slab rows 0..8 of one cluster
constexpr int kChunks = kTileFloats / 4;    // 16-byte copies per tile

// Start this thread's share of the copy of cluster cid into dst.
__device__ __forceinline__ void fetch_cluster(float* dst, const float* __restrict__ slab,
                                              int cid, int lane) {
  const float* src = slab + (int64_t)cid * kSlabRows * kTris;
  for (int c = lane; c < kChunks; c += kRays) __pipeline_memcpy_async(dst + 4 * c, src + 4 * c, 16);
}

__global__ void __launch_bounds__(kRays)
packet_hit_stream_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                         const float* __restrict__ t_max, const int* __restrict__ order,
                         const float* __restrict__ keys, const float* __restrict__ slab,
                         int n_clusters, int any_hit, int need_uv, float* __restrict__ t_out,
                         float* __restrict__ u_out, float* __restrict__ v_out,
                         int* __restrict__ tri_out) {
  __shared__ __align__(16) float tiles[kStages * kTileFloats];
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

  // prologue: clusters 0 .. kStages-2 in flight, one commit group each (empty
  // groups past the list keep the group count uniform)
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_clusters) fetch_cluster(tiles + s * kTileFloats, slab, row_order[s], lane);
    __pipeline_commit();
  }
  float pkt_max;
  bool pkt_open;
  packet_state(bt, true, s_max, s_open, pkt_max, pkt_open);
  for (int i = 0; i < n_clusters; ++i) {
    // both tests read only values every thread shares: the break is uniform
    if (row_keys[i] >= pkt_max || (any_hit && !pkt_open)) break;
    // the stage of cluster i-1 is free (packet_state's barrier follows its
    // tests): refill it with cluster i+kStages-1
    const int j = i + kStages - 1;
    if (j < n_clusters) fetch_cluster(tiles + (j % kStages) * kTileFloats, slab, row_order[j], lane);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);   // this thread's copies of cluster i have landed
    __syncthreads();                      // and every other thread's
    const float* tile = tiles + (i % kStages) * kTileFloats;
    const int base = row_order[i] * kTris;
    for (int k = 0; k < kTris; ++k) {
      float t, u, v;
      if (nrd::mt_hit_strided<kTris>(ox, oy, oz, dx, dy, dz, tile + k, t, u, v) && t < bt) {
        bt = t;
        if (need_uv) {
          bu = u;
          bv = v;
        }
        bi = base + k;
      }
    }
    packet_state(bt, bt >= tm, s_max, s_open, pkt_max, pkt_open);
  }
  __pipeline_wait_prior(0);   // drain the prefetches past the stop
  t_out[ray] = bt;
  u_out[ray] = bu;
  v_out[ray] = bv;
  tri_out[ray] = bi;
}

}  // namespace

extern "C" int nrd_packet_hit_stream(const void* origin, const void* direction,
                                     const void* t_max, const void* order, const void* keys,
                                     const void* slab, int n_clusters, int64_t n_packets,
                                     int any_hit, int need_uv, void* t_out, void* u_out,
                                     void* v_out, void* tri_out, void* stream) {
  if (n_clusters <= 0 || n_packets < 0 || n_packets > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(slab) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (n_packets == 0) return 0;
  packet_hit_stream_kernel<<<(unsigned)n_packets, kRays, 0, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)t_max, (const int*)order,
      (const float*)keys, (const float*)slab, n_clusters, any_hit, need_uv, (float*)t_out,
      (float*)u_out, (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}
