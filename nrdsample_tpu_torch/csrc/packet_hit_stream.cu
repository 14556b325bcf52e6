// Packet closest hit (and any hit) over 128-triangle clusters for slabs
// larger than the L2: a warp-granular walk with per-ray cluster culling.
//
// Replaces the HBM-streaming Pallas TPU kernel
// nrdsample_tpu/ops/packet.py:_packet_kernel_stream (_one_packet_stream),
// which closest_hit_packet picks when the cluster slab is larger than
// PACKET_VMEM_LIMIT. Function: 128 rays form a packet; stage 1 (PyTorch,
// ops/packet.py) gives each packet a worklist of the clusters its rays may
// enter, sorted by keys that are lower bounds of every ray's entry distance.
// Each ray's result is its closest hit over the clusters of the list, as the
// plain scan (ops/cluster.py:_scan_clusters) finds it: a ray tests a cluster
// only while the cluster's box entry is below its best t, and folds hits in
// with a strict t < best, so the first hit in walk order wins a tie. In
// any-hit mode a ray stops once it is blocked inside its t_max. On a miss
// t = t_max, u = v = 0 and tri = -1; with need_uv = 0, u = v = 0 everywhere.
//
// What bounds it on the card: operations, 128 Möller-Trumbore tests of ~50
// float32 operations per ray and tested cluster. A packet's rays diverge on
// bounce and shadow waves, so one shared walk (every ray of the packet tests
// every cluster the packet visits, until the next key reaches the packet's
// largest best t) made up to 238x the tests the rays need on the 1.06M-
// triangle exterior.
//
// Design: walk_packet of packet_walk.cuh, which the resident kernel runs
// too: each warp walks the packet's worklist on its own with the per-ray
// cull, reading each candidate cluster from its private cp.async ring of
// shared-memory tiles. The same walk reading the triangles straight from the
// slab through L1 (16-byte broadcast loads, no tile) gave identical results
// and came within 3% of the ring on chip_smoke's three exterior720 ray sets,
// ahead on some, behind on others; on the frame's own 30 launches the ring
// took 74.9 ms per frame and the L1 walk 85.4-85.7, in one call (PERF.md §6;
// NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

__global__ void __launch_bounds__(nrd::kRays)
packet_hit_stream_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                         const float* __restrict__ t_max, const int* __restrict__ order,
                         const float* __restrict__ keys, const float* __restrict__ slab,
                         const float* __restrict__ bounds_min,
                         const float* __restrict__ bounds_max, int n_clusters, int any_hit,
                         int need_uv, float* __restrict__ t_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ tri_out) {
  nrd::walk_packet(origin, direction, t_max, order, keys, slab, bounds_min, bounds_max,
                   n_clusters, any_hit, need_uv, t_out, u_out, v_out, tri_out);
}

}  // namespace

extern "C" int nrd_packet_hit_stream(const void* origin, const void* direction,
                                     const void* t_max, const void* order, const void* keys,
                                     const void* slab, const void* bounds_min,
                                     const void* bounds_max, int n_clusters, int64_t n_packets,
                                     int any_hit, int need_uv, void* t_out, void* u_out,
                                     void* v_out, void* tri_out, void* stream) {
  if (n_clusters <= 0 || n_packets < 0 || n_packets > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(slab) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (n_packets == 0) return 0;
  packet_hit_stream_kernel<<<(unsigned)n_packets, nrd::kRays, 0, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)t_max, (const int*)order,
      (const float*)keys, (const float*)slab, (const float*)bounds_min,
      (const float*)bounds_max, n_clusters, any_hit, need_uv, (float*)t_out, (float*)u_out,
      (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}
