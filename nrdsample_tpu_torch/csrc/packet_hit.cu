// Packet closest hit (and any hit) over 128-triangle clusters, for slabs the
// L2 holds: a warp-granular walk with per-ray cluster culling.
//
// Replaces the resident Pallas TPU kernel
// nrdsample_tpu/ops/packet.py:_packet_kernel (its hoisted loop
// _one_packet_hoisted), reached through closest_hit_packet and
// any_hit_packet for slabs up to PACKET_VMEM_LIMIT (48 MiB; the H100's L2
// holds 50 MB). Function: 128 rays form a packet; stage 1 (PyTorch, in
// ops/packet.py) gives each packet a worklist of the clusters its rays may
// enter, sorted by keys that are lower bounds of every ray's entry distance.
// Each ray's result is its closest hit over the clusters of the list, as the
// plain scan (ops/cluster.py:_scan_clusters) finds it: a ray tests a cluster
// only while the cluster's box entry is below its best t, and folds hits in
// with a strict t < best, so the first hit in walk order wins a tie. In
// any-hit mode a ray stops once it is blocked inside its t_max. On a miss
// t = t_max, u = v = 0 and tri = -1; with need_uv = 0, u = v = 0 everywhere
// (the TPU kernel's track_uv).
//
// What bounds it on the card: operations, 128 Möller-Trumbore tests per ray
// and tested cluster (58 float32 instructions each, sass_ops). Its first
// design walked one list per packet, every ray testing every cluster the
// packet visited until the next key reached the packet's largest best t:
// 3.4x and 12.5x the tests the rays need on shaderballs512's camera and
// divergent sets.
//
// Design: walk_packet of packet_walk.cuh, the streaming kernel's walk: each
// warp walks the packet's worklist on its own with the per-ray cull. The
// slab is small enough for the L2 (shaderballs512: 852 KB), so three tile
// sources were timed on the frame's own 4 launches (profile_frame
// shaderballs512, one call, each twice, in turns): a warp's private cp.async
// ring of 2 tiles 3.099 and 3.074 ms per frame, 16-byte __ldg broadcasts
// straight from the slab (no shared memory) 3.208 and 3.143, a block-shared
// tile loaded once when several warps' candidates are the same cluster (in
// rounds, three block barriers each) 3.501 and 3.432; the first design 7.452
// and 7.465 (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W). The ring ships,
// so this kernel runs the streaming kernel's code under its own name.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packet_walk.cuh"

namespace {

__global__ void __launch_bounds__(nrd::kRays)
packet_hit_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                  const float* __restrict__ t_max, const int* __restrict__ order,
                  const float* __restrict__ keys, const float* __restrict__ slab,
                  const float* __restrict__ bounds_min, const float* __restrict__ bounds_max,
                  int n_clusters, int any_hit, int need_uv, float* __restrict__ t_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  int* __restrict__ tri_out) {
  nrd::walk_packet(origin, direction, t_max, order, keys, slab, bounds_min, bounds_max,
                   n_clusters, any_hit, need_uv, t_out, u_out, v_out, tri_out);
}

}  // namespace

extern "C" int nrd_packet_hit(const void* origin, const void* direction, const void* t_max,
                              const void* order, const void* keys, const void* slab,
                              const void* bounds_min, const void* bounds_max, int n_clusters,
                              int64_t n_packets, int any_hit, int need_uv, void* t_out,
                              void* u_out, void* v_out, void* tri_out, void* stream) {
  if (n_clusters <= 0 || n_packets < 0 || n_packets > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(slab) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  if (n_packets == 0) return 0;
  packet_hit_kernel<<<(unsigned)n_packets, nrd::kRays, 0, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)t_max, (const int*)order,
      (const float*)keys, (const float*)slab, (const float*)bounds_min,
      (const float*)bounds_max, n_clusters, any_hit, need_uv, (float*)t_out, (float*)u_out,
      (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}
