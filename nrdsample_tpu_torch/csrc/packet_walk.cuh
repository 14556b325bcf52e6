// Shared pieces of the two packet kernels (packet_hit.cu, the resident walk,
// and packet_hit_stream.cu, the streamed one): the packet and cluster sizes,
// the order-preserving float map of their max reductions, and the resident
// walk's per-cluster packet state, which its stop test reads.

#pragma once

#include <stdint.h>

namespace nrd {

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
// blocked inside its t_max). Every thread gets the same values. Ends with
// (and relies on) a block barrier: after it every thread is done with the
// work it did before the call.
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

}  // namespace nrd
