// Dense closest hit: every ray against every triangle of a small scene.
//
// Replaces the Pallas TPU kernel nrdsample_tpu/ops/dense_pallas.py:_kernel,
// reached through closest_hit_dense_pallas. Function: Möller-Trumbore of each
// ray against all E <= 1024 triangles; keeps the best (t, u, v, tri) with a
// strict t < best, so the first of equal hits wins; on a miss t = t_max and
// tri = -1. The epsilons and the order of every operation are those of the
// plain version (ops/intersect.py), through the test in moller_trumbore.cuh.
//
// What bounds it on the card: each ray moves 24 bytes in (origin, direction),
// 4 more for a per-ray t_max, and 16 bytes out, but does ~45 flops and one
// IEEE divide per triangle: at E = 156 (the kitchen) that is ~7,000 flops
// against ~44 bytes, far above the H100's ~20 flop/byte ridge, so the kernel
// is bound by ALU issue, not by memory.
//
// Design: one thread per ray. Each block stages the (E, 9) table
// [p0, e1, e2] in shared memory (36 KB at E = 1024); every thread walks the
// triangles in the same order, so each shared-memory read is a broadcast and
// the inner loop is pure register arithmetic. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 1024;

__global__ void __launch_bounds__(kThreads)
dense_hit_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                 const float* __restrict__ p0, const float* __restrict__ e1,
                 const float* __restrict__ e2, int n_tris,
                 const float* __restrict__ t_max, float t_max_scalar, int64_t n,
                 float* __restrict__ t_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ tri_out) {
  extern __shared__ float tab[];  // (n_tris, 9)
  for (int k = threadIdx.x; k < n_tris * 3; k += blockDim.x) {
    const int j = k / 3, c = k - 3 * (k / 3);
    tab[9 * j + c] = p0[k];
    tab[9 * j + 3 + c] = e1[k];
    tab[9 * j + 6 + c] = e2[k];
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
  float bt = t_max != nullptr ? t_max[i] : t_max_scalar;
  float bu = 0.0f, bv = 0.0f;
  int bi = -1;
  for (int j = 0; j < n_tris; ++j) {
    float t, u, v;
    if (nrd::mt_hit(ox, oy, oz, dx, dy, dz, tab + 9 * j, t, u, v) && t < bt) {
      bt = t;
      bu = u;
      bv = v;
      bi = j;
    }
  }
  t_out[i] = bt;
  u_out[i] = bu;
  v_out[i] = bv;
  tri_out[i] = bi;
}

}  // namespace

extern "C" int nrd_dense_hit(const void* origin, const void* direction, const void* p0,
                             const void* e1, const void* e2, int n_tris, const void* t_max,
                             float t_max_scalar, int64_t n, void* t_out, void* u_out,
                             void* v_out, void* tri_out, void* stream) {
  if (n_tris < 0 || n_tris > kMaxTris) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 9 * (size_t)(n_tris > 0 ? n_tris : 1);
  dense_hit_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)p0, (const float*)e1,
      (const float*)e2, n_tris, (const float*)t_max, t_max_scalar, n, (float*)t_out,
      (float*)u_out, (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}
