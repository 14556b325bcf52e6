// Emissive light probe: the intensity of the nearest emissive triangle along
// each ray, or 0 on a miss (CastLightRay_AnyHit of the 16-candidate emissive
// importance-sampling reservoir).
//
// Replaces the Pallas TPU kernel nrdsample_tpu/ops/emissive_probe.py:
// _probe_kernel, reached through light_probe_pallas. The Möller-Trumbore test
// and tie-break are those of dense_hit.cu (moller_trumbore.cuh, strict
// t < best, best starting at T_MAX = 1e5); padding slots of the emissive set
// have zero edges, so det = 0 and they always miss. It computes bit for bit
// what ops/emissive_probe.py:light_probe_plain computes.
//
// What bounds it on the card: each ray moves 24 bytes in and 4 out and does
// ~45 flops plus one IEEE divide per emissive triangle. The emissive sets of
// the dense scenes are small (E = 8 slots for the Cornell box and the
// kitchen), so at ~360 flops per 28 bytes the kernel sits near the H100's
// ridge: a 1080p frame's 33M probe rays move ~0.9 GB, about 0.3 ms of HBM
// time, and the arithmetic costs about as much.
//
// Design: one thread per ray; each block stages the (E, 10) table
// [p0, e1, e2, intensity] in shared memory (20 KB at E = 512) and every
// thread walks it in the same order, so table reads are broadcasts. The
// winning intensity is kept in a register: no triangle index is written and
// no gather follows. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "moller_trumbore.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTris = 512;
constexpr float kTMax = 1e5f;  // intersect.T_MAX

__global__ void __launch_bounds__(kThreads)
emissive_probe_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                      const float* __restrict__ p0, const float* __restrict__ e1,
                      const float* __restrict__ e2, const float* __restrict__ intensity,
                      int n_tris, int64_t n, float* __restrict__ out) {
  extern __shared__ float tab[];  // (n_tris, 10)
  for (int k = threadIdx.x; k < n_tris * 3; k += blockDim.x) {
    const int j = k / 3, c = k - 3 * (k / 3);
    tab[10 * j + c] = p0[k];
    tab[10 * j + 3 + c] = e1[k];
    tab[10 * j + 6 + c] = e2[k];
  }
  for (int j = threadIdx.x; j < n_tris; j += blockDim.x) tab[10 * j + 9] = intensity[j];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = origin[3 * i], oy = origin[3 * i + 1], oz = origin[3 * i + 2];
  const float dx = direction[3 * i], dy = direction[3 * i + 1], dz = direction[3 * i + 2];
  float bt = kTMax;
  float li = 0.0f;
  for (int j = 0; j < n_tris; ++j) {
    const float* r = tab + 10 * j;
    float t, u, v;
    if (nrd::mt_hit(ox, oy, oz, dx, dy, dz, r, t, u, v) && t < bt) {
      bt = t;
      li = r[9];
    }
  }
  out[i] = li;
}

}  // namespace

extern "C" int nrd_emissive_probe(const void* origin, const void* direction, const void* p0,
                                  const void* e1, const void* e2, const void* intensity,
                                  int n_tris, int64_t n, void* out, void* stream) {
  if (n_tris < 0 || n_tris > kMaxTris) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sizeof(float) * 10 * (size_t)(n_tris > 0 ? n_tris : 1);
  emissive_probe_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)origin, (const float*)direction, (const float*)p0, (const float*)e1,
      (const float*)e2, (const float*)intensity, n_tris, n, (float*)out);
  return (int)cudaGetLastError();
}
