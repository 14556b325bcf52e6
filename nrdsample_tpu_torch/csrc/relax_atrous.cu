// One RELAX à-trous iteration: an edge-stopped 3x3 stencil at a runtime step.
//
// Replaces the Pallas TPU kernel nrdsample_tpu/denoise/atrous_pallas.py:
// _iteration_kernel (atrous_iteration_pallas). Function, per pixel, as the plain
// version denoise/relax.py:atrous_iteration computes it: for the 9 taps at
// offsets (dy, dx) in {-step, 0, step}^2, clamped to the edge, in row-major order,
//   wz  = exp(-|z_n - z| / (phi_d * max(|z|, 1e-3) * (|dy| + |dx| + 1e-3)))
//   wn  = pow(clamp(dot(n_n, n), 0, 1), phi_n)
//   wl  = exp(-|lum_n - lum| / (sqrt(max(var, 0) + 1e-12) * phi_l + 1e-4))
//   wgt = ky * kx * wz * wn * wl        (k = 1/4, 1/2, 1/4)
// summed into illum * wgt, var * wgt^2 and wgt; the outputs are the sums times
// 1 / max(sum wgt, 1e-6) (once for the illumination, twice for the variance).
// exp and pow are the IEEE expf and powf, not the fast intrinsics; with
// --fmad=false the float32 sequence is the plain version's.
//
// What bounds it on the card: it reads 8 float planes and writes 4 (48 bytes a
// pixel) and does ~200 float operations a pixel, 2 exp and 1 pow per tap among
// them: at 1920x1080 the bytes take ~0.03 ms at 3.35 TB/s and the operations
// ~0.013 ms, so bytes bound it.
//
// Design: one thread per pixel, 32x8 blocks so a warp reads a row segment; the
// 9 taps are read from device memory, where neighbouring threads' taps share
// cache lines. The TPU kernel's row bands with a step-sized DMA halo and lane
// rolls over a padded width have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "nan_minmax.cuh"

namespace {

__device__ __forceinline__ float lum3(float r, float g, float b) {
  return r * (float)0.2126 + g * (float)0.7152 + b * (float)0.0722;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__global__ void __launch_bounds__(256)
relax_atrous_kernel(const float* __restrict__ il, const float* __restrict__ var,
                    const float* __restrict__ vz, const float* __restrict__ nrm, int h, int w,
                    int step, float phi_l, float phi_n, float phi_d, float* __restrict__ out_il,
                    float* __restrict__ out_var) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t i = (int64_t)y * w + x;
  const float lum_c = lum3(il[3 * i], il[3 * i + 1], il[3 * i + 2]);
  const float sigma_l = sqrtf(nan_max(var[i], 0.0f) + (float)1e-12) * phi_l + (float)1e-4;
  const float z = vz[i];
  const float abs_z = nan_max(fabsf(z), 1e-3f);
  const float n0 = nrm[3 * i], n1 = nrm[3 * i + 1], n2 = nrm[3 * i + 2];
  const float kern[3] = {0.25f, 0.5f, 0.25f};

  float acc[3] = {0.0f, 0.0f, 0.0f};
  float acc_var = 0.0f, acc_w = 0.0f;
  for (int iy = 0; iy < 3; ++iy) {
    const int dy = (iy - 1) * step;
    const int yy = clampi(y + dy, 0, h - 1);
    for (int ix = 0; ix < 3; ++ix) {
      const int dx = (ix - 1) * step;
      const int64_t j = (int64_t)yy * w + clampi(x + dx, 0, w - 1);
      const float t0 = __ldg(il + 3 * j), t1 = __ldg(il + 3 * j + 1), t2 = __ldg(il + 3 * j + 2);
      // (|dy| + |dx| + 1e-3) is summed in double, as Python sums it
      const float reach = (float)((double)(abs(dy) + abs(dx)) + 1e-3);
      const float wz = expf(-fabsf(__ldg(vz + j) - z) / (phi_d * abs_z * reach));
      const float ndot = __ldg(nrm + 3 * j) * n0 + __ldg(nrm + 3 * j + 1) * n1 +
                         __ldg(nrm + 3 * j + 2) * n2;
      const float wn = powf(nan_min(nan_max(ndot, 0.0f), 1.0f), phi_n);
      const float wl = expf(-fabsf(lum3(t0, t1, t2) - lum_c) / sigma_l);
      const float wgt = kern[iy] * kern[ix] * wz * wn * wl;
      acc[0] = acc[0] + t0 * wgt;
      acc[1] = acc[1] + t1 * wgt;
      acc[2] = acc[2] + t2 * wgt;
      acc_var = acc_var + __ldg(var + j) * wgt * wgt;
      acc_w = acc_w + wgt;
    }
  }
  const float inv = 1.0f / nan_max(acc_w, 1e-6f);
  for (int k = 0; k < 3; ++k) out_il[3 * i + k] = acc[k] * inv;
  out_var[i] = acc_var * inv * inv;
}

}  // namespace

extern "C" int nrd_relax_atrous(const void* il, const void* var, const void* vz, const void* nrm,
                                int h, int w, int step, float phi_l, float phi_n, float phi_d,
                                void* out_il, void* out_var, void* stream) {
  if (h <= 0 || w <= 0 || step <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  relax_atrous_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)il, (const float*)var, (const float*)vz, (const float*)nrm, h, w, step,
      phi_l, phi_n, phi_d, (float*)out_il, (float*)out_var);
  return (int)cudaGetLastError();
}
