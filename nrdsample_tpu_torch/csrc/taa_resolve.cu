// The TAA resolve after the history gather.
//
// Replaces the Pallas TPU kernel nrdsample_tpu/denoise/taa_pallas.py:_taa_kernel
// (taa_resolve_pallas). Function, per pixel, as the plain version
// denoise/taa.py:resolve_tail computes it:
//   1. mean and sigma = sqrt(max(E[c^2] - mu^2, 0) + 1e-12) of the current colour
//      over the clamped 3x3 neighbourhood, and over 5x5 where a wide mask is
//      given and above 0.5 (sums in row-major tap order, times 1/9 or 1/25);
//   2. the gathered history clamped to mu -+ sigma * sigma_scale;
//   3. the CIELAB distance of the history and the clamped history (both clamped
//      to [0, 1]; XYZ rows as three multiply-adds, the cube root as
//      pow(x, 1/3)), mix = clamp(base_mix + clamp(dE / 23, 0, 1) / 2, 0, 1);
//   4. mix = 1 where pixel centre + mv_d lands off screen, then
//      max(mix, reset_mix); out = clamped + (cur - clamped) * mix.
// Built with --fmad=false and without fast math (powf, sqrtf and the divides
// are IEEE), so the float32 sequence is the plain version's.
//
// What bounds it on the card: it reads 10 float planes (cur 3, prev 3, mv_d 2,
// wide, reset) and writes 3, 52 bytes a pixel, against ~400 float operations
// (2 x 3 pow): at 1920x1080 the bytes take ~0.032 ms at 3.35 TB/s and the
// operations ~0.025 ms, so bytes bound it.
//
// Design: one thread per pixel, 32x8 blocks; the 25 taps of the current colour
// are read from device memory, where neighbouring threads' taps share cache
// lines. The TPU kernel's row bands, lane rolls and 128-lane padding do not
// carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }

// color.rgb_to_lab of an rgb already clamped to [0, 1]
__device__ void lab(const float c[3], float out[3]) {
  const float m[3][3] = {{(float)0.4124564, (float)0.3575761, (float)0.1804375},
                         {(float)0.2126729, (float)0.7151522, (float)0.0721750},
                         {(float)0.0193339, (float)0.1191920, (float)0.9503041}};
  const float inv_white[3] = {(float)(1.0 / 0.950489), (float)(1.0 / 1.0),
                              (float)(1.0 / 1.088840)};
  const float r = fmaxf(c[0], 0.0f), g = fmaxf(c[1], 0.0f), b = fmaxf(c[2], 0.0f);
  float f[3];
  for (int k = 0; k < 3; ++k) {
    const float xyz = (m[k][0] * r + m[k][1] * g + m[k][2] * b) * inv_white[k];
    f[k] = xyz > (float)0.008856 ? powf(fmaxf(xyz, (float)1e-9), (float)(1.0 / 3.0))
                                 : (float)7.787 * xyz + (float)(16.0 / 116.0);
  }
  out[0] = 116.0f * f[1] - 16.0f;
  out[1] = 500.0f * (f[0] - f[1]);
  out[2] = 200.0f * (f[1] - f[2]);
}

__global__ void __launch_bounds__(256)
taa_resolve_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                   const float* __restrict__ mv_d, const float* __restrict__ wide,
                   const float* __restrict__ reset_mix, int h, int w, float sigma_scale,
                   float base_mix, float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t i = (int64_t)y * w + x;
  const bool use_wide = wide != nullptr && __ldg(wide + i) > 0.5f;
  const int r = use_wide ? 2 : 1;

  float s1[3] = {0.0f, 0.0f, 0.0f}, s2[3] = {0.0f, 0.0f, 0.0f};
  for (int dy = -r; dy <= r; ++dy) {
    const int64_t row = (int64_t)clampi(y + dy, 0, h - 1) * w;
    for (int dx = -r; dx <= r; ++dx) {
      const float* c = cur + 3 * (row + clampi(x + dx, 0, w - 1));
      for (int k = 0; k < 3; ++k) {
        const float v = __ldg(c + k);
        s1[k] = s1[k] + v;
        s2[k] = s2[k] + v * v;
      }
    }
  }
  const float inv_n = use_wide ? (float)(1.0 / 25.0) : (float)(1.0 / 9.0);

  float p[3], cl[3], pc[3], cc[3];
  for (int k = 0; k < 3; ++k) {
    const float mu = s1[k] * inv_n;
    const float sigma = sqrtf(fmaxf(s2[k] * inv_n - mu * mu, 0.0f) + (float)1e-12);
    p[k] = __ldg(prev + 3 * i + k);
    cl[k] = fminf(fmaxf(p[k], mu - sigma * sigma_scale), mu + sigma * sigma_scale);
    pc[k] = clamp01(p[k]);
    cc[k] = clamp01(cl[k]);
  }
  float lp[3], lc[3];
  lab(pc, lp);
  lab(cc, lc);
  const float d0 = lp[0] - lc[0], d1 = lp[1] - lc[1], d2 = lp[2] - lc[2];
  const float jnd = clamp01(sqrtf(d0 * d0 + d1 * d1 + d2 * d2) * (float)(1.0 / 23.0));
  float mix = clamp01(base_mix + jnd * 0.5f);

  const float px = ((float)x + 0.5f) + __ldg(mv_d + 2 * i);
  const float py = ((float)y + 0.5f) + __ldg(mv_d + 2 * i + 1);
  const bool on = px >= 0.0f && px <= (float)w && py >= 0.0f && py <= (float)h;
  if (!on) mix = 1.0f;
  mix = fmaxf(mix, __ldg(reset_mix + i));
  for (int k = 0; k < 3; ++k) {
    const float c = __ldg(cur + 3 * i + k);
    out[3 * i + k] = cl[k] + (c - cl[k]) * mix;
  }
}

}  // namespace

extern "C" int nrd_taa_resolve(const void* cur, const void* prev, const void* mv_d,
                               const void* wide, const void* reset_mix, int h, int w,
                               float sigma_scale, float base_mix, void* out, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  taa_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (const float*)mv_d, (const float*)wide,
      (const float*)reset_mix, h, w, sigma_scale, base_mix, (float*)out);
  return (int)cudaGetLastError();
}
