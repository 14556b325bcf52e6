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
// wide, reset) and writes 3, 52 bytes a pixel. The instructions a pixel needs
// depend on its data: ~160 float32 instructions for the moments, the clamp and
// the mix, 144 more on a wide pixel, and ~420 more (6 powf, a sqrtf) for the
// CIELAB distance, which only a pixel whose clamped history differs from its
// history in [0, 1] needs (elsewhere the two CIELAB values are equal, the
// distance is exactly 0) and only where the mix does not ignore it (on screen,
// reset_mix below 1). On 1920x1080 planes where 8-10% of the pixels need it,
// the bytes bound it (~0.032 ms at 3.35 TB/s).
//
// Design: a 32x8 block resolves a 32x16 tile, two rows per thread, so each warp
// works along one image row, in three phases between two barriers.
//   1. The tile's current colour plus a 2-pixel halo (36x20 pixels, 3
//      channels) is staged once in shared memory, clamped to the edge as it is
//      loaded, so the tap loops read shared memory and clamp no index. A warp
//      with no wide pixel takes the 9 taps, unrolled; one with any takes the 25,
//      a narrow lane adding 0 at the outer 16 (x + 0 == x), so neither order of
//      summation changes. Each pixel's clamped history goes to shared memory,
//      and a pixel that needs the CIELAB distance appends itself to a block-wide
//      list.
//   2. The block's threads take the list's pixels in turn and compute their
//      distances: the powf work runs on full warps instead of on every warp
//      that holds one such pixel.
//   3. Each thread mixes its two pixels and writes them.
// The TPU kernel's row bands, lane rolls and 128-lane padding do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nan_minmax.cuh"

namespace {

constexpr int kTileW = 32;             // one warp per row
constexpr int kRows = 8;               // thread rows
constexpr int kPerThread = 2;          // rows per thread
constexpr int kTileH = kRows * kPerThread;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kHalo = 2;
constexpr int kInW = kTileW + 2 * kHalo, kInH = kTileH + 2 * kHalo;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float clamp01(float v) { return nan_min(nan_max(v, 0.0f), 1.0f); }

// color.rgb_to_lab of an rgb already clamped to [0, 1]
__device__ void lab(const float c[3], float out[3]) {
  const float m[3][3] = {{(float)0.4124564, (float)0.3575761, (float)0.1804375},
                         {(float)0.2126729, (float)0.7151522, (float)0.0721750},
                         {(float)0.0193339, (float)0.1191920, (float)0.9503041}};
  const float inv_white[3] = {(float)(1.0 / 0.950489), (float)(1.0 / 1.0),
                              (float)(1.0 / 1.088840)};
  const float r = nan_max(c[0], 0.0f), g = nan_max(c[1], 0.0f), b = nan_max(c[2], 0.0f);
  float f[3];
  for (int k = 0; k < 3; ++k) {
    const float xyz = (m[k][0] * r + m[k][1] * g + m[k][2] * b) * inv_white[k];
    f[k] = xyz > (float)0.008856 ? powf(nan_max(xyz, (float)1e-9), (float)(1.0 / 3.0))
                                 : (float)7.787 * xyz + (float)(16.0 / 116.0);
  }
  out[0] = 116.0f * f[1] - 16.0f;
  out[1] = 500.0f * (f[0] - f[1]);
  out[2] = 200.0f * (f[1] - f[2]);
}

// Sums of the current colour and its square over the (2r+1)^2 taps around
// shared-memory position (sy, sx), in row-major tap order; kWide takes all 25
// taps, a narrow lane (wide false) adding 0 at the outer 16.
template <bool kWide>
__device__ __forceinline__ void moments(float (*s_cur)[kInH][kInW], int sy, int sx,
                                        bool wide, float s1[3], float s2[3]) {
  constexpr int r = kWide ? 2 : 1;
#pragma unroll
  for (int dy = -r; dy <= r; ++dy) {
#pragma unroll
    for (int dx = -r; dx <= r; ++dx) {
      const bool inner = dy >= -1 && dy <= 1 && dx >= -1 && dx <= 1;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = s_cur[k][sy + dy][sx + dx];
        const float m = inner || wide ? v : 0.0f;
        s1[k] = s1[k] + m;
        s2[k] = s2[k] + m * m;
      }
    }
  }
}

__global__ void __launch_bounds__(kTileW * kRows)
taa_resolve_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                   const float* __restrict__ mv_d, const float* __restrict__ wide,
                   const float* __restrict__ reset_mix, int h, int w, float sigma_scale,
                   float base_mix, float* __restrict__ out) {
  __shared__ float s_cur[3][kInH][kInW];       // the tile and its halo, clamped to the image
  __shared__ float s_cl[3][kTilePx];           // the clamped history
  __shared__ float s_jnd[kTilePx];             // clamp(dE / 23, 0, 1)
  __shared__ unsigned short s_list[kTilePx];   // pixels that need dE
  __shared__ int s_count;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int oy = blockIdx.y * kTileH, ox = blockIdx.x * kTileW;
  if (tid == 0) s_count = 0;
  for (int r = tid; r < kInH * kInW; r += kTileW * kRows) {
    const int sy = r / kInW, sx = r % kInW;
    const int64_t g = (int64_t)clampi(oy - kHalo + sy, 0, h - 1) * w +
                      clampi(ox - kHalo + sx, 0, w - 1);
    for (int k = 0; k < 3; ++k) s_cur[k][sy][sx] = __ldg(cur + 3 * g + k);
  }
  __syncthreads();

  // 1. moments, clamp; every lane of a warp takes part in the vote, and a
  // pixel outside the image reads its clamped edge pixel and stores nothing
  const int tx = threadIdx.x, x = ox + tx;
  bool on[kPerThread];
  float reset[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ty = threadIdx.y + j * kRows, y = oy + ty, slot = ty * kTileW + tx;
    const bool inside = x < w && y < h;
    const int64_t i = (int64_t)min(y, h - 1) * w + min(x, w - 1);
    const bool use_wide = wide != nullptr && __ldg(wide + i) > 0.5f;
    float s1[3] = {0.0f, 0.0f, 0.0f}, s2[3] = {0.0f, 0.0f, 0.0f};
    if (__any_sync(0xffffffffu, use_wide)) {
      moments<true>(s_cur, ty + kHalo, tx + kHalo, use_wide, s1, s2);
    } else {
      moments<false>(s_cur, ty + kHalo, tx + kHalo, false, s1, s2);
    }
    const float inv_n = use_wide ? (float)(1.0 / 25.0) : (float)(1.0 / 9.0);
    bool differs = false;
    for (int k = 0; k < 3; ++k) {
      const float mu = s1[k] * inv_n;
      const float sigma = sqrtf(nan_max(s2[k] * inv_n - mu * mu, 0.0f) + (float)1e-12);
      const float p = __ldg(prev + 3 * i + k);
      const float cl = nan_min(nan_max(p, mu - sigma * sigma_scale), mu + sigma * sigma_scale);
      s_cl[k][slot] = cl;
      differs = differs || clamp01(p) != clamp01(cl);
    }
    const float px = ((float)x + 0.5f) + __ldg(mv_d + 2 * i);
    const float py = ((float)y + 0.5f) + __ldg(mv_d + 2 * i + 1);
    on[j] = px >= 0.0f && px <= (float)w && py >= 0.0f && py <= (float)h;
    reset[j] = __ldg(reset_mix + i);
    // dE is exactly 0 where the two CIELAB operands are equal, and the mix
    // does not depend on it off screen (1) or under a reset_mix of 1 or more
    s_jnd[slot] = 0.0f;
    if (inside && differs && on[j] && !(reset[j] >= 1.0f)) {
      s_list[atomicAdd(&s_count, 1)] = (unsigned short)slot;
    }
  }
  __syncthreads();

  // 2. the CIELAB distance of the listed pixels
  const int n_list = s_count;
  for (int e = tid; e < n_list; e += kTileW * kRows) {
    const int slot = s_list[e];
    const int64_t i = (int64_t)(oy + slot / kTileW) * w + ox + slot % kTileW;
    float pc[3], cc[3];
    for (int k = 0; k < 3; ++k) {
      pc[k] = clamp01(__ldg(prev + 3 * i + k));
      cc[k] = clamp01(s_cl[k][slot]);
    }
    float lp[3], lc[3];
    lab(pc, lp);
    lab(cc, lc);
    const float d0 = lp[0] - lc[0], d1 = lp[1] - lc[1], d2 = lp[2] - lc[2];
    s_jnd[slot] = clamp01(sqrtf(d0 * d0 + d1 * d1 + d2 * d2) * (float)(1.0 / 23.0));
  }
  __syncthreads();

  // 3. mix and write
  if (x >= w) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ty = threadIdx.y + j * kRows, y = oy + ty, slot = ty * kTileW + tx;
    if (y >= h) return;
    const float mix = nan_max(on[j] ? clamp01(base_mix + s_jnd[slot] * 0.5f) : 1.0f, reset[j]);
    const int64_t i = (int64_t)y * w + x;
    for (int k = 0; k < 3; ++k) {
      const float c = s_cur[k][ty + kHalo][tx + kHalo], cl = s_cl[k][slot];
      out[3 * i + k] = cl + (c - cl) * mix;
    }
  }
}

}  // namespace

extern "C" int nrd_taa_resolve(const void* cur, const void* prev, const void* mv_d,
                               const void* wide, const void* reset_mix, int h, int w,
                               float sigma_scale, float base_mix, void* out, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileW, kRows);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  taa_resolve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)prev, (const float*)mv_d, (const float*)wide,
      (const float*)reset_mix, h, w, sigma_scale, base_mix, (float*)out);
  return (int)cudaGetLastError();
}
