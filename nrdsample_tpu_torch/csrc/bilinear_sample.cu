// Clamp-to-edge bilinear sample of an (H, W, C) image at N positions.
//
// Replaces the Pallas TPU kernel nrdsample_tpu/ops/reproject.py:_vertical_kernel,
// reached through reproject_bounded from sample_bilinear_auto and
// sample_bicubic_auto: the denoisers' history gathers. Function: for each
// position (x, y) in pixel units, p = pos - 0.5, i0 = floor(p), f = p - i0,
// and the four texels at (i0 + {0,1}) clamped into the image blend as
// c00 (1-fx)(1-fy) + c10 fx (1-fy) + c01 (1-fx) fy + c11 fx fy, in that order,
// as the plain version mathlib/filtering.py:sample_bilinear does. The library
// is built with --fmad=false, so the kernel's float32 results are the plain
// version's bit for bit.
//
// What bounds it on the card: per position it reads 8 bytes of position and
// 4 x C texels and writes C floats, for ~10 operations per channel: bytes,
// not operations, bound it. The texel reads are gathers, but the positions
// of neighbouring threads are neighbouring pixels displaced by similar
// motion, so the four taps of a warp fall on a few cache lines.
//
// Design: one thread per position, looping over the C channels; the image
// stays in device memory and is read through the read-only cache. The TPU
// kernel's bounded-displacement stencil (a tent-weighted sum over 2d+1 row
// passes, needed there because the TPU's gather is slow) has no
// counterpart: one direct gather serves any displacement, including
// off-screen positions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilinear_sample_kernel(const float* __restrict__ img, int h, int w, int c,
                       const float* __restrict__ pos, int64_t n, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = pos[2 * i] - 0.5f;
  const float py = pos[2 * i + 1] - 0.5f;
  const int x0 = (int)floorf(px);
  const int y0 = (int)floorf(py);
  const float fx = px - (float)x0;
  const float fy = py - (float)y0;
  const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
  const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
  const float* r0 = img + (int64_t)ya * w * c;
  const float* r1 = img + (int64_t)yb * w * c;
  float* o = out + i * c;
  for (int k = 0; k < c; ++k) {
    const float c00 = __ldg(r0 + xa * c + k), c10 = __ldg(r0 + xb * c + k);
    const float c01 = __ldg(r1 + xa * c + k), c11 = __ldg(r1 + xb * c + k);
    o[k] = c00 * (1.0f - fx) * (1.0f - fy) + c10 * fx * (1.0f - fy) +
           c01 * (1.0f - fx) * fy + c11 * fx * fy;
  }
}

}  // namespace

extern "C" int nrd_bilinear_sample(const void* img, int h, int w, int c, const void* pos,
                                   int64_t n, void* out, void* stream) {
  if (h <= 0 || w <= 0 || c <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  bilinear_sample_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, c, (const float*)pos, n, (float*)out);
  return (int)cudaGetLastError();
}
