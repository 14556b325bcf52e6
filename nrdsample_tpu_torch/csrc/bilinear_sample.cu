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
// motion, so the taps of a block fall on a few cache lines.
//
// Design: the image and the output stay in their HWC layout, so a thread
// per position looping over its C channels would make each warp access
// scatter 32 floats C apart. Instead a block takes a run of kPositions
// positions in two phases:
//   1. one thread per position computes its clamped texel offsets and
//      fractions into shared memory;
//   2. the block walks the run's kPositions x C outputs in flat order
//      (output e is channel e % C of position e / C; thread t takes outputs
//      t, t + kPositions, ...), so the 32 lanes of a warp read 32
//      neighbouring floats of a few texels per tap and write 32 neighbouring
//      floats of the output, one fully used 128-byte line per store.
// The stores are 4-byte, each warp's already one whole line: 16-byte stores
// were slower on the card in both forms tried, 4 consecutive outputs per
// thread (a warp's loads of one tap then spread over 4x as many positions)
// and the run staged in shared memory first (one more pass and barrier);
// runs of 256 positions gained nothing. The TPU kernel's bounded-displacement
// stencil (a tent-weighted sum over 2d+1 row passes, needed there because the
// TPU's gather is slow) has no counterpart: one direct gather serves any
// displacement, including off-screen positions.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kPositions = 128;   // positions per block = threads per block

struct Taps {
  int o00, o10, o01, o11;   // float offsets of the four texels' channel 0
  float fx, fy;
};

__global__ void __launch_bounds__(kPositions)
bilinear_sample_kernel(const float* __restrict__ img, int h, int w, int c,
                       const float* __restrict__ pos, int64_t n, float* __restrict__ out) {
  __shared__ Taps taps[kPositions];
  const int64_t first = (int64_t)blockIdx.x * kPositions;
  const int np = (int)min((int64_t)kPositions, n - first);
  const int tid = threadIdx.x;
  // phase 1: one thread per position
  if (tid < np) {
    const float px = pos[2 * (first + tid)] - 0.5f;
    const float py = pos[2 * (first + tid) + 1] - 0.5f;
    const int x0 = (int)floorf(px);
    const int y0 = (int)floorf(py);
    const int xa = min(max(x0, 0), w - 1), xb = min(max(x0 + 1, 0), w - 1);
    const int ya = min(max(y0, 0), h - 1), yb = min(max(y0 + 1, 0), h - 1);
    Taps t;
    t.o00 = (ya * w + xa) * c;
    t.o10 = (ya * w + xb) * c;
    t.o01 = (yb * w + xa) * c;
    t.o11 = (yb * w + xb) * c;
    t.fx = px - (float)x0;
    t.fy = py - (float)y0;
    taps[tid] = t;
  }
  __syncthreads();
  // phase 2: the run's outputs in flat order; output e is channel k of
  // position p, and both advance by a fixed step from one e to the next
  const int total = np * c;
  const int dp = kPositions / c, dk = kPositions % c;
  int p = tid / c, k = tid % c;
  float* o = out + first * c;
  for (int e = tid; e < total; e += kPositions) {
    const Taps& t = taps[p];
    const float c00 = __ldg(img + t.o00 + k), c10 = __ldg(img + t.o10 + k);
    const float c01 = __ldg(img + t.o01 + k), c11 = __ldg(img + t.o11 + k);
    o[e] = c00 * (1.0f - t.fx) * (1.0f - t.fy) + c10 * t.fx * (1.0f - t.fy) +
           c01 * (1.0f - t.fx) * t.fy + c11 * t.fx * t.fy;
    p += dp;
    k += dk;
    if (k >= c) {
      k -= c;
      ++p;
    }
  }
}

}  // namespace

extern "C" int nrd_bilinear_sample(const void* img, int h, int w, int c, const void* pos,
                                   int64_t n, void* out, void* stream) {
  if (h <= 0 || w <= 0 || c <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  // texel offsets and a run's output count are int: the image must hold
  // fewer than 2^31 floats, a run of kPositions pixels too
  if ((int64_t)h * w * c > INT_MAX || c > INT_MAX / kPositions) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int64_t blocks = (n + kPositions - 1) / kPositions;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  bilinear_sample_kernel<<<(unsigned)blocks, kPositions, 0, (cudaStream_t)stream>>>(
      (const float*)img, h, w, c, (const float*)pos, n, (float*)out);
  return (int)cudaGetLastError();
}
