// RELAX temporal accumulation with the variance estimate, one launch per signal.
//
// Replaces the Pallas TPU kernel nrdsample_tpu/denoise/taccum_pallas.py:_taccum_kernel
// (taccum_variance_pallas). Function, per pixel, as the plain version
// denoise/relax.py:taccum_plain computes it:
//   1. anti-firefly: the input luminance clamped to the [min, max] of its 8
//      clamped neighbours, the colour scaled by clamped / max(lum, 1e-9);
//   2. a clamp-to-edge bilinear gather of the 10 history channels at
//      pixel centre + mv.xy (mathlib/filtering.py:sample_bilinear);
//   3. disocclusion: |prev_z - (z + mv.z)| / max(|z|, 1e-3) < threshold and
//      dot(n, prev_n) > 0.5, times on-screen, times the confidence plane
//      (where the wrapper has folded a reset in as 0);
//   4. frames = min(prev_frames * valid + 1, max_frames), alpha = 1 / frames,
//      the illumination and the (lum, lum^2) moments blended where valid;
//   5. variance = max(m2 - m1^2, 0), and for frames < 4 the larger of that and
//      the 3x3 spatial variance of the accumulated luminance.
// The library is built with --fmad=false and without fast math, and the
// arithmetic below is the plain version's sequence of float32 operations, so
// the two agree to the ULP on the card.
//
// What bounds it on the card: per pixel it reads 21 float planes (10 of history,
// 11 of the current frame) and writes 7, ~112 bytes, against ~250 float32
// instructions: bytes bound it at 1920x1080 (~0.07 ms at 3.35 TB/s).
//
// Design: the variance needs the accumulated luminance of the 3x3 neighbours,
// so a block computes the accumulation for a 32x32 ring of positions and
// writes the 30x30 outputs inside it (1.14 accumulations per output). Its 32x8
// threads take 4 ring rows each, one warp per row, so every pass keeps all 256
// threads busy and a warp's loads of a plane fall on one image row. The input
// luminance of the ring plus a 1-pixel margin (34x34) is staged once in shared
// memory; the anti-firefly reads its 8 neighbours from there. The accumulated
// luminance, the temporal variance and the frame count of every ring position
// go to shared memory too; after one barrier each thread takes the 3x3 sums of
// its own positions from there. A ring position outside the image computes the
// clamped edge pixel, which is what the plain version's clamped shift reads;
// its anti-firefly neighbours are the edge pixel's clamped neighbours, which the
// staged margin holds. The TPU kernel's bounded tent-stencil gather (needed
// there because its gather is slow) has no counterpart: one direct bilinear
// gather serves every displacement, off-screen included. Row bands, lane rolls
// and pad-to-128 layouts are the TPU's and do not carry over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRingW = 32;              // ring positions per row: one warp
constexpr int kRingH = 32;              // ring rows
constexpr int kRows = 8;                // thread rows; each takes kRingH / kRows ring rows
constexpr int kOutW = kRingW - 2, kOutH = kRingH - 2;
constexpr int kInW = kRingW + 2, kInH = kRingH + 2;   // staged input luminance

__device__ __forceinline__ float lum3(float r, float g, float b) {
  return r * (float)0.2126 + g * (float)0.7152 + b * (float)0.0722;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

struct Planes {
  const float* h_il;   // (H, W, 3)
  const float* h_m;    // (H, W, 2)
  const float* h_z;    // (H, W)
  const float* h_n;    // (H, W, 3)
  const float* h_f;    // (H, W)
  const float* il;     // (H, W, 3)
  const float* vz;     // (H, W)
  const float* nrm;    // (H, W, 3)
  const float* mv;     // (H, W, 3)
  const float* conf;   // (H, W) or null
  const float* max_frames;
  int h, w;
  float thr;
  int anti_ff;
};

// bilinear weights of the four texels in the plain version's order
struct Tap {
  int64_t i00, i10, i01, i11;
  float fx, fy;
};

__device__ __forceinline__ float blend(const float* a, int stride, int k, const Tap& t) {
  const float c00 = __ldg(a + t.i00 * stride + k), c10 = __ldg(a + t.i10 * stride + k);
  const float c01 = __ldg(a + t.i01 * stride + k), c11 = __ldg(a + t.i11 * stride + k);
  return c00 * (1.0f - t.fx) * (1.0f - t.fy) + c10 * t.fx * (1.0f - t.fy) +
         c01 * (1.0f - t.fx) * t.fy + c11 * t.fx * t.fy;
}

// Accumulation at pixel (y, x), inside the image; nb points at its staged
// input luminance, rows kInW apart. Fills acc[3], m1, m2, frames.
__device__ void accumulate(const Planes& p, const float* nb, int y, int x, float acc[3],
                           float& m1, float& m2, float& frames) {
  const int64_t i = (int64_t)y * p.w + x;
  float il[3] = {__ldg(p.il + 3 * i), __ldg(p.il + 3 * i + 1), __ldg(p.il + 3 * i + 2)};
  if (p.anti_ff) {
    const float l = nb[0];
    float nmin = 0.0f, nmax = 0.0f;
    bool first = true;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        const float ln = nb[dy * kInW + dx];
        nmin = first ? ln : fminf(nmin, ln);
        nmax = first ? ln : fmaxf(nmax, ln);
        first = false;
      }
    }
    const float scale = fminf(fmaxf(l, nmin), nmax) / fmaxf(l, 1e-9f);
    for (int k = 0; k < 3; ++k) il[k] = il[k] * scale;
  }

  // history gather at the pixel centre + mv.xy
  const float mvx = __ldg(p.mv + 3 * i), mvy = __ldg(p.mv + 3 * i + 1);
  const float mvz = __ldg(p.mv + 3 * i + 2);
  const float posx = ((float)x + 0.5f) + mvx, posy = ((float)y + 0.5f) + mvy;
  const float sx = posx - 0.5f, sy = posy - 0.5f;
  const int x0 = (int)floorf(sx), y0 = (int)floorf(sy);
  Tap t;
  t.fx = sx - (float)x0;
  t.fy = sy - (float)y0;
  const int xa = clampi(x0, 0, p.w - 1), xb = clampi(x0 + 1, 0, p.w - 1);
  const int ya = clampi(y0, 0, p.h - 1), yb = clampi(y0 + 1, 0, p.h - 1);
  t.i00 = (int64_t)ya * p.w + xa;
  t.i10 = (int64_t)ya * p.w + xb;
  t.i01 = (int64_t)yb * p.w + xa;
  t.i11 = (int64_t)yb * p.w + xb;
  float prev_il[3], prev_n[3];
  for (int k = 0; k < 3; ++k) prev_il[k] = blend(p.h_il, 3, k, t);
  const float prev_m1 = blend(p.h_m, 2, 0, t), prev_m2 = blend(p.h_m, 2, 1, t);
  const float prev_z = blend(p.h_z, 1, 0, t);
  for (int k = 0; k < 3; ++k) prev_n[k] = blend(p.h_n, 3, k, t);
  const float prev_f = blend(p.h_f, 1, 0, t);

  // disocclusion (denoise/common.py:disocclusion_weight), on-screen, confidence
  const float z = __ldg(p.vz + i);
  const float* n = p.nrm + 3 * i;
  const float rel = fabsf(prev_z - (z + mvz)) / fmaxf(fabsf(z), 1e-3f);
  const float ndot = __ldg(n) * prev_n[0] + __ldg(n + 1) * prev_n[1] + __ldg(n + 2) * prev_n[2];
  float valid = (rel < p.thr ? 1.0f : 0.0f) * (ndot > 0.5f ? 1.0f : 0.0f);
  const bool on = posx >= 0.0f && posx <= (float)p.w && posy >= 0.0f && posy <= (float)p.h;
  valid = valid * (on ? 1.0f : 0.0f);
  if (p.conf != nullptr) valid = valid * __ldg(p.conf + i);

  frames = fminf(prev_f * valid + 1.0f, __ldg(p.max_frames));
  const float alpha = 1.0f / frames;
  const float l = lum3(il[0], il[1], il[2]);
  const float l2 = l * l;
  if (valid > 0.0f) {
    for (int k = 0; k < 3; ++k) acc[k] = prev_il[k] * (1.0f - alpha) + il[k] * alpha;
    m1 = prev_m1 * (1.0f - alpha) + l * alpha;
    m2 = prev_m2 * (1.0f - alpha) + l2 * alpha;
  } else {
    for (int k = 0; k < 3; ++k) acc[k] = il[k];
    m1 = l;
    m2 = l2;
  }
}

__global__ void __launch_bounds__(kRingW * kRows)
relax_taccum_kernel(Planes p, float* __restrict__ out_il, float* __restrict__ out_m,
                    float* __restrict__ out_f, float* __restrict__ out_var) {
  __shared__ float s_in[kInH * kInW];          // input luminance, clamped to the image
  __shared__ float s_lum[kRingH * kRingW];     // accumulated luminance
  __shared__ float s_var_t[kRingH * kRingW];
  __shared__ float s_frames[kRingH * kRingW];
  const int tid = threadIdx.y * kRingW + threadIdx.x;
  const int oy = blockIdx.y * kOutH, ox = blockIdx.x * kOutW;   // first output pixel

  // stage the input luminance of rows oy-2 .. oy+kOutH+1, columns likewise
  for (int r = tid; r < kInH * kInW; r += kRingW * kRows) {
    const int y = clampi(oy - 2 + r / kInW, 0, p.h - 1);
    const int x = clampi(ox - 2 + r % kInW, 0, p.w - 1);
    const float* c = p.il + ((int64_t)y * p.w + x) * 3;
    s_in[r] = lum3(__ldg(c), __ldg(c + 1), __ldg(c + 2));
  }
  __syncthreads();

  const int rx = threadIdx.x, gx = ox - 1 + rx;
  const int x = clampi(gx, 0, p.w - 1);
  const bool own_x = rx >= 1 && rx <= kOutW && gx < p.w;
#pragma unroll 1
  for (int ry = threadIdx.y; ry < kRingH; ry += kRows) {
    const int gy = oy - 1 + ry;
    const int y = clampi(gy, 0, p.h - 1);
    float acc[3], m1, m2, frames;
    accumulate(p, s_in + (y - oy + 2) * kInW + (x - ox + 2), y, x, acc, m1, m2, frames);
    const int r = ry * kRingW + rx;
    s_lum[r] = lum3(acc[0], acc[1], acc[2]);
    s_var_t[r] = fmaxf(m2 - m1 * m1, 0.0f);
    s_frames[r] = frames;
    if (own_x && ry >= 1 && ry <= kOutH && gy < p.h) {
      const int64_t i = (int64_t)gy * p.w + gx;
      for (int k = 0; k < 3; ++k) out_il[3 * i + k] = acc[k];
      out_m[2 * i] = m1;
      out_m[2 * i + 1] = m2;
      out_f[i] = frames;
    }
  }
  __syncthreads();

  if (!own_x) return;
  const float ninth = (float)(1.0 / 9.0);
#pragma unroll 1
  for (int ry = threadIdx.y; ry < kRingH; ry += kRows) {
    const int gy = oy - 1 + ry;
    if (ry < 1 || ry > kOutH || gy >= p.h) continue;
    float s1 = 0.0f, s2 = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dx = -1; dx <= 1; ++dx) {
        const float ln = s_lum[(ry + dy) * kRingW + rx + dx];
        s1 = s1 + ln;
        s2 = s2 + ln * ln;
      }
    }
    const float mu = s1 * ninth;
    const float var_s = fmaxf(s2 * ninth - mu * mu, 0.0f);
    const int r = ry * kRingW + rx;
    const float var_t = s_var_t[r];
    out_var[(int64_t)gy * p.w + gx] = s_frames[r] < 4.0f ? fmaxf(var_s, var_t) : var_t;
  }
}

}  // namespace

extern "C" int nrd_relax_taccum(const void* h_il, const void* h_m, const void* h_z,
                                const void* h_n, const void* h_f, const void* il,
                                const void* vz, const void* nrm, const void* mv,
                                const void* conf, const void* max_frames, int h, int w,
                                float thr, int anti_ff, void* out_il, void* out_m, void* out_f,
                                void* out_var, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  Planes p{(const float*)h_il, (const float*)h_m, (const float*)h_z, (const float*)h_n,
           (const float*)h_f,  (const float*)il,  (const float*)vz,  (const float*)nrm,
           (const float*)mv,   (const float*)conf, (const float*)max_frames, h, w, thr,
           anti_ff};
  const dim3 block(kRingW, kRows);
  const dim3 grid((w + kOutW - 1) / kOutW, (h + kOutH - 1) / kOutH);
  relax_taccum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      p, (float*)out_il, (float*)out_m, (float*)out_f, (float*)out_var);
  return (int)cudaGetLastError();
}
