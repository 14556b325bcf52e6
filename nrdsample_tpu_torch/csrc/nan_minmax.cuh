// Minimum and maximum under PyTorch's NaN rule.
//
// torch.minimum, torch.maximum, torch.clamp and torch.clamp_min give NaN when
// an operand is NaN, where fminf / fmaxf return the other operand. The
// denoiser kernels use these in place of fminf / fmaxf wherever their plain
// versions use those PyTorch ops, so that a NaN in the input (the stress
// tests without sanitization) reaches the same pixels on the card as on the
// CPU. Each is one instruction (PTX min.NaN / max.NaN, sm_80 and later); on
// two numbers it gives min.f32's / max.f32's result, which is what fminf /
// fmaxf compile to, bit for bit.

#pragma once

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
