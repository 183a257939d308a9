// A CPU stand-in for the bf16 pieces of CUDA's cuda_bf16.h that the port's
// kernels use, for tests/test_torch_kernel_emulation.py: the conversion of an
// f32 value to bf16, rounded to nearest with ties to even as on the card (and
// as torch's .to(torch.bfloat16)), and the pair whose .x sits at the lower
// address.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { std::uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7F800000u) == 0x7F800000u && (u & 0x007FFFFFu)) return {0x7FC0};  // NaN
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {static_cast<std::uint16_t>(u >> 16)};
}

inline std::uint16_t __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }

inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
