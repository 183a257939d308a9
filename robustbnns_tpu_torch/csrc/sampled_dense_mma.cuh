// The bf16 tensor-core pieces of the sampled-dense kernels: one warp-wide
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators), the packing of two f32
// values into a bf16 pair, and a 4-warp block's products over one staged
// chunk; the transposing ldmatrix of sampled_dense_xs_bf16.cu. Shared by the
// three bf16 sources.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// for lane = 4 gq + tq: a[0] holds A(gq, 2tq .. 2tq+1), a[1] A(gq+8, ..),
// a[2] A(gq, 2tq+8 ..), a[3] A(gq+8, 2tq+8 ..); b[0] holds B(2tq .. 2tq+1, gq),
// b[1] B(2tq+8 .., gq); c[0], c[1] are C(gq, 2tq), C(gq, 2tq+1) and c[2], c[3]
// the same columns of row gq+8. Each 32-bit register holds two bf16, the lower
// index in the low half.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sampled_dense {
namespace {

constexpr int kMmaThreads = 128;  // 4 warps of 32 rows each
constexpr int kMmaWarpRows = 32;  // two m16 tiles a warp

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16: lane 8j + r gives the
// address of row r of 8 x 8 matrix j (8 bf16, 16-byte aligned); lane
// 4 gq + tq receives in r[j] the elements (row 2tq, column gq) and
// (2tq + 1, gq) of matrix j, the first in the low half: for a row-major
// (k, n) B operand, the m16n8k16 B fragment of the matrix's columns.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lower address) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_word(const uint16_t* p) {  // two bf16, the lower index in the low half
  return *reinterpret_cast<const uint32_t*>(p);
}

// One kDepth-deep chunk of a 4-warp block's products: warp w adds rows
// 32w .. 32w+31 of As times the kCols rows of Bs (both k-contiguous, row
// stride kDepth + 8) into acc[m tile][n tile].
template <int kCols, int kDepth>
__device__ __forceinline__ void mma_chunk(const uint16_t* __restrict__ as, const uint16_t* __restrict__ bs,
                                          float (&acc)[2][kCols / 8][4]) {
  constexpr int kStride = kDepth + 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int k0 = 0; k0 < kDepth; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint16_t* p = as + (warp * kMmaWarpRows + 16 * mt + gq) * kStride + k0 + 2 * tq;
      a[mt][0] = smem_word(p);
      a[mt][1] = smem_word(p + 8 * kStride);
      a[mt][2] = smem_word(p + 8);
      a[mt][3] = smem_word(p + 8 * kStride + 8);
    }
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const uint16_t* p = bs + (8 * nt + gq) * kStride + k0 + 2 * tq;
      const uint32_t b[2] = {smem_word(p), smem_word(p + 8)};
      mma_bf16_16816(acc[0][nt], a[0], b);
      mma_bf16_16816(acc[1][nt], a[1], b);
    }
  }
}

}  // namespace
}  // namespace sampled_dense
