// Input-gradient sampled-dense kernels: dx = sum_s g_s @ W_s^T for a shared
// input, and dxs[s] = g_s @ W_s^T for the per-sample-input variant, with
// W_s = loc + softplus(rho) * eps_s regenerated from the forward's counter-based
// noise (sampled_dense_common.cuh), never read from device memory.
//
// Replaces the Pallas kernels _bwd_dx_kernel and _bwd_xs_dx_kernel
// (robustbnns_tpu/ops/sampled_dense.py:114 and :362).
//
// What bounds them on the H100. At the main path's shapes (B = 128, S = 10;
// 784 -> 1024 for dx, 1024 -> 1024 and 1024 -> 10 for dxs) the wide layers do
// S*B*I*O exact-f32 FMAs (1.03 and 1.34 G: 31 and 40 us at the H100 SXM's
// 67 TFLOP/s FP32 peak) on the FFMA pipe, which also issues everything else.
// They also draw S*I*O normals, and at B = 128 each normal feeds only 128 FMAs
// while costing about 57 instructions on its fast path (a quarter of a
// Philox4x32-10 and half of a precise Box-Muller: 228 SASS instructions for a
// probe kernel around one normal4, scripts/torch_dx_probe.py), so the noise
// adds over 40% to the issue slots the FFMAs need. The 10-class head is bound by writing dxs
// (5.2 MB).
//
// Design:
// - Wide path (O > 16). A block of 128 threads owns a 128-row x 64-input tile
//   and walks a run of work units u = s * C + c, c the 16-deep chunk of O
//   (four Philox quads, so a quad is never split and at B <= 128 every eps is
//   drawn once per call). Each thread accumulates 8 rows x 8 inputs from
//   float4 shared-memory reads: 4 loads per 64 FFMA, and a quarter warp reads
//   one broadcast of g^T and 128 contiguous bytes of W^T. The g^T and W^T
//   tiles are double-buffered with one __syncthreads per unit: the next
//   unit's g, loc and softplus(rho) tiles arrive by cp.async during this
//   unit's FFMAs, then each thread transposes its own g float4s and draws two
//   Philox quads of W^T. 126 registers, no spills, four blocks (16 warps) on
//   an SM.
// - softplus(rho) is computed once per call into a scratch (I, O) by a small
//   elementwise pass, so no unit pays expf/log1pf again for each sample.
// - Filling the card: each tile's units are split into n_split runs, one
//   block each (ops/sampled_dense.py dx_plan). dx splits all S * C units of a
//   tile (layer 0: 13 tiles x 40 runs = 520 blocks, four an SM); dxs splits
//   each sample's C chunks only while the grid is small (the hidden layer:
//   16 tiles x 10 samples x 3 runs = 480 blocks). Each run writes its partial
//   tile to a scratch, and a second pass sums the partials in the order
//   0 .. n_split-1: no atomics, so the result is bit-identical from call to
//   call, and dx's sum over samples stays in these kernels. dx's runs are at
//   most 48 whatever S is; dxs's partials exist only for small grids. With
//   one run a block writes its tile to the output itself.
// - Narrow path (O <= 16, the 10-class head). A block of 4 warps owns 128
//   rows x 32 inputs: per sample each (warp, lane) draws one Philox quad of
//   W_s^T into shared memory (softplus inline), then each warp takes a row at
//   a time with one input per lane, so g is one broadcast and each store a
//   128-byte line of dxs[s, b, :]. dx's narrow path sums S in registers.
// - Any B, I, O and S: ragged edges are masked; cp.async and vector loads
//   only where O is a multiple of 4 (else plain masked loads), vector stores
//   only where I is.
#include "sampled_dense_passes.cuh"

namespace sampled_dense {
namespace {

constexpr int kDxRows = 128;     // batch rows of a wide block
constexpr int kDxCols = 64;      // inputs i of a wide block
constexpr int kDxDepth = 16;     // outputs o per work unit (four Philox quads)
constexpr int kDxThreads = 128;  // 16 row groups x 8 input groups, 8 x 8 outputs each
constexpr int kNarrowO = 16;        // the narrow path takes O <= kNarrowO
constexpr int kNarrowThreads = 128;  // 4 warps: one Philox quad each per input
constexpr int kNarrowCols = 32;      // inputs i of a narrow block, one per lane
constexpr int kNarrowRows = 128;     // batch rows of a narrow block

// One 128-row x 64-input tile over a run of work units u = s * C + c (c: the
// 16-deep chunk of O). kSum: block row y is run y of the tile's S * C units.
// Else: block row y is sample y / n_split, chunks run y % n_split of its C.
// With n_split > 1 the tile goes to partials[run] (dxs: + s * B * I).
template <bool kSum>
__global__ void __launch_bounds__(kDxThreads, 4) dx_wide_kernel(
    const float* __restrict__ g,    // (S, B, O)
    const float* __restrict__ loc,  // (I, O)
    const float* __restrict__ sp,   // (I, O) softplus(rho)
    float* __restrict__ out,        // dx (B, I) or dxs (S, B, I); the partials when n_split > 1
    int S, int B, int I, int O, uint32_t seed, int n_split) {
  constexpr int kGStride = kDxRows + 4;  // padded rows: fewer bank conflicts on the
  constexpr int kWStride = kDxCols + 4;  // transposed stores, float4 reads stay aligned
  __shared__ __align__(16) float gt[2][kDxDepth][kGStride];  // g^T of a unit
  __shared__ __align__(16) float wt[2][kDxDepth][kWStride];  // W_s^T of a unit

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kDxCols, b0 = blockIdx.z * kDxRows;
  const int C = (O + kDxDepth - 1) / kDxDepth;
  const bool vec_o = (O & 3) == 0;
  int run, s_out;
  long long u_begin, u_end;
  if (kSum) {
    run = blockIdx.y, s_out = 0;
    const long long total = (long long)S * C;
    u_begin = total * run / n_split;
    u_end = total * (run + 1) / n_split;
  } else {
    run = blockIdx.y % n_split, s_out = blockIdx.y / n_split;
    u_begin = (long long)s_out * C + (long long)C * run / n_split;
    u_end = (long long)s_out * C + (long long)C * (run + 1) / n_split;
  }

  // FFMA: rows 8tr .. 8tr+7, inputs 4tc .. 4tc+3 and 32+4tc .. 32+4tc+3, so a
  // quarter warp reads 128 contiguous bytes of W^T and one broadcast of g^T.
  const int tr = tid / 8, tc = tid % 8;
  const int wq = tid % 4, wi = tid / 4;  // draws quad wq of inputs wi and wi + 32

  // The next unit's g, loc and softplus(rho) tiles land here (cp.async where O
  // is a multiple of 4) while the FFMAs run; each thread stages only the
  // float4s it fetched itself, so no barrier guards these buffers.
  __shared__ __align__(16) float graw[kDxRows][kDxDepth];
  __shared__ __align__(16) float lraw[kDxCols][kDxDepth];
  __shared__ __align__(16) float sraw[kDxCols][kDxDepth];
  auto fetch = [&](long long u) {
    const int s = (int)(u / C), o0 = (int)(u % C) * kDxDepth, o = o0 + 4 * wq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = tid + j * kDxThreads, r = f / 4, k = 4 * (f % 4), b = b0 + r;
      const float* src = g + ((size_t)s * B + min(b, B - 1)) * O;
      if (vec_o) {
        cp_async16(&graw[r][k], src + min(o0 + k, O - 4), b < B && o0 + k < O);
      } else {
        *reinterpret_cast<float4*>(&graw[r][k]) =
            b < B ? load4(src, o0 + k, O) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wi + 32 * h, i = i0 + r;
      const size_t row = (size_t)min(i, I - 1) * O;
      if (vec_o) {
        cp_async16(&lraw[r][4 * wq], loc + row + min(o, O - 4), i < I && o < O);
        cp_async16(&sraw[r][4 * wq], sp + row + min(o, O - 4), i < I && o < O);
      } else {
        const bool in = i < I;
        *reinterpret_cast<float4*>(&lraw[r][4 * wq]) =
            in ? load4(loc + row, o, O) : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&sraw[r][4 * wq]) =
            in ? load4(sp + row, o, O) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    cp_async_commit();
  };
  auto stage = [&](long long u, int buf) {
    const int s = (int)(u / C), o0 = (int)(u % C) * kDxDepth, o = o0 + 4 * wq;
    cp_async_wait_all();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = tid + j * kDxThreads, r = f / 4, k = 4 * (f % 4);
      const float4 v = *reinterpret_cast<const float4*>(&graw[r][k]);
      gt[buf][k + 0][r] = v.x;
      gt[buf][k + 1][r] = v.y;
      gt[buf][k + 2][r] = v.z;
      gt[buf][k + 3][r] = v.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wi + 32 * h, i = i0 + r;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);  // zero past I and O, where loc and sp are zero
      if (i < I && o < O) {
        const float4 lv = *reinterpret_cast<const float4*>(&lraw[r][4 * wq]);
        const float4 sv = *reinterpret_cast<const float4*>(&sraw[r][4 * wq]);
        const float4 z = normal4(seed, s, i, o >> 2);
        w = make_float4(draw(lv.x, sv.x, z.x), draw(lv.y, sv.y, z.y), draw(lv.z, sv.z, z.z),
                        draw(lv.w, sv.w, z.w));
      }
      wt[buf][4 * wq + 0][r] = w.x;
      wt[buf][4 * wq + 1][r] = w.y;
      wt[buf][4 * wq + 2][r] = w.z;
      wt[buf][4 * wq + 3][r] = w.w;
    }
  };

  float acc[8][8] = {};
  if (u_begin < u_end) {
    fetch(u_begin);
    stage(u_begin, 0);
  }
  __syncthreads();
  int buf = 0;
  for (long long u = u_begin; u < u_end; ++u) {
    const bool more = u + 1 < u_end;
    if (more) fetch(u + 1);
#pragma unroll
    for (int k = 0; k < kDxDepth; ++k) {
      const float4 ga = *reinterpret_cast<const float4*>(&gt[buf][k][8 * tr]);
      const float4 gb = *reinterpret_cast<const float4*>(&gt[buf][k][8 * tr + 4]);
      const float4 wa = *reinterpret_cast<const float4*>(&wt[buf][k][4 * tc]);
      const float4 wb = *reinterpret_cast<const float4*>(&wt[buf][k][32 + 4 * tc]);
      const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(gv[r], wv[c], acc[r][c]);
    }
    if (more) stage(u + 1, buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  const size_t plane = (size_t)B * I;
  float* dst = out + (n_split > 1 ? run * (kSum ? plane : S * plane) : 0) + s_out * plane;
  store_tile(dst, acc, 0, B, I, b0 + 8 * tr, i0 + 4 * tc);
  store_tile(dst, acc, 4, B, I, b0 + 8 * tr, i0 + 32 + 4 * tc);
}

// O <= 16: a block owns 128 rows x 32 inputs. Per sample, each of its first
// 32 * ceil(O/4) threads draws one Philox quad of W_s^T (softplus inline),
// then a warp takes one row at a time and its lanes the 32 inputs: the g row
// is one broadcast, the stores one 128-byte line. kSum: block row 0 loops
// over all samples and sums in registers; else block row y is sample y.
template <bool kSum>
__global__ void __launch_bounds__(kNarrowThreads) dx_narrow_kernel(
    const float* __restrict__ g, const float* __restrict__ loc, const float* __restrict__ rho,
    float* __restrict__ out,  // kSum: dx (B, I); else dxs (S, B, I)
    int S, int B, int I, int O, uint32_t seed) {
  __shared__ __align__(16) float gs[kNarrowRows][kNarrowO];  // g rows, zero past O and B
  __shared__ __align__(16) float ws[kNarrowCols][kNarrowO];  // W_s rows, zero past O and I
  const int lane = threadIdx.x % kNarrowCols, warp = threadIdx.x / kNarrowCols;
  const int i0 = blockIdx.x * kNarrowCols, i = i0 + lane;
  const int b0 = blockIdx.z * kNarrowRows;
  const int s_begin = kSum ? 0 : blockIdx.y, s_end = kSum ? S : blockIdx.y + 1;
  constexpr int kRowsPerWarp = kNarrowRows / (kNarrowThreads / kNarrowCols);

  float acc[kRowsPerWarp] = {};
  for (int s = s_begin; s < s_end; ++s) {
    __syncthreads();  // the previous sample's tiles are consumed
    for (int k = threadIdx.x; k < kNarrowRows * kNarrowO; k += kNarrowThreads) {
      const int r = k / kNarrowO, o = k % kNarrowO, b = b0 + r;
      gs[r][o] = (b < B && o < O) ? g[((size_t)s * B + b) * O + o] : 0.f;
    }
    {  // thread (lane, warp) draws quad q = warp of input i
      const int q = warp;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < I && 4 * q < O) {
        const float4 z = normal4(seed, s, i, q);
        float* wp = &w.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 4 * q + j;
          if (o < O) {
            const size_t at = (size_t)i * O + o;
            wp[j] = draw(loc[at], softplus(rho[at]), component(z, j));
          }
        }
      }
      *reinterpret_cast<float4*>(&ws[lane][4 * q]) = w;
    }
    __syncthreads();
    float wv[kNarrowO];
#pragma unroll
    for (int q = 0; q < kNarrowO / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(&ws[lane][4 * q]);
      wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * (kNarrowThreads / kNarrowCols);
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < kNarrowO / 4; ++q) {  // one broadcast float4 per warp, o in order
        const float4 v = *reinterpret_cast<const float4*>(&gs[r][4 * q]);
        d = fmaf(v.x, wv[4 * q], d);
        d = fmaf(v.y, wv[4 * q + 1], d);
        d = fmaf(v.z, wv[4 * q + 2], d);
        d = fmaf(v.w, wv[4 * q + 3], d);
      }
      if (kSum) {
        acc[j] += d;
      } else if (b0 + r < B && i < I) {
        out[((size_t)s * B + b0 + r) * I + i] = d;
      }
    }
  }
  if (kSum && i < I) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * (kNarrowThreads / kNarrowCols);
      if (b0 + r < B) out[(size_t)(b0 + r) * I + i] = acc[j];
    }
  }
}

// O <= kNarrowO: the narrow kernel. Else softplus(rho) into sp, the wide
// kernel with n_split runs per tile (dx) or chunk runs per sample (dxs), and,
// when n_split > 1, the fixed-order sum of the partials into out.
template <bool kSum>
int launch(const float* g, const float* loc, const float* rho, float* sp, float* partials,
           float* out, int S, int B, int I, int O, uint32_t seed, int n_split, cudaStream_t stream) {
  if (n_split < 1 || (n_split > 1 && (!partials || O <= kNarrowO)) || (!kSum && (long long)S * n_split > 65535))
    return (int)cudaErrorInvalidValue;
  if (O <= kNarrowO) {
    const dim3 grid((I + kNarrowCols - 1) / kNarrowCols, kSum ? 1 : S,
                    (B + kNarrowRows - 1) / kNarrowRows);
    dx_narrow_kernel<kSum><<<grid, kNarrowThreads, 0, stream>>>(g, loc, rho, out, S, B, I, O, seed);
    return (int)cudaGetLastError();
  }
  if (!sp) return (int)cudaErrorInvalidValue;
  const long long n_params = (long long)I * O;
  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);
  const dim3 grid((I + kDxCols - 1) / kDxCols, kSum ? n_split : S * n_split, (B + kDxRows - 1) / kDxRows);
  dx_wide_kernel<kSum><<<grid, kDxThreads, 0, stream>>>(g, loc, sp, n_split > 1 ? partials : out, S, B,
                                                        I, O, seed, n_split);
  if (n_split > 1) {
    const long long n = (long long)B * I * (kSum ? 1 : S);
    sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, out, n, n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sampled_dense

// dx = sum_s g_s W_s^T. sp: an (I, O) scratch for softplus(rho) (wide path);
// partials: an (n_split, B, I) scratch when n_split > 1, else unused.
extern "C" int sampled_dense_dx(const float* g, const float* loc, const float* rho, float* sp,
                                float* partials, float* dx, int S, int B, int I, int O,
                                uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<true>(g, loc, rho, sp, partials, dx, S, B, I, O, seed, n_split,
                                     static_cast<cudaStream_t>(stream));
}

// dxs[s] = g_s W_s^T. As sampled_dense_dx, with (n_split, S, B, I) partials.
extern "C" int sampled_dense_xs_dx(const float* g, const float* loc, const float* rho, float* sp,
                                   float* partials, float* dxs, int S, int B, int I, int O,
                                   uint32_t seed, int n_split, void* stream) {
  return sampled_dense::launch<false>(g, loc, rho, sp, partials, dxs, S, B, I, O, seed, n_split,
                                      static_cast<cudaStream_t>(stream));
}
