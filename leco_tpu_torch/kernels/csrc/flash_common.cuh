// Shared pieces of the two flash-attention backward kernels (dQ, dK/dV): tile
// loads from device memory into shared memory, and a warp-level bf16
// tensor-core product. The forward has its own Hopper helpers
// (sm90_common.cuh).
//
// Layout contract (checked by the Python wrappers): q, k, v, o, dO are
// contiguous (BH, N, D) bf16; lse and delta are contiguous (BH, Nq) fp32.
// A tile is 64 rows; its head dim D is padded to DP (a multiple of the MMA
// depth 16) with zero columns in shared memory only, so device memory is
// never read or written past column D and any N works.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace leco {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kRows = 64;  // rows of every q / k tile
constexpr int kWarps = 4;  // each warp owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;

// Rows [row0, row0 + 64) of a row-major (n, D) matrix into a (64, DP) tile.
// Rows at or past n are zero. When `scale` is given, each value is scaled in
// fp32 and rounded back to bf16, the TPU kernel's q * scale.
template <int D, int DP, bool SCALED>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n, float scale) {
  const bf16* base = src + static_cast<size_t>(row0) * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    bf16 x = __float2bfloat16(0.f);
    if (row0 + r < n) {
      x = base[static_cast<size_t>(r) * D + c];
      if (SCALED) x = __float2bfloat16(__bfloat162float(x) * scale);
    }
    dst[r * DP + c] = x;
  }
}

// Zero the pad columns D..DP of a tile once; tile loads never touch them.
template <int D, int DP>
__device__ __forceinline__ void zero_pad_cols(bf16* tile) {
  if (DP == D) return;
  for (int i = threadIdx.x; i < kRows * (DP - D); i += kThreads) {
    const int r = i / (DP - D);
    tile[r * DP + D + (i - r * (DP - D))] = __float2bfloat16(0.f);
  }
}

// Per-row vector of length n into shared memory, zero past n.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kRows; i += kThreads)
    dst[i] = (row0 + i < n) ? src[row0 + i] : 0.f;
}

// One warp: C (16 x NC, fp32, row-major, ldc) {=, +=} A (16 x K, bf16,
// row-major, lda) * B (K x NC, bf16). B_COL_MAJOR: element (k, n) of B is
// B[n * ldb + k] (a row-major (NC, K) matrix read transposed); otherwise it
// is B[k * ldb + n]. fp32 accumulation on the tensor cores.
template <int K, int NC, bool B_COL_MAJOR, bool ACCUM>
__device__ __forceinline__ void warp_mma(float* C, int ldc, const bf16* A,
                                         int lda, const bf16* B, int ldb) {
  using BLayout = typename std::conditional<B_COL_MAJOR, wmma::col_major,
                                            wmma::row_major>::type;
#pragma unroll 1
  for (int n0 = 0; n0 < NC; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACCUM)
      wmma::load_matrix_sync(acc, C + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(a, A + k0, lda);
      wmma::load_matrix_sync(b, B_COL_MAJOR ? B + n0 * ldb + k0 : B + k0 * ldb + n0,
                             ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + n0, acc, ldc, wmma::mem_row_major);
  }
}

// The head dims of the SD family: 40 (padded to 48), 64, 80 and 160.
// Returns cudaErrorInvalidValue for any other D.
#define LECO_DISPATCH_HEAD_DIM(d, LAUNCH) \
  switch (d) {                            \
    case 40: return LAUNCH(40, 48);       \
    case 64: return LAUNCH(64, 64);       \
    case 80: return LAUNCH(80, 80);       \
    case 160: return LAUNCH(160, 160);    \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace leco
