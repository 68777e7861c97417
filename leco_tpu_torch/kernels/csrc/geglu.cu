// Fused GEGLU projection for Hopper (sm_90a):
//   out = value * gelu(gate),  [value | gate] = x W^T + b + xd up^T
// with gelu the exact gelu through the Abramowitz-Stegun 7.1.26 erf
// polynomial (leco_tpu/ops/geglu.py `_erf_poly`).
//
// Replaces: leco_tpu/ops/geglu.py, `_kernel` (reached through `_fwd_impl`
// and the `geglu_fused` custom VJP).
//
// Layout contract (checked by the Python wrapper): x (M, K) and out (M, N)
// contiguous bf16; w (2N, K) contiguous bf16 (torch Linear layout: rows
// [0, N) are the value half, [N, 2N) the gate half); bias fp32 (2N) or null;
// the LoRA delta xd (M, r) and up (2N, r) contiguous bf16 with r <= 16, or
// null with r = 0. K and N are multiples of 8.
//
// What bounds it on this card: at the SD1.5 level-0 shape (M = 8192,
// K = 320, N = 1280) it does 2*M*K*2N = 13.4 GFLOP against about 28 MB of
// x, W and out, some 480 operations per byte: compute-bound, but close
// enough to the ridge that not writing the (M, 2N) projection matters. The
// unfused form writes and re-reads it (42 MB) and runs gelu and the product
// as separate passes.
//
// What the design does: a block owns 128 rows x 64 output columns and keeps
// two fp32 accumulators, one for the value columns and one for the matching
// gate columns, so the projection never leaves the SM. K streams through
// shared memory in 32-wide stages with 16-byte loads. The rank-r delta is
// one more MMA step per accumulator, with r zero-padded to the MMA depth 16
// in shared memory. 8 warps, each 32 x 32 of the output, use WMMA m16n16k16
// bf16 with fp32 accumulation; the bias, the erf polynomial and the product
// run in fp32 on the accumulators, with one rounding to bf16. Ragged M is
// masked. A simple first kernel: no pipelining of the K stages.
#include "wmma_common.cuh"

namespace leco {
namespace geglu {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kGegluThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kLdK = kBK + 8;
constexpr int kRankPad = 16;
constexpr int kLdR = kRankPad + 8;

constexpr size_t smem_bytes() {
  return (kBM * kLdK + 2 * kBN * kLdK + kBM * kLdR + 2 * kBN * kLdR) * sizeof(bf16);
}

__device__ __forceinline__ float erf_poly(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float sign = static_cast<float>((x > 0.f) - (x < 0.f));
  const float ax = fabsf(x);
  const float t = 1.f / (1.f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return sign * (1.f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_poly(float g) {
  return 0.5f * g * (1.f + erf_poly(g * 0.70710678118654752f));
}

// rows [row0, row0 + rows) x columns [k0, k0 + kBK) of a row-major (n, ld)
// bf16 matrix into a (rows, kLdK) tile, 8 values per load; zero outside.
template <int ROWS>
__device__ __forceinline__ void load_k_tile(bf16* dst, const bf16* src, int row0,
                                            int n, int k0, int ld) {
  constexpr int kVecs = kBK / 8;
  for (int i = threadIdx.x; i < ROWS * kVecs; i += kGegluThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < n && k0 + c < ld)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * ld + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * kLdK + c) = v;
  }
}

// rows [row0, row0 + rows) of a row-major (n, r) matrix into (rows, kLdR),
// zero past row n and column r.
template <int ROWS>
__device__ __forceinline__ void load_rank_tile(bf16* dst, const bf16* src, int row0,
                                               int n, int r) {
  for (int i = threadIdx.x; i < ROWS * kRankPad; i += kGegluThreads) {
    const int row = i / kRankPad;
    const int c = i - row * kRankPad;
    bf16 v = __float2bfloat16(0.f);
    if (row0 + row < n && c < r) v = src[static_cast<size_t>(row0 + row) * r + c];
    dst[row * kLdR + c] = v;
  }
}

using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

// acc_v/acc_g += A (the warp's 32 rows of a, lda) times the warp's 32
// columns of bv/bg (col-major, ldb), one MMA depth of 16.
__device__ __forceinline__ void mma_step(FragAcc (&acc_v)[2][2], FragAcc (&acc_g)[2][2],
                                         const bf16* a, int lda, const bf16* bv,
                                         const bf16* bg, int ldb) {
  FragA fa[2];
  FragB fv[2], fg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], a + i * 16 * lda, lda);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::load_matrix_sync(fv[j], bv + j * 16 * ldb, ldb);
    wmma::load_matrix_sync(fg[j], bg + j * 16 * ldb, ldb);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::mma_sync(acc_v[i][j], fa[i], fv[j], acc_v[i][j]);
      wmma::mma_sync(acc_g[i][j], fa[i], fg[j], acc_g[i][j]);
    }
}

__global__ void __launch_bounds__(kGegluThreads)
    geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const bf16* __restrict__ xd,
                 const bf16* __restrict__ up, bf16* __restrict__ out, int m, int k,
                 int n, int r) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bv = as + kBM * kLdK;
  bf16* bg = bv + kBN * kLdK;
  bf16* xds = bg + kBN * kLdK;
  bf16* uv = xds + kBM * kLdR;
  bf16* ug = uv + kBN * kLdR;

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;

  FragAcc acc_v[2][2], acc_g[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc_v[i][j], 0.f);
      wmma::fill_fragment(acc_g[i][j], 0.f);
    }

  const bf16* w_gate = w + static_cast<size_t>(n) * k;
  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_k_tile<kBM>(as, x, m0, m, k0, k);
    load_k_tile<kBN>(bv, w, n0, n, k0, k);
    load_k_tile<kBN>(bg, w_gate, n0, n, k0, k);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16)
      mma_step(acc_v, acc_g, as + wm * 32 * kLdK + kk, kLdK,
               bv + wn * 32 * kLdK + kk, bg + wn * 32 * kLdK + kk, kLdK);
    __syncthreads();
  }
  if (r > 0) {  // the LoRA delta xd * up^T, before the activation
    load_rank_tile<kBM>(xds, xd, m0, m, r);
    load_rank_tile<kBN>(uv, up, n0, n, r);
    load_rank_tile<kBN>(ug, up + static_cast<size_t>(n) * r, n0, n, r);
    __syncthreads();
    mma_step(acc_v, acc_g, xds + wm * 32 * kLdR, kLdR, uv + wn * 32 * kLdR,
             ug + wn * 32 * kLdR, kLdR);
    __syncthreads();
  }

  // Epilogue: per warp, one value and one gate fragment at a time through a
  // row-major fp32 scratch (the operand tiles' space, free now); a lane
  // finishes 8 consecutive columns of one row and stores them as 16 bytes.
  float* sv = reinterpret_cast<float*>(smem) + warp * 512;
  float* sg = sv + 256;
  const int rl = lane / 2;
  const int cl = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sv, acc_v[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(sg, acc_g[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + rl;
      const int col = n0 + wn * 32 + j * 16 + cl;
      if (row < m && col < n) {  // n % 8 == 0: all 8 columns are in range
        __align__(16) bf16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = sv[rl * 16 + cl + e];
          float g = sg[rl * 16 + cl + e];
          if (bias != nullptr) {
            v += bias[col + e];
            g += bias[n + col + e];
          }
          o[e] = __float2bfloat16(v * gelu_poly(g));
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * n + col) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

}  // namespace geglu
}  // namespace leco

extern "C" int leco_geglu(const void* x, const void* w, const void* bias,
                          const void* xd, const void* up, void* out, int m, int k,
                          int n, int r, void* stream) {
  using namespace leco::geglu;
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || n % 8 != 0 || r < 0 ||
      r > kRankPad || (r > 0 && (xd == nullptr || up == nullptr)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      geglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  geglu_kernel<<<grid, kGegluThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const leco::bf16*>(x), static_cast<const leco::bf16*>(w),
      static_cast<const float*>(bias), static_cast<const leco::bf16*>(xd),
      static_cast<const leco::bf16*>(up), static_cast<leco::bf16*>(out), m, k, n, r);
  return cudaGetLastError();
}
