// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_bwd_dkv_kernel` (reached
// through `_dkv_call` and `_flash_bwd_3d`).
//
// What bounds it on this card: four N x N x D products per (batch*head)
// (K * qs^T, V * dO^T, P^T * dO, dS^T * qs) against about 6*N*D*2 bytes; at
// N = 4096 it is compute-bound.
//
// What the design does about it: a block owns 64 key rows and streams the
// query side (q, dO, lse, delta) in 64-row tiles, so P^T is recomputed on the
// SM from the saved log-sum-exp. dK and dV accumulate in fp32 in shared
// memory; each warp owns 16 key rows end to end. Blocks write disjoint rows of
// dK and dV, so, as on the TPU, the dQ and dK/dV kernels stay separate and no
// atomics are needed. At D = 160 the two fp32 accumulators and six tiles take
// 208.5 KB of the 227 KB a block may use, so a block runs alone on its SM.
//
// Numerics kept from the TPU kernel: qs = bf16(q * scale) carries the scale
// into both the logits and dK = dS^T * qs; P^T is rounded to bf16 before
// P^T * dO; dS^T = P^T * (dP^T - delta) is rounded to bf16 before dS^T * qs;
// key rows >= Nk (and query columns >= Nq) get P = 0.
#include "flash_common.cuh"

namespace leco {

template <int DP>
constexpr size_t dkv_smem_bytes() {
  return 4 * kRows * DP * sizeof(bf16)        // k, v, q (scaled), dO tiles
         + 2 * kRows * kRows * sizeof(bf16)   // P^T, dS^T
         + 2 * kRows * kRows * sizeof(float)  // logits^T, dP^T
         + 2 * kRows * DP * sizeof(float)     // dK, dV accumulators
         + 2 * kRows * sizeof(float);         // lse, delta of the q tile
}

template <int D, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int nq,
                         int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * DP;
  bf16* qs = vs + kRows * DP;
  bf16* dos = qs + kRows * DP;
  bf16* pts = dos + kRows * DP;
  bf16* dsts = pts + kRows * kRows;
  float* sts = reinterpret_cast<float*>(dsts + kRows * kRows);
  float* dpts = sts + kRows * kRows;
  float* dk_acc = dpts + kRows * kRows;
  float* dv_acc = dk_acc + kRows * DP;
  float* col_lse = dv_acc + kRows * DP;
  float* col_delta = col_lse + kRows;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  q += static_cast<size_t>(bh) * nq * D;
  dout += static_cast<size_t>(bh) * nq * D;
  k += static_cast<size_t>(bh) * nk * D;
  v += static_cast<size_t>(bh) * nk * D;
  dk += static_cast<size_t>(bh) * nk * D;
  dv += static_cast<size_t>(bh) * nk * D;
  lse += static_cast<size_t>(bh) * nq;
  delta += static_cast<size_t>(bh) * nq;

  load_tile<D, DP, false>(ks, k, k0, nk, 1.f);
  load_tile<D, DP, false>(vs, v, k0, nk, 1.f);
  zero_pad_cols<D, DP>(ks);
  zero_pad_cols<D, DP>(vs);
  zero_pad_cols<D, DP>(qs);
  zero_pad_cols<D, DP>(dos);
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int q0 = 0; q0 < nq; q0 += kRows) {
    load_tile<D, DP, true>(qs, q, q0, nq, scale);
    load_tile<D, DP, false>(dos, dout, q0, nq, 1.f);
    load_rows(col_lse, lse, q0, nq);
    load_rows(col_delta, delta, q0, nq);
    __syncthreads();

    // this warp's 16 key rows against the 64 queries of the tile
    warp_mma<DP, kRows, true, false>(sts + r0 * kRows, kRows, ks + r0 * DP, DP,
                                     qs, DP);
    warp_mma<DP, kRows, true, false>(dpts + r0 * kRows, kRows, vs + r0 * DP, DP,
                                     dos, DP);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const bool key_ok = k0 + r < nk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float p = (key_ok && q0 + c < nq)
                            ? expf(sts[r * kRows + c] - col_lse[c])
                            : 0.f;
        pts[r * kRows + c] = __float2bfloat16(p);
        dsts[r * kRows + c] =
            __float2bfloat16(p * (dpts[r * kRows + c] - col_delta[c]));
      }
    }
    __syncwarp();
    warp_mma<kRows, DP, false, true>(dv_acc + r0 * DP, DP, pts + r0 * kRows,
                                     kRows, dos, DP);
    warp_mma<kRows, DP, false, true>(dk_acc + r0 * DP, DP, dsts + r0 * kRows,
                                     kRows, qs, DP);
    __syncthreads();  // the next tile load overwrites qs / dos / lse / delta
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const int row = k0 + r;
    if (row >= nk) break;
    for (int c = lane; c < D; c += 32) {
      dk[static_cast<size_t>(row) * D + c] = __float2bfloat16(dk_acc[r * DP + c]);
      dv[static_cast<size_t>(row) * D + c] = __float2bfloat16(dv_acc[r * DP + c]);
    }
  }
}

template <int D, int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int nq, int nk, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  auto kernel = flash_bwd_dkv_kernel<D, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((nk + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace leco

extern "C" int leco_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int bh,
                                  int nq, int nk, int d, float scale,
                                  void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_DKV(D, DP) \
  leco::launch_dkv<D, DP>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_DKV)
#undef LECO_DKV
}
