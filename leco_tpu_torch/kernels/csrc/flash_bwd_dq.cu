// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_bwd_dq_kernel` (reached
// through `_dq_call` and `_flash_bwd_3d`).
//
// What bounds it on this card: three N x N x D products per (batch*head)
// (logits, dP = dO * V^T, dS * K) against about 4*N*D*2 bytes of q/k/v/dO;
// at N = 4096 that is over 2,000 operations per byte, so it is compute-bound.
//
// What the design does about it: a block owns 64 query rows and streams K/V
// in 64-row tiles through shared memory, so the N x N probabilities are
// recomputed on the SM from the saved log-sum-exp and never stored. The
// products run on the tensor cores (WMMA bf16, fp32 accumulation). Each warp
// owns 16 query rows end to end; the dQ accumulator is fp32 in shared memory.
// Blocks write disjoint rows of dQ, so no atomics are needed.
//
// Numerics kept from the TPU kernel: the logits use bf16(q * scale) as the
// forward does; P = exp(logits - lse) is zeroed for columns >= Nk;
// dS = P * (dP - delta) is rounded to bf16 before dS * K; the scale is
// applied to the (64, D) result, not to dS. delta = rowsum(dO * O) comes in
// from the caller, as on the TPU.
#include "flash_common.cuh"

namespace leco {

template <int DP>
constexpr size_t dq_smem_bytes() {
  return 4 * kRows * DP * sizeof(bf16)        // q (scaled), dO, k, v tiles
         + kRows * kRows * sizeof(bf16)       // dS
         + 2 * kRows * kRows * sizeof(float)  // logits, dP
         + kRows * DP * sizeof(float)         // dQ accumulator
         + 2 * kRows * sizeof(float);         // lse, delta
}

template <int D, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int nq, int nk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * DP;
  bf16* ks = dos + kRows * DP;
  bf16* vs = ks + kRows * DP;
  bf16* dss = vs + kRows * DP;
  float* ss = reinterpret_cast<float*>(dss + kRows * kRows);
  float* dps = ss + kRows * kRows;
  float* acc = dps + kRows * kRows;
  float* row_lse = acc + kRows * DP;
  float* row_delta = row_lse + kRows;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  q += static_cast<size_t>(bh) * nq * D;
  dout += static_cast<size_t>(bh) * nq * D;
  dq += static_cast<size_t>(bh) * nq * D;
  k += static_cast<size_t>(bh) * nk * D;
  v += static_cast<size_t>(bh) * nk * D;
  lse += static_cast<size_t>(bh) * nq;
  delta += static_cast<size_t>(bh) * nq;

  load_tile<D, DP, true>(qs, q, q0, nq, scale);
  load_tile<D, DP, false>(dos, dout, q0, nq, 1.f);
  zero_pad_cols<D, DP>(qs);
  zero_pad_cols<D, DP>(dos);
  zero_pad_cols<D, DP>(ks);
  zero_pad_cols<D, DP>(vs);
  load_rows(row_lse, lse, q0, nq);
  load_rows(row_delta, delta, q0, nq);
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) acc[i] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kRows) {
    load_tile<D, DP, false>(ks, k, k0, nk, 1.f);
    load_tile<D, DP, false>(vs, v, k0, nk, 1.f);
    __syncthreads();

    warp_mma<DP, kRows, true, false>(ss + r0 * kRows, kRows, qs + r0 * DP, DP,
                                     ks, DP);
    warp_mma<DP, kRows, true, false>(dps + r0 * kRows, kRows, dos + r0 * DP, DP,
                                     vs, DP);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float l = row_lse[r];
      const float dl = row_delta[r];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        const float p = (k0 + c < nk) ? expf(ss[r * kRows + c] - l) : 0.f;
        dss[r * kRows + c] = __float2bfloat16(p * (dps[r * kRows + c] - dl));
      }
    }
    __syncwarp();
    warp_mma<kRows, DP, false, true>(acc + r0 * DP, DP, dss + r0 * kRows, kRows,
                                     ks, DP);
    __syncthreads();  // the next tile load overwrites ks / vs
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= nq) break;
    for (int c = lane; c < D; c += 32)
      dq[static_cast<size_t>(row) * D + c] = __float2bfloat16(acc[r * DP + c] * scale);
  }
}

template <int D, int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int nq, int nk, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  auto kernel = flash_bwd_dq_kernel<D, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace leco

extern "C" int leco_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int nq,
                                 int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_DQ(D, DP) \
  leco::launch_dq<D, DP>(q, k, v, dout, lse, delta, dq, bh, nq, nk, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_DQ)
#undef LECO_DQ
}
