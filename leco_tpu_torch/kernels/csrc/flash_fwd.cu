// Flash-attention forward for Hopper (sm_90a), in two layouts.
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_kernel` (reached through
// `_fwd_call` and `_flash_fwd_3d`) through the entry point `leco_flash_fwd`,
// and `_attn_kernel_packed` (reached through `_flash_fwd_packed`, the
// `LECO_FLASH_PACKED=1` route) through `leco_flash_fwd_packed`.
//
// What bounds it on this card: at the SD1.5 level-0 shape (N = 4096, D = 40)
// one (batch*head) does 4*N*N*D = 2.7 GFLOP against 3*N*D*2 = 1 MB of q/k/v,
// about 2,700 operations per byte, so it is compute-bound (the H100's ridge
// is near 295). The N x N logits never leave the SM.
//
// What the design does about it: the TPU kernels hold the whole K/V of a
// head (or, packed, of all heads) in VMEM; 227 KB of shared memory cannot (K
// and V are 2.6 MB at N = 4096, D = 160). So each block takes 64 query rows
// of one (batch, head) and streams K/V through shared memory in 64-row tiles
// with an online softmax: a running max m and sum l per row, and an fp32
// accumulator that is rescaled by exp(m_old - m_new) before each P*V
// product. Both products run on the tensor cores (WMMA m16n16k16 bf16, fp32
// accumulation). Each of the 4 warps owns 16 query rows end to end (logits,
// softmax, accumulator), so only the K/V tile loads need a block-wide
// barrier.
//
// The two layouts share this one kernel: a (batch*head) is `heads` heads of
// one batch row, and its rows lie `ld` elements apart. The (BH, N, D) layout
// is heads = 1, ld = D. The packed layout reads q, k and v where the model
// keeps them, (B, N, C = heads * D): head h of batch b starts at column
// h * D of batch b's (N, C) matrix and its rows are C apart, so the
// `(b n (h d) -> (b h) n d)` copies of the 3-d route are not made, and O is
// written back into (B, N, C) the same way. The TPU kernel pads K/V to a
// multiple of 128 in HBM and masks the padding; here the tile loads zero
// rows past Nk and the logits of those columns are masked, which is the
// same computation without the padding copy. The packed route writes no lse
// (its backward is plain fp32 PyTorch, as in JAX).
//
// Numerics kept from the TPU kernels: q * scale is rounded to bf16 before
// the logits; P is rounded to bf16 before P*V while l sums the fp32 P; the
// normaliser is applied to the (rows, D) output; masked keys (column >= Nk)
// get the logit -1e30. Outputs: O bf16 and, 3-d only, LSE = m + log(l)
// (BH, Nq) fp32.
#include "flash_common.cuh"

namespace leco {

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return 3 * kRows * DP * sizeof(bf16)    // q (scaled), k, v tiles
         + kRows * kRows * sizeof(bf16)   // P
         + kRows * kRows * sizeof(float)  // logits
         + kRows * DP * sizeof(float)     // output accumulator
         + 2 * kRows * sizeof(float);     // m, l
}

// grid (ceil(nq / 64), batch * heads); `lse` may be null (packed route)
template <int D, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int nq, int nk, float scale,
                     int heads, int ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * DP;
  bf16* vs = ks + kRows * DP;
  bf16* ps = vs + kRows * DP;
  float* ss = reinterpret_cast<float*>(ps + kRows * kRows);
  float* acc = ss + kRows * kRows;
  float* row_m = acc + kRows * DP;
  float* row_l = row_m + kRows;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  q += static_cast<size_t>(b) * nq * ld + h * D;
  k += static_cast<size_t>(b) * nk * ld + h * D;
  v += static_cast<size_t>(b) * nk * ld + h * D;
  o += static_cast<size_t>(b) * nq * ld + h * D;

  load_tile<D, DP, true>(qs, q, q0, nq, scale, ld);
  zero_pad_cols<D, DP>(qs);
  zero_pad_cols<D, DP>(ks);
  zero_pad_cols<D, DP>(vs);
  for (int i = threadIdx.x; i < kRows * DP; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    row_m[i] = -__int_as_float(0x7f800000);  // -inf: the first alpha is 0
    row_l[i] = 0.f;
  }

  for (int k0 = 0; k0 < nk; k0 += kRows) {
    load_tile<D, DP, false>(ks, k, k0, nk, 1.f, ld);
    load_tile<D, DP, false>(vs, v, k0, nk, 1.f, ld);
    __syncthreads();

    // logits of this warp's 16 rows against the 64 keys of the tile
    warp_mma<DP, kRows, true, false>(ss + r0 * kRows, kRows, qs + r0 * DP, DP,
                                     ks, DP);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      float s0 = ss[r * kRows + lane];
      float s1 = ss[r * kRows + lane + 32];
      if (k0 + lane >= nk) s0 = kMaskedLogit;
      if (k0 + lane + 32 >= nk) s1 = kMaskedLogit;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      ps[r * kRows + lane] = __float2bfloat16(p0);
      ps[r * kRows + lane + 32] = __float2bfloat16(p1);
      const float alpha = expf(m_old - m_new);
      const float sum = warp_sum(p0 + p1);
      for (int c = lane; c < DP; c += 32) acc[r * DP + c] *= alpha;
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncwarp();
    warp_mma<kRows, DP, false, true>(acc + r0 * DP, DP, ps + r0 * kRows, kRows,
                                     vs, DP);
    __syncthreads();  // the next tile load overwrites ks / vs
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= nq) break;
    const float l = row_l[r];
    for (int c = lane; c < D; c += 32)
      o[static_cast<size_t>(row) * ld + c] = __float2bfloat16(acc[r * DP + c] / l);
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * nq + row] = row_m[r] + logf(l);
  }
}

template <int D, int DP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int nq, int nk, float scale,
                       int heads, int ld, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DP>();
  auto kernel = flash_fwd_kernel<D, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), nq, nk, scale, heads, ld);
  return cudaGetLastError();
}

}  // namespace leco

// (BH, N, D) layout: o (BH, Nq, D), lse (BH, Nq)
extern "C" int leco_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int nq, int nk, int d,
                              float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_FWD(D, DP) \
  leco::launch_fwd<D, DP>(q, k, v, o, lse, bh, nq, nk, scale, 1, D, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_FWD)
#undef LECO_FWD
}

// packed layout: q, o (B, Nq, C), k, v (B, Nk, C) with C = heads * D; no lse
extern "C" int leco_flash_fwd_packed(const void* q, const void* k, const void* v,
                                     void* o, int b, int heads, int nq, int nk,
                                     int c, float scale, void* stream) {
  if (b <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || c % heads != 0 ||
      b * heads > 65535)
    return cudaErrorInvalidValue;
  const int d = c / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_FWD(D, DP) \
  leco::launch_fwd<D, DP>(q, k, v, o, nullptr, b * heads, nq, nk, scale, heads, c, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_FWD)
#undef LECO_FWD
}
