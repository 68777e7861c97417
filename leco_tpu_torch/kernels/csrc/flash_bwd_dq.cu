// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_bwd_dq_kernel` (reached
// through `_dq_call` and `_flash_bwd_3d`), through the entry point
// `leco_flash_bwd_dq`.
//
// What bounds it on this card. Per (batch * head) it does three Nq x Nk x D
// products (S = qs * K^T, dP = dO * V^T, dQ = dS * K), 6 * Nq * Nk * D FLOPs
// on the tensor cores, and Nq * Nk exponentials on the special-function
// units, against (3 * Nq + 2 * Nk) * D bf16 values and two fp32 rows in
// device memory. At SD1.5's target level 0, (BH 8, N 4096, D 40): 32.2
// GFLOP, 33 us at 989 TFLOP/s, and 134 M exponentials, 34 us at the H100's
// ~3.9 T/s; 13.4 MB, 4 us at 3.35 TB/s. At SD2.1's, (10, 4096, 64): 64.4
// GFLOP, 65 us, and 168 M exponentials, 43 us. So the products and the
// exponentials bound it together; bytes never do.
//
// What the design does about it:
// - Every product is a warpgroup MMA (wgmma). A block takes 128 query rows of
//   one (batch * head): two consumer warpgroups of 64 rows, and a producer
//   warpgroup whose first thread loads q and dO once by TMA, then keeps TMA
//   loads of K and V tiles (128 keys; 64 at D 160) in flight through a
//   2-stage mbarrier ring (`full` counts the bytes, `empty` the 8 consumer warps). The
//   producer gives its registers to the consumers (setmaxnreg 40 / 232).
// - Per key tile, S = qs * K^T and dP = dO * V^T accumulate in registers
//   from 128-byte-swizzled shared memory (K-major operands, no bank
//   conflicts), as two commit groups: the exponentials of P run while dP's
//   MMAs are still in flight. dS = P o (dP - delta) is rounded to bf16 in
//   registers, whose accumulator layout is wgmma's A-from-registers layout,
//   and dQ += dS * K reads the same K tile a second time as an MN-major
//   operand. dQ accumulates in registers across all key tiles of the block:
//   blocks write disjoint rows, there are no atomics, and two calls on the
//   same inputs give the same bits.
// - Exponentials are exp2 with log2(e) folded into one FMA per logit:
//   P = 2^(s * log2 e - lse * log2 e) (ex2.approx, a few ulps from exp).
//   Nothing is reassociated otherwise: the TPU kernel also sums dS * K over
//   keys in one product, here in key tiles in order.
// - q, dO, K, V and dQ are each read as a (BH, N, 1, D) tensor map. TMA's
//   zero fill pads D to the 64-column blocks of shared memory (D 40 -> 64,
//   80 -> 128, 160 -> 192) and the ragged N edges; the dQ store clips at Nq
//   and D. lse and delta (fp32 (BH, Nq)) are read with ordinary masked loads
//   into registers, two rows a thread, once per block.
// - Head dims 40, 64, 80, 160. S and dP run ceil(D / 16) k16 steps; dQ runs
//   at width 64 for D 40 and 64, 80 and 160 otherwise. S, dP, dS and dQ stay
//   in registers without spilling: 64 + 64 + 32 + 40 a thread at D 80 with
//   128-key tiles (faster than 64 at D 40 and 64 on the H100), and 32 + 32 +
//   16 + 80 at D 160, whose tiles are 64 keys. Shared memory: 97 KB at
//   D <= 64, 193 KB at 80 and at 160.
//
// Numerics kept from the TPU kernel: the logits use qs = bf16(q * scale)
// (formed once per block in shared memory after the q load); P is set to 0
// for key columns >= Nk (TMA's zero fill gives S = 0, which is no mask);
// dS = P o (dP - delta) is rounded to bf16 before dS * K; the scale is
// applied to the (rows, D) result, not to dS. delta = rowsum(dO o O) comes
// in from the caller, as on the TPU.
#include "sm90_common.cuh"

namespace leco {

constexpr int kDqRows = 128;     // query rows of a block: two warpgroups of 64
constexpr int kDqThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kDqStages = 2;

template <int D>
struct DqShape {
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kSteps = (D + 15) / 16;   // k16 steps of S and dP
  static constexpr int kOut = D <= 64 ? 64 : (D + 15) / 16 * 16;  // width of dS * K
  static constexpr int kKeys = D <= 80 ? 128 : 64;  // keys of a K / V tile
  static constexpr uint32_t kRowsBytes = kBlocks * kDqRows * 128;  // q or dO
  static constexpr uint32_t kTileBytes = kBlocks * kKeys * 128;    // one K or V tile
  // + 1024 to align the start to the swizzle pattern
  static constexpr size_t kSmem = 1024 + 2 * kRowsBytes + 2 * kDqStages * kTileBytes;
};

// grid (ceil(nq / 128), bh)
template <int D>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap domap,
                        const __grid_constant__ CUtensorMap dqmap,
                        const float* __restrict__ lse, const float* __restrict__ delta, int nq,
                        int nk, float scale) {
  using S = DqShape<D>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kDqStages];  // q + dO, full[s], empty[s]

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  unsigned char* q_ptr = smem_raw + (q_s - raw);
  const uint32_t do_s = q_s + S::kRowsBytes;
  const uint32_t rows_full = smem_addr(&bars[0]);
  auto k_tile = [&](int s) { return do_s + S::kRowsBytes + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + S::kTileBytes; };
  auto full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_addr(&bars[1 + kDqStages + s]); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const int tiles = (nk + S::kKeys - 1) / S::kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(rows_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    release_registers<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(rows_full, 2 * S::kRowsBytes);
      for (int blk = 0; blk < S::kBlocks; ++blk) {
        tma_load_4d(q_s + blk * kDqRows * 128, &qmap, rows_full, 64 * blk, 0, q0, bh);
        tma_load_4d(do_s + blk * kDqRows * 128, &domap, rows_full, 64 * blk, 0, q0, bh);
      }
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kDqStages;
        if (j >= kDqStages) mbar_wait(empty(s), ((j / kDqStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * S::kTileBytes);
        for (int blk = 0; blk < S::kBlocks; ++blk) {
          tma_load_4d(k_tile(s) + blk * S::kKeys * 128, &kmap, full(s), 64 * blk, 0,
                      j * S::kKeys, bh);
          tma_load_4d(v_tile(s) + blk * S::kKeys * 128, &vmap, full(s), 64 * blk, 0,
                      j * S::kKeys, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows 64 * cw .. 64 * cw + 63 of the block
  claim_registers<232>();
  const int cw = wg - 1;
  const Fragment fr;
  const uint32_t q_rows = q_s + cw * 64 * 128;
  const uint32_t do_rows = do_s + cw * 64 * 128;

  // lse (in log2 units) and delta of this thread's two rows
  const int row = q0 + cw * 64 + fr.r_lo;
  const float* lse_bh = lse + static_cast<size_t>(bh) * nq;
  const float* delta_bh = delta + static_cast<size_t>(bh) * nq;
  const float lse_lo = row < nq ? lse_bh[row] * kLog2e : 0.f;
  const float lse_hi = row + 8 < nq ? lse_bh[row + 8] * kLog2e : 0.f;
  const float delta_lo = row < nq ? delta_bh[row] : 0.f;
  const float delta_hi = row + 8 < nq ? delta_bh[row + 8] : 0.f;

  // q * scale rounded to bf16, in place over this warpgroup's rows
  mbar_wait(rows_full, 0);
  scale_rows_bf16<S::kBlocks>(q_ptr, kDqRows, cw * 64, 64, scale, fr.t, 128);
  fence_proxy_async();
  named_barrier(1 + cw, 128);

  float dq[S::kOut / 2];
#pragma unroll
  for (int i = 0; i < S::kOut / 2; ++i) dq[i] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kDqStages;
    mbar_wait(full(s), (j / kDqStages) & 1);

    float p[S::kKeys / 2];   // S, then P in place
    float dp[S::kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)  // 16 columns: column block k / 4, 32 bytes a step
      wgmma_ss<S::kKeys>(p, smem_desc(q_rows + (k / 4) * kDqRows * 128 + (k % 4) * 32, 16, 1024),
                         smem_desc(k_tile(s) + (k / 4) * S::kKeys * 128 + (k % 4) * 32, 16, 1024),
                         k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)
      wgmma_ss<S::kKeys>(dp, smem_desc(do_rows + (k / 4) * kDqRows * 128 + (k % 4) * 32, 16, 1024),
                         smem_desc(v_tile(s) + (k / 4) * S::kKeys * 128 + (k % 4) * 32, 16, 1024),
                         k > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is in; dP's MMAs run on under the exponentials
    fence_registers<S::kKeys / 2>(p);

#pragma unroll
    for (int c = 0; c < S::kKeys / 8; ++c) {
      p[4 * c] = exp2_approx(fmaf(p[4 * c], kLog2e, -lse_lo));
      p[4 * c + 1] = exp2_approx(fmaf(p[4 * c + 1], kLog2e, -lse_lo));
      p[4 * c + 2] = exp2_approx(fmaf(p[4 * c + 2], kLog2e, -lse_hi));
      p[4 * c + 3] = exp2_approx(fmaf(p[4 * c + 3], kLog2e, -lse_hi));
    }
    const int k0 = j * S::kKeys;
    if (k0 + S::kKeys > nk) {
#pragma unroll
      for (int c = 0; c < S::kKeys / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * c + fr.col + e >= nk) p[4 * c + e] = p[4 * c + 2 + e] = 0.f;
    }

    wgmma_wait<0>();
    fence_registers<S::kKeys / 2>(dp);
    uint32_t ds[S::kKeys / 4];  // dS in bf16: the A operand of dS * K
#pragma unroll
    for (int c = 0; c < S::kKeys / 8; ++c) {
      ds[2 * c] = pack_bf16(p[4 * c] * (dp[4 * c] - delta_lo),
                            p[4 * c + 1] * (dp[4 * c + 1] - delta_lo));
      ds[2 * c + 1] = pack_bf16(p[4 * c + 2] * (dp[4 * c + 2] - delta_hi),
                                p[4 * c + 3] * (dp[4 * c + 3] - delta_hi));
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::kKeys / 16; ++kk)  // K as an MN-major operand: 16 keys a step
      wgmma_rs_mn<S::kOut>(dq, &ds[4 * kk],
                           smem_desc(k_tile(s) + kk * 16 * 128, S::kKeys * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers<S::kOut / 2>(dq);
    if (fr.lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  // dQ * scale into this warpgroup's q rows (every warp is past its last q
  // read), then one TMA store per column block
  named_barrier(1 + cw, 128);
  stage_fragment<S::kOut>(q_ptr, kDqRows, cw * 64, dq, [&](float x, int) { return x * scale; });
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (fr.t == 0) {
    for (int blk = 0; blk < S::kBlocks; ++blk)
      tma_store_4d(&dqmap, q_rows + blk * kDqRows * 128, 64 * blk, 0, q0 + cw * 64, bh);
    tma_store_wait();
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bh, int nq, int nk,
                      float scale, cudaStream_t stream) {
  using S = DqShape<D>;
  CUtensorMap qmap, kmap, vmap, domap, dqmap;
  cudaError_t err = sm90::encode_bnhd(&qmap, q, bh, nq, 1, D, D, kDqRows);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&kmap, k, bh, nk, 1, D, D, S::kKeys);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&vmap, v, bh, nk, 1, D, D, S::kKeys);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&domap, dout, bh, nq, 1, D, D, kDqRows);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&dqmap, dq, bh, nq, 1, D, D, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kDqRows - 1) / kDqRows, bh);
  kernel<<<grid, kDqThreads, S::kSmem, stream>>>(qmap, kmap, vmap, domap, dqmap, lse, delta, nq,
                                                  nk, scale);
  return cudaGetLastError();
}

}  // namespace leco

// q, dO, dq (BH, Nq, D); k, v (BH, Nk, D) bf16; lse, delta (BH, Nq) fp32
extern "C" int leco_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int bh, int nq,
                                 int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_DQ(D)                                                                     \
  leco::launch_dq<D>(q, k, v, dout, static_cast<const float*>(lse),                    \
                     static_cast<const float*>(delta), dq, bh, nq, nk, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_DQ)
#undef LECO_DQ
}
