// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_bwd_dkv_kernel` (reached
// through `_dkv_call` and `_flash_bwd_3d`), through the entry point
// `leco_flash_bwd_dkv`.
//
// What bounds it on this card. Per (batch * head) it does four Nq x Nk x D
// products (S^T = K * qs^T, dP^T = V * dO^T, dV = P^T * dO, dK = dS^T * qs),
// 8 * Nq * Nk * D FLOPs on the tensor cores, and Nq * Nk exponentials,
// against (2 * Nq + 4 * Nk) * D bf16 values and two fp32 rows in device
// memory. At SD1.5's target level 0, (BH 8, N 4096, D 40): 42.9 GFLOP, 43 us
// at 989 TFLOP/s, and 134 M exponentials, 34 us at the H100's ~3.9 T/s;
// 16 MB, 5 us at 3.35 TB/s. At SD2.1's, (10, 4096, 64): 85.9 GFLOP, 87 us,
// and 168 M exponentials, 43 us. The products bound it, the exponentials
// close behind; bytes never do.
//
// What the design does about it:
// - Every product is a warpgroup MMA (wgmma). A block takes 128 key rows of
//   one (batch * head), one consumer warpgroup per 64 keys; K and V are
//   loaded once by TMA and stay in shared memory. The producer warpgroup
//   streams the query side through a 3-stage mbarrier ring: its first thread
//   TMA-loads a tile of q and one of dO (64 queries; 32 at D 160) onto
//   `full`; every producer thread loads one value of the tile's lse (times
//   log2 e) or delta with an ordinary masked load into the stage, waits for
//   `full`, rounds its share of q * scale to bf16 in place, fences the async
//   proxy and arrives on `ready` (128 arrivals). The consumers wait on
//   `ready` only, so qs is rounded before any wgmma reads it, and the
//   rounding of the next tiles overlaps this tile's products. The producer
//   runs on 40 registers, the consumers on 232 (setmaxnreg).
// - Per query tile, S^T = K * qs^T and dP^T = V * dO^T accumulate in
//   registers from 128-byte-swizzled shared memory (K and V as K-major A, qs
//   and dO as K-major B), as two commit groups, so P^T's exponentials run
//   while dP^T's MMAs are in flight. P^T is rounded to bf16 in registers for
//   dV += P^T * dO, and dS^T = P^T o (dP^T - delta) for dK += dS^T * qs; both
//   read dO and qs as MN-major B operands from the same stage. dK and dV
//   accumulate in registers across all query tiles: blocks write disjoint
//   rows, there are no atomics, and two calls give the same bits.
// - Exponentials are exp2 with log2(e) folded into one FMA per logit:
//   P^T = 2^(s * log2 e - lse * log2 e) (ex2.approx, a few ulps from exp).
//   The sums over queries run in tiles in order; the TPU kernel takes each
//   in one product over all of Nq.
// - q, dO, K, V, dK and dV are each read as a (BH, N, 1, D) tensor map.
//   TMA's zero fill pads D to the 64-column blocks of shared memory (D 40 ->
//   64, 80 -> 128, 160 -> 192) and the ragged N edges; the dK and dV stores
//   clip at Nk and D.
// - Head dims 40, 64, 80, 160. S^T and dP^T run ceil(D / 16) k16 steps; dK
//   and dV run at width 64 for D 40 and 64, 80 and 160 otherwise. At D 160
//   the two fp32 accumulators alone take 160 registers a thread, so the
//   query tile there is 32 wide (S^T, dP^T 16 registers each, P^T and dS^T 8
//   each), and both accumulators stay in registers. Shared memory: 81 KB at
//   D <= 64, 161 KB at 80, 169 KB at 160.
//
// Numerics kept from the TPU kernel: qs = bf16(q * scale) carries the scale
// into both the logits and dK = dS^T * qs; P^T is set to 0 for key rows >= Nk
// and for query columns >= Nq (TMA's zero fill gives S = 0, which is no
// mask); P^T is rounded to bf16 before P^T * dO, and dS^T, formed from the
// fp32 P^T, before dS^T * qs. delta = rowsum(dO o O) comes in from the
// caller, as on the TPU.
#include "sm90_common.cuh"

namespace leco {

constexpr int kKvRows = 128;     // key rows of a block: two warpgroups of 64
constexpr int kKvThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kKvStages = 3;

template <int D>
struct DkvShape {
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kSteps = (D + 15) / 16;   // k16 steps of S^T and dP^T
  static constexpr int kOut = D <= 64 ? 64 : (D + 15) / 16 * 16;  // width of dK, dV
  static constexpr int kQueries = D <= 80 ? 64 : 32;  // queries of a q / dO tile
  static constexpr uint32_t kRowsBytes = kBlocks * kKvRows * 128;  // K or V
  static constexpr uint32_t kTileBytes = kBlocks * kQueries * 128;  // one q or dO tile
  // + 1024 to align the start to the swizzle pattern
  static constexpr size_t kSmem = 1024 + 2 * kRowsBytes + 2 * kKvStages * kTileBytes;
};

// grid (ceil(nk / 128), bh)
template <int D>
__global__ void __launch_bounds__(kKvThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap dkmap,
                         const __grid_constant__ CUtensorMap dvmap,
                         const float* __restrict__ lse, const float* __restrict__ delta, int nq,
                         int nk, float scale) {
  using S = DkvShape<D>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  // K + V, full[s], ready[s], empty[s]
  __shared__ __align__(8) uint64_t bars[1 + 3 * kKvStages];
  // per stage: the tile's lse * log2 e, then its delta
  __shared__ __align__(16) float rows[kKvStages][2][S::kQueries];

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  unsigned char* k_ptr = smem_raw + (k_s - raw);
  const uint32_t v_s = k_s + S::kRowsBytes;
  unsigned char* v_ptr = k_ptr + S::kRowsBytes;
  const uint32_t kv_full = smem_addr(&bars[0]);
  auto q_tile = [&](int s) { return v_s + S::kRowsBytes + s * 2 * S::kTileBytes; };
  auto do_tile = [&](int s) { return q_tile(s) + S::kTileBytes; };
  auto full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto ready = [&](int s) { return smem_addr(&bars[1 + kKvStages + s]); };
  auto empty = [&](int s) { return smem_addr(&bars[1 + 2 * kKvStages + s]); };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKvRows;
  const int tiles = (nq + S::kQueries - 1) / S::kQueries;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(ready(s), 128);  // every producer thread
      mbar_init(empty(s), 8);    // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    release_registers<40>();
    const int t = threadIdx.x;
    if (t == 0) {
      mbar_expect_tx(kv_full, 2 * S::kRowsBytes);
      for (int blk = 0; blk < S::kBlocks; ++blk) {
        tma_load_4d(k_s + blk * kKvRows * 128, &kmap, kv_full, 64 * blk, 0, k0, bh);
        tma_load_4d(v_s + blk * kKvRows * 128, &vmap, kv_full, 64 * blk, 0, k0, bh);
      }
    }
    // thread t < kQueries carries lse[query t of the tile], the next kQueries delta
    const bool carries = t < 2 * S::kQueries;
    const float* src = (t < S::kQueries ? lse : delta) + static_cast<size_t>(bh) * nq;
    const float mul = t < S::kQueries ? kLog2e : 1.f;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kKvStages;
      const int query = j * S::kQueries + t % S::kQueries;
      const float value = carries && query < nq ? src[query] * mul : 0.f;
      if (j >= kKvStages) mbar_wait(empty(s), ((j / kKvStages) - 1) & 1);
      if (t == 0) {
        mbar_expect_tx(full(s), 2 * S::kTileBytes);
        for (int blk = 0; blk < S::kBlocks; ++blk) {
          tma_load_4d(q_tile(s) + blk * S::kQueries * 128, &qmap, full(s), 64 * blk, 0,
                      j * S::kQueries, bh);
          tma_load_4d(do_tile(s) + blk * S::kQueries * 128, &domap, full(s), 64 * blk, 0,
                      j * S::kQueries, bh);
        }
      }
      if (carries) rows[s][t / S::kQueries][t % S::kQueries] = value;
      mbar_wait(full(s), (j / kKvStages) & 1);
      scale_rows_bf16<S::kBlocks>(smem_raw + (q_tile(s) - raw), S::kQueries, 0, S::kQueries,
                                  scale, t, 128);
      fence_proxy_async();
      mbar_arrive(ready(s));
    }
    return;
  }

  // consumers: warpgroup cw owns key rows 64 * cw .. 64 * cw + 63 of the block
  claim_registers<232>();
  const int cw = wg - 1;
  const Fragment fr;
  const uint32_t k_rows = k_s + cw * 64 * 128;
  const uint32_t v_rows = v_s + cw * 64 * 128;
  const bool key_lo = k0 + cw * 64 + fr.r_lo < nk;  // this thread's two key rows exist
  const bool key_hi = k0 + cw * 64 + fr.r_lo + 8 < nk;

  float dk[S::kOut / 2], dv[S::kOut / 2];
#pragma unroll
  for (int i = 0; i < S::kOut / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kKvStages;
    mbar_wait(ready(s), (j / kKvStages) & 1);

    float p[S::kQueries / 2];   // S^T, then P^T in place
    float dp[S::kQueries / 2];  // dP^T
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)  // 16 columns: column block k / 4, 32 bytes a step
      wgmma_ss<S::kQueries>(
          p, smem_desc(k_rows + (k / 4) * kKvRows * 128 + (k % 4) * 32, 16, 1024),
          smem_desc(q_tile(s) + (k / 4) * S::kQueries * 128 + (k % 4) * 32, 16, 1024), k > 0);
    wgmma_commit();
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)
      wgmma_ss<S::kQueries>(
          dp, smem_desc(v_rows + (k / 4) * kKvRows * 128 + (k % 4) * 32, 16, 1024),
          smem_desc(do_tile(s) + (k / 4) * S::kQueries * 128 + (k % 4) * 32, 16, 1024), k > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in; dP^T's MMAs run on under the exponentials
    fence_registers<S::kQueries / 2>(p);

    const float* lse_s = rows[s][0];
    const float* delta_s = rows[s][1];
    uint32_t pt[S::kQueries / 4];  // P^T in bf16: the A operand of P^T * dO
#pragma unroll
    for (int c = 0; c < S::kQueries / 8; ++c) {
      const float2 l = *reinterpret_cast<const float2*>(&lse_s[8 * c + fr.col]);
      p[4 * c] = exp2_approx(fmaf(p[4 * c], kLog2e, -l.x));
      p[4 * c + 1] = exp2_approx(fmaf(p[4 * c + 1], kLog2e, -l.y));
      p[4 * c + 2] = exp2_approx(fmaf(p[4 * c + 2], kLog2e, -l.x));
      p[4 * c + 3] = exp2_approx(fmaf(p[4 * c + 3], kLog2e, -l.y));
    }
    const int q0 = j * S::kQueries;
    if (!key_lo || !key_hi || q0 + S::kQueries > nq) {
#pragma unroll
      for (int c = 0; c < S::kQueries / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool query = q0 + 8 * c + fr.col + e < nq;
          if (!(query && key_lo)) p[4 * c + e] = 0.f;
          if (!(query && key_hi)) p[4 * c + 2 + e] = 0.f;
        }
    }
#pragma unroll
    for (int c = 0; c < S::kQueries / 8; ++c) {
      pt[2 * c] = pack_bf16(p[4 * c], p[4 * c + 1]);
      pt[2 * c + 1] = pack_bf16(p[4 * c + 2], p[4 * c + 3]);
    }

    wgmma_wait<0>();
    fence_registers<S::kQueries / 2>(dp);
    uint32_t ds[S::kQueries / 4];  // dS^T in bf16: the A operand of dS^T * qs
#pragma unroll
    for (int c = 0; c < S::kQueries / 8; ++c) {
      const float2 dl = *reinterpret_cast<const float2*>(&delta_s[8 * c + fr.col]);
      ds[2 * c] = pack_bf16(p[4 * c] * (dp[4 * c] - dl.x), p[4 * c + 1] * (dp[4 * c + 1] - dl.y));
      ds[2 * c + 1] =
          pack_bf16(p[4 * c + 2] * (dp[4 * c + 2] - dl.x), p[4 * c + 3] * (dp[4 * c + 3] - dl.y));
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::kQueries / 16; ++kk)  // dO, qs as MN-major operands: 16 queries a step
      wgmma_rs_mn<S::kOut>(dv, &pt[4 * kk],
                           smem_desc(do_tile(s) + kk * 16 * 128, S::kQueries * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < S::kQueries / 16; ++kk)
      wgmma_rs_mn<S::kOut>(dk, &ds[4 * kk],
                           smem_desc(q_tile(s) + kk * 16 * 128, S::kQueries * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers<S::kOut / 2>(dv);
    fence_registers<S::kOut / 2>(dk);
    if (fr.lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  // dK into this warpgroup's K rows and dV into its V rows (no wgmma reads
  // them any more), then one TMA store per column block of each
  named_barrier(1 + cw, 128);
  stage_fragment<S::kOut>(k_ptr, kKvRows, cw * 64, dk, [](float x, int) { return x; });
  stage_fragment<S::kOut>(v_ptr, kKvRows, cw * 64, dv, [](float x, int) { return x; });
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (fr.t == 0) {
    for (int blk = 0; blk < S::kBlocks; ++blk) {
      tma_store_4d(&dkmap, k_rows + blk * kKvRows * 128, 64 * blk, 0, k0 + cw * 64, bh);
      tma_store_4d(&dvmap, v_rows + blk * kKvRows * 128, 64 * blk, 0, k0 + cw * 64, bh);
    }
    tma_store_wait();
  }
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int bh, int nq,
                       int nk, float scale, cudaStream_t stream) {
  using S = DkvShape<D>;
  CUtensorMap qmap, kmap, vmap, domap, dkmap, dvmap;
  cudaError_t err = sm90::encode_bnhd(&qmap, q, bh, nq, 1, D, D, S::kQueries);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&kmap, k, bh, nk, 1, D, D, kKvRows);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&vmap, v, bh, nk, 1, D, D, kKvRows);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&domap, dout, bh, nq, 1, D, D, S::kQueries);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&dkmap, dk, bh, nk, 1, D, D, 64);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&dvmap, dv, bh, nk, 1, D, D, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((nk + kKvRows - 1) / kKvRows, bh);
  kernel<<<grid, kKvThreads, S::kSmem, stream>>>(qmap, kmap, vmap, domap, dkmap, dvmap, lse,
                                                  delta, nq, nk, scale);
  return cudaGetLastError();
}

}  // namespace leco

// q, dO (BH, Nq, D); k, v, dk, dv (BH, Nk, D) bf16; lse, delta (BH, Nq) fp32
extern "C" int leco_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int bh,
                                  int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_DKV(D)                                                                    \
  leco::launch_dkv<D>(q, k, v, dout, static_cast<const float*>(lse),                   \
                      static_cast<const float*>(delta), dk, dv, bh, nq, nk, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_DKV)
#undef LECO_DKV
}
