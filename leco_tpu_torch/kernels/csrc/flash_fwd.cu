// Flash-attention forward for Hopper (sm_90a), in two layouts.
//
// Replaces: leco_tpu/ops/flash_attention.py, `_attn_kernel` (reached through
// `_fwd_call` and `_flash_fwd_3d`) through the entry point `leco_flash_fwd`,
// and `_attn_kernel_packed` (reached through `_flash_fwd_packed`, the
// `LECO_FLASH_PACKED=1` route) through `leco_flash_fwd_packed`.
//
// What bounds it on this card. Per (batch, head) it does 4 * Nq * Nk * D
// FLOPs on the tensor cores and Nq * Nk exponentials on the special-function
// units, against 2 * (Nq + Nk) * D bf16 values of q, k, v and o in device
// memory, so bytes never bound it. At SD2.1's level 0, (BH 20, N 4096, D 64):
// 85.9 GFLOP, 87 us at 989 TFLOP/s, and 336 M exponentials, 86 us at the
// H100's ~3.9 T/s (132 SMs x 16 a clock); 42 MB, 13 us at 3.35 TB/s. At
// SD1.5's level 0, (16, 4096, 40): 43 GFLOP, 43 us, and 268 M exponentials,
// 69 us: there the exponentials, not the products, are the bound.
//
// What the design does about it:
// - Both products are warpgroup MMAs (wgmma). A block takes 128 query rows
//   of one (batch, head): two consumer warpgroups of 64 rows each, and one
//   producer warpgroup whose first thread keeps TMA loads of K and V tiles
//   in flight through a 2-stage ring in shared memory (mbarriers: `full`
//   counts the bytes, `empty` the 8 consumer warps). The producer gives its
//   registers to the consumers (setmaxnreg 40 / 232).
// - S = Q * K^T accumulates in registers (Q and K read from 128-byte-swizzled
//   shared memory, no bank conflicts). The online softmax runs on those
//   registers: each row lives in 4 threads, so its max needs two shuffles;
//   its sum is kept per thread and reduced once at the end. P is rounded to
//   bf16 in registers, whose accumulator layout is wgmma's register layout
//   for A, and O += P * V reads V from shared memory as an MN-major operand
//   and accumulates in registers. Nothing goes through shared memory in
//   fp32. The two consumer warpgroups run the same loop on the same tiles,
//   so one's exponentials overlap the other's products. (Issuing the next
//   tile's logits before this tile's softmax as well, with a deeper ring,
//   ran slower on the H100 at every SD shape tried; see PERF.md.)
// - Exponentials are exp2 with log2(e) folded into one FMA per logit:
//   p = 2^(s * log2 e - m * log2 e), which differs from exp(s - m) by a few
//   ulps (ex2.approx); the max m and LSE = m + ln(l) stay in logit units.
// - One TMA descriptor covers both layouts: q, k, v and o are each read as a
//   4-d (B, N, H, D) tensor with strides (N * ld, ld, D, 1) and a box of
//   (64 columns, 1, rows, 1). The 3-d layout is H = 1, ld = D; the packed
//   one reads (B, N, C = H * D) in place with ld = C. TMA's zero fill pads D
//   to the 64-column blocks of shared memory (D 40 -> 64, 80 -> 128, 160 ->
//   192) and pads the ragged N edge; the O store clips at Nq and D. So the
//   packed route is bitwise the 3-d route.
// - Head dims 40, 64, 80, 160. D 40 is padded to 64 in shared memory, not
//   48: a 128-byte-swizzled row is 64 bf16 wide, so one TMA box fills one
//   column block and one descriptor layout serves every D. Q * K^T runs only
//   ceil(D / 16) k16 steps (48 deep at D 40; the padding columns are zero);
//   P * V runs at width 64 for D 40 and 64 (a whole column block of the
//   MN-major V operand; a partial block was not tried), 80 and 160
//   otherwise. Key tiles are 128 wide for D <= 80 and 64 at D 160, so that
//   Q and the ring fit in shared memory (81 KB at D <= 64, 161 KB at 80,
//   145 KB at 160).
//
// Numerics kept from the TPU kernels: q * scale is rounded to bf16 before
// the logits (once per block, in shared memory, after the Q load); masked
// keys (column >= Nk) get the logit -1e30 in registers (TMA's zero fill is
// not a mask); l sums the fp32 P before P is rounded; the normaliser is
// applied to the (rows, D) output. Outputs: O bf16 and, 3-d only,
// LSE = m + ln(l) as (BH, Nq) fp32, which the backward kernels read.
#include "sm90_common.cuh"

namespace leco {

constexpr float kMaskedLogit = -1e30f;  // as the TPU kernel: no inf - inf NaN
constexpr int kQRows = 128;  // query rows of a block: two warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;

template <int D>
struct FwdShape {
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kSteps = (D + 15) / 16;   // k16 steps of Q * K^T
  static constexpr int kOut = D <= 64 ? 64 : (D + 15) / 16 * 16;  // width of P * V
  static constexpr int kKeys = D <= 80 ? 128 : 64;  // keys of a K / V tile
  static constexpr uint32_t kQBytes = kBlocks * kQRows * 128;
  static constexpr uint32_t kTileBytes = kBlocks * kKeys * 128;  // one K or V tile
  // + 1024 to align the start to the swizzle pattern
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes;
};

// grid (ceil(nq / 128), batch * heads); `lse` may be null (packed route)
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, float* __restrict__ lse,
                     int nq, int nk, float scale, int heads) {
  using S = FwdShape<D>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];  // q, full[s], empty[s]

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  unsigned char* q_ptr = smem_raw + (q_s - raw);
  const uint32_t q_full = smem_addr(&bars[0]);
  auto k_tile = [&](int s) { return q_s + S::kQBytes + s * 2 * S::kTileBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + S::kTileBytes; };
  auto full = [&](int s) { return smem_addr(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_addr(&bars[1 + kStages + s]); };

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kQRows;
  const int tiles = (nk + S::kKeys - 1) / S::kKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    release_registers<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, S::kQBytes);
      for (int blk = 0; blk < S::kBlocks; ++blk)
        tma_load_4d(q_s + blk * kQRows * 128, &qmap, q_full, 64 * blk, h, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * S::kTileBytes);
        for (int blk = 0; blk < S::kBlocks; ++blk) {
          tma_load_4d(k_tile(s) + blk * S::kKeys * 128, &kmap, full(s), 64 * blk, h,
                      j * S::kKeys, b);
          tma_load_4d(v_tile(s) + blk * S::kKeys * 128, &vmap, full(s), 64 * blk, h,
                      j * S::kKeys, b);
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

  // q * scale rounded to bf16, in place over this warpgroup's rows
  mbar_wait(q_full, 0);
  scale_rows_bf16<S::kBlocks>(q_ptr, kQRows, cw * 64, 64, scale, fr.t, 128);
  fence_proxy_async();
  named_barrier(1 + cw, 128);

  float o[S::kOut / 2];
#pragma unroll
  for (int i = 0; i < S::kOut / 2; ++i) o[i] = 0.f;
  float m_lo = -__int_as_float(0x7f800000), m_hi = m_lo;  // -inf: the first rescale is 0
  float l_lo = 0.f, l_hi = 0.f;  // this thread's part of each row's sum

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(full(s), (j / kStages) & 1);

    float sc[S::kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < S::kSteps; ++k)  // 16 columns: column block k / 4, 32 bytes a step
      wgmma_ss<S::kKeys>(sc, smem_desc(q_rows + (k / 4) * kQRows * 128 + (k % 4) * 32, 16, 1024),
                         smem_desc(k_tile(s) + (k / 4) * S::kKeys * 128 + (k % 4) * 32, 16, 1024),
                         k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers<S::kKeys / 2>(sc);

    const int k0 = j * S::kKeys;
    if (k0 + S::kKeys > nk) {
#pragma unroll
      for (int c = 0; c < S::kKeys / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * c + fr.col + e >= nk) sc[4 * c + e] = sc[4 * c + 2 + e] = kMaskedLogit;
    }

    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int c = 0; c < S::kKeys / 8; ++c) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * c], sc[4 * c + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * c + 2], sc[4 * c + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
    const float alpha_lo = exp2_approx((m_lo - mx_lo) * kLog2e);
    const float alpha_hi = exp2_approx((m_hi - mx_hi) * kLog2e);
    const float ms_lo = mx_lo * kLog2e, ms_hi = mx_hi * kLog2e;
    m_lo = mx_lo;
    m_hi = mx_hi;

    uint32_t p[S::kKeys / 4];  // P in bf16: the A operand of P * V
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int c = 0; c < S::kKeys / 8; ++c) {
      const float p0 = exp2_approx(fmaf(sc[4 * c], kLog2e, -ms_lo));
      const float p1 = exp2_approx(fmaf(sc[4 * c + 1], kLog2e, -ms_lo));
      const float p2 = exp2_approx(fmaf(sc[4 * c + 2], kLog2e, -ms_hi));
      const float p3 = exp2_approx(fmaf(sc[4 * c + 3], kLog2e, -ms_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      p[2 * c] = pack_bf16(p0, p1);
      p[2 * c + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int c = 0; c < S::kOut / 8; ++c) {
      o[4 * c] *= alpha_lo;
      o[4 * c + 1] *= alpha_lo;
      o[4 * c + 2] *= alpha_hi;
      o[4 * c + 3] *= alpha_hi;
    }

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::kKeys / 16; ++kk)
      wgmma_rs_mn<S::kOut>(o, &p[4 * kk],
                           smem_desc(v_tile(s) + kk * 16 * 128, S::kKeys * 128, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers<S::kOut / 2>(o);
    if (fr.lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }

  // O / l into this warpgroup's Q rows (every warp is past its last Q read),
  // in the swizzled layout, then one TMA store per column block
  named_barrier(1 + cw, 128);
  stage_fragment<S::kOut>(q_ptr, kQRows, cw * 64, o,
                          [&](float x, int hi) { return x / (hi ? l_hi : l_lo); });
  if (lse != nullptr && fr.lane % 4 == 0) {
    const int row = q0 + cw * 64 + fr.r_lo;
    if (row < nq) lse[static_cast<size_t>(bh) * nq + row] = m_lo + logf(l_lo);
    if (row + 8 < nq) lse[static_cast<size_t>(bh) * nq + row + 8] = m_hi + logf(l_hi);
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (fr.t == 0) {
    for (int blk = 0; blk < S::kBlocks; ++blk)
      tma_store_4d(&omap, q_rows + blk * kQRows * 128, 64 * blk, h, q0 + cw * 64, b);
    tma_store_wait();
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       int batch, int heads, int nq, int nk, int ld, float scale,
                       cudaStream_t stream) {
  using S = FwdShape<D>;
  CUtensorMap qmap, kmap, vmap, omap;
  cudaError_t err = sm90::encode_bnhd(&qmap, q, batch, nq, heads, D, ld, kQRows);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&kmap, k, batch, nk, heads, D, ld, S::kKeys);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&vmap, v, batch, nk, heads, D, ld, S::kKeys);
  if (err == cudaSuccess) err = sm90::encode_bnhd(&omap, o, batch, nq, heads, D, ld, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  dim3 grid((nq + kQRows - 1) / kQRows, batch * heads);
  kernel<<<grid, kThreads, S::kSmem, stream>>>(qmap, kmap, vmap, omap, lse, nq, nk, scale, heads);
  return cudaGetLastError();
}

}  // namespace leco

// (BH, N, D) layout: o (BH, Nq, D), lse (BH, Nq)
extern "C" int leco_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int bh, int nq, int nk, int d, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_FWD(D) \
  leco::launch_fwd<D>(q, k, v, o, static_cast<float*>(lse), bh, 1, nq, nk, D, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_FWD)
#undef LECO_FWD
}

// packed layout: q, o (B, Nq, C), k, v (B, Nk, C) with C = heads * D; no lse
extern "C" int leco_flash_fwd_packed(const void* q, const void* k, const void* v, void* o, int b,
                                     int heads, int nq, int nk, int c, float scale,
                                     void* stream) {
  if (b <= 0 || heads <= 0 || nq <= 0 || nk <= 0 || c % heads != 0 || b * heads > 65535)
    return cudaErrorInvalidValue;
  const int d = c / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LECO_FWD(D) leco::launch_fwd<D>(q, k, v, o, nullptr, b, heads, nq, nk, c, scale, s)
  LECO_DISPATCH_HEAD_DIM(d, LECO_FWD)
#undef LECO_FWD
}
