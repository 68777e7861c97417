// Fused GEGLU projection for Hopper (sm_90a):
//   out = value * gelu(gate),  [value | gate] = x W^T + xd up^T + b
// with gelu the exact gelu through the Abramowitz-Stegun 7.1.26 erf
// polynomial (leco_tpu/ops/geglu.py `_erf_poly`).
//
// Replaces: leco_tpu/ops/geglu.py, `_kernel` (reached through `_fwd_impl`
// and the `geglu_fused` custom VJP).
//
// Layout contract (checked by the Python wrapper): x (M, K) and w (2N, K)
// contiguous bf16 on 16-byte boundaries (torch Linear layout: rows [0, N)
// of w are the value half, [N, 2N) the gate half); out (M, N) bf16; bias
// fp32 (2N) or null; the LoRA delta xd (M, r) and up (2N, r) contiguous bf16
// with r <= 16, or null with r = 0. K and N are multiples of 8; M is any.
//
// What bounds it on this card: the tensor cores. 2 * M * K * 2N operations
// (13.4 GFLOP at each of SD1.5's three levels at batch 2: 13.6 us at 989
// TFLOP/s) against a few MB of x, W and out. Two costs sit beside the
// products: the operand traffic from L2 into shared memory (K is short, 320
// to 1280, so each output tile streams its whole K once), and the epilogue,
// an erf polynomial with one division and one exponential for every output
// (about as many instructions as the products' issue slots at K = 320).
//
// What the design does:
// - A tile is 128 rows x BN output columns, which is 2 * BN columns of the
//   projection: the value columns [n0, n0 + BN) and the matching gate columns
//   [N + n0, ...). Two consumer warpgroups each own 64 rows and keep two
//   wgmma accumulators in registers (value and gate, fp32, BN / 2 floats a
//   thread each). The value and gate of an output sit at the same register
//   position, so the epilogue never leaves the registers until it rounds.
// - Operands are both K-major (x (M, K), W (2N, K)): the plain TN case. A
//   producer warpgroup's first thread TMA-loads a stage (x box 128 x 64, and
//   one box of BN x 64 from each of two tensor maps of W, the value half and
//   the gate half, so a box that runs past N is zero-filled instead of
//   reading gate rows) into a ring of stages with the 128-byte swizzle; TMA
//   zero-fills a ragged M and a K that is not a multiple of 64.
// - Persistent: one block an SM walks the tiles (M fastest, so the blocks in
//   flight share W tiles in L2), and the producer runs ahead across tiles, so
//   one tile's epilogue overlaps the next tile's loads.
// - BN is 128 or 64, whichever gives the fewer waves of tiles times BN (ties
//   to 128, which reads fewer operand bytes per product): at SD1.5's mid
//   block (M = 128 at batch 2, N = 5120) 64 gives 80 tiles instead of 40.
// - The LoRA delta: an xd row is 2r bytes (8 at r = 4), under TMA's 16-byte
//   stride rule, so the producer warpgroup writes xd and up with ordinary
//   loads into the first 16 columns of one more stage of the ring (zero past
//   r, M and N), and the consumers run one k16 step per accumulator on it
//   before the epilogue.
// - Epilogue in registers: + fp32 bias, value * gelu(gate) in fp32 (the
//   plain version's erf polynomial, with IEEE division and expf), one
//   rounding to bf16, staged in the output's swizzle and written by TMA
//   (clipped at M and N). The store is waited on only before the next
//   tile's epilogue reuses the staging tile.
#include <algorithm>

#include "sm90_common.cuh"

namespace leco {
namespace geglu {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;     // rows of a tile: two consumer warpgroups of 64
constexpr int kKBlock = 64;    // K of a stage: one 128-byte swizzled line
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kRankPad = 16;   // the LoRA rank, padded to one wgmma depth

template <int BN>
struct Shape {
  static constexpr int kStages = BN == 128 ? 4 : 6;
  static constexpr uint32_t kXBytes = kRows * 128;  // x box: 128 rows x 64
  static constexpr uint32_t kWBytes = BN * 128;     // one W box: BN rows x 64
  static constexpr uint32_t kStageBytes = kXBytes + 2 * kWBytes;
  static constexpr uint32_t kOutBytes = 64 * BN * 2;  // one warpgroup's output
  // + 1024 to align the start to the swizzle pattern
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kOutBytes;
};

// 1 / y correctly rounded for y in [1, 2^126) (what rcp.rn and IEEE
// division give there) without rcp.rn's branch to its special cases, which
// keeps the compiler from interleaving the epilogue's outputs: the
// approximate reciprocal and one fma-based Newton step
__device__ __forceinline__ float rcp_rn(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

// sign(x) * (1 - poly(t) * exp(-x^2)), t = 1 / (1 + p|x|): the sign as a
// copysign (at x = 0 the gelu below multiplies by g = 0 either way) and the
// division as the correctly rounded reciprocal: the same bits
__device__ __forceinline__ float erf_poly(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = rcp_rn(1.f + p * ax);
  const float poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t;
  return copysignf(1.f - poly * expf(-ax * ax), x);
}

__device__ __forceinline__ float geglu_out(float v, float g) {
  return v * (0.5f * g * (1.f + erf_poly(g * 0.70710678118654752f)));
}

// The LoRA stage: the x box's rows are xd rows m0.., the W boxes' rows are
// up rows n0.. and N + n0..; each row's r values, then zeros to its 64th
// column (0 past M and N), in the 128-byte swizzle. Thread t of the
// producer warpgroup writes rows t, t + 128, ...: all r loads of a row are
// issued before its first store.
template <int BN>
__device__ __forceinline__ void fill_rank_stage(unsigned char* stage, const bf16* xd,
                                                const bf16* up, int m0, int n0, int m, int n,
                                                int r, int t) {
  for (int row = t; row < kRows + 2 * BN; row += 128) {
    const bf16* src;
    if (row < kRows) {
      src = m0 + row < m ? xd + static_cast<size_t>(m0 + row) * r : nullptr;
    } else {
      const int half = (row - kRows) / BN;  // 0: value rows, 1: gate rows
      const int nn = n0 + (row - kRows) % BN;
      src = nn < n ? up + (static_cast<size_t>(half) * n + nn) * r : nullptr;
    }
    uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (src != nullptr) {
      const unsigned short* p = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
      for (int e = 0; e < kRankPad; ++e)
        if (e < r) w[e / 2] |= static_cast<uint32_t>(p[e]) << (16 * (e % 2));
    }
    unsigned char* line = stage + row * 128;  // rows are contiguous across the three boxes
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint4*>(line + ((c ^ (row % 8)) * 16)) =
          c < 2 ? make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3])
                : make_uint4(0, 0, 0, 0);
  }
}

// grid: min(tiles, SMs), persistent; tile i is rows (i % m_tiles) * 128..,
// output columns (i / m_tiles) * BN..
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap gmap,
                 const __grid_constant__ CUtensorMap omap, const float* __restrict__ bias,
                 const bf16* __restrict__ xd, const bf16* __restrict__ up, int m, int k, int n,
                 int r, int m_tiles, int tiles) {
  using S = Shape<BN>;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * S::kStages];  // full[s], empty[s]

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  auto x_tile = [&](int s) { return base + s * S::kStageBytes; };
  auto v_tile = [&](int s) { return x_tile(s) + S::kXBytes; };
  auto g_tile = [&](int s) { return v_tile(s) + S::kWBytes; };
  const uint32_t out_s = base + S::kStages * S::kStageBytes;
  auto full = [&](int s) { return smem_addr(&bars[s]); };
  auto empty = [&](int s) { return smem_addr(&bars[S::kStages + s]); };

  const int kblocks = (k + kKBlock - 1) / kKBlock;
  const int stages_per_tile = kblocks + (r > 0 ? 1 : 0);  // + the LoRA stage
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    release_registers<40>();
    const int t = threadIdx.x;
    int it = 0;  // stages used so far, over all of this block's tiles
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kRows;
      const int n0 = (tile / m_tiles) * BN;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        if (t != 0) continue;
        const int s = it % S::kStages;
        if (it >= S::kStages) mbar_wait(empty(s), ((it / S::kStages) - 1) & 1);
        mbar_expect_tx(full(s), S::kStageBytes);
        tma_load_4d(x_tile(s), &xmap, full(s), kb * kKBlock, m0, 0, 0);
        tma_load_4d(v_tile(s), &vmap, full(s), kb * kKBlock, n0, 0, 0);
        tma_load_4d(g_tile(s), &gmap, full(s), kb * kKBlock, n0, 0, 0);
      }
      if (r > 0) {  // the whole warpgroup writes the LoRA stage
        // only thread 0 waits on the ring: it alone has waited on every
        // earlier use of every stage, so its parity cannot be a phase behind
        const int s = it % S::kStages;
        if (t == 0 && it >= S::kStages) mbar_wait(empty(s), ((it / S::kStages) - 1) & 1);
        named_barrier(1, 128);
        fill_rank_stage<BN>(base_ptr + s * S::kStageBytes, xd, up, m0, n0, m, n, r, t);
        fence_proxy_async();
        named_barrier(1, 128);
        if (t == 0) mbar_arrive(full(s));
        ++it;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows m0 + 64 * cw .. + 63 of each tile
  claim_registers<232>();
  const int cw = wg - 1;
  const Fragment fr;
  unsigned char* o_ptr = base_ptr + (out_s - base) + cw * S::kOutBytes;
  float acc_v[BN / 2], acc_g[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc_v[i] = acc_g[i] = 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile % m_tiles) * kRows;
    const int n0 = (tile / m_tiles) * BN;
    if (bias != nullptr && fr.t < BN / 16) {  // the tile's bias lines into L1 for the epilogue
      const int half = fr.t / (BN / 32);      // value, gate
      const int col = n0 + 32 * (fr.t % (BN / 32));
      if (col < n) asm volatile("prefetch.global.L1 [%0];" ::"l"(bias + half * n + col));
    }
    for (int kb = 0; kb < stages_per_tile; ++kb, ++it) {
      const int s = it % S::kStages;
      mbar_wait(full(s), (it / S::kStages) & 1);
      const uint32_t a = x_tile(s) + cw * 64 * 128;
      wgmma_fence();
      // every stage, the LoRA stage too (zero past column r), runs the same
      // four k16 steps
#pragma unroll
      for (int kk = 0; kk < kKBlock / 16; ++kk) {  // 16 columns, 32 bytes a step
        const uint64_t ad = smem_desc(a + kk * 32, 16, 1024);
        const int accumulate = kb > 0 || kk > 0;
        wgmma_ss<BN>(acc_v, ad, smem_desc(v_tile(s) + kk * 32, 16, 1024), accumulate);
        wgmma_ss<BN>(acc_g, ad, smem_desc(g_tile(s) + kk * 32, 16, 1024), accumulate);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kb > 0 && fr.lane == 0) mbar_arrive(empty((it - 1) % S::kStages));
    }
    wgmma_wait<0>();
    fence_registers<BN / 2>(acc_v);
    fence_registers<BN / 2>(acc_g);
    if (fr.lane == 0) mbar_arrive(empty((it - 1) % S::kStages));

    // epilogue: the previous tile's store has read the staging tile
    if (fr.t == 0) tma_store_wait_read();
    named_barrier(2 + cw, 128);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = n0 + 8 * c + fr.col;  // even, and N is: col + 1 < N iff col < N
      float bv[2] = {0.f, 0.f}, bg[2] = {0.f, 0.f};
      if (bias != nullptr && col < n) {
        bv[0] = bias[col];
        bv[1] = bias[col + 1];
        bg[0] = bias[n + col];
        bg[1] = bias[n + col + 1];
      }
      unsigned char* row = o_ptr + (c / 8) * 64 * 128 + fr.r_lo * 128;
      const int at = (((c % 8) ^ (fr.r_lo % 8)) * 16) + fr.col * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // rows r_lo and r_lo + 8
        const float* v = &acc_v[4 * c + 2 * hf];
        const float* g = &acc_g[4 * c + 2 * hf];
        *reinterpret_cast<uint32_t*>(row + hf * 8 * 128 + at) =
            pack_bf16(geglu_out(v[0] + bv[0], g[0] + bg[0]),
                      geglu_out(v[1] + bv[1], g[1] + bg[1]));
      }
    }
    fence_proxy_async();
    named_barrier(2 + cw, 128);
    if (fr.t == 0 && m0 + 64 * cw < m) {
      for (int blk = 0; blk < BN / 64; ++blk)
        if (n0 + 64 * blk < n)
          tma_store_4d(&omap, out_s + cw * S::kOutBytes + blk * 64 * 128, n0 + 64 * blk,
                       m0 + 64 * cw, 0, 0);
      tma_store_commit();
    }
  }
  if (fr.t == 0) tma_store_wait_read();  // shared memory outlives the last store's read
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* xd, const void* up,
                   void* out, int m, int k, int n, int r, cudaStream_t stream) {
  using S = Shape<BN>;
  const cuuint64_t mk = cuuint64_t(m) * k * 2, nk = cuuint64_t(n) * k * 2,
                   mn = cuuint64_t(m) * n * 2;
  CUtensorMap xmap{}, vmap{}, gmap{}, omap{};
  cudaError_t err = sm90::encode_4d(&xmap, x, {cuuint64_t(k), cuuint64_t(m), 1, 1},
                                    {cuuint64_t(k) * 2, mk, mk}, {kKBlock, kRows, 1, 1},
                                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sm90::encode_4d(&vmap, w, {cuuint64_t(k), cuuint64_t(n), 1, 1},
                          {cuuint64_t(k) * 2, nk, nk}, {kKBlock, BN, 1, 1},
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)  // the gate half: rows [N, 2N) of w
    err = sm90::encode_4d(&gmap, static_cast<const bf16*>(w) + static_cast<size_t>(n) * k,
                          {cuuint64_t(k), cuuint64_t(n), 1, 1}, {cuuint64_t(k) * 2, nk, nk},
                          {kKBlock, BN, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sm90::encode_4d(&omap, out, {cuuint64_t(n), cuuint64_t(m), 1, 1},
                          {cuuint64_t(n) * 2, mn, mn}, {64, 64, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = geglu_kernel<BN>;
  static const cudaError_t opt_in = cudaFuncSetAttribute(  // once: host time counts
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(S::kSmem));
  if (opt_in != cudaSuccess) return opt_in;
  const int m_tiles = (m + kRows - 1) / kRows;
  const long long tiles = static_cast<long long>(m_tiles) * ((n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(std::min<long long>(tiles, sm90::sm_count()));
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      xmap, vmap, gmap, omap, static_cast<const float*>(bias), static_cast<const bf16*>(xd),
      static_cast<const bf16*>(up), m, k, n, r, m_tiles, static_cast<int>(tiles));
  return cudaGetLastError();
}

// BN 64 or 128: the fewer waves of tiles over the SMs times BN, ties to 128
inline int tile_n(int m, int n) {
  const long long m_tiles = (m + kRows - 1) / kRows;
  const int sms = sm90::sm_count();
  auto cost = [&](int bn) {
    const long long tiles = m_tiles * ((n + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(64) < cost(128) ? 64 : 128;
}

}  // namespace geglu
}  // namespace leco

extern "C" int leco_geglu(const void* x, const void* w, const void* bias, const void* xd,
                          const void* up, void* out, int m, int k, int n, int r, void* stream) {
  using namespace leco::geglu;
  if (m <= 0 || k <= 0 || n <= 0 || k % 8 != 0 || n % 8 != 0 || r < 0 || r > kRankPad ||
      (r > 0 && (xd == nullptr || up == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile_n(m, n) == 64 ? launch<64>(x, w, bias, xd, up, out, m, k, n, r, s)
                            : launch<128>(x, w, bias, xd, up, out, m, k, n, r, s);
}
