// 3x3, stride-1, pad-1 convolution as an implicit GEMM, for Hopper (sm_90a).
// One core, two entry points:
//
//   leco_conv3x3    out = conv3x3(x) + bias
//     Replaces: leco_tpu/ops/conv.py, `_conv_kernel` (reached through
//     `conv3x3_gemm` and the `conv3x3` custom VJP; also its dx, which is the
//     same conv on the flipped, in/out-swapped weights).
//   leco_gnconv3x3  out = conv3x3(silu(a[b, c] * x + s[b, c])) + bias
//     Replaces: leco_tpu/ops/gn_conv.py, `_gnconv_kernel` (reached through
//     `_gnconv_call` and `affine_silu_conv`): the GroupNorm collapsed to a
//     per-(batch, channel) affine, applied with the SiLU as the input tile is
//     staged, so the normalised activation never goes to device memory.
//
// Layout contract (checked by the Python wrappers): x (B, Cin, H, W) and out
// (B, Cout, H, W) contiguous bf16 (the port's NCHW); w (Cout, Cin, 3, 3)
// contiguous bf16 (OIHW); bias fp32 (Cout) or null; a, s fp32 (B, Cin).
//
// The GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin. What bounds it on
// this card: at the SD1.5 level-0 shape (B = 2, 64x64, 320 -> 320) it does
// 2*M*N*K = 15 GFLOP against about 5 MB of activations and weights, so it is
// compute-bound (the H100's ridge is near 295 operations per byte).
//
// What the design does: a block owns 128 pixels x 64 output channels and
// walks K in stages of 16 input channels x 9 taps. Each stage gathers the
// nine shifted 128 x 16 input tiles into shared memory (out-of-image taps
// are 0: the padding is zero AFTER the activation, as in gn_conv.py:226-235)
// and the 9 x 64 x 16 weight slab, which is contiguous in OIHW (16 channels
// x 9 taps per output channel). No layout copy of x is made: for a fixed
// channel the pixels are contiguous in NCHW, so each tap's tile is a
// column-major WMMA A operand. 8 warps, each 32 x 32 of the output, run the
// products on the tensor cores (WMMA m16n16k16 bf16, fp32 accumulation); the
// fp32 bias goes on in the epilogue, with one rounding to bf16. Ragged M and
// N tiles, and any Cin, are masked. This is a simple first kernel: the nine
// tap tiles are re-read from L1/L2 rather than shared as one halo tile, and
// no stage is pipelined.
#include "wmma_common.cuh"

namespace leco {
namespace conv {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 64;   // output channels per block
constexpr int kBK = 16;   // input channels per stage (times 9 taps)
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kConvThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kLdA = kBM + 8;  // A tiles [tap][channel][pixel]: column-major A
constexpr int kLdB = kBK + 8;  // B tiles [tap][out channel][channel]: column-major B

constexpr size_t smem_bytes() {
  return (9 * kBK * kLdA + 9 * kBN * kLdB) * sizeof(bf16);
}

template <bool PROLOGUE>
__global__ void __launch_bounds__(kConvThreads)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ aff_a,
                   const float* __restrict__ aff_s, bf16* __restrict__ out,
                   int batch, int cin, int h, int wd, int cout, int silu) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + 9 * kBK * kLdA;

  const int hw = h * wd;
  const int m_total = batch * hw;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % kWarpsM;  // the warp's 32 x 32 sub-tile
  const int wn = warp / kWarpsM;

  // The pixel this thread gathers for (one column of every A tile), and the
  // input offset and validity of each of its nine taps.
  const int am = threadIdx.x % kBM;
  const int ac = threadIdx.x / kBM;  // 0 or 1: which half of the channels
  const int m = m0 + am;
  const bool m_ok = m < m_total;
  int b = 0, y = 0, xq = 0;
  if (m_ok) {
    b = m / hw;
    const int p = m - b * hw;
    y = p / wd;
    xq = p - y * wd;
  }
  int tap_off[9];
  bool tap_ok[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int yy = y + t / 3 - 1;
    const int xx = xq + t % 3 - 1;
    tap_ok[t] = m_ok && yy >= 0 && yy < h && xx >= 0 && xx < wd;
    tap_off[t] = yy * wd + xx;
  }
  const bf16* xb = x + static_cast<size_t>(b) * cin * hw;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < cin; c0 += kBK) {
    // A: the nine shifted (128 pixels x 16 channels) tiles
    for (int cl = ac; cl < kBK; cl += 2) {
      const int c = c0 + cl;
      const bool c_ok = c < cin;
      float sa = 0.f, ss = 0.f;
      if (PROLOGUE && c_ok && m_ok) {
        sa = aff_a[b * cin + c];
        ss = aff_s[b * cin + c];
      }
      const bf16* xc = xb + static_cast<size_t>(c) * hw;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        bf16 val = zero;
        if (c_ok && tap_ok[t]) {
          val = xc[tap_off[t]];
          if (PROLOGUE) {
            float f = sa * __bfloat162float(val) + ss;
            // the fast exp and reciprocal: their error is far below the
            // bf16 rounding that follows
            if (silu) f *= __frcp_rn(1.f + __expf(-f));
            val = __float2bfloat16(f);
          }
        }
        as[(t * kBK + cl) * kLdA + am] = val;
      }
    }
    // B: per output channel, 16 channels x 9 taps are contiguous in OIHW.
    // Neighbouring threads take neighbouring channels of one tap, so their
    // shared-memory stores fall in distinct banks; the nine taps of a
    // weight row are re-read from L1.
    for (int i = threadIdx.x; i < kBN * kBK * 9; i += kConvThreads) {
      const int cl = i % kBK;
      const int co_l = (i / kBK) % kBN;
      const int t = i / (kBK * kBN);
      const int co = n0 + co_l;
      const int c = c0 + cl;
      bf16 val = zero;
      if (co < cout && c < cin) val = w[(static_cast<size_t>(co) * cin + c) * 9 + t];
      bs[(t * kBN + co_l) * kLdB + cl] = val;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < 9; ++t) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + t * kBK * kLdA + wm * 32 + i * 16, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + (t * kBN + wn * 32 + j * 16) * kLdB, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the next stage overwrites the tiles
  }

  // Epilogue: each warp stages one 16 x 16 fragment at a time in its own
  // fp32 scratch (the A tiles' space, free now), column-major, so that a
  // lane writes 8 consecutive pixels of one output channel.
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int nl = lane / 2;
  const int ml = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_col_major);
      __syncwarp();
      const int co = n0 + wn * 32 + j * 16 + nl;
      if (co < cout) {
        const float bv = bias != nullptr ? bias[co] : 0.f;
        const int mb = m0 + wm * 32 + i * 16 + ml;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int mm = mb + e;
          if (mm < m_total) {
            const int bb = mm / hw;
            const int p = mm - bb * hw;
            out[(static_cast<size_t>(bb) * cout + co) * hw + p] =
                __float2bfloat16(scratch[nl * 16 + ml + e] + bv);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool PROLOGUE>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* a,
                   const void* s, void* out, int batch, int cin, int h, int wd,
                   int cout, int silu, cudaStream_t stream) {
  if (batch <= 0 || cin <= 0 || h <= 0 || wd <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes();
  auto kernel = conv3x3_kernel<PROLOGUE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long m_total = static_cast<long long>(batch) * h * wd;
  dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(a),
      static_cast<const float*>(s), static_cast<bf16*>(out), batch, cin, h, wd,
      cout, silu);
  return cudaGetLastError();
}

}  // namespace conv
}  // namespace leco

extern "C" int leco_conv3x3(const void* x, const void* w, const void* bias,
                            void* out, int batch, int cin, int h, int wd,
                            int cout, void* stream) {
  return leco::conv::launch<false>(x, w, bias, nullptr, nullptr, out, batch, cin,
                                   h, wd, cout, 0,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int leco_gnconv3x3(const void* x, const void* a, const void* s,
                              const void* w, const void* bias, void* out,
                              int batch, int cin, int h, int wd, int cout,
                              int silu, void* stream) {
  return leco::conv::launch<true>(x, w, bias, a, s, out, batch, cin, h, wd, cout,
                                  silu, static_cast<cudaStream_t>(stream));
}
