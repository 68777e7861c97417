// 3x3, stride-1, pad-1 convolution as an implicit GEMM for Hopper (sm_90a).
// One core, four entry points:
//
//   leco_conv3x3    out = conv3x3(x) + bias
//     Replaces: leco_tpu/ops/conv.py, `_conv_kernel` (reached through
//     `conv3x3_gemm` and the `conv3x3` custom VJP; also its dx, which is the
//     same conv on the flipped, in/out-swapped weights).
//   leco_gnconv3x3  out = conv3x3(silu(a[b, c] * x + s[b, c])) + bias
//     Replaces: leco_tpu/ops/gn_conv.py, `_gnconv_kernel` (reached through
//     `_gnconv_call` and `affine_silu_conv`): the GroupNorm collapsed to a
//     per-(batch, channel) affine, applied with the SiLU to the staged input
//     tile, so the normalised activation never goes to device memory.
//   leco_conv3x3_rows, leco_gnconv3x3_rows  the same two on a row window:
//     x holds one rank's h rows of a taller image with one row of each
//     neighbour above and below (h + 2 rows, spatial parallelism's halo), and
//     out the rank's h rows, with no padding in H (W is padded as above).
//     For gnconv two flags say whether the first and the last row of x are
//     image rows or the zero padding past the image's edge: a padding row is
//     0 after the activation, as outside the image in leco_gnconv3x3 (the
//     TPU kernel's `valid` mask, gn_conv.py:218-228, moved to the window).
//
// Layout contract (checked by the Python wrappers): x (B, Cin, H, W) and out
// (B, Cout, H, W) contiguous bf16 (the port's NCHW), both on 16-byte
// boundaries; w the weights repacked to (9, Cout, Cin8) bf16 by
// `leco_conv3x3_pack` (below; tap t = 3 * ky + kx, Cin8 = Cin rounded up to
// a multiple of 8, zeros past Cin; the input gradient's flip is folded into
// the same copy); bias fp32 (Cout) or null; a, s fp32 (B, Cin).
//
// What bounds it on this card: out[Cout, pixels] = sum over the 9 taps of
// W_t[Cout, Cin] * x_t[Cin, pixels] is 2 * B*H*W * Cout * 9*Cin FLOPs against
// a few MB of activations and weights: at (2, 320, 64x64, 320) 15 GFLOP, 15 us
// at 989 TFLOP/s, so the tensor cores bound it; under gnconv the prologue
// adds one tanh per staged element on the special-function units.
//
// What the design does:
// - M = Cout, N = pixels, K = Cin. A block owns 128 output channels (two
//   consumer warpgroups of 64, accumulators in registers) x 128 pixels of one
//   image: R = 128 / WB image rows of WB columns. wgmma reads A (the weights,
//   K-major, 128-byte swizzle) and B (the input, MN-major: pixels are
//   contiguous in NCHW, so x is staged as it lies, with no layout copy).
// - Taps from a halo, not nine re-reads. For each 64-channel chunk the
//   centre copy (WB columns from x0, 64 channels, R + 2 rows from y0 - 1)
//   comes by TMA, one box per image row; rows outside the image arrive as 0.
//   One image row of a copy is one block of the MN-major operand (64 lines
//   of WB pixels), so the three row taps dy of a copy are the same
//   descriptor started dy blocks further. The column taps need the copy
//   shifted by one pixel, which neither a descriptor (it starts on a swizzle
//   atom) nor TMA (a box starts on a 16-byte boundary) can do: fill warps
//   build the left and right copies from the centre in shared memory (a
//   byte permute of neighbouring words), with the one column past the tile's
//   edge read from device memory. The swizzle follows the row: 128 bytes at
//   WB 64 (W > 32), 64 at WB 32 (W 17-32), 32 at WB 16 (W <= 16); columns
//   past W load as 0 and are never stored. The weights come one tap at a
//   time, a box of (64 channels, 128 output channels).
// - Warp-specialised and pipelined: producer warp 0 keeps TMA loads in
//   flight (the centre double-buffered, a chunk ahead; the weights through a
//   4-stage ring), producer warps 1-7 build the copies, and the consumers
//   keep one group of wgmmas in flight behind the one they wait on before
//   they release a stage. setmaxnreg gives the producers' registers to the
//   consumers.
// - gnconv: the fill warps apply silu(a * x + s) in place to each element of
//   the centre copy once, before the shifts (in fp32, rounded to bf16
//   before the product, as the TPU kernel does), masked by image
//   coordinates so that the padding stays 0 after the activation while a
//   real 0 inside the image becomes silu(s); then they fence the async
//   proxy and arrive on the copy's `ready` barrier, which the consumers wait
//   on. The SiLU is f/2 + f/2 * tanh(f/2): one tanh.approx per element.
// - Epilogue: the fp32 bias is added to the registers, rounded once to bf16,
//   staged in the output's swizzle and written with one TMA store per
//   warpgroup, clipped at Cout, H and W.
// - Row windows: the kernel reads input row y0 - 1 + r + off for tile row r
//   (off 0, or 1 on a window, whose row 0 is the halo above); the rows in
//   [lo, hi) are live data, the rest load as 0 (outside x: TMA's fill) or
//   are zeroed after the load (a window's padding rows).
// - W not a multiple of 8 (SD2.1's 12 x 12 level at 768 px, 4 x 4): no
//   tensor map of x or out exists (a row stride must be a multiple of 16
//   bytes), so the fill warps load the centre copy (WB 16) with ordinary
//   loads and the consumers store with ordinary stores; the rest is the same.
#include <cuda_bf16.h>

#include <algorithm>

#include "sm90_common.cuh"

namespace leco {
namespace conv {

using bf16 = __nv_bfloat16;

constexpr int kCoutTile = 128;  // output channels of a block: two warpgroups of 64
constexpr int kPixels = 128;    // output pixels of a block: the wgmma N
constexpr int kChunk = 64;      // input channels of a stage: one 128-byte line of A
constexpr int kThreads = 512;   // two producer warpgroups + two consumer warpgroups
constexpr int kFillThreads = 224;  // producer warps 1-7
constexpr int kCopies = 3;  // input copies of a chunk: column shifts dx 1, 0, 2
constexpr int kSlots = 4;   // their tiles: two for the centre (double-buffered), left, right
constexpr int kAStages = 6;

// the column shift of input copy k: the centre (1), then the left (0) and
// right (2) copies built from it
__host__ __device__ constexpr int copy_dx(int k) { return k == 0 ? 1 : 2 * (k - 1); }
constexpr uint32_t kATileBytes = kCoutTile * kChunk * 2;  // one tap's weights

template <int WB>
struct Tile {
  static constexpr int kRows = kPixels / WB;  // output image rows of a block
  static constexpr int kLineBytes = WB * 2;   // one (image row, channel) line
  static constexpr int kSwizzleBits = WB == 64 ? 3 : WB == 32 ? 2 : 1;
  static constexpr uint32_t kLayout = 4 - kSwizzleBits;  // wgmma descriptor layout
  static constexpr CUtensorMapSwizzle kSwizzle =
      WB == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : WB == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint32_t kBlockBytes = kChunk * kLineBytes;  // one image row: the LBO
  static constexpr uint32_t kBTileBytes = (kRows + 2) * kBlockBytes;
  // one warpgroup's output, staged in the side copies' tiles at the end
  static constexpr uint32_t kOutBytes = kRows * 64 * kLineBytes;
  static_assert(kOutBytes <= kBTileBytes, "the output does not fit a copy's tile");
  static constexpr int kLines = (kRows + 2) * kChunk;  // lines of a copy
  // + 1024 to align the start to the swizzle pattern
  static constexpr size_t kSmem = 1024 + kSlots * kBTileBytes + kAStages * kATileBytes;
};

// The rows of x and out: x has `in` rows and out `out`; output row y's
// centre tap reads input row y + off; input rows [lo, hi) hold image data
struct Rows {
  int in, out, off, lo, hi;
};

// silu(a * x + s), or a * x + s, from the halved affine: h = (a / 2) * x +
// s / 2 is exactly f / 2 (halving is exact), and silu(f) = h + h * tanh(h)
__device__ __forceinline__ float activate(float ha, float x, float hs, int silu) {
  const float h = fmaf(ha, x, hs);
  return silu ? fmaf(h, sm90::tanh_approx(h), h) : 2.f * h;
}

// Eight pixels of one line, image columns xs.., through silu(a * x + s)
// (PROLOGUE; sa, ss are a / 2, s / 2) and masked: a pixel outside the image, or of a dead line (a
// channel past Cin or a row outside the image), is 0 whatever v holds.
template <bool PROLOGUE>
__device__ __forceinline__ uint4 activate_chunk(uint4 v, bool live, int xs, int wd, float sa,
                                                float ss, int silu) {
  uint32_t* pair = reinterpret_cast<uint32_t*>(&v);
  if (live && xs >= 0 && xs + 8 <= wd) {  // all eight inside the image
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pair[e]));
      pair[e] = PROLOGUE ? sm90::pack_bf16(activate(sa, f.x, ss, silu),
                                           activate(sa, f.y, ss, silu))
                         : pair[e];
    }
    return v;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&pair[e]));
    float g[2] = {f.x, f.y};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int col = xs + 2 * e + k;
      const bool in = live && col >= 0 && col < wd;
      if (PROLOGUE && in) g[k] = activate(sa, g[k], ss, silu);
      if (!in) g[k] = 0.f;
    }
    pair[e] = sm90::pack_bf16(g[0], g[1]);
  }
  return v;
}

// grid (B * y_tiles * x_tiles, ceil(Cout / 128))
template <bool PROLOGUE, int WB, bool MANUAL>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap omap, const bf16* __restrict__ x,
                   const float* __restrict__ bias, const float* __restrict__ aff_a,
                   const float* __restrict__ aff_s, bf16* __restrict__ out, int cin, Rows rows,
                   int wd, int cout, int silu, int y_tiles, int x_tiles) {
  using T = Tile<WB>;
  using namespace sm90;
  constexpr int kChunksPerLine = WB / 8;  // 16-byte chunks of a line
  constexpr int kChunksPerCopy = (T::kRows + 2) * kChunk * kChunksPerLine;
  extern __shared__ unsigned char smem_raw[];
  // full_a[s], empty_a[s], then per input tile: ready[t], empty[t]; full_c[2]
  __shared__ __align__(8) uint64_t bars[2 * kAStages + 2 * kSlots + 2];
  // per line of a chunk: the pixel left of the tile and the one right of it
  __shared__ uint16_t edges[2][T::kLines];

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  auto b_tile = [&](int t) { return base + t * T::kBTileBytes; };
  auto a_tile = [&](int s) { return base + kSlots * T::kBTileBytes + s * kATileBytes; };
  const uint32_t out_s = base + 2 * T::kBTileBytes;  // the side copies' tiles, at the end
  auto full_a = [&](int s) { return smem_addr(&bars[s]); };
  auto empty_a = [&](int s) { return smem_addr(&bars[kAStages + s]); };
  auto ready = [&](int k) { return smem_addr(&bars[2 * kAStages + k]); };
  auto empty = [&](int t) { return smem_addr(&bars[2 * kAStages + kSlots + t]); };
  auto full_c = [&](int t) { return smem_addr(&bars[2 * kAStages + 2 * kSlots + t]); };
  // copy k of chunk cc: its tile, and the parity of that tile's use
  auto slot = [](int k, int cc) { return k == 0 ? cc % 2 : k + 1; };
  auto use = [](int k, int cc) { return k == 0 ? cc / 2 : cc; };

  // the block's tile: output channels co0.., image b, rows y0.., columns x0..
  const int co0 = blockIdx.y * kCoutTile;
  int tile = blockIdx.x;
  const int x0 = (tile % x_tiles) * WB;
  tile /= x_tiles;
  const int y0 = (tile % y_tiles) * T::kRows;
  const int b = tile / y_tiles;
  // split K (blockIdx.z of gridDim.z, one cluster): this block's chunks of
  // input channels, from channel ch0
  const int all_chunks = (cin + kChunk - 1) / kChunk;
  const int per_split = (all_chunks + gridDim.z - 1) / gridDim.z;
  const int chunks = min(all_chunks - static_cast<int>(blockIdx.z) * per_split, per_split);
  const int ch0 = blockIdx.z * per_split * kChunk;
  const int splits = gridDim.z;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), 8);  // one arrival from each consumer warp
    }
    for (int t = 0; t < kSlots; ++t) {
      mbar_init(ready(t), kFillThreads);
      // a centre is also read by the fill warps, which build the sides from it
      mbar_init(empty(t), t < 2 ? 8 + kFillThreads / 32 : 8);
    }
    mbar_init(full_c(0), 1);
    mbar_init(full_c(1), 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg < 2) {  // producers
    release_registers<88>();
    if (threadIdx.x == 0) {
      // the centre copy of chunk cc: one box per image row, at aligned columns
      auto load_centre = [&](int cc) {
        const int t = cc % 2;
        if (cc >= 2) mbar_wait(empty(t), ((cc / 2) - 1) & 1);
        mbar_expect_tx(full_c(t), T::kBTileBytes);
        for (int r = 0; r < T::kRows + 2; ++r) {
          const int yy = y0 - 1 + r + rows.off;  // a row above x loads as row rows.in: zeros
          tma_load_4d(b_tile(t) + r * T::kBlockBytes, &xmap, full_c(t), x0, ch0 + cc * kChunk,
                      yy < 0 ? rows.in : yy, b);
        }
      };
      if (!MANUAL) load_centre(0);
      for (int cc = 0; cc < chunks; ++cc) {
        if (!MANUAL && cc + 1 < chunks) load_centre(cc + 1);  // a chunk ahead
        for (int r = 0; r < 9; ++r) {  // the weights, in the consumers' tap order
          const int i = 9 * cc + r;
          const int s = i % kAStages;
          if (i >= kAStages) mbar_wait(empty_a(s), ((i / kAStages) - 1) & 1);
          mbar_expect_tx(full_a(s), kATileBytes);
          const int tap = 3 * (r % 3) + copy_dx(r / 3);  // 3 * dy + dx
          tma_load_4d(a_tile(s), &wmap, full_a(s), ch0 + cc * kChunk, co0, tap, 0);
        }
      }
    } else if (threadIdx.x >= 32) {  // warps 1-7: the input copies
      const int t = threadIdx.x - 32;
      constexpr int kEdgeIters = (T::kLines + kFillThreads - 1) / kFillThreads;
      for (int cc = 0; cc < chunks; ++cc) {
        // the pixels just past the tile's sides, for every line: loaded now,
        // used once the centre's activation has hidden their latency
        float edge_val[kEdgeIters][2], edge_a[kEdgeIters], edge_s[kEdgeIters];
#pragma unroll
        for (int m = 0; m < kEdgeIters; ++m) {
          const int line = t + m * kFillThreads;
          const int c = ch0 + cc * kChunk + line % kChunk;
          const int yy = y0 - 1 + line / kChunk + rows.off;
          const bool live = line < T::kLines && c < cin && yy >= rows.lo && yy < rows.hi;
          edge_a[m] = PROLOGUE && live ? 0.5f * aff_a[b * cin + c] : 0.5f;
          edge_s[m] = PROLOGUE && live ? 0.5f * aff_s[b * cin + c] : 0.f;
#pragma unroll
          for (int sd = 0; sd < 2; ++sd) {
            const int col = sd == 0 ? x0 - 1 : x0 + WB;
            edge_val[m][sd] = live && col >= 0 && col < wd
                ? __bfloat162float(x[((static_cast<size_t>(b) * cin + c) * rows.in + yy) * wd + col])
                : 0.f;
          }
        }
        // the centre: activated in place (TMA), or loaded and activated
        const int ct = cc % 2;
        unsigned char* centre = base_ptr + ct * T::kBTileBytes;
        if (MANUAL) {
          if (cc >= 2) mbar_wait(empty(ct), ((cc / 2) - 1) & 1);
        } else {
          mbar_wait(full_c(ct), (cc / 2) & 1);
        }
        if (MANUAL) {
          for (int q = t; q < kChunksPerCopy; q += kFillThreads) {
            const uint32_t off = q * 16;  // where the chunk lies
            const int line = q / kChunksPerLine;  // y_l * 64 + c_l
            const int c = ch0 + cc * kChunk + line % kChunk;
            const int yy = y0 - 1 + line / kChunk + rows.off;
            const int xs = x0 + (swizzle<T::kSwizzleBits>(off) % T::kLineBytes) / 2;
            const bool live = c < cin && yy >= rows.lo && yy < rows.hi;
            uint4 v = make_uint4(0, 0, 0, 0);
            float sa = 0.5f, ss = 0.f;
            if (live) {
              const unsigned short* row = reinterpret_cast<const unsigned short*>(x) +
                                          ((static_cast<size_t>(b) * cin + c) * rows.in + yy) * wd;
              uint32_t* pair = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const int col = xs + e;
                const uint32_t bits = col < wd ? row[col] : 0u;
                pair[e / 2] |= bits << (16 * (e % 2));
              }
              if (PROLOGUE) {
                sa = 0.5f * aff_a[b * cin + c];
                ss = 0.5f * aff_s[b * cin + c];
              }
            }
            *reinterpret_cast<uint4*>(centre + off) =
                activate_chunk<PROLOGUE>(v, live, xs, wd, sa, ss, silu);
          }
        } else if (PROLOGUE) {
          // two chunks a step, both loads before either store; TMA's zero
          // fill is the padding of a dead line outside x, which stays as it
          // is; a dead line inside x (a window's padding row) is zeroed
          for (int q0 = t; q0 < kChunksPerCopy; q0 += 2 * kFillThreads) {
            uint4 v[2];
            float sa[2], ss[2];
            int xs[2];
            bool live[2], loaded[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int q = q0 + u * kFillThreads;
              const uint32_t off = q * 16;
              const int line = q / kChunksPerLine;
              const int c = ch0 + cc * kChunk + line % kChunk;
              const int yy = y0 - 1 + line / kChunk + rows.off;
              xs[u] = x0 + (swizzle<T::kSwizzleBits>(off) % T::kLineBytes) / 2;
              loaded[u] = q < kChunksPerCopy && c < cin && yy >= 0 && yy < rows.in;
              live[u] = loaded[u] && yy >= rows.lo && yy < rows.hi;
              v[u] = live[u] ? *reinterpret_cast<const uint4*>(centre + off)
                             : make_uint4(0, 0, 0, 0);
              sa[u] = live[u] ? 0.5f * aff_a[b * cin + c] : 0.5f;
              ss[u] = live[u] ? 0.5f * aff_s[b * cin + c] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (loaded[u])
                *reinterpret_cast<uint4*>(centre + (q0 + u * kFillThreads) * 16) =
                    live[u] ? activate_chunk<true>(v[u], true, xs[u], wd, sa[u], ss[u], silu)
                            : make_uint4(0, 0, 0, 0);
          }
        }
        fence_proxy_async();
        mbar_arrive(ready(ct));
        named_barrier(3, kFillThreads);  // every fill thread is past the last chunk's sides
#pragma unroll
        for (int m = 0; m < kEdgeIters; ++m) {
          const int line = t + m * kFillThreads;
          if (line >= T::kLines) continue;
          const int c = ch0 + cc * kChunk + line % kChunk;
          const int yy = y0 - 1 + line / kChunk + rows.off;
#pragma unroll
          for (int sd = 0; sd < 2; ++sd) {
            const int col = sd == 0 ? x0 - 1 : x0 + WB;
            float f = edge_val[m][sd];
            if (PROLOGUE && c < cin && yy >= rows.lo && yy < rows.hi && col >= 0 && col < wd)
              f = activate(edge_a[m], f, edge_s[m], silu);
            edges[sd][line] = __bfloat16_as_ushort(__float2bfloat16(f));
          }
        }
        named_barrier(3, kFillThreads);  // the whole centre and its edges are written

        // the sides: the centre shifted by one column, the column past the
        // tile's edge from device memory
        for (int k = 1; k < kCopies; ++k) {
          if (cc > 0) mbar_wait(empty(k + 1), (cc - 1) & 1);
          unsigned char* side = base_ptr + (k + 1) * T::kBTileBytes;
          const bool left = k == 1;
          for (int q0 = t; q0 < kChunksPerCopy; q0 += 2 * kFillThreads) {  // two chunks a step
            uint4 cur[2];
            // left: the previous pixel in the high half; right: the next in the low
            uint32_t edge[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int q = q0 + u * kFillThreads;
              if (q >= kChunksPerCopy) continue;
              const uint32_t off = q * 16;
              const uint32_t lo = swizzle<T::kSwizzleBits>(off);  // logical offset
              const int n = (lo % T::kLineBytes) / 16;  // the chunk's place in its line
              cur[u] = *reinterpret_cast<const uint4*>(centre + off);
              if (left ? n > 0 : n < kChunksPerLine - 1) {
                edge[u] = *reinterpret_cast<const uint32_t*>(
                    centre + (left ? swizzle<T::kSwizzleBits>(lo - 16) + 12
                                   : swizzle<T::kSwizzleBits>(lo + 16)));
              } else {
                const uint32_t bits = edges[left ? 0 : 1][q / kChunksPerLine];
                edge[u] = left ? bits << 16 : bits;
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int q = q0 + u * kFillThreads;
              if (q >= kChunksPerCopy) continue;
              const uint4 c4 = cur[u];
              *reinterpret_cast<uint4*>(side + q * 16) =
                  left ? make_uint4(__byte_perm(edge[u], c4.x, 0x5432),
                                    __byte_perm(c4.x, c4.y, 0x5432),
                                    __byte_perm(c4.y, c4.z, 0x5432),
                                    __byte_perm(c4.z, c4.w, 0x5432))
                       : make_uint4(__byte_perm(c4.x, c4.y, 0x5432),
                                    __byte_perm(c4.y, c4.z, 0x5432),
                                    __byte_perm(c4.z, c4.w, 0x5432),
                                    __byte_perm(c4.w, edge[u], 0x5432));
            }
          }
          fence_proxy_async();
          mbar_arrive(ready(k + 1));
        }
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty(ct));  // this warp is done with the centre
      }
    }
    if (splits > 1) {  // the consumers' two cluster barriers (below)
      cluster_arrive();
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // consumers: warpgroup cw owns output channels co0 + 64 * cw .. + 63
  claim_registers<168>();
  const int cw = wg - 2;
  const Fragment fr;

  float acc[kPixels / 2];
#pragma unroll
  for (int i = 0; i < kPixels / 2; ++i) acc[i] = 0.f;

  // tap i: chunk i / 9, copy k = (i % 9) / 3 (column shift copy_dx(k)), row shift dy = i % 3
  const int taps = 9 * chunks;
  for (int i = 0; i < taps; ++i) {
    const int cc = i / 9, k = (i % 9) / 3, dy = i % 3;
    const int sa = i % kAStages;
    if (dy == 0) mbar_wait(ready(slot(k, cc)), use(k, cc) & 1);
    mbar_wait(full_a(sa), (i / kAStages) & 1);
    const uint32_t a_rows = a_tile(sa) + cw * 64 * 128;
    const uint32_t b_rows = b_tile(slot(k, cc)) + dy * T::kBlockBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)  // 16 channels a step
      wgmma_ss_mn<kPixels>(acc, smem_desc(a_rows + kk * 32, 16, 1024),
                           smem_desc(b_rows + kk * 16 * T::kLineBytes, T::kBlockBytes,
                                     8 * T::kLineBytes, T::kLayout));
    wgmma_commit();
    wgmma_wait<1>();  // the previous tap's products are done: release its stages
    if (i > 0 && fr.lane == 0) {
      mbar_arrive(empty_a((i - 1) % kAStages));
      if ((i - 1) % 3 == 2) mbar_arrive(empty(slot(((i - 1) % 9) / 3, (i - 1) / 9)));
    }
  }
  wgmma_wait<0>();
  fence_registers<kPixels / 2>(acc);
  named_barrier(4, 256);  // both warpgroups are done with the copies' tiles
  if (splits > 1) {
    // split K: every block of the cluster leaves its partial sums in its
    // copies' tiles, and the first adds the others' to its own, in rank
    // order (the same order every call: the same bits)
    float* red = reinterpret_cast<float*>(base_ptr);  // [cw * 64 + i][thread]
    if (blockIdx.z != 0) {
#pragma unroll
      for (int i = 0; i < kPixels / 2; ++i) red[(cw * 64 + i) * 128 + fr.t] = acc[i];
    }
    cluster_arrive();
    cluster_wait();
    if (blockIdx.z == 0) {
      for (int r = 1; r < splits; ++r) {
        const uint32_t remote = map_rank(smem_addr(red), r);
#pragma unroll
        for (int i = 0; i < kPixels / 2; ++i)
          acc[i] += ld_cluster_f32(remote + ((cw * 64 + i) * 128 + fr.t) * 4);
      }
    }
    cluster_arrive();  // the others' shared memory stays until the first has read it
    cluster_wait();
    if (blockIdx.z != 0) return;
  }

  // epilogue: + bias, one rounding; column n of the accumulator is pixel
  // (y0 + n / WB, x0 + n % WB)
  const int co_w = co0 + cw * 64;
  float bv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int co = co_w + fr.r_lo + 8 * hf;
    bv[hf] = bias != nullptr && co < cout ? bias[co] : 0.f;
  }
  if (MANUAL) {
#pragma unroll
    for (int c = 0; c < kPixels / 8; ++c) {
      const int n = 8 * c + fr.col;
      const int yy = y0 + n / WB, xx = x0 + n % WB;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int co = co_w + fr.r_lo + 8 * hf;
        if (co >= cout || yy >= rows.out) continue;
        bf16* dst = out + ((static_cast<size_t>(b) * cout + co) * rows.out + yy) * wd;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (xx + e < wd) dst[xx + e] = __float2bfloat16(acc[4 * c + 2 * hf + e] + bv[hf]);
      }
    }
    return;
  }
  // the warpgroup's (R rows, 64 channels, WB columns) box, in the swizzle
  // of the output's tensor map
  unsigned char* o_ptr = base_ptr + (out_s - base) + cw * T::kOutBytes;
#pragma unroll
  for (int c = 0; c < kPixels / 8; ++c) {
    const int n = 8 * c + fr.col;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = fr.r_lo + 8 * hf;
      const uint32_t off = ((n / WB * 64 + row) * WB + n % WB) * 2;
      *reinterpret_cast<uint32_t*>(o_ptr + swizzle<T::kSwizzleBits>(off)) =
          pack_bf16(acc[4 * c + 2 * hf] + bv[hf], acc[4 * c + 2 * hf + 1] + bv[hf]);
    }
  }
  fence_proxy_async();
  named_barrier(1 + cw, 128);
  if (fr.t == 0 && co_w < cout) {
    tma_store_4d(&omap, out_s + cw * T::kOutBytes, x0, co_w, y0, b);
    tma_store_wait();
  }
}

// The weights in the core's layout: OIHW w (cout, cin, 3, 3) -> (9, cout,
// cin8), tap t = 3 * ky + kx, zeros past cin; with `flip`, those of the
// input gradient, (9, cin, cout8) with out[t][i][o] = w[o][i][8 - t]. One
// thread a row element of the output, all nine taps: the nine weights it
// reads are contiguous, and neighbouring threads write neighbouring columns.
__global__ void pack_weight_kernel(const bf16* __restrict__ w, bf16* __restrict__ out, int cout,
                                   int cin, int flip) {
  const int rows = flip ? cin : cout;
  const int cols = flip ? cout : cin;
  const int cols8 = (cols + 7) / 8 * 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * cols8) return;
  const int r = static_cast<int>(idx / cols8);
  const int c = static_cast<int>(idx % cols8);
  bf16 v[9];
  const bf16* src = w + (static_cast<size_t>(flip ? c : r) * cin + (flip ? r : c)) * 9;
#pragma unroll
  for (int t = 0; t < 9; ++t) v[t] = c < cols ? src[flip ? 8 - t : t] : __float2bfloat16(0.f);
#pragma unroll
  for (int t = 0; t < 9; ++t) out[(static_cast<size_t>(t) * rows + r) * cols8 + c] = v[t];
}

// Split K over a cluster of up to 8 blocks (one per SM) when the output
// tiles fill less than half of the card's SMs: the small images of the
// UNet's inner levels (8 x 8 and 16 x 16 at 512 px) would otherwise run a
// long K loop on a few SMs. Every split gets at least one chunk.
// (ops/conv.py::tile_plan says the same.)
inline int split_k(long long blocks, int chunks) {
  const int sms = sm90::sm_count();
  if (2 * blocks >= sms) return 1;
  int splits = static_cast<int>(std::min<long long>(8, sms / blocks));
  splits = std::max(1, std::min(splits, chunks));
  const int per = (chunks + splits - 1) / splits;
  return (chunks + per - 1) / per;
}

template <bool PROLOGUE, int WB, bool MANUAL>
cudaError_t launch_tile(const void* x, const void* w, const void* bias, const void* a,
                        const void* s, void* out, int batch, int cin, Rows rows, int wd, int cout,
                        int silu, cudaStream_t stream) {
  using T = Tile<WB>;
  CUtensorMap xmap{}, wmap{}, omap{};
  const cuuint64_t cin8 = (cin + 7) / 8 * 8;
  cudaError_t err = sm90::encode_4d(
      &wmap, w, {cin8, cuuint64_t(cout), 9, 1},
      {cin8 * 2, cuuint64_t(cout) * cin8 * 2, 9 * cuuint64_t(cout) * cin8 * 2},
      {kChunk, kCoutTile, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess && !MANUAL)
    err = sm90::encode_nchw(&xmap, x, batch, cin, rows.in, wd, WB, kChunk, 1, T::kSwizzle);
  if (err == cudaSuccess && !MANUAL)
    err = sm90::encode_nchw(&omap, out, batch, cout, rows.out, wd, WB, 64, T::kRows, T::kSwizzle);
  if (err != cudaSuccess) return err;
  auto kernel = conv3x3_kernel<PROLOGUE, WB, MANUAL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(T::kSmem));
  if (err != cudaSuccess) return err;
  const int y_tiles = (rows.out + T::kRows - 1) / T::kRows;
  const int x_tiles = (wd + WB - 1) / WB;
  const long long tiles = static_cast<long long>(batch) * y_tiles * x_tiles;
  const int cout_tiles = (cout + kCoutTile - 1) / kCoutTile;
  if (tiles > 0x7fffffffLL || cout_tiles > 65535) return cudaErrorInvalidValue;
  const int splits = split_k(tiles * cout_tiles, (cin + kChunk - 1) / kChunk);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles), cout_tiles, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = T::kSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  config.attrs = cluster;
  config.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, xmap, wmap, omap, static_cast<const bf16*>(x),
                           static_cast<const float*>(bias), static_cast<const float*>(a),
                           static_cast<const float*>(s), static_cast<bf16*>(out), cin, rows, wd,
                           cout, silu, y_tiles, x_tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tile follows the image row (ops/conv.py::tile_plan says the same):
// WB 64 above W 32, 32 above 16, else 16; W % 8 != 0 takes the fill route.
template <bool PROLOGUE>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* a, const void* s,
                   void* out, int batch, int cin, Rows rows, int wd, int cout, int silu,
                   cudaStream_t stream) {
  if (batch <= 0 || cin <= 0 || rows.out <= 0 || rows.in <= 0 || wd <= 0 || cout <= 0)
    return cudaErrorInvalidValue;
  if (wd % 8 != 0)
    return launch_tile<PROLOGUE, 16, true>(x, w, bias, a, s, out, batch, cin, rows, wd, cout,
                                           silu, stream);
  if (wd > 32)
    return launch_tile<PROLOGUE, 64, false>(x, w, bias, a, s, out, batch, cin, rows, wd, cout,
                                            silu, stream);
  if (wd > 16)
    return launch_tile<PROLOGUE, 32, false>(x, w, bias, a, s, out, batch, cin, rows, wd, cout,
                                            silu, stream);
  return launch_tile<PROLOGUE, 16, false>(x, w, bias, a, s, out, batch, cin, rows, wd, cout, silu,
                                          stream);
}

// the whole image (pad 1 in H), and the row window of h output rows (x has
// h + 2: the halo rows; `top` and `bottom` say whether the first and the
// last are image rows or padding)
inline Rows padded(int h) { return {h, h, 0, 0, h}; }
inline Rows window(int h, int top, int bottom) {
  return {h + 2, h, 1, top ? 0 : 1, bottom ? h + 2 : h + 1};
}

}  // namespace conv
}  // namespace leco

extern "C" int leco_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int batch, int cin, int h, int wd, int cout, void* stream) {
  return leco::conv::launch<false>(x, w, bias, nullptr, nullptr, out, batch, cin,
                                   leco::conv::padded(h), wd, cout, 0,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int leco_gnconv3x3(const void* x, const void* a, const void* s, const void* w,
                              const void* bias, void* out, int batch, int cin, int h, int wd,
                              int cout, int silu, void* stream) {
  return leco::conv::launch<true>(x, w, bias, a, s, out, batch, cin, leco::conv::padded(h), wd,
                                  cout, silu, static_cast<cudaStream_t>(stream));
}

// x (B, Cin, h + 2, W): the rows of the window; out (B, Cout, h, W)
extern "C" int leco_conv3x3_rows(const void* x, const void* w, const void* bias, void* out,
                                 int batch, int cin, int h, int wd, int cout, void* stream) {
  return leco::conv::launch<false>(x, w, bias, nullptr, nullptr, out, batch, cin,
                                   leco::conv::window(h, 1, 1), wd, cout, 0,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int leco_gnconv3x3_rows(const void* x, const void* a, const void* s, const void* w,
                                   const void* bias, void* out, int batch, int cin, int h,
                                   int wd, int cout, int silu, int top, int bottom,
                                   void* stream) {
  return leco::conv::launch<true>(x, w, bias, a, s, out, batch, cin,
                                  leco::conv::window(h, top, bottom), wd, cout, silu,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int leco_conv3x3_pack(const void* w, void* out, int cout, int cin, int flip,
                                 void* stream) {
  if (cout <= 0 || cin <= 0) return cudaErrorInvalidValue;
  const long long rows = flip ? cin : cout;
  const long long n = rows * (((flip ? cout : cin) + 7) / 8 * 8);
  leco::conv::pack_weight_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const leco::conv::bf16*>(w), static_cast<leco::conv::bf16*>(out), cout, cin,
      flip);
  return cudaGetLastError();
}
