// GroupNorm (+ optional SiLU) for Hopper (sm_90a), bf16 in and out, fp32
// statistics.
//
// Replaces: leco_tpu/ops/group_norm.py, `_gn_kernel` (reached through
// `group_norm_silu` and the `fused_group_norm` custom VJP).
//
// Layout contract (checked by the Python wrapper): x and y (B, C, H, W)
// contiguous bf16 (the port's NCHW); gamma, beta fp32 (C); C % groups == 0;
// any H * W and any 2-byte-aligned x.
//
// Numerics kept from the TPU kernel: sums of x and x*x in fp32 over the
// group, mean = S/n, var = SQ/n - mean^2 (no clamp), inv = rsqrt(var + eps),
// then the per-channel fold scale = gamma * inv, shift = beta - mean * scale
// and y = x * scale + shift, optionally y * sigmoid(y), rounded to bf16 once.
//
// What bounds it on this card: memory. The least it can move is x read once
// and y written once, 4 bytes an element (5.2 MB each way at (2, 320, 64^2):
// 3.1 us at 3.35 TB/s), against about 10 operations an element.
//
// What the design does:
// - In NCHW a (batch, group) is one contiguous run of n = (C / groups) * H * W
//   values. Each (batch, group) gets a thread-block cluster of S blocks
//   (S <= 8, portable), chosen so that B * groups * S blocks fill the SMs
//   about four times over; block `rank` owns the rank-th share of the run.
// - One read: a block loads its share once with 16-byte loads into shared
//   memory, summing S and SQ in fp32 on the way (shuffles, then the warps'
//   sums in order), and publishes its partial pair. After a cluster barrier
//   every block reads all S partials through distributed shared memory in
//   rank order, so every block holds bitwise the same mean and inv, with no
//   atomics, and a call repeats bitwise. Then it folds gamma and beta per
//   channel, normalises from shared memory, applies the SiLU and writes y
//   with 16-byte stores.
// - Large groups: a share of more than kResidentElems elements (more than 8
//   blocks' 32 KB, a group of more than 131,072 elements) is not kept; that
//   route reads its share a second time (from L2) to normalise it.
// - Ragged cases: the run of a group, and so a share, need not start on a
//   16-byte boundary (n % 8 != 0, or x not 16-byte aligned): the elements
//   before the first boundary and after the last whole 16 bytes go one at a
//   time. If x and y differ in their alignment mod 16 bytes, every element
//   goes one at a time.
#include <algorithm>

#include "sm90_common.cuh"

namespace leco {
namespace gn {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
// The largest share a block keeps in shared memory (32 KB); a group of more
// than kMaxCluster * kResidentElems = 131,072 elements re-reads its shares.
constexpr long long kResidentElems = 16384;
// gamma and beta of up to this many channels of a block's share are read
// into shared memory with the share (every SD shape: H * W >= 64); past it,
// from device memory when they are needed
constexpr int kTableChannels = 512;

struct Share {
  const bf16* x;  // the share's first element in x, and in y
  bf16* y;
  int count;   // elements
  int head;    // elements before the first 16-byte boundary (all of them if !vec)
  int nvec;    // whole 16-byte vectors after the head
  int shift;   // where element 0 goes in shared memory: keeps vectors aligned
};

__device__ __forceinline__ Share share_of(const bf16* x, bf16* y, int lo, int hi, bool vec) {
  Share s;
  s.x = x + lo;
  s.y = y + lo;
  s.count = max(0, hi - lo);
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(s.x) % 16) / 2);
  s.head = vec ? min(s.count, (8 - mis) % 8) : s.count;
  s.nvec = (s.count - s.head) / 8;
  s.shift = vec ? mis : 0;
  return s;
}

__device__ __forceinline__ void add_stats(float v, float& sum, float& sq) {
  sum += v;
  sq += v * v;
}

__device__ __forceinline__ float normalise(float v, float scale, float shift, int silu) {
  float y = v * scale + shift;
  if (silu) y = y / (1.f + expf(-y));
  return y;
}

// grid (B * groups * splits), clusters of `splits` along x; `share`
// elements a block (a multiple of 8); dynamic shared memory: (share + 8)
// bf16 when RESIDENT
template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    group_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ y, int c, int hw,
                      int groups, int n, int share, int splits, float eps, int silu, int vec) {
  using namespace sm90;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][kThreads / 32];
  __shared__ float part[2];
  __shared__ float stats[2];
  __shared__ float table[2][kTableChannels];  // gamma, beta of the share's channels
  unsigned short* kept = reinterpret_cast<unsigned short*>(smem_raw);

  const int rank = blockIdx.x % splits;
  const long long group = blockIdx.x / splits;  // b * groups + g
  const int cg = c / groups;
  const int ch0 = static_cast<int>(group % groups) * cg;  // the group's first channel
  const int lo = rank * share;  // n < 2^31: indices inside a group are ints
  const Share sh = share_of(x + group * n, y + group * n, lo, min(n, lo + share), vec);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(sh.x);
  const int t = threadIdx.x;
  const int first = lo / hw;  // the share's first channel, counted in the group
  const int channels = sh.count > 0 ? min(kTableChannels, (lo + sh.count - 1) / hw - first + 1) : 0;

  // ---- the one read: sums, and the share kept in shared memory
  float sum = 0.f, sq = 0.f;
  auto scalar = [&](int i) {
    const unsigned short bits = xs[i];
    if (RESIDENT) kept[sh.shift + i] = bits;
    add_stats(__bfloat162float(__ushort_as_bfloat16(bits)), sum, sq);
  };
  for (int i = t; i < sh.head; i += kThreads) scalar(i);
  const uint4* xv = reinterpret_cast<const uint4*>(xs + sh.head);
  uint4* kv = reinterpret_cast<uint4*>(kept + sh.shift + sh.head);
  constexpr int kBatch = 4;  // vectors in flight a thread
  for (int j0 = t; j0 < sh.nvec; j0 += kBatch * kThreads) {
    uint4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      v[u] = j < sh.nvec ? xv[j] : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads;
      if (j >= sh.nvec) break;
      if (RESIDENT) kv[j] = v[u];
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&v[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        add_stats(f.x, sum, sq);
        add_stats(f.y, sum, sq);
      }
    }
  }
  for (int i = sh.head + 8 * sh.nvec + t; i < sh.count; i += kThreads) scalar(i);
  for (int i = t; i < channels; i += kThreads) {
    table[0][i] = gamma[ch0 + first + i];
    table[1][i] = beta[ch0 + first + i];
  }

  // ---- the block's partial pair, then the group's statistics
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  if (t % 32 == 0) {
    red[0][t / 32] = sum;
    red[1][t / 32] = sq;
  }
  __syncthreads();
  if (t == 0) {
    float ps = 0.f, pq = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ps += red[0][w];
      pq += red[1][w];
    }
    part[0] = ps;
    part[1] = pq;
  }
  cluster_arrive();  // release: the partials are written
  cluster_wait();
  if (t < 32) {
    // lane r reads rank r's pair (one round trip for all), then every lane
    // adds them in rank order: the same bits in every block
    float ps = 0.f, pq = 0.f;
    if (t < splits) {
      ps = ld_cluster_f32(map_rank(smem_addr(&part[0]), t));
      pq = ld_cluster_f32(map_rank(smem_addr(&part[1]), t));
    }
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < splits; ++r) {
      ts += __shfl_sync(0xffffffffu, ps, r);
      tq += __shfl_sync(0xffffffffu, pq, r);
    }
    if (t == 0) {
      const float mean = ts / static_cast<float>(n);
      const float var = tq / static_cast<float>(n) - mean * mean;
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
  }
  __syncthreads();
  cluster_arrive();  // this block is done reading the others' partials
  const float mean = stats[0];
  const float inv = stats[1];

  // ---- normalise: element i of the share is element lo + i of the group
  auto fold = [&](int e, float& scale, float& shift) {
    const int ch = e / hw - first;  // in the table
    const float g = ch < kTableChannels ? table[0][ch] : gamma[ch0 + first + ch];
    const float b = ch < kTableChannels ? table[1][ch] : beta[ch0 + first + ch];
    scale = g * inv;
    shift = b - mean * scale;
  };
  auto load = [&](int i) -> unsigned short { return RESIDENT ? kept[sh.shift + i] : xs[i]; };
  unsigned short* ys = reinterpret_cast<unsigned short*>(sh.y);
  auto scalar_out = [&](int i) {
    float scale, shift;
    fold(lo + i, scale, shift);
    const float v = __bfloat162float(__ushort_as_bfloat16(load(i)));
    ys[i] = __bfloat16_as_ushort(__float2bfloat16(normalise(v, scale, shift, silu)));
  };
  for (int i = t; i < sh.head; i += kThreads) scalar_out(i);
  uint4* yv = reinterpret_cast<uint4*>(ys + sh.head);
  for (int j = t; j < sh.nvec; j += kThreads) {
    const uint4 in = RESIDENT ? kv[j] : xv[j];
    const int e0 = lo + sh.head + 8 * j;  // the vector's first element in the group
    float scale, shift;
    fold(e0, scale, shift);
    int next = (e0 / hw + 1) * hw;  // where the next channel starts
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&in);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      float r[2] = {f.x, f.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (e0 + 2 * e + h == next) {  // a channel boundary inside the vector
          fold(next, scale, shift);
          next += hw;
        }
        r[h] = normalise(r[h], scale, shift, silu);
      }
      o[e] = pack_bf16(r[0], r[1]);
    }
    yv[j] = make_uint4(o[0], o[1], o[2], o[3]);
  }
  for (int i = sh.head + 8 * sh.nvec + t; i < sh.count; i += kThreads) scalar_out(i);
  cluster_wait();  // no block leaves while another may still read its partials
}

template <bool RESIDENT>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, long long bg,
                   int c, int hw, int groups, int n, int share, int splits, float eps, int silu,
                   int vec, cudaStream_t stream) {
  auto kernel = group_norm_kernel<RESIDENT>;
  // at most 32,784 bytes: under the 48 KB a launch may take without opting in
  const size_t smem = RESIDENT ? static_cast<size_t>(share + 8) * 2 : 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(bg * splits));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), c, hw, groups, n, share, splits,
      eps, silu, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gn
}  // namespace leco

extern "C" int leco_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                               int batch, int c, int hw, int groups, float eps, int silu,
                               void* stream) {
  using namespace leco::gn;
  if (batch <= 0 || c <= 0 || hw <= 0 || groups <= 0 || c % groups != 0)
    return cudaErrorInvalidValue;
  const long long bg = static_cast<long long>(batch) * groups;
  const long long n = static_cast<long long>(c / groups) * hw;
  if (n > 0x7fffffffLL - 8) return cudaErrorInvalidValue;
  // about four blocks an SM, but no block under 1024 elements; a group too
  // large to keep at that split takes the largest cluster
  long long splits = (4LL * leco::sm90::sm_count() + bg - 1) / bg;
  splits = std::max(1LL, std::min({splits, static_cast<long long>(kMaxCluster), (n + 1023) / 1024}));
  auto share_of = [&](long long s) { return ((n + s - 1) / s + 7) / 8 * 8; };
  if (share_of(splits) > kResidentElems) splits = kMaxCluster;
  const long long share = share_of(splits);
  const bool resident = share <= kResidentElems;
  if (bg * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sp = static_cast<int>(splits);
  return resident ? launch<true>(x, gamma, beta, y, bg, c, hw, groups, static_cast<int>(n),
                                 static_cast<int>(share), sp, eps, silu, vec, s)
                  : launch<false>(x, gamma, beta, y, bg, c, hw, groups, static_cast<int>(n),
                                  static_cast<int>(share), sp, eps, silu, vec, s);
}
