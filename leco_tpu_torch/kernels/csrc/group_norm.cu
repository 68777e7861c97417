// GroupNorm (+ optional SiLU) for Hopper (sm_90a), bf16 in and out, fp32
// statistics.
//
// Replaces: leco_tpu/ops/group_norm.py, `_gn_kernel` (reached through
// `group_norm_silu` and the `fused_group_norm` custom VJP).
//
// Entry points: leco_group_norm, the whole GroupNorm in one launch; and the
// same split in two for a caller that reduces the statistics in between
// (spatial parallelism: each rank holds some rows of every group):
// leco_group_norm_stats writes each (batch, group)'s fp32 S and SQ, summed
// as the one-launch kernel sums them, and leco_group_norm_apply normalises
// with S and SQ as given, over a count `total` given with them.
//
// Layout contract (checked by the Python wrapper): x and y (B, C, H, W)
// contiguous bf16 (the port's NCHW); gamma, beta fp32 (C); C % groups == 0;
// any H * W and any 2-byte-aligned x.
//
// Numerics kept from the TPU kernel (every entry): sums of x and x*x in fp32 over the
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
// - The split: the statistics launch is the one-launch kernel's first half
//   (its share read once, the cluster's partials added in rank order) and
//   writes S and SQ from the cluster's first block; the apply launch reads
//   them and its share once, with no cluster.
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

// what a launch does: the whole GroupNorm, its statistics, or the normalisation
enum Mode { kFull, kStats, kApply };

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

// grid (B * groups * splits), clusters of `splits` along x (no cluster for
// kApply); `share` elements a block (a multiple of 8); dynamic shared
// memory: (share + 8) bf16 when RESIDENT. `sums` (B * groups, 2) fp32: S
// and SQ, written by kStats, read by kApply with the count `total`
template <int MODE, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    group_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, bf16* __restrict__ y, int c, int hw,
                      int groups, int n, int share, int splits, float eps, int silu, int vec,
                      float* __restrict__ sums, float total) {
  static_assert(MODE == kFull || !RESIDENT, "only the one-launch kernel keeps its share");
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
  const Share sh = share_of(x + group * n, MODE == kStats ? y : y + group * n, lo,
                            min(n, lo + share), vec);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(sh.x);
  const int t = threadIdx.x;
  const int first = lo / hw;  // the share's first channel, counted in the group
  const int channels = sh.count > 0 ? min(kTableChannels, (lo + sh.count - 1) / hw - first + 1) : 0;
  const uint4* xv = reinterpret_cast<const uint4*>(xs + sh.head);
  uint4* kv = reinterpret_cast<uint4*>(kept + sh.shift + sh.head);
  if constexpr (MODE != kStats) {
    for (int i = t; i < channels; i += kThreads) {
      table[0][i] = gamma[ch0 + first + i];
      table[1][i] = beta[ch0 + first + i];
    }
  }

  if constexpr (MODE == kApply) {
    if (t == 0) {
      const float mean = sums[2 * group] / total;
      const float var = sums[2 * group + 1] / total - mean * mean;
      stats[0] = mean;
      stats[1] = rsqrtf(var + eps);
    }
    __syncthreads();
  } else {
    // ---- the one read: sums, and the share kept in shared memory
    float sum = 0.f, sq = 0.f;
    auto scalar = [&](int i) {
      const unsigned short bits = xs[i];
      if (RESIDENT) kept[sh.shift + i] = bits;
      add_stats(__bfloat162float(__ushort_as_bfloat16(bits)), sum, sq);
    };
    for (int i = t; i < sh.head; i += kThreads) scalar(i);
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
        if (MODE == kStats && rank == 0) {
          sums[2 * group] = ts;
          sums[2 * group + 1] = tq;
        }
        const float mean = ts / static_cast<float>(n);
        const float var = tq / static_cast<float>(n) - mean * mean;
        stats[0] = mean;
        stats[1] = rsqrtf(var + eps);
      }
    }
    __syncthreads();
    cluster_arrive();  // this block is done reading the others' partials
    if constexpr (MODE == kStats) {
      cluster_wait();  // no block leaves while another may still read its partials
      return;
    }
  }
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
  if constexpr (MODE == kFull) cluster_wait();  // no block leaves while another may still read its partials
}

template <int MODE, bool RESIDENT>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y, long long bg,
                   int c, int hw, int groups, int n, int share, int splits, float eps, int silu,
                   int vec, float* sums, float total, cudaStream_t stream) {
  auto kernel = group_norm_kernel<MODE, RESIDENT>;
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
  config.numAttrs = MODE == kApply ? 0 : 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), c, hw, groups, n, share, splits,
      eps, silu, vec, sums, total);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How a (batch, group) is split over blocks: about four blocks an SM, but
// no block under 1024 elements; a group too large to keep at that split
// takes the largest cluster. cudaErrorInvalidValue for a shape the kernel
// does not take.
struct Plan {
  long long bg, n, splits, share;
  bool resident;
};

inline cudaError_t plan(int batch, int c, int hw, int groups, Plan* p) {
  if (batch <= 0 || c <= 0 || hw <= 0 || groups <= 0 || c % groups != 0)
    return cudaErrorInvalidValue;
  p->bg = static_cast<long long>(batch) * groups;
  p->n = static_cast<long long>(c / groups) * hw;
  if (p->n > 0x7fffffffLL - 8) return cudaErrorInvalidValue;
  long long splits = (4LL * sm90::sm_count() + p->bg - 1) / p->bg;
  splits = std::max(1LL, std::min({splits, static_cast<long long>(kMaxCluster),
                                   (p->n + 1023) / 1024}));
  auto share_of = [&](long long s) { return ((p->n + s - 1) / s + 7) / 8 * 8; };
  if (share_of(splits) > kResidentElems) splits = kMaxCluster;
  p->splits = splits;
  p->share = share_of(splits);
  p->resident = p->share <= kResidentElems;
  if (p->bg * splits > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace gn
}  // namespace leco

extern "C" int leco_group_norm(const void* x, const void* gamma, const void* beta, void* y,
                               int batch, int c, int hw, int groups, float eps, int silu,
                               void* stream) {
  using namespace leco::gn;
  Plan p;
  const cudaError_t err = plan(batch, c, hw, groups, &p);
  if (err != cudaSuccess) return err;
  const int vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(p.n), share = static_cast<int>(p.share);
  const int sp = static_cast<int>(p.splits);
  return p.resident ? launch<kFull, true>(x, gamma, beta, y, p.bg, c, hw, groups, n, share, sp,
                                          eps, silu, vec, nullptr, 0.f, s)
                    : launch<kFull, false>(x, gamma, beta, y, p.bg, c, hw, groups, n, share, sp,
                                           eps, silu, vec, nullptr, 0.f, s);
}

// sums (B * groups, 2) fp32: each group's S and SQ over x
extern "C" int leco_group_norm_stats(const void* x, void* sums, int batch, int c, int hw,
                                     int groups, void* stream) {
  using namespace leco::gn;
  Plan p;
  const cudaError_t err = plan(batch, c, hw, groups, &p);
  if (err != cudaSuccess) return err;
  return launch<kStats, false>(x, nullptr, nullptr, nullptr, p.bg, c, hw, groups,
                               static_cast<int>(p.n), static_cast<int>(p.share),
                               static_cast<int>(p.splits), 0.f, 0, 1, static_cast<float*>(sums),
                               0.f, static_cast<cudaStream_t>(stream));
}

// y from x with each group's mean S / total and variance SQ / total - mean^2
extern "C" int leco_group_norm_apply(const void* x, const void* gamma, const void* beta,
                                     const void* sums, void* y, int batch, int c, int hw,
                                     int groups, float total, float eps, int silu,
                                     void* stream) {
  using namespace leco::gn;
  Plan p;
  const cudaError_t err = plan(batch, c, hw, groups, &p);
  if (err != cudaSuccess) return err;
  if (!(total > 0.f)) return cudaErrorInvalidValue;
  const int vec = ((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  return launch<kApply, false>(x, gamma, beta, y, p.bg, c, hw, groups, static_cast<int>(p.n),
                               static_cast<int>(p.share), static_cast<int>(p.splits), eps, silu,
                               vec, const_cast<float*>(static_cast<const float*>(sums)), total,
                               static_cast<cudaStream_t>(stream));
}
