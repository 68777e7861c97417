// GroupNorm (+ optional SiLU) for Hopper (sm_90a), bf16 in and out, fp32
// statistics.
//
// Replaces: leco_tpu/ops/group_norm.py, `_gn_kernel` (reached through
// `group_norm_silu` and the `fused_group_norm` custom VJP).
//
// Layout contract (checked by the Python wrapper): x and y (B, C, H, W)
// contiguous bf16 (the port's NCHW); gamma, beta fp32 (C); C % groups == 0.
//
// Numerics kept from the TPU kernel: sums of x and x*x in fp32 over the
// group, mean = S/n, var = SQ/n - mean^2 (no clamp), inv = rsqrt(var + eps),
// then the per-channel fold scale = gamma * inv, shift = beta - mean * scale
// and y = x * scale + shift, optionally y * sigmoid(y), rounded to bf16 once.
//
// What bounds it on this card: memory. It reads x twice and writes y once
// (6 bytes per element) and does about 10 operations per element.
//
// What the design does: in NCHW a (batch, group) is one contiguous run of
// (C / groups) * H * W values, so a block owns one (batch, group): a strided
// pass accumulates the two sums, a block reduction turns them into the
// statistics, and a second pass (which finds x in L2: a group is at most a
// few hundred KB at the SD shapes) writes the normalised output channel by
// channel. The TPU kernel's (C, G) membership matmul, which works around
// Mosaic's unsplittable lane dimension, has no counterpart here. A simple
// first kernel: B * groups blocks (32 to 96 at SD batch sizes) do not fill
// the card's 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace leco {
namespace gn {

constexpr int kGnThreads = 512;

__global__ void __launch_bounds__(kGnThreads)
    group_norm_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      __nv_bfloat16* __restrict__ y, int c, int hw, int groups,
                      float eps, int silu) {
  __shared__ float red_s[kGnThreads / 32];
  __shared__ float red_q[kGnThreads / 32];
  __shared__ float stats[2];

  const int g = blockIdx.x % groups;
  const int cg = c / groups;
  const size_t n = static_cast<size_t>(cg) * hw;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;  // (b * groups + g) * n
  const __nv_bfloat16* xs = x + base;

  float s = 0.f, q = 0.f;
  for (size_t i = threadIdx.x; i < n; i += kGnThreads) {
    const float v = __bfloat162float(xs[i]);
    s += v;
    q += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red_s[warp] = s;
    red_q[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int i = 0; i < kGnThreads / 32; ++i) {
      ts += red_s[i];
      tq += red_q[i];
    }
    const float mean = ts / static_cast<float>(n);
    const float var = tq / static_cast<float>(n) - mean * mean;
    stats[0] = mean;
    stats[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stats[0];
  const float inv = stats[1];

  __nv_bfloat16* ys = y + base;
  for (int cl = 0; cl < cg; ++cl) {
    const int ch = g * cg + cl;
    const float scale = gamma[ch] * inv;
    const float shift = beta[ch] - mean * scale;
    const size_t off = static_cast<size_t>(cl) * hw;
    for (int p = threadIdx.x; p < hw; p += kGnThreads) {
      float v = __bfloat162float(xs[off + p]) * scale + shift;
      if (silu) v = v / (1.f + expf(-v));
      ys[off + p] = __float2bfloat16(v);
    }
  }
}

}  // namespace gn
}  // namespace leco

extern "C" int leco_group_norm(const void* x, const void* gamma, const void* beta,
                               void* y, int batch, int c, int hw, int groups,
                               float eps, int silu, void* stream) {
  if (batch <= 0 || c <= 0 || hw <= 0 || groups <= 0 || c % groups != 0)
    return cudaErrorInvalidValue;
  leco::gn::group_norm_kernel<<<batch * groups, leco::gn::kGnThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), c, hw, groups,
      eps, silu);
  return cudaGetLastError();
}
