// What the WMMA kernel (geglu.cu) takes from CUDA: the bf16 type and the
// warp-level tensor-core API. The flash-attention kernels and the conv core
// use the Hopper helpers of sm90_common.cuh instead.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace leco {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

}  // namespace leco
