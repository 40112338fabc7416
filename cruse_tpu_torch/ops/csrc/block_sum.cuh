// Block-wide sums of per-thread partials, shared by the training kernels
// (dw_stencil.cu, tfcm_bwd.cu). f32 throughout: a shuffle tree within each
// warp, then one sum over the warps in a fixed order, so the result does not
// depend on how the warps were scheduled.
#pragma once

#include <cuda_runtime.h>

// Sum v[i] over the block's WARPS * 32 threads into out[i * stride]; every
// thread of the block must call it.
template <int WARPS, int N>
__device__ void block_sum(float (&v)[N], float* out, int stride = 1) {
  __shared__ float warp_sums[WARPS][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w][threadIdx.x];
    out[threadIdx.x * stride] = s;
  }
}
