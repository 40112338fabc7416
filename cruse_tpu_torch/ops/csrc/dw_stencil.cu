// (3, 3) time-dilated causal depthwise stencil of MTFAA's TFCM block, forward
// and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cruse_tpu/ops/dw_kernel.py::dw_causal_tm
// (_stencil_kernel forward, _bwd_kernel backward). T-minor, per channel c:
//
//   y[b, k, c, t] = sum_{it, jf} wd[it, jf, c] * x[b, k + jf - 1, c, t + it * d]
//
// x is the input already extended by 2d frames before t = 0 (T + 2d frames),
// bands outside [0, K) read as zero. The backward gives
//
//   dx[b, k, c, u]  = sum_{it, jf} wd[it, jf, c] * g[b, k + 1 - jf, c, u - it * d]
//   dwd[it, jf, c]  = sum_{b, k, t} x[b, k + jf - 1, c, t + it * d] * g[b, k, c, t]
//
// with g read as zero outside [0, K) x [0, T).
//
// What bounds it: bytes. Nine multiply-adds a point (27 with the backward's
// tap sums) against 8 to 12 bytes a point of least traffic; the 9 reads of a
// point's neighbours come from L1/L2, since neighbouring rows are neighbouring
// blocks.
//
// What the design does about it: the TPU wrapper materialises a band-padded
// copy of x and a band- and time-padded copy of g before each launch; here the
// indices are bounded in the kernel and nothing is padded. A block owns one
// row (b, k, c) and walks its frames, lanes along T (coalesced), with the
// channel's nine weights in registers. The backward writes dx and, in the same
// pass, the block's nine tap sums (f32: per-thread sums, a shuffle tree, one
// sum over the warps) into part[row, 9]; the caller adds the rows of a channel,
// so the result does not depend on the order in which blocks run.
//
// Layouts: x f32 [B, K, C, T + 2d], wd f32 [3, 3, C], y and g f32
// [B, K, C, T], dx f32 [B, K, C, T + 2d], part f32 [B * K * C, 9], all
// contiguous. Plain C interface (bound with ctypes): pointers and the stream
// are void*, the launch is on the caller's stream, nothing is allocated here,
// and each entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wd, float* __restrict__ y,
              int K, int C, int T, int d) {
  const long long row = blockIdx.x;  // (b * K + k) * C + c
  const int c = static_cast<int>(row % C);
  const int k = static_cast<int>((row / C) % K);
  const int Te = T + 2 * d;
  const long long band = static_cast<long long>(C) * Te;
  float w[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i / 3][i % 3] = wd[i * C + c];
  const bool lo = k > 0, hi = k < K - 1;
  const float* xr = x + row * Te;
  float* yr = y + row * T;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const float* p = xr + t + it * d;
      if (lo) acc = fmaf(w[it][0], p[-band], acc);
      acc = fmaf(w[it][1], p[0], acc);
      if (hi) acc = fmaf(w[it][2], p[band], acc);
    }
    yr[t] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ wd, float* __restrict__ dx, float* __restrict__ part,
              int K, int C, int T, int d) {
  const long long row = blockIdx.x;
  const int c = static_cast<int>(row % C);
  const int k = static_cast<int>((row / C) % K);
  const int Te = T + 2 * d;
  const long long xband = static_cast<long long>(C) * Te;
  const long long gband = static_cast<long long>(C) * T;
  float w[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i / 3][i % 3] = wd[i * C + c];
  const bool lo = k > 0, hi = k < K - 1;
  const float* gr = g + row * T;
  const float* xr = x + row * Te;
  float* dxr = dx + row * Te;

  // dx: the stencil with both axes flipped, on g bounded to [0, K) x [0, T)
  for (int u = threadIdx.x; u < Te; u += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int t = u - it * d;
      if (t < 0 || t >= T) continue;
      if (hi) acc = fmaf(w[it][0], gr[t + gband], acc);  // jf = 0: y's band k + 1 read x's band k
      acc = fmaf(w[it][1], gr[t], acc);
      if (lo) acc = fmaf(w[it][2], gr[t - gband], acc);
    }
    dxr[u] = acc;
  }

  // the nine tap sums of this row
  float s[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) s[i] = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float gv = gr[t];
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const float* p = xr + t + it * d;
      if (lo) s[it * 3 + 0] = fmaf(p[-xband], gv, s[it * 3 + 0]);
      s[it * 3 + 1] = fmaf(p[0], gv, s[it * 3 + 1]);
      if (hi) s[it * 3 + 2] = fmaf(p[xband], gv, s[it * 3 + 2]);
    }
  }
  block_sum<kWarps>(s, part + row * 9);
}

bool bad_shape(long long B, int K, int C, int T, int d) {
  return B < 1 || K < 1 || C < 1 || T < 1 || d < 1 || B * K * C > 2147483647LL;
}

}  // namespace

extern "C" {

// x: f32 [B, K, C, T + 2d]; wd: f32 [3, 3, C]; y: f32 [B, K, C, T].
int dw_stencil_fwd_f32(const void* x, const void* wd, void* y, int B, int K, int C, int T, int d,
                       void* stream) {
  if (bad_shape(B, K, C, T, d)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(static_cast<long long>(B) * K * C);
  dw_fwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wd), static_cast<float*>(y), K, C, T, d);
  return static_cast<int>(cudaGetLastError());
}

// g: f32 [B, K, C, T]; x: f32 [B, K, C, T + 2d]; wd: f32 [3, 3, C];
// dx: f32 [B, K, C, T + 2d]; part: f32 [B * K * C, 9] (tap sums per row).
int dw_stencil_bwd_f32(const void* g, const void* x, const void* wd, void* dx, void* part, int B,
                       int K, int C, int T, int d, void* stream) {
  if (bad_shape(B, K, C, T, d)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(static_cast<long long>(B) * K * C);
  dw_bwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(x), static_cast<const float*>(wd),
      static_cast<float*>(dx), static_cast<float*>(part), K, C, T, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
