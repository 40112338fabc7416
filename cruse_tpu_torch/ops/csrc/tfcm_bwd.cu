// Backward of one train-mode TFCM block of MTFAA, phases A and B, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels cruse_tpu/ops/tfcm_bwd_kernels.py::tail_bwd
// (_tail_kernel) and mid_bwd (_mid_kernel). The block is
//   h1 = x @ w1 + b1;  h1a = prelu(bn1(h1), a1)
//   h2 = dw(h1a) + bd; h2a = prelu(bn2(h2), a2);  y = h2a @ w2 + b2 + x
// with batch statistics (m, v) over B, K, T, dw the (3, 3) depthwise stencil,
// causal and dilated by d in time, one band each side in frequency. Both BNs'
// global means cut the backward into phases; each phase is one pass here:
//
// tail (phase A), from dh2a = g @ w2^T and h2:
//   xh = (h2 - m2) * iv2;  hn = xh * g2 + be2;  neg = hn < 0
//   dh2n = neg ? a2 * dh2a : dh2a
//   dgamma2[c] = sum dh2n * xh;  dbeta2[c] = sum dh2n;  da2 = sum neg ? dh2a * hn : 0
//
// mid (phase B), from dh2 (the BN2-applied gradient) and h1:
//   dh1a[k, t] = sum_{it, jf} wd[it, jf] * dh2[k + 1 - jf, t + (2 - it) d]
//   (BN1 / PReLU1 recomputed from h1)  dh1n = neg ? a1 * dh1a : dh1a
//   dgamma1, dbeta1, da1 as above;  dbd[c] = sum dh2
//   dwd[it, jf, c] = sum_{b, k, t} xe[k + jf - 1, t + it d] * dh2[k, t]
// where xe is h1a extended by 2d TRUE ZEROS before t = 0 and by a zero band
// at each edge (not prelu(bn1(0))), and dh2 is zero outside [0, K) x [0, T).
//
// What bounds them: bytes (two reads and one write of [B, K, C, T] each;
// about 10 and 60 operations a point).
//
// What the design does about it: the TPU kernels take one batch item a grid
// step and carry their sums from step to step; here a block owns one row
// (b, k, c) and walks its frames with lanes along T, so the channel's
// statistics and weights are registers, the reads are coalesced, the 9
// neighbours of a point come from L1/L2 (the neighbouring rows are
// neighbouring blocks), and nothing is padded: the indices are bounded here,
// so there is no dilation limit and T need not fill a tile. Every sum is
// taken in f32 per thread, then over the block (shuffle tree, one sum over
// the warps), and written to part[row, :]; the caller adds the rows of a
// channel, so the sums do not depend on the order in which blocks run.
//
// The values that decide a PReLU's side are computed without fused
// multiply-adds, in the plain version's order, so the kernel takes the same
// side of every point as the plain version does.
//
// Layouts: dh2a, h2, dh2n, dh2, h1, dh1n f32 [B, K, C, T]; stats f32 [4, C]
// (mean, rsqrt(var + eps), scale, bias); slope f32 [1] on the device; wd f32
// [3, 3, C]; tail part f32 [B * K * C, 4] (dgamma, dbeta, da, unused); mid
// part f32 [B * K * C, 16] (9 tap sums as it * 3 + jf, dgamma, dbeta, da, dbd,
// unused). All contiguous. Plain C interface (bound with ctypes): the launch
// is on the caller's stream, nothing is allocated here, and each entry
// returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

struct Bn {
  float m, iv, ga, be, a;
  // (h - m) * iv, then * ga + be, each rounded on its own
  __device__ float xhat(float h) const { return __fmul_rn(__fsub_rn(h, m), iv); }
  __device__ float norm(float xh) const { return __fadd_rn(__fmul_rn(xh, ga), be); }
};

__device__ Bn load_bn(const float* __restrict__ stats, const float* __restrict__ slope, int C,
                      int c) {
  return Bn{stats[c], stats[C + c], stats[2 * C + c], stats[3 * C + c], slope[0]};
}

__global__ void __launch_bounds__(kThreads)
tail_bwd_kernel(const float* __restrict__ dh2a, const float* __restrict__ h2,
                const float* __restrict__ stats, const float* __restrict__ slope,
                float* __restrict__ dh2n, float* __restrict__ part, int C, int T) {
  const long long row = blockIdx.x;  // (b * K + k) * C + c
  const Bn bn = load_bn(stats, slope, C, static_cast<int>(row % C));
  const float* ur = dh2a + row * T;
  const float* hr = h2 + row * T;
  float* outr = dh2n + row * T;
  float s[3] = {0.f, 0.f, 0.f};
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float u = ur[t];
    const float xh = bn.xhat(hr[t]);
    const float hn = bn.norm(xh);
    const bool neg = hn < 0.f;
    const float dn = neg ? bn.a * u : u;
    outr[t] = dn;
    s[0] = fmaf(dn, xh, s[0]);
    s[1] += dn;
    if (neg) s[2] = fmaf(u, hn, s[2]);
  }
  block_sum<kWarps>(s, part + row * 4);
}

__global__ void __launch_bounds__(kThreads)
mid_bwd_kernel(const float* __restrict__ dh2, const float* __restrict__ h1,
               const float* __restrict__ wd, const float* __restrict__ stats,
               const float* __restrict__ slope, float* __restrict__ dh1n,
               float* __restrict__ part, int K, int C, int T, int d) {
  const long long row = blockIdx.x;
  const int c = static_cast<int>(row % C);
  const int k = static_cast<int>((row / C) % K);
  const Bn bn = load_bn(stats, slope, C, c);
  const long long band = static_cast<long long>(C) * T;
  float w[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i / 3][i % 3] = wd[i * C + c];
  const bool lo = k > 0, hi = k < K - 1;
  const float* gr = dh2 + row * T;
  const float* hr = h1 + row * T;
  float* outr = dh1n + row * T;

  float s[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) s[i] = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    // dh1a: the flipped stencil on dh2, zero past the last frame and the edge bands
    float acc = 0.f;
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int tt = t + (2 - it) * d;
      if (tt >= T) continue;
      if (hi) acc = fmaf(w[it][0], gr[tt + band], acc);
      acc = fmaf(w[it][1], gr[tt], acc);
      if (lo) acc = fmaf(w[it][2], gr[tt - band], acc);
    }
    const float xh = bn.xhat(hr[t]);
    const float hn = bn.norm(xh);
    const bool neg = hn < 0.f;
    const float dn = neg ? bn.a * acc : acc;
    outr[t] = dn;
    s[9] = fmaf(dn, xh, s[9]);
    s[10] += dn;
    if (neg) s[11] = fmaf(acc, hn, s[11]);
    const float gv = gr[t];
    s[12] += gv;
    // tap sums: xe[k + jf - 1, t + it d] is h1a[k + jf - 1, t - (2 - it) d], a
    // true zero before t = 0 and beyond the edge bands
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      const int tt = t - (2 - it) * d;
      if (tt < 0) continue;
#pragma unroll
      for (int jf = 0; jf < 3; ++jf) {
        if ((jf == 0 && !lo) || (jf == 2 && !hi)) continue;
        const float v = bn.norm(bn.xhat(hr[tt + (jf - 1) * band]));
        const float ha = v < 0.f ? bn.a * v : v;
        s[it * 3 + jf] = fmaf(ha, gv, s[it * 3 + jf]);
      }
    }
  }
  block_sum<kWarps>(s, part + row * 16);
}

bool bad_shape(long long B, int K, int C, int T) {
  return B < 1 || K < 1 || C < 1 || T < 1 || B * K * C > 2147483647LL;
}

}  // namespace

extern "C" {

int tfcm_tail_bwd_f32(const void* dh2a, const void* h2, const void* stats, const void* slope,
                      void* dh2n, void* part, int B, int K, int C, int T, void* stream) {
  if (bad_shape(B, K, C, T)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(static_cast<long long>(B) * K * C);
  tail_bwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dh2a), static_cast<const float*>(h2),
      static_cast<const float*>(stats), static_cast<const float*>(slope),
      static_cast<float*>(dh2n), static_cast<float*>(part), C, T);
  return static_cast<int>(cudaGetLastError());
}

int tfcm_mid_bwd_f32(const void* dh2, const void* h1, const void* wd, const void* stats,
                     const void* slope, void* dh1n, void* part, int B, int K, int C, int T, int d,
                     void* stream) {
  if (bad_shape(B, K, C, T) || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(static_cast<long long>(B) * K * C);
  mid_bwd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dh2), static_cast<const float*>(h1), static_cast<const float*>(wd),
      static_cast<const float*>(stats), static_cast<const float*>(slope),
      static_cast<float*>(dh1n), static_cast<float*>(part), K, C, T, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
