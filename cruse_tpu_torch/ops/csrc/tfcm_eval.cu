// Eval-mode TFCM stack (the whole dilation ladder in one launch), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels cruse_tpu/ops/tfcm_kernel.py::
// fused_tfcm_stack_eval (body _stack_kernel) and fused_tfcm_block_eval (body
// _block_kernel, the one-layer case of this kernel). Per layer l, with the
// BatchNorms folded into the convs on the host:
//
//   p1[k, o, t] = prelu(b1[o] + sum_c w1[c, o] * x[k, c, t], a1)
//   z[k, o, t]  = bd[o] + sum_{it, jf} wd[it, jf, o] * p1[k + jf - 1, o, t - (2 - it) * d]
//   x[k, o, t] += b2[o] + sum_c w2[c, o] * prelu(z[k, c, t], a2)
//
// where p1 is ZERO before t = 0 and outside the bands [0, K), as the
// reference zero-pads p1 (not x).
//
// What bounds it: FMAs. A layer costs 2C^2 + 9C multiply-adds a point
// (1,368 at C = 24, 5,040 at C = 48) on 8 bytes a point of device memory for
// the whole stack (x read once, y written once), far above the card's f32
// balance of ~20 FLOP/byte. So the stack stays on chip between layers.
//
// What the design does about it: a block owns a tile of kt bands x tt frames
// of one batch row and holds it, extended by the halo the ladder needs
// (L bands at each side, 2 * sum(d) frames before), in shared memory: x_s, the
// running activations, and p_s, the current layer's p1. Each layer computes
// p1 (phase 1) and then z, p2 and the residual update of x_s (phase 2) only
// where a later layer still reads it, so the region shrinks layer by layer
// (its cone); positions outside the sequence read as zero p1. One thread
// owns one (band, frame) position at a time, with its channel column in
// registers, so the C x C contractions read shared memory once per column
// and the weights as warp-wide broadcasts; neighbouring threads own
// neighbouring frames, so the T-minor loads and stores are coalesced and the
// stencil's time shifts are plain address offsets. The halo is recomputed by
// neighbouring tiles: that waste, not the bytes, is what a faster version
// would remove. The channel count is a template parameter (the register
// columns need it at compile time).
//
// Layouts: x, y float32 [B, K, C, T] contiguous; params float32 [L, P] with
// P = 2C^2 + 12C + 2: w1 [C][C] (in, out), b1 [C], wd [3][3][C], bd [C],
// w2 [C][C] (in, out), b2 [C], a1, a2. Plain C interface (bound with
// ctypes): pointers and the stream are void*, the launch is on the caller's
// stream, nothing is allocated here, and the entry returns
// cudaGetLastError() of its launch (or the error of its attribute call).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLayers = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Dilations {
  int n;
  int d[kMaxLayers];
};

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

template <int C>
__global__ void __launch_bounds__(kThreads)
tfcm_eval_kernel(const float* __restrict__ x, const float* __restrict__ params,
                 float* __restrict__ y, int K, int T, int kt, int tt, Dilations dil) {
  extern __shared__ float smem[];
  constexpr int P = 2 * C * C + 12 * C + 2;
  const int L = dil.n;
  int H = 0;
  for (int l = 0; l < L; ++l) H += 2 * dil.d[l];
  const int KE = kt + 2 * L;  // tile bands, with the halo
  const int TE = tt + H;      // tile frames, with the halo
  const int row = C * TE;     // one band of a tile buffer

  float* w_s = smem;                // [P]: this layer's parameters
  float* x_s = w_s + P;             // [KE][C][TE]: the running activations
  float* p_s = x_s + KE * row;      // [KE][C][TE]: this layer's p1

  const int b = blockIdx.z;
  const int k0 = blockIdx.y * kt - L;  // global band of tile band 0
  const int t0 = blockIdx.x * tt - H;  // global frame of tile frame 0
  const float* xb = x + static_cast<long long>(b) * K * C * T;

  for (int i = threadIdx.x; i < KE * row; i += blockDim.x) {
    const int kk = i / row, c = (i / TE) % C, ti = i % TE;
    const int k = k0 + kk, t = t0 + ti;
    x_s[i] = (k >= 0 && k < K && t >= 0 && t < T)
                 ? xb[(static_cast<long long>(k) * C + c) * T + t] : 0.f;
  }

  int h_in = 0;  // first tile frame where this layer's input is exact
  for (int l = 0; l < L; ++l) {
    const int d = dil.d[l];
    const int h_out = h_in + 2 * d;  // ... and its output
    __syncthreads();  // the previous layer is done with w_s
    for (int i = threadIdx.x; i < P; i += blockDim.x) w_s[i] = params[static_cast<long long>(l) * P + i];
    __syncthreads();
    const float* w1 = w_s;
    const float* b1 = w1 + C * C;
    const float* wd = b1 + C;
    const float* bd = wd + 9 * C;
    const float* w2 = bd + C;
    const float* b2 = w2 + C * C;
    const float a1 = b2[C], a2 = b2[C + 1];

    // phase 1: p1 over tile bands [l, KE - l) and frames [h_in, TE)
    {
      const int nb = KE - 2 * l, nt = TE - h_in;
      for (int i = threadIdx.x; i < nb * nt; i += blockDim.x) {
        const int kk = l + i / nt, ti = h_in + i % nt;
        const int k = k0 + kk, t = t0 + ti;
        float* p_col = p_s + kk * row + ti;
        if (k < 0 || k >= K || t < 0) {
#pragma unroll
          for (int o = 0; o < C; ++o) p_col[o * TE] = 0.f;
          continue;
        }
        const float* x_col = x_s + kk * row + ti;
        float xc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) xc[c] = x_col[c * TE];
        for (int o = 0; o < C; ++o) {
          float acc = b1[o];
#pragma unroll
          for (int c = 0; c < C; ++c) acc = fmaf(w1[c * C + o], xc[c], acc);
          p_col[o * TE] = prelu(acc, a1);
        }
      }
    }
    __syncthreads();

    // phase 2: depthwise, PReLU, 1x1 conv and residual over tile bands
    // [l + 1, KE - l - 1) and frames [h_out, TE); each thread touches only its
    // own x_s column, and p_s is read-only here
    {
      const int nb = KE - 2 * l - 2, nt = TE - h_out;
      for (int i = threadIdx.x; i < nb * nt; i += blockDim.x) {
        const int kk = l + 1 + i / nt, ti = h_out + i % nt;
        float p2[C];
#pragma unroll
        for (int o = 0; o < C; ++o) {
          float z = bd[o];
#pragma unroll
          for (int it = 0; it < 3; ++it) {
            const float* p_row = p_s + o * TE + ti - (2 - it) * d;
#pragma unroll
            for (int jf = 0; jf < 3; ++jf) z = fmaf(wd[(it * 3 + jf) * C + o], p_row[(kk + jf - 1) * row], z);
          }
          p2[o] = prelu(z, a2);
        }
        float* x_col = x_s + kk * row + ti;
        for (int o = 0; o < C; ++o) {
          float acc = b2[o];
#pragma unroll
          for (int c = 0; c < C; ++c) acc = fmaf(w2[c * C + o], p2[c], acc);
          x_col[o * TE] += acc;
        }
      }
    }
    h_in = h_out;
  }
  __syncthreads();

  // the tile's own bands [L, L + kt) and frames [H, TE)
  float* yb = y + static_cast<long long>(b) * K * C * T;
  for (int i = threadIdx.x; i < kt * C * tt; i += blockDim.x) {
    const int kk = i / (C * tt), c = (i / tt) % C, ti = i % tt;
    const int k = k0 + L + kk, t = t0 + H + ti;
    if (k < K && t < T) yb[(static_cast<long long>(k) * C + c) * T + t] = x_s[(L + kk) * row + c * TE + H + ti];
  }
}

template <int C>
int launch(const float* x, const float* params, float* y, int B, int K, int T,
           const Dilations& dil, int kt, int tt, cudaStream_t stream) {
  int H = 0;
  for (int l = 0; l < dil.n; ++l) H += 2 * dil.d[l];
  const size_t bytes =
      (static_cast<size_t>(2 * C * C + 12 * C + 2) +
       2 * static_cast<size_t>(kt + 2 * dil.n) * C * (tt + H)) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tfcm_eval_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + tt - 1) / tt, (K + kt - 1) / kt, B);
  tfcm_eval_kernel<C><<<grid, kThreads, bytes, stream>>>(x, params, y, K, T, kt, tt, dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: f32 [B, K, C, T] contiguous; params: f32 [L, 2C^2 + 12C + 2]
// contiguous (folded on the host); dilations: L host ints; kt, tt: the band
// and time tile of one block (chosen by the caller to fit shared memory).
int tfcm_eval_f32(const void* x, const void* params, void* y, int B, int K, int C, int T,
                  int L, const int* dilations, int kt, int tt, void* stream) {
  if (L < 1 || L > kMaxLayers || kt < 1 || tt < 1) return static_cast<int>(cudaErrorInvalidValue);
  Dilations dil;
  dil.n = L;
  for (int l = 0; l < kMaxLayers; ++l) dil.d[l] = l < L ? dilations[l] : 0;
  const float* xf = static_cast<const float*>(x);
  const float* pf = static_cast<const float*>(params);
  float* yf = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 4: return launch<4>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 8: return launch<8>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 12: return launch<12>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 16: return launch<16>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 24: return launch<24>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 32: return launch<32>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    case 48: return launch<48>(xf, pf, yf, B, K, T, dil, kt, tt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
