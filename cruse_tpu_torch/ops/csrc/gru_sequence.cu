// Grouped-GRU recurrence over a whole sequence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cruse_tpu/ops/gru_kernel.py::gru_sequence_pallas
// (body _gru_kernel). Same math, torch gate order (r, z, n), input projection
// already applied by the caller:
//
//   hp = h . w_hh^T + b_hh
//   r  = sigmoid(x_r + hp_r)
//   z  = sigmoid(x_z + hp_z)
//   n  = tanh(x_n + r * hp_n)
//   h' = (1 - z) * n + z * h
//
// What bounds it: per-step latency. Step t + 1 needs all of step t's hidden
// state, so the T steps are strictly sequential, and each step is a small
// [BT, H] x [H, 3H] product per group -- far too little work to fill the card
// or to be bound by its FLOPs or bytes. Run as plain PyTorch, every step costs
// a dozen kernel launches (matmul, bias, splits, gates), and the launch
// overhead is the whole cost.
//
// What the design does about it: ONE launch runs all T steps. Batch rows and
// groups are independent for the whole sequence, so the grid is
// (G, ceil(B / BT)) and each block loops over time on its own BT rows of one
// group; no state crosses blocks and no grid-wide barrier is needed. Thread j
// owns hidden unit j of the block's BT rows: it keeps those BT state values in
// registers and computes the three gate dot products for them. The state is
// shared through a double-buffered [H][BT] tile in shared memory, so a step
// needs one __syncthreads. The group's pre-transposed weight [H, 3H] is read
// each step through the read-only cache; at config-1 shapes one bank's four
// groups (1.5 MB in f32) stay resident in the 50 MB L2. With bf16 weights the
// state is rounded to bf16 before the product (as the TPU kernel does), and
// products and sums stay f32. Accurate expf/tanhf: no fast-math.
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// each entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;            // BT: batch rows per block
constexpr int kMaxThreads = 512;    // one thread per hidden unit, H <= 512

__device__ __forceinline__ float load_weight(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_weight(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The state as the recurrent product sees it: f32 as is, or rounded to the
// weight's bf16 (round to nearest even, as torch's and XLA's casts do).
template <typename W>
__device__ __forceinline__ float product_operand(float h);

template <>
__device__ __forceinline__ float product_operand<float>(float h) { return h; }

template <>
__device__ __forceinline__ float product_operand<__nv_bfloat16>(float h) {
  return __bfloat162float(__float2bfloat16_rn(h));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// x_proj [B, T, G, 3H], h0 [B, G, H], w_t [G, H, 3H] (w_hh transposed),
// b_hh [G, 3H]; y [B, T, G, H], h_last [B, G, H]. All contiguous, f32 except w_t.
template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
gru_sequence_kernel(const float* __restrict__ x_proj, const float* __restrict__ h0,
                    const W* __restrict__ w_t, const float* __restrict__ b_hh,
                    float* __restrict__ y, float* __restrict__ h_last,
                    int B, int T, int G, int H) {
  extern __shared__ float4 smem[];
  float* hq = reinterpret_cast<float*>(smem);  // [2][H][kRows], double-buffered

  const int g = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int j = threadIdx.x;
  const bool active = j < H;
  const int H3 = 3 * H;
  const W* w = w_t + static_cast<size_t>(g) * H * H3;

  float h[kRows];
  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  if (active) {
    bias_r = b_hh[g * H3 + j];
    bias_z = b_hh[g * H3 + H + j];
    bias_n = b_hh[g * H3 + 2 * H + j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      h[r] = b < B ? h0[(static_cast<size_t>(b) * G + g) * H + j] : 0.f;
      hq[j * kRows + r] = product_operand<W>(h[r]);
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* cur = hq + (t & 1) * H * kRows;
    float* nxt = hq + ((t + 1) & 1) * H * kRows;
    if (active) {
      // this step's input projections, issued before the product hides their latency
      float xr[kRows], xz[kRows], xn[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        if (b < B) {
          const float* xp = x_proj + ((static_cast<size_t>(b) * T + t) * G + g) * H3;
          xr[r] = xp[j];
          xz[r] = xp[H + j];
          xn[r] = xp[2 * H + j];
        } else {
          xr[r] = xz[r] = xn[r] = 0.f;
        }
      }

      float acc_r[kRows], acc_z[kRows], acc_n[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_r[r] = acc_z[r] = acc_n[r] = 0.f;

#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        const W* wk = w + static_cast<size_t>(k) * H3;
        const float wr = load_weight(wk + j);
        const float wz = load_weight(wk + H + j);
        const float wn = load_weight(wk + 2 * H + j);
        const float4* hk = reinterpret_cast<const float4*>(cur + k * kRows);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 v = hk[q];  // same address across the warp: a broadcast
          const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 4 * q + e;
            acc_r[r] = fmaf(hv[e], wr, acc_r[r]);
            acc_z[r] = fmaf(hv[e], wz, acc_z[r]);
            acc_n[r] = fmaf(hv[e], wn, acc_n[r]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float rg = sigmoid(xr[r] + (acc_r[r] + bias_r));
        const float zg = sigmoid(xz[r] + (acc_z[r] + bias_z));
        const float ng = tanhf(xn[r] + rg * (acc_n[r] + bias_n));
        h[r] = (1.f - zg) * ng + zg * h[r];
        nxt[j * kRows + r] = product_operand<W>(h[r]);
        const int b = b0 + r;
        if (b < B) y[((static_cast<size_t>(b) * T + t) * G + g) * H + j] = h[r];
      }
    }
    // one barrier a step: next step's reads of nxt follow every write to it,
    // and this step's reads of cur all precede the writes to it a step later
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      if (b < B) h_last[(static_cast<size_t>(b) * G + g) * H + j] = h[r];
    }
  }
}

template <typename W>
int launch(const void* x_proj, const void* h0, const void* w_t, const void* b_hh, void* y,
           void* h_last, int B, int T, int G, int H, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  const int threads = (H + 31) / 32 * 32;
  const dim3 grid(G, (B + kRows - 1) / kRows);
  const size_t smem = 2 * static_cast<size_t>(H) * kRows * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_sequence_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gru_sequence_kernel<W><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(h0),
      static_cast<const W*>(w_t), static_cast<const float*>(b_hh), static_cast<float*>(y),
      static_cast<float*>(h_last), B, T, G, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_sequence_f32(const void* x_proj, const void* h0, const void* w_t, const void* b_hh,
                     void* y, void* h_last, int B, int T, int G, int H, void* stream) {
  return launch<float>(x_proj, h0, w_t, b_hh, y, h_last, B, T, G, H, stream);
}

int gru_sequence_bf16w(const void* x_proj, const void* h0, const void* w_t, const void* b_hh,
                       void* y, void* h_last, int B, int T, int G, int H, void* stream) {
  return launch<__nv_bfloat16>(x_proj, h0, w_t, b_hh, y, h_last, B, T, G, H, stream);
}

}  // extern "C"
