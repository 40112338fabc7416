// Complex multi-frame deep filter, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cruse_tpu/ops/deep_filter_kernel.py::
// deep_filter_pallas (body _df_kernel). Per output bin (b, t, f), with the
// taps in tap_offsets order (time offset outer, frequency offset inner):
//
//   out[t, f] = sum_k coef[t, f, k] * spec[t - dt_k, f - df_k]     (complex)
//   acc_r = acc_r + sr*cr - si*ci;  acc_i = acc_i + sr*ci + si*cr
//
// dt runs over [0, 2*t_dim] (causal) or [-t_dim, t_dim] (symmetric), df over
// [-f_dim, f_dim]. A read outside the spectrum is zero, except that a read at
// t - dt < 0 takes history[H + t - dt] when a history of H = 2*t_dim past
// frames is given (causal only). So one kernel runs the offline utterance
// (no history: the TPU kernel's zero fill) and the streaming hop (T = 1 with
// the carried frames).
//
// What bounds it: device-memory bytes. Each output bin does 4K multiply-adds
// on 8K + 8 bytes of coefficients and spectrum, about 1 FLOP per byte, far
// below the card's ~20 FLOP/byte f32 balance. The coefficients [B,T,F,K,2]
// are K times the spectrum, so the least traffic is the coefficients once,
// the spectrum once and the output once.
//
// What the design does about it: a block owns `rows` consecutive frames of
// one batch row. It copies their coefficients, which are one contiguous range
// in the model's own [B,T,F,K,2] layout, into shared memory with coalesced
// (16-byte where aligned) loads, and copies the spectrum tile those frames
// read -- rows + 2*t_dim frames by F + 2*f_dim bins, zero-padded in frequency,
// history or zeros past the start, zeros past the end -- once. Then one
// thread per output bin walks its K taps out of shared memory. The tile
// overlap re-reads 2*t_dim spectrum frames per block, a few percent of the
// coefficient bytes. `rows` is the most frames (<= 8) whose tile fits in 48 KB
// of shared memory, so several blocks stay resident per SM and one block's
// loads overlap another's arithmetic.
//
// The spectrum is complex64 [B, T, F] (interleaved re/im) with a batch and a
// row stride, so the low-bin slice of a wider spectrum needs no copy; the
// history has a batch stride, so the carried frames need no copy either; the
// coefficients and the output are contiguous. Plain C interface (bound
// with ctypes): pointers and the stream are void*, the launch is on the
// caller's stream, nothing is allocated here, and the entry returns
// cudaGetLastError() of its launch (or the error of its attribute call).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
deep_filter_kernel(const float2* __restrict__ spec, long long spec_bstride,
                   long long spec_rstride, const float2* __restrict__ history,
                   long long hist_bstride, const float* __restrict__ coefs,
                   float2* __restrict__ out,
                   int T, int F, int t_dim, int f_dim, int dt_min, int rows,
                   bool vec) {
  extern __shared__ float4 smem[];
  const int K = (2 * t_dim + 1) * (2 * f_dim + 1);
  const int H = 2 * t_dim;  // history frames
  const int dt_max = dt_min + 2 * t_dim;
  const int span = rows + dt_max - dt_min;  // spectrum frames the tile reads
  const int width = F + 2 * f_dim;          // bins, zero-padded by f_dim
  const int row_floats = F * K * 2;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * rows;
  const int nrows = min(rows, T - t0);

  float* c_s = reinterpret_cast<float*>(smem);                  // [rows][F][K][2]
  float2* s_s = reinterpret_cast<float2*>(c_s + rows * row_floats);  // [span][width]

  // the block's coefficients: one contiguous range
  const long long cbase = (static_cast<long long>(b) * T + t0) * row_floats;
  const int n = nrows * row_floats;
  if (vec) {  // row_floats % 4 == 0 and coefs 16-byte aligned
    const float4* g = reinterpret_cast<const float4*>(coefs + cbase);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) smem[i] = __ldcs(g + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) c_s[i] = __ldcs(coefs + cbase + i);
  }

  // the spectrum tile: tile row r is frame t0 - dt_max + r, column c bin c - f_dim
  for (int i = threadIdx.x; i < span * width; i += blockDim.x) {
    const int tau = t0 - dt_max + i / width;
    const int phi = i % width - f_dim;
    float2 v = make_float2(0.f, 0.f);
    if (phi >= 0 && phi < F && tau < T) {
      if (tau >= 0) {
        v = spec[b * spec_bstride + tau * spec_rstride + phi];
      } else if (history != nullptr && tau >= -H) {
        v = history[b * hist_bstride + static_cast<long long>(H + tau) * F + phi];
      }
    }
    s_s[i] = v;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < nrows * F; o += blockDim.x) {
    const int i = o / F;
    const int f = o % F;
    const float2* c = reinterpret_cast<const float2*>(c_s) + o * K;
    float acc_r = 0.f, acc_i = 0.f;
    int k = 0;
    for (int dt = dt_min; dt <= dt_max; ++dt) {
      // frame t0 + i - dt is tile row i - dt + dt_max; bin f - df is column f - df + f_dim
      const float2* srow = s_s + (i - dt + dt_max) * width + f + f_dim;
      for (int df = -f_dim; df <= f_dim; ++df, ++k) {
        const float2 s = srow[-df];
        const float2 w = c[k];
        acc_r = acc_r + s.x * w.x - s.y * w.y;
        acc_i = acc_i + s.x * w.y + s.y * w.x;
      }
    }
    out[(static_cast<long long>(b) * T + t0 + i) * F + f] = make_float2(acc_r, acc_i);
  }
}

}  // namespace

extern "C" {

// spec: complex64 [B, T, F] at (batch, row) strides in complex elements, bins
// contiguous; history: complex64 [B, 2*t_dim, F] at a batch stride, frames
// and bins contiguous within a batch row, or null;
// coefs: f32 [B, T, F, K, 2] contiguous; out: complex64 [B, T, F] contiguous.
int deep_filter_f32(const void* spec, long long spec_bstride, long long spec_rstride,
                    const void* history, long long hist_bstride, const void* coefs,
                    void* out, int B, int T, int F, int t_dim, int f_dim, int causal,
                    void* stream) {
  const int K = (2 * t_dim + 1) * (2 * f_dim + 1);
  const int dt_min = causal ? 0 : -t_dim;
  const size_t row_bytes = static_cast<size_t>(F) * K * 2 * sizeof(float);
  const size_t tile_row_bytes = static_cast<size_t>(F + 2 * f_dim) * sizeof(float2);
  auto smem_bytes = [&](int rows) {
    return rows * row_bytes + (rows + 2 * t_dim) * tile_row_bytes;
  };
  int rows = kMaxRows < T ? kMaxRows : T;
  while (rows > 1 && smem_bytes(rows) > kDefaultSmem) --rows;
  const size_t bytes = smem_bytes(rows);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        deep_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = (F * K * 2) % 4 == 0 && reinterpret_cast<uintptr_t>(coefs) % 16 == 0;
  const dim3 grid((T + rows - 1) / rows, B);
  deep_filter_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), spec_bstride, spec_rstride,
      static_cast<const float2*>(history), hist_bstride, static_cast<const float*>(coefs),
      static_cast<float2*>(out), T, F, t_dim, f_dim, dt_min, rows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
