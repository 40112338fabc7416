// Backward of the grouped-GRU recurrence over a whole sequence, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX train step differentiates the plain
// recurrence cruse_tpu/nn/gru.py::gru_scan (lax.scan) under XLA's autodiff,
// and the Pallas kernel gru_sequence_pallas is forward only. It is the
// backward of csrc/gru_sequence.cu, torch gate order (r, z, n):
//
//   forward   hp = h_prev . w_hh^T + b_hh,  r = sigmoid(x_r + hp_r),
//             z = sigmoid(x_z + hp_z),      n = tanh(x_n + r * hp_n),
//             h = (1 - z) * n + z * h_prev
//   backward  dh     = dy_t + carry
//             dn_pre = dh (1 - z) (1 - n^2)
//             dz_pre = dh (h_prev - n) z (1 - z)
//             dr_pre = dn_pre hp_n r (1 - r)
//             dx_proj_t = [dr_pre, dz_pre, dn_pre],  dhp_t = [dr_pre, dz_pre, dn_pre r]
//             carry  = dh z + w_hh^T . dhp_t         (the carry of step t - 1)
//
// and dh0 is the carry left after t = 0. The caller gives hp for all t (one
// batched product of the saved states, outside the kernel) and takes
// dw_hh = sum dhp_t (x) h_prev and db_hh = sum dhp_t outside it too, so the
// kernel holds only what is sequential: the carry.
//
// Design: batch rows and groups are independent recurrences, so a block owns
// (group, 8 batch rows) and walks t from T - 1 down to 0 on its own, with no
// communication between blocks. Thread k owns hidden unit k: it keeps the
// carry of its unit for the 8 rows in registers, computes the gates of its
// unit, and stores its three dhp values of each row into a double-buffered
// [3H][8] tile in shared memory; after one barrier it takes its unit's
// column of the product, carry[k] += sum_j w_hh[g, j, k] dhp[j], reading
// w_hh[g, j, k] coalesced over k straight from L2 in the layout the weight
// already has ([G, 3H, H]), 8 rows at a time, and the tile's row j as two
// float4 broadcasts. One barrier a step: the next step writes the other
// buffer. Accurate expf/tanhf, f32 throughout, no fast-math.
//
// What bounds it: the T steps are strictly sequential, and each step
// streams the group's weight (3H x H floats: 371 KB at H = 176) from L2 into
// every block, more than an SM's L1 holds. So a step costs the latency of
// that stream (the 3H loads of a thread, 8 issued before their multiply-adds),
// not arithmetic: at config 2 (B = 128, T = 1001, G = 4, H = 176) the
// multiply-adds alone would take 1.42 ms on the whole card. Holding the
// weight in a cluster's shared memory, as the forward's resident kernel does,
// is the later redesign.
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// the entry returns the error of its launch (cudaGetLastError()).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;          // batch rows a block
constexpr int kMaxThreads = 512;  // one thread a hidden unit: H <= 512
constexpr int kChunk = 8;         // weights a thread loads before their multiply-adds

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// x_proj, hp, dx_proj, dhp [B, T, G, 3H]; y, dy [B, T, G, H]; h0, dh_last, dh0
// [B, G, H] (dh_last may be null: zeros); w_hh [G, 3H, H]. All contiguous f32.
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_kernel(const float* __restrict__ x_proj, const float* __restrict__ hp,
               const float* __restrict__ y, const float* __restrict__ h0,
               const float* __restrict__ dy, const float* __restrict__ dh_last,
               const float* __restrict__ w_hh, float* __restrict__ dx_proj,
               float* __restrict__ dhp, float* __restrict__ dh0, int B, int T, int G, int H) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);  // [2][3H][kRows]: a step's dhp, double-buffered

  const int g = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int k = threadIdx.x;
  const bool active = k < H;
  const int H3 = 3 * H;
  const float* w = w_hh + static_cast<size_t>(g) * H3 * H;  // [3H][H] of this group

  float carry[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    carry[r] = (active && b < B && dh_last != nullptr)
                   ? dh_last[(static_cast<size_t>(b) * G + g) * H + k] : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    float* cur = tile + (t & 1) * H3 * kRows;
    if (active) {
      float d_r[kRows], d_z[kRows], d_n[kRows];  // this unit's dhp of each row
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        d_r[r] = d_z[r] = d_n[r] = 0.f;
        if (b < B) {
          const size_t row = (static_cast<size_t>(b) * T + t) * G + g;  // (b, t, g)
          const float* xp = x_proj + row * H3;
          const float* hq = hp + row * H3;
          const float xr = xp[k], xz = xp[H + k], xn = xp[2 * H + k];
          const float hr = hq[k], hz = hq[H + k], hn = hq[2 * H + k];
          const float h_prev = t > 0 ? y[(row - G) * H + k]  // (b, t - 1, g)
                                     : h0[(static_cast<size_t>(b) * G + g) * H + k];
          const float dh = dy[row * H + k] + carry[r];
          const float rg = sigmoid(xr + hr);
          const float zg = sigmoid(xz + hz);
          const float ng = tanhf(xn + rg * hn);
          const float dn = dh * (1.f - zg) * (1.f - ng * ng);
          const float dz = dh * (h_prev - ng) * zg * (1.f - zg);
          const float dr = dn * hn * rg * (1.f - rg);
          float* dx = dx_proj + row * H3;
          float* dp = dhp + row * H3;
          dx[k] = dr;
          dx[H + k] = dz;
          dx[2 * H + k] = dn;
          d_r[r] = dr;
          d_z[r] = dz;
          d_n[r] = dn * rg;
          dp[k] = d_r[r];
          dp[H + k] = d_z[r];
          dp[2 * H + k] = d_n[r];
          carry[r] = dh * zg;  // the direct path; the product through w_hh is added below
        }
      }
      float4* out = reinterpret_cast<float4*>(cur);
      out[2 * k] = make_float4(d_r[0], d_r[1], d_r[2], d_r[3]);
      out[2 * k + 1] = make_float4(d_r[4], d_r[5], d_r[6], d_r[7]);
      out[2 * (H + k)] = make_float4(d_z[0], d_z[1], d_z[2], d_z[3]);
      out[2 * (H + k) + 1] = make_float4(d_z[4], d_z[5], d_z[6], d_z[7]);
      out[2 * (2 * H + k)] = make_float4(d_n[0], d_n[1], d_n[2], d_n[3]);
      out[2 * (2 * H + k) + 1] = make_float4(d_n[4], d_n[5], d_n[6], d_n[7]);
    }
    __syncthreads();
    if (active) {
      const float4* d = reinterpret_cast<const float4*>(cur);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const int full = H3 / kChunk * kChunk;
      for (int j0 = 0; j0 < full; j0 += kChunk) {
        float wv[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) wv[u] = __ldg(w + static_cast<size_t>(j0 + u) * H + k);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float4 lo = d[2 * (j0 + u)], hi = d[2 * (j0 + u) + 1];
          acc[0] = fmaf(wv[u], lo.x, acc[0]);
          acc[1] = fmaf(wv[u], lo.y, acc[1]);
          acc[2] = fmaf(wv[u], lo.z, acc[2]);
          acc[3] = fmaf(wv[u], lo.w, acc[3]);
          acc[4] = fmaf(wv[u], hi.x, acc[4]);
          acc[5] = fmaf(wv[u], hi.y, acc[5]);
          acc[6] = fmaf(wv[u], hi.z, acc[6]);
          acc[7] = fmaf(wv[u], hi.w, acc[7]);
        }
      }
      for (int j = full; j < H3; ++j) {
        const float wj = __ldg(w + static_cast<size_t>(j) * H + k);
        const float4 lo = d[2 * j], hi = d[2 * j + 1];
        acc[0] = fmaf(wj, lo.x, acc[0]);
        acc[1] = fmaf(wj, lo.y, acc[1]);
        acc[2] = fmaf(wj, lo.z, acc[2]);
        acc[3] = fmaf(wj, lo.w, acc[3]);
        acc[4] = fmaf(wj, hi.x, acc[4]);
        acc[5] = fmaf(wj, hi.y, acc[5]);
        acc[6] = fmaf(wj, hi.z, acc[6]);
        acc[7] = fmaf(wj, hi.w, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) carry[r] += acc[r];
    }
    // no second barrier: step t - 1 writes the other buffer, and a thread
    // reaches step t - 2's writes into this one only after every thread has
    // passed step t - 1's barrier, that is, has finished reading this one
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      if (b < B) dh0[(static_cast<size_t>(b) * G + g) * H + k] = carry[r];
    }
  }
}

}  // namespace

extern "C" {

int gru_bwd_f32(const void* x_proj, const void* hp, const void* y, const void* h0, const void* dy,
                const void* dh_last, const void* w_hh, void* dx_proj, void* dhp, void* dh0, int B,
                int T, int G, int H, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  const int threads = (H + 31) / 32 * 32;
  const dim3 grid(G, (B + kRows - 1) / kRows);
  const size_t smem = 2 * 3 * static_cast<size_t>(H) * kRows * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gru_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(hp), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(w_hh),
      static_cast<float*>(dx_proj), static_cast<float*>(dhp), static_cast<float*>(dh0), B, T, G, H);
  return cudaGetLastError();
}

}  // extern "C"
