// Temporal attention of MTFAA's axial self-attention, forward, for Hopper
// (sm_90a).
//
// Replaces the forward of the Pallas TPU kernel cruse_tpu/ops/asa_kernel.py::
// flash_tattn_tm (body _fwd_kernel). T-minor, per row bf:
//
//   out[c', t] = sum_s softmax_s(sum_c q[c, t] k[c, s] / sqrt(c_q)) v[c', s]
//
// over the keys s that query t sees: t - window < s <= t (causal, windowed),
// s <= t (causal), or every s (non-causal; the reference's flash path has no
// such mode and masks causally whatever it is asked).
//
// What bounds it: FMAs and exps, not bytes. Each (query, key) pair costs
// c_q + C multiply-adds and one exp (c_q = 6..12, C = 24..48), on inputs of
// (2 c_q + C) * T floats a row; the plain version's cost is instead the
// [BF, T, T] logits and probabilities it writes and reads (1.6 GB each at
// BF = 1024, T = 626).
//
// What the design does about it: a block owns 128 queries of one row, one
// thread each, holding its scaled q column, a running max and sum and its C
// output accumulators in registers (online softmax, the flash algorithm).
// The block walks the key tiles of 32 frames that its queries' band touches
// -- tiles outside the band are skipped, not masked, as _lo_block does on the
// TPU -- staging each tile's k and v (T-minor rows: coalesced loads) in
// shared memory, which the threads then read as warp-wide broadcasts. Per
// tile a thread takes its 32 logits into registers, rescales its sum and
// accumulators once to the tile's new max, and adds the tile's
// probability-weighted values. Nothing of size T x T exists. The head
// widths are template parameters (c_q rounded up to 4, 8 or 16, C to 8, 16,
// 24, 32 or 48; the padded rows are zero), so the register arrays have a
// fixed size.
//
// Layouts: q, k f32 [BF, c, T], v f32 [BF, C, T], out f32 [BF, C, T], all
// contiguous. Plain C interface (bound with ctypes): pointers and the stream
// are void*, the launch is on the caller's stream, nothing is allocated here,
// and the entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kQueries = 128;  // queries (threads) a block
constexpr int kKeys = 32;      // keys a shared-memory tile
constexpr float kNeg = -1e30f;

template <int CQ, int CV>
__global__ void __launch_bounds__(kQueries)
tattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int c, int cv, int T,
                 int window, int causal, float scale) {
  __shared__ float k_s[CQ][kKeys];
  __shared__ float v_s[CV][kKeys];
  const long long bf = blockIdx.y;
  const int q_lo = blockIdx.x * kQueries;
  const int t = q_lo + threadIdx.x;
  const bool active = t < T;
  const float* qb = q + bf * c * T;
  const float* kb = k + bf * c * T;
  const float* vb = v + bf * cv * T;

  float qr[CQ];
#pragma unroll
  for (int i = 0; i < CQ; ++i) qr[i] = (active && i < c) ? qb[static_cast<long long>(i) * T + t] * scale : 0.f;
  float acc[CV];
#pragma unroll
  for (int i = 0; i < CV; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  // the keys any query of this block sees
  int s_lo = 0, s_hi = T - 1;
  if (causal) {
    s_hi = min(T, q_lo + kQueries) - 1;
    if (window > 0) s_lo = max(0, q_lo - window + 1);
  }
  for (int s0 = s_lo / kKeys * kKeys; s0 <= s_hi; s0 += kKeys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < CQ * kKeys; i += kQueries) {
      const int r = i / kKeys, s = s0 + i % kKeys;
      k_s[r][i % kKeys] = (r < c && s < T) ? kb[static_cast<long long>(r) * T + s] : 0.f;
    }
    for (int i = threadIdx.x; i < CV * kKeys; i += kQueries) {
      const int r = i / kKeys, s = s0 + i % kKeys;
      v_s[r][i % kKeys] = (r < cv && s < T) ? vb[static_cast<long long>(r) * T + s] : 0.f;
    }
    __syncthreads();

    float logit[kKeys];
    unsigned valid = 0u;
    float m_tile = kNeg;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int s = s0 + j;
      const bool ok = s < T && (!causal || (s <= t && (window <= 0 || s > t - window)));
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < CQ; ++i) a = fmaf(qr[i], k_s[i][j], a);
      logit[j] = a;
      if (ok) {
        valid |= 1u << j;
        m_tile = fmaxf(m_tile, a);
      }
    }
    if (valid == 0u) continue;  // no key of this tile in this query's band
    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int i = 0; i < CV; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = (valid >> j) & 1u ? expf(logit[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < CV; ++i) acc[i] = fmaf(p, v_s[i][j], acc[i]);
    }
  }
  if (!active) return;
  const float inv = 1.f / l;
  float* ob = out + bf * cv * T;
#pragma unroll
  for (int i = 0; i < CV; ++i)
    if (i < cv) ob[static_cast<long long>(i) * T + t] = acc[i] * inv;
}

template <int CQ>
int launch_cv(const float* q, const float* k, const float* v, float* out, int BF, int c, int cv,
              int T, int window, int causal, cudaStream_t stream) {
  const dim3 grid((T + kQueries - 1) / kQueries, BF);
  const float scale = 1.f / sqrtf(static_cast<float>(c));
#define TATTN_CASE(N)                                                                   \
  case N:                                                                               \
    tattn_fwd_kernel<CQ, N><<<grid, kQueries, 0, stream>>>(q, k, v, out, c, cv, T,      \
                                                            window, causal, scale);     \
    break;
  const int cvp = cv <= 8 ? 8 : cv <= 16 ? 16 : cv <= 24 ? 24 : cv <= 32 ? 32 : 48;
  switch (cv <= 48 ? cvp : 0) {
    TATTN_CASE(8)
    TATTN_CASE(16)
    TATTN_CASE(24)
    TATTN_CASE(32)
    TATTN_CASE(48)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TATTN_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k: f32 [BF, c, T]; v, out: f32 [BF, cv, T]; all contiguous. c <= 16,
// cv <= 48. window <= 0: no window. causal == 0: every key (window unused).
int tattn_fwd_f32(const void* q, const void* k, const void* v, void* out, int BF, int c, int cv,
                  int T, int window, int causal, void* stream) {
  if (BF < 1 || BF > 65535 || c < 1 || cv < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 4) return launch_cv<4>(qf, kf, vf, of, BF, c, cv, T, window, causal, s);
  if (c <= 8) return launch_cv<8>(qf, kf, vf, of, BF, c, cv, T, window, causal, s);
  if (c <= 16) return launch_cv<16>(qf, kf, vf, of, BF, c, cv, T, window, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
