// Temporal attention of MTFAA's axial self-attention, backward, for Hopper
// (sm_90a).
//
// Replaces the backward of the Pallas TPU kernel cruse_tpu/ops/asa_kernel.py::
// flash_tattn_tm (bodies _dq_kernel and _dkv_kernel). With the forward's
// logsumexp lse[t] and D[t] = sum_C dO[:, t] * O[:, t] (computed by the
// caller), per row bf and pair (query t, key s) inside the causal band
// (s <= t, and s > t - window with a window):
//
//   p  = exp(scale * q[:, t] . k[:, s] - lse[t])
//   ds = p * (dO[:, t] . v[:, s] - D[t])
//   dq[:, t] += scale * ds * k[:, s]     dk[:, s] += scale * ds * q[:, t]
//   dv[:, s] += p * dO[:, t]
//
// What bounds it: operations. A pair costs 2 c + C multiply-adds and an exp
// for dq, 2 (c + C) and an exp for dk/dv (c = 6..12, C = 24..48), on inputs of
// a few hundred bytes a frame; nothing of size T x T exists, where the plain
// version's autograd keeps and re-reads the [BF, T, T] probabilities.
//
// What the design does about it: the TPU kernels form [S, TQ] tiles of logits
// for the matrix unit and, for dk/dv, walk every later query block and mask.
// Here dq takes one thread a query, as the forward does: its scaled q, dO,
// lse, D and c accumulators in registers, the key tiles (k, v; 32 frames,
// T-minor rows, coalesced loads) staged in shared memory and read as
// broadcasts. dk/dv takes one thread a key: its k, v and c + C accumulators in
// registers, the query tiles (scaled q, dO, lse, D) staged the same way, and
// the query loop ends at the last query that sees the block's keys
// (t < s + window), so tiles outside the band are skipped, not masked. No
// atomics: each output element has one owner. The head widths are template
// parameters (c rounded up to 4, 8 or 16, C to 8, 16, 24, 32 or 48; padded
// rows are zero), so the register arrays have a fixed size.
//
// Layouts: q, k, dq, dk f32 [BF, c, T]; v, dout, dv f32 [BF, C, T]; lse, dd
// f32 [BF, T]; all contiguous. Causal only. Plain C interface (bound with
// ctypes): the launch is on the caller's stream, nothing is allocated here,
// and each entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // queries (dq) or keys (dk/dv) a block
constexpr int kTile = 32;      // frames a shared-memory tile

// rows[r][j] = src[r, f0 + j] for r < rows_used and f0 + j < T, else 0
template <int R>
__device__ void stage(float (&rows)[R][kTile], const float* __restrict__ src, int rows_used, int T,
                      int f0, float scale) {
  for (int i = threadIdx.x; i < R * kTile; i += kThreads) {
    const int r = i / kTile, f = f0 + i % kTile;
    rows[r][i % kTile] = (r < rows_used && f < T) ? src[static_cast<long long>(r) * T + f] * scale : 0.f;
  }
}

template <int CQ, int CV>
__global__ void __launch_bounds__(kThreads)
tattn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int c, int cv, int T, int window, float scale) {
  __shared__ float k_s[CQ][kTile];
  __shared__ float v_s[CV][kTile];
  const long long bf = blockIdx.y;
  const int q_lo = blockIdx.x * kThreads;
  const int t = q_lo + threadIdx.x;
  const bool active = t < T;
  const float* qb = q + bf * c * T;
  const float* kb = k + bf * c * T;
  const float* vb = v + bf * cv * T;
  const float* gb = dout + bf * cv * T;

  float qr[CQ], acc[CQ], gr[CV];
#pragma unroll
  for (int i = 0; i < CQ; ++i) {
    qr[i] = (active && i < c) ? qb[static_cast<long long>(i) * T + t] * scale : 0.f;
    acc[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < CV; ++i) gr[i] = (active && i < cv) ? gb[static_cast<long long>(i) * T + t] : 0.f;
  const float l = active ? lse[bf * T + t] : 0.f;
  const float dsum = active ? dd[bf * T + t] : 0.f;

  // the keys any query of this block sees
  const int s_hi = min(T, q_lo + kThreads) - 1;
  const int s_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  for (int s0 = s_lo / kTile * kTile; s0 <= s_hi; s0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    stage<CQ>(k_s, kb, c, T, s0, 1.f);
    stage<CV>(v_s, vb, cv, T, s0, 1.f);
    __syncthreads();
    if (!active || s0 > t || (window > 0 && s0 + kTile <= t - window + 1)) continue;
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const int s = s0 + j;
      const bool ok = s <= t && (window <= 0 || s > t - window);
      float a = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < CQ; ++i) a = fmaf(qr[i], k_s[i][j], a);
#pragma unroll
      for (int i = 0; i < CV; ++i) dp = fmaf(gr[i], v_s[i][j], dp);
      const float ds = ok ? expf(a - l) * (dp - dsum) : 0.f;
#pragma unroll
      for (int i = 0; i < CQ; ++i) acc[i] = fmaf(ds, k_s[i][j], acc[i]);
    }
  }
  if (!active) return;
  float* ob = dq + bf * c * T;
#pragma unroll
  for (int i = 0; i < CQ; ++i)
    if (i < c) ob[static_cast<long long>(i) * T + t] = acc[i] * scale;
}

template <int CQ, int CV>
__global__ void __launch_bounds__(kThreads)
tattn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dk, float* __restrict__ dv, int c, int cv, int T, int window,
                 float scale) {
  __shared__ float q_s[CQ][kTile];  // scaled
  __shared__ float g_s[CV][kTile];
  __shared__ float l_s[1][kTile];
  __shared__ float d_s[1][kTile];
  const long long bf = blockIdx.y;
  const int s_lo = blockIdx.x * kThreads;
  const int s = s_lo + threadIdx.x;
  const bool active = s < T;
  const float* qb = q + bf * c * T;
  const float* kb = k + bf * c * T;
  const float* vb = v + bf * cv * T;
  const float* gb = dout + bf * cv * T;

  float kr[CQ], dkr[CQ], vr[CV], dvr[CV];
#pragma unroll
  for (int i = 0; i < CQ; ++i) {
    kr[i] = (active && i < c) ? kb[static_cast<long long>(i) * T + s] : 0.f;
    dkr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < CV; ++i) {
    vr[i] = (active && i < cv) ? vb[static_cast<long long>(i) * T + s] : 0.f;
    dvr[i] = 0.f;
  }

  // the queries that see any key of this block: s_lo <= t, and t < s + window
  int t_hi = T - 1;
  if (window > 0) t_hi = min(t_hi, min(T, s_lo + kThreads) - 1 + window - 1);
  for (int t0 = s_lo; t0 <= t_hi; t0 += kTile) {  // s_lo is a multiple of kTile
    __syncthreads();  // the previous tile is consumed
    stage<CQ>(q_s, qb, c, T, t0, scale);
    stage<CV>(g_s, gb, cv, T, t0, 1.f);
    stage<1>(l_s, lse + bf * T, 1, T, t0, 1.f);
    stage<1>(d_s, dd + bf * T, 1, T, t0, 1.f);
    __syncthreads();
    if (!active || t0 + kTile <= s || (window > 0 && t0 >= s + window)) continue;
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const int t = t0 + j;
      const bool ok = t < T && t >= s && (window <= 0 || t < s + window);
      float a = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < CQ; ++i) a = fmaf(q_s[i][j], kr[i], a);
#pragma unroll
      for (int i = 0; i < CV; ++i) dp = fmaf(g_s[i][j], vr[i], dp);
      const float p = ok ? expf(a - l_s[0][j]) : 0.f;
      const float ds = p * (dp - d_s[0][j]);
#pragma unroll
      for (int i = 0; i < CV; ++i) dvr[i] = fmaf(p, g_s[i][j], dvr[i]);
#pragma unroll
      for (int i = 0; i < CQ; ++i) dkr[i] = fmaf(ds, q_s[i][j], dkr[i]);
    }
  }
  if (!active) return;
  float* dkb = dk + bf * c * T;
  float* dvb = dv + bf * cv * T;
#pragma unroll
  for (int i = 0; i < CQ; ++i)
    if (i < c) dkb[static_cast<long long>(i) * T + s] = dkr[i];
#pragma unroll
  for (int i = 0; i < CV; ++i)
    if (i < cv) dvb[static_cast<long long>(i) * T + s] = dvr[i];
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *dd;
  float *dq, *dk, *dv;
  int BF, c, cv, T, window;
  cudaStream_t stream;
};

template <int CQ, int CV>
void launch(const Args& a, bool dkv) {
  const dim3 grid((a.T + kThreads - 1) / kThreads, a.BF);
  const float scale = 1.f / sqrtf(static_cast<float>(a.c));
  if (dkv) {
    tattn_dkv_kernel<CQ, CV><<<grid, kThreads, 0, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.dd, a.dk, a.dv, a.c, a.cv, a.T, a.window, scale);
  } else {
    tattn_dq_kernel<CQ, CV><<<grid, kThreads, 0, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.dd, a.dq, a.c, a.cv, a.T, a.window, scale);
  }
}

template <int CQ>
int launch_cv(const Args& a, bool dkv) {
  if (a.cv <= 8) launch<CQ, 8>(a, dkv);
  else if (a.cv <= 16) launch<CQ, 16>(a, dkv);
  else if (a.cv <= 24) launch<CQ, 24>(a, dkv);
  else if (a.cv <= 32) launch<CQ, 32>(a, dkv);
  else if (a.cv <= 48) launch<CQ, 48>(a, dkv);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, bool dkv) {
  if (a.BF < 1 || a.BF > 65535 || a.c < 1 || a.cv < 1 || a.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.c <= 4) return launch_cv<4>(a, dkv);
  if (a.c <= 8) return launch_cv<8>(a, dkv);
  if (a.c <= 16) return launch_cv<16>(a, dkv);
  return static_cast<int>(cudaErrorInvalidValue);
}

const float* in(const void* p) { return static_cast<const float*>(p); }
float* out(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

// q, k, dq: f32 [BF, c, T]; v, dout: f32 [BF, cv, T]; lse, dd: f32 [BF, T].
// c <= 16, cv <= 48. window <= 0: no window (full causal).
int tattn_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* dd, void* dq, int BF, int c, int cv, int T, int window, void* stream) {
  const Args a{in(q), in(k), in(v), in(dout), in(lse), in(dd), out(dq), nullptr, nullptr,
               BF, c, cv, T, window, static_cast<cudaStream_t>(stream)};
  return dispatch(a, false);
}

// As above; dk: f32 [BF, c, T], dv: f32 [BF, cv, T].
int tattn_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dd, void* dk, void* dv, int BF, int c, int cv, int T, int window,
                  void* stream) {
  const Args a{in(q), in(k), in(v), in(dout), in(lse), in(dd), nullptr, out(dk), out(dv),
               BF, c, cv, T, window, static_cast<cudaStream_t>(stream)};
  return dispatch(a, true);
}

}  // extern "C"
