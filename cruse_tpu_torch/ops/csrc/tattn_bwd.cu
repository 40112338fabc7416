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
// tattn_dq_kernel: one thread a query, a block 128 queries. Its scaled q,
// dO, lse, D and c accumulators sit in registers; the key tiles (k, v; 32
// frames, T-minor rows, coalesced loads) are staged in shared memory by the
// whole block and read as scalar broadcasts, and the block walks every key
// tile that one of its queries sees. The head widths are template parameters
// (c rounded up to 4, 8 or 16, C to 8, 16, 24, 32 or 48; padded rows are
// zero), so the register arrays have a fixed size.
//
// tattn_dkv_kernel, the same design as the forward (tattn.cu) with the roles
// swapped, a lane holding a key and walking queries:
// - The band at warp granularity. A warp owns 32 consecutive keys of one
//   row, one a lane, with the key's k (log2(e) / sqrt(c) folded in), v and
//   the c + C accumulators of dk and dv in registers. It walks only the
//   32-query tiles its keys' band touches, from the diagonal tile to the one
//   that holds the last live key + window - 1 (T - 1 without a window): at
//   window 126 and T = 626 it computes 1.30x the band's pairs over a row
//   (1.27x for an interior warp; a block of 128 keys walking every tile of
//   all its keys computed 2.03x), 1.10x without a window. Warps are numbered over
//   (row, key block) without gaps. Only the tiles that hold a pair outside
//   the band are masked (the diagonal, and the tiles at the window's edge):
//   at window 126 an interior warp masks 3 of its 5 tiles, and the 2 middle
//   ones run with no compare and no select. Masked pairs get p = 0 by a
//   select, so no inf or NaN of an exp outside the band reaches a sum.
//   Queries past T are zero in shared memory (q, dO, lse and D), which adds
//   exactly 0 to dk and dv, so the last tile of a row needs no mask for them.
//   ops/asa_kernel.py::tattn_key_tiles is this walk's index arithmetic in
//   Python, tattn_dkv_walk_reference the whole walk.
// - Warp-private tiles, staged ahead. Each warp keeps its own ring of
//   kStages tiles in shared memory (c q rows, C dO rows, one lse row and one D
//   row, 32 floats each, T-minor as in global memory). The next tile is
//   requested by 4-byte cp.async (a row of 626 floats is only 8-byte aligned)
//   while the current one is computed; cp.async.wait_group and __syncwarp hand
//   it over. No __syncthreads: the warps of a block never wait for each other.
// - Reads as float4 over 4 queries. Queries go in groups of 4: each 16-byte
//   shared read of q_s[i][t..t+3] or dO_s[i][t..t+3] is a broadcast to the
//   warp and feeds 4 multiply-adds, first of the 4 logits and the 4 dp, then,
//   after p and ds, of dk[i] and dv[i]. For the second use the float4s stay
//   live in registers where they fit without a spill ((4, 16), (6, 24)), and
//   are read again from shared memory elsewhere (read_again).
// - Base-2 exp. p = exp2f(q . k' - lse * log2(e)); dk is multiplied by
//   1 / sqrt(c) at the store.
// - The head widths are template parameters, 5 instances (kDkvInstances): one
//   for each of config 5b's stages (c, C) = (6, 24), (8, 32), (12, 48), and
//   (4, 16), (16, 48); the first that holds (c, C) is taken. None spills on
//   an H100: 153 registers at (6, 24) (3 blocks of 4 warps an SM), 179 and
//   222 at (8, 32) and (12, 48) (2 blocks). Padded q and dO rows are zero in
//   shared memory, padded k and v zero in registers, and the padded dk and
//   dv are never stored. No atomics: each dk and dv element
//   has one owner lane, so the results are deterministic.
//
// Layouts: q, k, dq, dk f32 [BF, c, T]; v, dout, dv f32 [BF, C, T]; lse, dd
// f32 [BF, T]; all contiguous. Causal only. Plain C interface (bound with
// ctypes): the launch is on the caller's stream, nothing is allocated here,
// and each entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 128;  // queries (dq) or keys (dk/dv) a block
constexpr int kTile = 32;      // frames a shared-memory tile
constexpr int kWarps = kThreads / 32;  // dk/dv: warps a block, each on its own 32 keys and ring
constexpr int kGroup = 4;      // dk/dv: queries a float4 read feeds
constexpr int kStages = 2;     // dk/dv: tiles in a warp's ring
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

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

// dst <- *src (4 bytes), or 0 when !full; dst in shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool full) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every group but the newest `kStages - 1` has landed
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// *p, 16 bytes of shared memory that a group read for its logits and dp,
// read again for its accumulation. Left to them, the compiler and ptxas keep
// the group's (c + C) float4s live from the first read to the second: 4 (c +
// C) more registers, which is faster where they fit (on an H100, 13-15 % at
// (6, 24), 153 registers) and spills from (8, 32) up (255 registers; 2.8x
// slower at (12, 48)). So with Live false the read is a volatile load, which
// neither merges with the first.
template <bool Live>
__device__ __forceinline__ float4 read_again(const float* p) {
  if constexpr (Live) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    float4 r;
    const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
                 : "r"(at));
    return r;
  }
}

// Does the query tile [t0, t0 + kTile) hold a pair outside the band of a live
// key of [s0, s_hi]: a query (below T) before a key, or one window or more
// after it? (asa_kernel.py::tattn_key_tiles)
__device__ __forceinline__ bool tile_masked(int t0, int s0, int s_hi, int T, int window) {
  return t0 < s_hi || (window > 0 && min(t0 + kTile, T) - 1 >= s0 + window);
}

template <int CQ, int CV>
__global__ void __launch_bounds__(kThreads)
tattn_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dk, float* __restrict__ dv, int BF, int c, int cv, int T,
                 int window, float scale2, float scale) {
  constexpr int kTileFloats = (CQ + CV + 2) * kTile;  // q rows, dO rows, lse, D; kTile floats each
  // keep a group's float4s live between its two reads (read_again): 2 (c + C)
  // accumulators and inputs plus 4 (c + C) floats fit at (4, 16) and (6, 24)
  constexpr bool kLive = 6 * (CQ + CV) <= 192;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (T + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= static_cast<long long>(BF) * per_row) return;  // no block-wide barrier follows
  const long long bf = gw / per_row;
  const int s0 = static_cast<int>(gw % per_row) * 32, s_hi = min(s0 + 32, T) - 1;
  const int s = s0 + lane;  // this lane's key
  const bool live = s < T;
  const float* qb = q + bf * c * T;
  const float* gb = dout + bf * cv * T;
  const float* lb = lse + bf * T;
  const float* db = dd + bf * T;
  float* ring = reinterpret_cast<float*>(smem4) + warp * (kStages * kTileFloats);

  float kr[CQ], vr[CV], dkr[CQ], dvr[CV];
  {
    const float* kb = k + bf * c * T;
    const float* vb = v + bf * cv * T;
#pragma unroll
    for (int i = 0; i < CQ; ++i) {
      kr[i] = (live && i < c) ? kb[static_cast<long long>(i) * T + s] * scale2 : 0.f;
      dkr[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) {
      vr[i] = (live && i < cv) ? vb[static_cast<long long>(i) * T + s] : 0.f;
      dvr[i] = 0.f;
    }
  }

  // the queries that see the warp's live keys, as whole tiles (s0 starts one)
  const int t_hi = window > 0 ? min(T - 1, s_hi + window - 1) : T - 1;
  const int first = s0 / kTile, n_tiles = t_hi / kTile - first + 1;

  // padded rows stay zero in every stage
  for (int st = 0; st < kStages; ++st) {
    float* tile = ring + st * kTileFloats + lane;
    for (int r = c; r < CQ; ++r) tile[r * kTile] = 0.f;
    for (int r = CQ + cv; r < CQ + CV; ++r) tile[r * kTile] = 0.f;
  }
  // lane j copies query t0 + j of every row; queries past T are zero-filled
  auto request = [&](int tile_index) {
    const int t = tile_index * kTile + lane;
    const bool in = t < T;
    const long long col = in ? t : 0;
    float* tile = ring + (tile_index % kStages) * kTileFloats + lane;
    for (int r = 0; r < c; ++r) copy_async(tile + r * kTile, qb + r * static_cast<long long>(T) + col, in);
    for (int r = 0; r < cv; ++r)
      copy_async(tile + (CQ + r) * kTile, gb + r * static_cast<long long>(T) + col, in);
    copy_async(tile + (CQ + CV) * kTile, lb + col, in);
    copy_async(tile + (CQ + CV + 1) * kTile, db + col, in);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) request(first + i);
    copy_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) request(first + it + kStages - 1);
    copy_async_commit();  // an empty group past the last tile keeps the count
    copy_async_wait();
    __syncwarp();  // every lane's copies of this tile are visible
    const int t0 = (first + it) * kTile;
    const float* qs = ring + ((first + it) % kStages) * kTileFloats;
    const float* gs = qs + CQ * kTile;
    const float* ls = gs + CV * kTile;
    const float* dds = ls + kTile;
    const bool masked = tile_masked(t0, s0, s_hi, T, window);
#pragma unroll 1
    for (int j = 0; j < kTile; j += kGroup) {
      float a[kGroup] = {0.f, 0.f, 0.f, 0.f}, dp[kGroup] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(qs + i * kTile + j);
        a[0] = fmaf(qq.x, kr[i], a[0]);
        a[1] = fmaf(qq.y, kr[i], a[1]);
        a[2] = fmaf(qq.z, kr[i], a[2]);
        a[3] = fmaf(qq.w, kr[i], a[3]);
      }
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const float4 gg = *reinterpret_cast<const float4*>(gs + i * kTile + j);
        dp[0] = fmaf(gg.x, vr[i], dp[0]);
        dp[1] = fmaf(gg.y, vr[i], dp[1]);
        dp[2] = fmaf(gg.z, vr[i], dp[2]);
        dp[3] = fmaf(gg.w, vr[i], dp[3]);
      }
      const float4 l4 = *reinterpret_cast<const float4*>(ls + j);
      const float4 d4 = *reinterpret_cast<const float4*>(dds + j);
      // p in a[], ds in dp[]
      a[0] = exp2f(fmaf(-l4.x, kLog2e, a[0]));
      a[1] = exp2f(fmaf(-l4.y, kLog2e, a[1]));
      a[2] = exp2f(fmaf(-l4.z, kLog2e, a[2]));
      a[3] = exp2f(fmaf(-l4.w, kLog2e, a[3]));
      if (masked) {  // warp-uniform: only the band's edge tiles take it
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int t = t0 + j + u;
          const bool ok = t >= s && (window <= 0 || t < s + window);
          a[u] = ok ? a[u] : 0.f;
        }
      }
      dp[0] = a[0] * (dp[0] - d4.x);
      dp[1] = a[1] * (dp[1] - d4.y);
      dp[2] = a[2] * (dp[2] - d4.z);
      dp[3] = a[3] * (dp[3] - d4.w);
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const float4 gg = read_again<kLive>(gs + i * kTile + j);
        dvr[i] = fmaf(a[0], gg.x, dvr[i]);
        dvr[i] = fmaf(a[1], gg.y, dvr[i]);
        dvr[i] = fmaf(a[2], gg.z, dvr[i]);
        dvr[i] = fmaf(a[3], gg.w, dvr[i]);
      }
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        const float4 qq = read_again<kLive>(qs + i * kTile + j);
        dkr[i] = fmaf(dp[0], qq.x, dkr[i]);
        dkr[i] = fmaf(dp[1], qq.y, dkr[i]);
        dkr[i] = fmaf(dp[2], qq.z, dkr[i]);
        dkr[i] = fmaf(dp[3], qq.w, dkr[i]);
      }
    }
    __syncwarp();  // the tile is consumed before its stage is requested again
  }

  if (!live) return;
  float* dkb = dk + bf * c * T;
  float* dvb = dv + bf * cv * T;
#pragma unroll
  for (int i = 0; i < CQ; ++i)
    if (i < c) dkb[static_cast<long long>(i) * T + s] = dkr[i] * scale;
#pragma unroll
  for (int i = 0; i < CV; ++i)
    if (i < cv) dvb[static_cast<long long>(i) * T + s] = dvr[i];
}

struct Args {
  const float *q, *k, *v, *dout, *lse, *dd;
  float* dq;
  int BF, c, cv, T, window;
  cudaStream_t stream;
};

template <int CQ, int CV>
void launch_dq(const Args& a) {
  const dim3 grid((a.T + kThreads - 1) / kThreads, a.BF);
  const float scale = 1.f / sqrtf(static_cast<float>(a.c));
  tattn_dq_kernel<CQ, CV><<<grid, kThreads, 0, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.dd, a.dq, a.c, a.cv, a.T, a.window, scale);
}

template <int CQ>
int launch_dq_cv(const Args& a) {
  if (a.cv <= 8) launch_dq<CQ, 8>(a);
  else if (a.cv <= 16) launch_dq<CQ, 16>(a);
  else if (a.cv <= 24) launch_dq<CQ, 24>(a);
  else if (a.cv <= 32) launch_dq<CQ, 32>(a);
  else if (a.cv <= 48) launch_dq<CQ, 48>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dq(const Args& a) {
  if (a.BF < 1 || a.BF > 65535 || a.c < 1 || a.cv < 1 || a.T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.c <= 4) return launch_dq_cv<4>(a);
  if (a.c <= 8) return launch_dq_cv<8>(a);
  if (a.c <= 16) return launch_dq_cv<16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

using DkvKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, float*, float*, int, int, int, int, int, float, float);

struct DkvInstance {
  int cq, cv;
  DkvKernel kernel;
};

// The dk/dv instances, cheapest first: the first that holds (c, cv) is taken.
// Config 5b's three stages (c = C / 4) have their own.
const DkvInstance kDkvInstances[] = {
    {4, 16, tattn_dkv_kernel<4, 16>},   {6, 24, tattn_dkv_kernel<6, 24>},   {8, 32, tattn_dkv_kernel<8, 32>},
    {12, 48, tattn_dkv_kernel<12, 48>}, {16, 48, tattn_dkv_kernel<16, 48>},
};

// The dk/dv instance for (c, cv) and its floats a staged tile, or null past the limits.
DkvKernel pick_dkv(int c, int cv, int* floats) {
  for (const DkvInstance& instance : kDkvInstances)
    if (c <= instance.cq && cv <= instance.cv) {
      *floats = (instance.cq + instance.cv + 2) * kTile;
      return instance.kernel;
    }
  return nullptr;
}

size_t dkv_smem_bytes(int floats) { return static_cast<size_t>(kWarps) * kStages * floats * sizeof(float); }

// Lets each dk/dv instance that needs more than the default shared memory
// take it, once a device (as tattn.cu's allow_smem).
cudaError_t allow_dkv_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    cudaError_t set = cudaSuccess;
    for (const DkvInstance& instance : kDkvInstances) {
      const size_t bytes = dkv_smem_bytes((instance.cq + instance.cv + 2) * kTile);
      if (bytes > kDefaultSmem && set == cudaSuccess)
        set = cudaFuncSetAttribute(instance.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
    }
    result[device] = set;
  });
  return result[device];
}

const float* in(const void* p) { return static_cast<const float*>(p); }
float* out(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

// q, k, dq: f32 [BF, c, T]; v, dout: f32 [BF, cv, T]; lse, dd: f32 [BF, T].
// c <= 16, cv <= 48. window <= 0: no window (full causal).
int tattn_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* dd, void* dq, int BF, int c, int cv, int T, int window, void* stream) {
  const Args a{in(q), in(k), in(v), in(dout), in(lse), in(dd), out(dq),
               BF, c, cv, T, window, static_cast<cudaStream_t>(stream)};
  return dispatch_dq(a);
}

// As above; dk: f32 [BF, c, T], dv: f32 [BF, cv, T].
int tattn_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dd, void* dk, void* dv, int BF, int c, int cv, int T, int window,
                  void* stream) {
  int floats = 0;
  const DkvKernel kernel = pick_dkv(c, cv, &floats);
  if (kernel == nullptr || BF < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(BF) * ((T + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_dkv_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(c));
  kernel<<<static_cast<unsigned>(blocks), kThreads, dkv_smem_bytes(floats), static_cast<cudaStream_t>(stream)>>>(
      in(q), in(k), in(v), in(dout), in(lse), in(dd), out(dk), out(dv), BF, c, cv, T, window, kLog2e * scale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv instance that (c, cv) launches, on the current device: info =
// registers and local (spill) bytes a thread, blocks an SM, threads a block,
// dynamic shared memory a block (bytes), keys a warp.
int tattn_dkv_info(int c, int cv, int* info) {
  int floats = 0;
  const DkvKernel kernel = pick_dkv(c, cv, &floats);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = dkv_smem_bytes(floats);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_dkv_smem();
  int blocks = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  info[3] = kThreads;
  info[4] = static_cast<int>(bytes);
  info[5] = 32;
  return 0;
}

}  // extern "C"
