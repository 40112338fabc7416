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
// Both kernels share the forward's design (tattn.cu): a warp owns 32
// consecutive frames of one row, one a lane, walks only the 32-frame tiles of
// their band from a warp-private ring filled by cp.async, reads the staged rows
// as float4 broadcasts over groups of 4 frames, and takes a base-2 exp.
//
// tattn_dq_kernel, the forward's walk exactly, a lane holding a query:
// - The band at warp granularity. A warp owns 32 consecutive queries of one
//   row, one a lane, with the query's q (log2(e) / sqrt(c) folded in), dO,
//   lse, D and the c accumulators of dq in registers. It walks only the
//   32-key tiles its queries' band touches (ops/asa_kernel.py::
//   tattn_band_tiles, as the forward): at window 126 and T = 626 it computes
//   1.27x the band's pairs (a block of 128 queries walking every tile of all
//   its queries computed 2.03x), 1.05x without a window. Warps are numbered
//   over (row, query block) without gaps. Only the tiles that hold a key
//   outside some live query's band are masked (the diagonal and the window's
//   edge); the others run with no compare and no select. Masked pairs get
//   p = 0 by a select, so no inf or NaN of an exp outside the band reaches a
//   sum. Keys past T are zero in shared memory: their ds need not be zero,
//   but it multiplies a zero k, and the diagonal tile that holds them is
//   masked anyway. Lanes whose query lies past T hold zeros, take part in
//   every copy and __syncwarp, and store nothing.
//   tattn_dq_walk_reference is this walk in PyTorch.
// - Warp-private tiles, staged ahead: the forward's ring of kStages tiles of
//   c k rows and C v rows, 32 floats each, T-minor as in global memory, the
//   next tile requested by 4-byte cp.async while the current one is
//   computed, handed over by cp.async.wait_group and __syncwarp. No
//   __syncthreads.
// - Reads as float4 over 4 keys. Each 16-byte shared read of k_s[i][s..s+3]
//   or v_s[i][s..s+3] is a broadcast to the warp and feeds 4 multiply-adds:
//   first of the 4 logits and the 4 dp, then, after p and ds, of dq[i] from
//   the same c float4s of k, kept in registers between the two uses (4 c
//   floats; no instance spills: 80 to 215 registers on an H100, where
//   reading them again from shared memory was 6-26 % slower).
// - Base-2 exp, with the constants folded into the sums' first terms: the
//   logits start from -lse * log2(e) and dp from -D, so p = exp2f(a) and
//   ds = p * dp; dq is multiplied by 1 / sqrt(c) at the store.
// - The head widths are template parameters, 5 instances (kDqInstances), as
//   for dk/dv: exact at config 5b's (6, 24), (8, 32), (12, 48), and (4, 16),
//   (16, 48); the first that holds (c, C) is taken. Padded k and v rows are
//   zero in shared memory, padded q channels zero in registers, and the
//   padded dq is never stored. No atomics: each dq element has one owner lane.
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

constexpr int kTile = 32;   // frames a shared-memory tile
constexpr int kWarps = 4;   // warps a block, each on its own 32 frames and ring
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 4;   // frames a float4 read feeds
constexpr int kStages = 2;  // tiles in a warp's ring
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

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

// Does some key of the tile [s0, s0 + kTile) lie outside the band of some
// live query of [q0, q_hi]? (asa_kernel.py::tattn_band_tiles, tattn.cu's)
__device__ __forceinline__ bool key_tile_masked(int s0, int q0, int q_hi, int window) {
  return s0 + kTile - 1 > q0 || (window > 0 && s0 < q_hi - window + 1);
}

template <int CQ, int CV>
__global__ void __launch_bounds__(kThreads)
tattn_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                float* __restrict__ dq, int BF, int c, int cv, int T, int window, float scale2,
                float scale) {
  constexpr int kTileFloats = (CQ + CV) * kTile;  // k rows, then v rows, kTile floats each
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (T + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= static_cast<long long>(BF) * per_row) return;  // no block-wide barrier follows
  const long long bf = gw / per_row;
  const int q0 = static_cast<int>(gw % per_row) * 32, q_hi = min(q0 + 32, T) - 1;
  const int t = q0 + lane;  // this lane's query
  const bool live = t < T;
  const float* kb = k + bf * c * T;
  const float* vb = v + bf * cv * T;
  float* ring = reinterpret_cast<float*>(smem4) + warp * (kStages * kTileFloats);

  float qr[CQ], gr[CV], acc[CQ];
  {
    const float* qb = q + bf * c * T;
    const float* gb = dout + bf * cv * T;
#pragma unroll
    for (int i = 0; i < CQ; ++i) {
      qr[i] = (live && i < c) ? qb[static_cast<long long>(i) * T + t] * scale2 : 0.f;
      acc[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < CV; ++i) gr[i] = (live && i < cv) ? gb[static_cast<long long>(i) * T + t] : 0.f;
  }
  // the first terms of a logit (log2 p) and of dp - D
  const float a0 = live ? -lse[bf * T + t] * kLog2e : 0.f;
  const float dp0 = live ? -dd[bf * T + t] : 0.f;

  // the keys the warp's live queries see, as whole tiles
  const int s_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int first = s_lo / kTile, n_tiles = q_hi / kTile - first + 1;

  // padded rows stay zero in every stage
  for (int st = 0; st < kStages; ++st) {
    float* tile = ring + st * kTileFloats + lane;
    for (int r = c; r < CQ; ++r) tile[r * kTile] = 0.f;
    for (int r = CQ + cv; r < CQ + CV; ++r) tile[r * kTile] = 0.f;
  }
  // lane j copies key s0 + j of every row; keys past T are zero-filled
  auto request = [&](int tile_index) {
    const int s = tile_index * kTile + lane;
    const bool in = s < T;
    const long long col = in ? s : 0;
    float* tile = ring + (tile_index % kStages) * kTileFloats + lane;
    for (int r = 0; r < c; ++r) copy_async(tile + r * kTile, kb + r * static_cast<long long>(T) + col, in);
    for (int r = 0; r < cv; ++r)
      copy_async(tile + (CQ + r) * kTile, vb + r * static_cast<long long>(T) + col, in);
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
    const int s0 = (first + it) * kTile;
    const float* ks = ring + ((first + it) % kStages) * kTileFloats;
    const float* vs = ks + CQ * kTile;
    const bool masked = key_tile_masked(s0, q0, q_hi, window);
#pragma unroll 1
    for (int j = 0; j < kTile; j += kGroup) {
      float a[kGroup] = {a0, a0, a0, a0}, dp[kGroup] = {dp0, dp0, dp0, dp0};
      float4 kk[CQ];  // the group's k, kept for the accumulation
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        kk[i] = *reinterpret_cast<const float4*>(ks + i * kTile + j);
        a[0] = fmaf(qr[i], kk[i].x, a[0]);
        a[1] = fmaf(qr[i], kk[i].y, a[1]);
        a[2] = fmaf(qr[i], kk[i].z, a[2]);
        a[3] = fmaf(qr[i], kk[i].w, a[3]);
      }
#pragma unroll
      for (int i = 0; i < CV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + i * kTile + j);
        dp[0] = fmaf(gr[i], vv.x, dp[0]);
        dp[1] = fmaf(gr[i], vv.y, dp[1]);
        dp[2] = fmaf(gr[i], vv.z, dp[2]);
        dp[3] = fmaf(gr[i], vv.w, dp[3]);
      }
      // p in a[], then ds = p (dO . v - D) in dp[]
#pragma unroll
      for (int u = 0; u < kGroup; ++u) a[u] = exp2f(a[u]);
      if (masked) {  // warp-uniform: only the band's edge tiles take it
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int s = s0 + j + u;
          const bool ok = s <= t && (window <= 0 || s > t - window);
          a[u] = ok ? a[u] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) dp[u] *= a[u];
#pragma unroll
      for (int i = 0; i < CQ; ++i) {
        acc[i] = fmaf(dp[0], kk[i].x, acc[i]);
        acc[i] = fmaf(dp[1], kk[i].y, acc[i]);
        acc[i] = fmaf(dp[2], kk[i].z, acc[i]);
        acc[i] = fmaf(dp[3], kk[i].w, acc[i]);
      }
    }
    __syncwarp();  // the tile is consumed before its stage is requested again
  }

  if (!live) return;
  float* ob = dq + bf * c * T;
#pragma unroll
  for (int i = 0; i < CQ; ++i)
    if (i < c) ob[static_cast<long long>(i) * T + t] = acc[i] * scale;
}

// Does the query tile [t0, t0 + kTile) hold a pair outside the band of a live
// key of [s0, s_hi]: a query (below T) before a key, or one window or more
// after it? (asa_kernel.py::tattn_key_tiles)
__device__ __forceinline__ bool query_tile_masked(int t0, int s0, int s_hi, int T, int window) {
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
    const bool masked = query_tile_masked(t0, s0, s_hi, T, window);
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

using DqKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                          const float*, float*, int, int, int, int, int, float, float);
using DkvKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                           const float*, float*, float*, int, int, int, int, int, float, float);

template <typename Kernel>
struct Instance {
  int cq, cv;  // the head widths it holds
  int rows;    // rows of kTile floats a staged tile
  Kernel kernel;
};

// The instances, cheapest first: the first that holds (c, cv) is taken.
// Config 5b's three stages (c = C / 4) have their own. A dq tile stages k
// and v rows, a dk/dv tile q and dO rows, lse and D.
const Instance<DqKernel> kDqInstances[] = {
    {4, 16, 20, tattn_dq_kernel<4, 16>},    {6, 24, 30, tattn_dq_kernel<6, 24>},
    {8, 32, 40, tattn_dq_kernel<8, 32>},    {12, 48, 60, tattn_dq_kernel<12, 48>},
    {16, 48, 64, tattn_dq_kernel<16, 48>},
};
const Instance<DkvKernel> kDkvInstances[] = {
    {4, 16, 22, tattn_dkv_kernel<4, 16>},   {6, 24, 32, tattn_dkv_kernel<6, 24>},
    {8, 32, 42, tattn_dkv_kernel<8, 32>},   {12, 48, 62, tattn_dkv_kernel<12, 48>},
    {16, 48, 66, tattn_dkv_kernel<16, 48>},
};

// The instance of `table` for (c, cv), or null past the limits.
template <typename Kernel, size_t N>
const Instance<Kernel>* pick(const Instance<Kernel> (&table)[N], int c, int cv) {
  for (const Instance<Kernel>& instance : table)
    if (c <= instance.cq && cv <= instance.cv) return &instance;
  return nullptr;
}

template <typename Kernel>
size_t smem_bytes(const Instance<Kernel>& instance) {
  return static_cast<size_t>(kWarps) * kStages * instance.rows * kTile * sizeof(float);
}

template <typename Kernel, size_t N>
cudaError_t allow_smem_of(const Instance<Kernel> (&table)[N]) {
  for (const Instance<Kernel>& instance : table) {
    const size_t bytes = smem_bytes(instance);
    if (bytes <= kDefaultSmem) continue;
    const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(instance.kernel),
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Lets each instance that needs more than the default shared memory take it,
// once a device (as tattn.cu's allow_smem).
cudaError_t allow_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    cudaError_t set = allow_smem_of(kDqInstances);
    if (set == cudaSuccess) set = allow_smem_of(kDkvInstances);
    result[device] = set;
  });
  return result[device];
}

// The blocks a launch over BF rows of T frames takes (a warp each 32 frames
// of a row), or 0 past the limits.
unsigned blocks_for(int BF, int T) {
  if (BF < 1 || T < 1) return 0;
  const long long warps = static_cast<long long>(BF) * ((T + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  return blocks > 2147483647LL ? 0 : static_cast<unsigned>(blocks);
}

// info = registers and local (spill) bytes a thread, blocks an SM, threads a
// block, dynamic shared memory a block (bytes), frames a warp.
template <typename Kernel>
int instance_info(const Instance<Kernel>* instance, int* info) {
  if (instance == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = reinterpret_cast<const void*>(instance->kernel);
  const size_t bytes = smem_bytes(*instance);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = allow_smem();
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

const float* in(const void* p) { return static_cast<const float*>(p); }
float* out(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" {

// q, k, dq: f32 [BF, c, T]; v, dout: f32 [BF, cv, T]; lse, dd: f32 [BF, T].
// c <= 16, cv <= 48. window <= 0: no window (full causal).
int tattn_dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* dd, void* dq, int BF, int c, int cv, int T, int window, void* stream) {
  const Instance<DqKernel>* instance = pick(kDqInstances, c, cv);
  const unsigned blocks = blocks_for(BF, T);
  if (instance == nullptr || blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(c));
  instance->kernel<<<blocks, kThreads, smem_bytes(*instance), static_cast<cudaStream_t>(stream)>>>(
      in(q), in(k), in(v), in(dout), in(lse), in(dd), out(dq), BF, c, cv, T, window, kLog2e * scale, scale);
  return static_cast<int>(cudaGetLastError());
}

// As above; dk: f32 [BF, c, T], dv: f32 [BF, cv, T].
int tattn_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                  const void* dd, void* dk, void* dv, int BF, int c, int cv, int T, int window,
                  void* stream) {
  const Instance<DkvKernel>* instance = pick(kDkvInstances, c, cv);
  const unsigned blocks = blocks_for(BF, T);
  if (instance == nullptr || blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(c));
  instance->kernel<<<blocks, kThreads, smem_bytes(*instance), static_cast<cudaStream_t>(stream)>>>(
      in(q), in(k), in(v), in(dout), in(lse), in(dd), out(dk), out(dv), BF, c, cv, T, window, kLog2e * scale,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The dq instance that (c, cv) launches, on the current device: info as
// instance_info's, queries a warp last.
int tattn_dq_info(int c, int cv, int* info) { return instance_info(pick(kDqInstances, c, cv), info); }

// The dk/dv instance that (c, cv) launches, as tattn_dq_info (keys a warp last).
int tattn_dkv_info(int c, int cv, int* info) { return instance_info(pick(kDkvInstances, c, cv), info); }

}  // extern "C"
