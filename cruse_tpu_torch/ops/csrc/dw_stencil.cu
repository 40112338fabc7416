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
// with g read as zero outside [0, K) x [0, T). Read from the other side, the
// tap sum is dwd[it, jf, c] = sum_{b, k, u} x[b, k, c, u] * g[b, k + 1 - jf, c,
// u - it * d] over the points of x: the nine g neighbours that give dx[k, u],
// times x[k, u]. So one pass over x and g gives both.
//
// What bounds them: bytes. Nine multiply-adds a point (18 with the tap sums)
// against 8 to 12 bytes a point of least traffic.
//
// What the designs do about it. A block owns a tile: one channel c of one
// batch item b, a group of kb bands and a span of tt frames (the forward's of
// y, the backward's of dx; ops/dw_kernel.py::dw_plan picks kb and tt). It
// walks down the group's rows one band at a time, from band k0 - 1 to k0 + kb
// (one band of halo each side, none read outside [0, K)), and stages each row
// in shared memory through a ring of kRing slots filled by cp.async: while
// the threads read one slot, the next kRing - 1 rows are in flight, so a row
// of x (and of g) comes from device memory once a tile, and only the halo
// bands and the 2d frames of the taps are read twice. The copy width (16, 8
// or 4 bytes) is the widest that the row stride and the base pointers allow,
// chosen per launch (a template instance each); a row of T = 626 floats is
// 8-byte aligned, T + 2d = 628 16-byte aligned, an odd T only 4-byte.
//
// A thread owns the frames x = threadIdx.x + j * kThreads (j < F, F =
// ceil(tt / kThreads) <= kFwdFrames or kBwdFrames) of the span, so a warp's shared reads and
// device stores touch consecutive words (no bank conflict whatever the tap's
// shift, 128 bytes a store instruction). A row at band q adds to three
// outputs: bands q + 1, q and q - 1 through the band taps jf = 0, 1, 2. So a
// thread keeps two running sums a frame (bands q and q + 1) and, at each new
// row, reads its three time taps, finishes band q - 1 and stores it: 3 shared
// reads and 9 multiply-adds an output, whatever d.
//
// The taps of a frame lie at t + it * d (forward, in x) or u - it * d
// (backward, in g). For d <= tt a row is staged as one run of tt + 2d frames;
// for d > tt as three runs of tt frames, one a tap, so shared memory stays
// under 3 tt floats a row at any dilation. Frames of g outside [0, T) are
// zeros written once into each slot (they sit at the same place in every row
// of a tile); cp.async never writes them.
//
// The backward's walk is the forward's with g in place of x and the taps
// mirrored; each slot also holds the row of x of the band below the g row
// (own bands only), and a thread keeps x of its frames at the two bands
// before in registers, so each point's nine products with g are taken from
// the same three tap reads as dx. Each block sums its nine tap sums (f32: a
// shuffle tree, then the warps in order) into part[c, :, tile];
// dw_finish_kernel, launched after it by the same C call, adds each
// channel's tiles in f64 in a fixed order. The sums do not depend on the
// order in which blocks run, no atomics are used, and a backward call is two
// launches.
//
// Layouts: x, dx f32 [B, K, C, T + 2d]; wd f32 [3, 3, C]; y, g f32 [B, K, C,
// T]; part f32 [C, 9, tiles] (it * 3 + jf); out f32 [3, 3, C]. All contiguous.
// Plain C interface (bound with ctypes): pointers and the stream are void*,
// the launches are on the caller's stream, nothing is allocated here, and each
// entry returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kFwdFrames = 5;  // frames a thread at most, forward: a span of kThreads * 5 = 640
constexpr int kBwdFrames = 6;  // and backward: 768, so dx's T + 2d = 642 frames at d = 8 are one span
constexpr int kRing = 4;       // ring slots: one read, kRing - 1 in flight
constexpr int kFinishThreads = 256;
constexpr int kFinishWarps = kFinishThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Floats a staged row of a span of `span` frames takes at dilation d: one run
// of span + 2d frames, or three runs of span frames (d > span), each with 6
// floats of slack for the copy width's rounding at both ends.
__host__ __device__ constexpr int row_floats(int span, int d) {
  return d <= span ? up4(span + 2 * d + 6) : 3 * up4(span + 6);
}

// A run of a source row staged in a slot: frames [lo, hi) are copied to
// slot[shift + f]; frames of the run outside the row are zero in the slot.
struct Run {
  int lo, hi, shift;
};

// Where a tile's row is staged and where each tap reads: the taps of the
// tile's frame x lie at source frames first + x + it * step (it = 0, 1, 2,
// step = d or -d, x < n), and tap it reads slot[x + off[it]]. `frames` is the
// source row's length (a multiple of V).
struct Staging {
  int runs;
  Run run[3];
  int off[3];
  int zero_lo[3], zero_hi[3];  // the run's frames outside the row: slot[zero_lo, lo + shift), [hi + shift, zero_hi)
};

template <int V>
__device__ void add_run(Staging& st, int r, int start, int end, int at, int frames) {
  const int from = start & ~(V - 1);             // floor to a multiple of V, negative too
  const int to = (end + V - 1) & ~(V - 1);
  const int lo = min(max(from, 0), to), hi = max(min(to, frames), lo);
  st.run[r] = Run{lo, hi, at - from};
  st.zero_lo[r] = at;
  st.zero_hi[r] = at + to - from;
}

template <int V>
__device__ Staging staging(int first, int step, int n, int span, int d, int frames) {
  Staging st;
  if (d <= span) {
    const int start = min(first, first + 2 * step);
    st.runs = 1;
    add_run<V>(st, 0, start, start + 2 * d + n, 0, frames);
#pragma unroll
    for (int it = 0; it < 3; ++it) st.off[it] = first + it * step + st.run[0].shift;
  } else {
    const int cap = up4(span + 6);
    st.runs = 3;
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      add_run<V>(st, it, first + it * step, first + it * step + n, it * cap, frames);
      st.off[it] = first + it * step + st.run[it].shift;
    }
  }
  return st;
}

// V floats (4 V bytes) from device to shared memory, asynchronously
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src), "n"(4 * V) : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int V>
__device__ __forceinline__ void stage_row(float* slot, const float* row, const Staging& st) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r == st.runs) break;
    for (int f = st.run[r].lo + static_cast<int>(threadIdx.x) * V; f < st.run[r].hi; f += kThreads * V)
      copy_async<V>(slot + st.run[r].shift + f, row + f);
  }
}

// The tile of block blockIdx.x: channel c fastest, then (b, band group, span)
struct Tile {
  int c, tile, b, k0, nb, f0, nf;
};

__device__ Tile tile_of(int K, int C, int frames, int kb, int span) {
  Tile t;
  t.c = static_cast<int>(blockIdx.x % C);
  t.tile = static_cast<int>(blockIdx.x / C);  // (b * nk + kg) * nt + tg
  const int nt = (frames + span - 1) / span, nk = (K + kb - 1) / kb;
  const int tg = t.tile % nt, kg = (t.tile / nt) % nk;
  t.b = t.tile / (nt * nk);
  t.k0 = kg * kb;
  t.nb = min(kb, K - t.k0);
  t.f0 = tg * span;
  t.nf = min(span, frames - t.f0);
  return t;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wd, float* __restrict__ y,
              int K, int C, int T, int d, int kb, int tt) {
  extern __shared__ __align__(16) float smem[];
  const int Te = T + 2 * d;
  const Tile tl = tile_of(K, C, T, kb, tt);
  const int slot_floats = row_floats(tt, d);
  const Staging st = staging<V>(tl.f0, d, tl.nf, tt, d, Te);
  const long long band_x = static_cast<long long>(C) * Te, band_y = static_cast<long long>(C) * T;
  const float* src = x + (static_cast<long long>(tl.b) * K * C + tl.c) * Te;  // band 0 of (b, c)
  float* dst = y + ((static_cast<long long>(tl.b) * K + tl.k0) * C + tl.c) * T + tl.f0;  // band k0
  const int rows = tl.nb + 2;  // bands k0 - 1 .. k0 + nb

  auto issue = [&](int s) {  // row s (band k0 - 1 + s) into its slot, one commit group
    const int q = tl.k0 - 1 + s;
    if (s < rows && q >= 0 && q < K) stage_row<V>(smem + (s % kRing) * slot_floats, src + q * band_x, st);
    copy_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = wd[i * C + tl.c];  // w[it * 3 + jf]
  const int nf = tl.nf, F = (tt + kThreads - 1) / kThreads;  // <= kFwdFrames
  float a[kFwdFrames], b[kFwdFrames];  // running y of bands q and q + 1
#pragma unroll
  for (int j = 0; j < kFwdFrames; ++j) a[j] = b[j] = 0.f;

  for (int s = 0; s < rows; ++s) {
    copy_wait<kRing - 2>();  // row s has landed (each later row is one group)
    __syncthreads();         // for every thread; and slot (s - 1) % kRing is read out
    issue(s + kRing - 1);
    const int q = tl.k0 - 1 + s;
    const bool live = q >= 0 && q < K;
    const float* row = smem + (s % kRing) * slot_floats;
    float* out = dst + (s - 2) * band_y;  // band q - 1
#pragma unroll
    for (int j = 0; j < kFwdFrames; ++j) {
      if (j == F) break;
      const int xj = static_cast<int>(threadIdx.x) + j * kThreads;
      if (xj >= nf) break;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      if (live) {
        v0 = row[xj + st.off[0]];
        v1 = row[xj + st.off[1]];
        v2 = row[xj + st.off[2]];
      }
      const float done = fmaf(w[8], v2, fmaf(w[5], v1, fmaf(w[2], v0, a[j])));  // jf = 2: band q - 1
      if (s >= 2) out[xj] = done;
      a[j] = fmaf(w[7], v2, fmaf(w[4], v1, fmaf(w[1], v0, b[j])));  // jf = 1: band q
      b[j] = fmaf(w[6], v2, fmaf(w[3], v1, w[0] * v0));              // jf = 0: band q + 1
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
              const float* __restrict__ wd, float* __restrict__ dx, float* __restrict__ part,
              int K, int C, int T, int d, int kb, int tu) {
  extern __shared__ __align__(16) float smem[];
  const int Te = T + 2 * d;
  const Tile tl = tile_of(K, C, Te, kb, tu);
  const int g_floats = row_floats(tu, d), slot_floats = g_floats + tu + 4;
  const Staging st = staging<V>(tl.f0, -d, tl.nf, tu, d, T);  // g's taps of dx frame u: u - it d
  Staging sx;  // x of the tile's own frames, after g in the slot
  sx.runs = 1;
  add_run<V>(sx, 0, tl.f0, tl.f0 + tl.nf, g_floats, Te);
  const long long band_g = static_cast<long long>(C) * T, band_x = static_cast<long long>(C) * Te;
  const long long bc = static_cast<long long>(tl.b) * K * C + tl.c;
  const float* gsrc = g + bc * T;
  const float* xsrc = x + bc * Te;
  float* dst = dx + (bc + static_cast<long long>(tl.k0) * C) * Te + tl.f0;  // band k0
  const int rows = tl.nb + 2;  // g of bands k0 - 1 .. k0 + nb; x of bands k0 .. k0 + nb - 1

  // g's frames outside [0, T): zero in every slot, once
  for (int i = 0; i < kRing; ++i) {
    float* slot = smem + i * slot_floats;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r == st.runs) break;
      const Run& run = st.run[r];
      for (int p = st.zero_lo[r] + static_cast<int>(threadIdx.x); p < run.lo + run.shift; p += kThreads)
        slot[p] = 0.f;
      for (int p = run.hi + run.shift + static_cast<int>(threadIdx.x); p < st.zero_hi[r]; p += kThreads)
        slot[p] = 0.f;
    }
  }
  auto issue = [&](int s) {  // g of band k0 - 1 + s and x of band k0 + s, one commit group
    float* slot = smem + (s % kRing) * slot_floats;
    const int q = tl.k0 - 1 + s;
    if (s < rows && q >= 0 && q < K) stage_row<V>(slot, gsrc + q * band_g, st);
    if (s < tl.nb) stage_row<V>(slot, xsrc + (q + 1) * band_x, sx);
    copy_commit();
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);

  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = wd[i * C + tl.c];
  float sum[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) sum[i] = 0.f;
  const int nf = tl.nf, F = (tu + kThreads - 1) / kThreads;  // <= kBwdFrames
  float a[kBwdFrames], b[kBwdFrames];    // running dx of bands q and q + 1
  float x0[kBwdFrames], x1[kBwdFrames];  // x of bands q - 1 and q (zero outside the own bands)
#pragma unroll
  for (int j = 0; j < kBwdFrames; ++j) a[j] = b[j] = x0[j] = x1[j] = 0.f;

  for (int s = 0; s < rows; ++s) {
    copy_wait<kRing - 2>();
    __syncthreads();
    issue(s + kRing - 1);
    const int q = tl.k0 - 1 + s;
    const bool live = q >= 0 && q < K, own = s < tl.nb;
    const float* grow = smem + (s % kRing) * slot_floats;
    const float* xrow = grow + g_floats;
    float* out = dst + (s - 2) * band_x;  // band q - 1
#pragma unroll
    for (int j = 0; j < kBwdFrames; ++j) {
      if (j == F) break;
      const int xj = static_cast<int>(threadIdx.x) + j * kThreads;
      if (xj >= nf) break;
      float g0 = 0.f, g1 = 0.f, g2 = 0.f;
      if (live) {
        g0 = grow[xj + st.off[0]];
        g1 = grow[xj + st.off[1]];
        g2 = grow[xj + st.off[2]];
      }
      const float x2 = own ? xrow[xj] : 0.f;  // x of band q + 1
      const float done = fmaf(w[6], g2, fmaf(w[3], g1, fmaf(w[0], g0, a[j])));  // jf = 0: band q - 1
      if (s >= 2) out[xj] = done;
      a[j] = fmaf(w[7], g2, fmaf(w[4], g1, fmaf(w[1], g0, b[j])));  // jf = 1: band q
      b[j] = fmaf(w[8], g2, fmaf(w[5], g1, w[2] * g0));              // jf = 2: band q + 1
      const float gv[3] = {g0, g1, g2};
#pragma unroll
      for (int it = 0; it < 3; ++it) {  // x[k, u] g[k + 1 - jf, u - it d] at k = q - 1 + jf
        sum[it * 3] = fmaf(x0[j], gv[it], sum[it * 3]);
        sum[it * 3 + 1] = fmaf(x1[j], gv[it], sum[it * 3 + 1]);
        sum[it * 3 + 2] = fmaf(x2, gv[it], sum[it * 3 + 2]);
      }
      x0[j] = x1[j];
      x1[j] = x2;
    }
  }
  const int tiles = static_cast<int>(gridDim.x / C);
  block_sum<kWarps>(sum, part + static_cast<long long>(tl.c) * 9 * tiles + tl.tile, tiles);
}

// The tap sums over the tiles, in f64 in a fixed order: one warp a (tap, c),
// lanes along the tiles, then a shuffle tree, into out[tap * C + c].
__global__ void __launch_bounds__(kFinishThreads)
dw_finish_kernel(const float* __restrict__ part, int C, int tiles, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int item = static_cast<int>(blockIdx.x) * kFinishWarps + static_cast<int>(threadIdx.x >> 5);
  if (item >= 9 * C) return;  // a whole warp
  const int c = item % C, tap = item / C;
  const float* col = part + (static_cast<long long>(c) * 9 + tap) * tiles;
  double acc = 0.0;
  for (int j = lane; j < tiles; j += 32) acc += col[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[item] = static_cast<float>(acc);
}

// The widest copy (floats) that every row start allows: each pointer aligned
// to it and each row stride a multiple of it.
int vector_floats(std::initializer_list<const void*> ptrs, std::initializer_list<long long> strides) {
  for (int v : {4, 2}) {
    bool ok = true;
    for (const void* p : ptrs) ok = ok && reinterpret_cast<std::uintptr_t>(p) % (4 * v) == 0;
    for (long long s : strides) ok = ok && s % v == 0;
    if (ok) return v;
  }
  return 1;
}

size_t fwd_smem_bytes(int tt, int d) { return 4 * static_cast<size_t>(kRing) * row_floats(tt, d); }
size_t bwd_smem_bytes(int tu, int d) { return 4 * static_cast<size_t>(kRing) * (row_floats(tu, d) + tu + 4); }

bool bad_tile(long long B, int K, int C, int T, int d, int kb, int span, int frames_a_thread) {
  if (B < 1 || K < 1 || C < 1 || T < 1 || d < 1 || kb < 1 || kb > K || span < 4 || span % 4 != 0 ||
      span > kThreads * frames_a_thread || static_cast<long long>(T) + 2LL * d > 2147483647LL)
    return true;
  const long long frames = static_cast<long long>(T) + 2LL * d;  // the backward's, the longer
  return B * ((K + kb - 1) / kb) * ((frames + span - 1) / span) * C > 2147483647LL;
}

// Lets `kernel` take `bytes` of dynamic shared memory.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename Kernel>
int kernel_info(Kernel kernel, size_t bytes, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = static_cast<cudaError_t>(allow_smem(kernel, bytes));
  if (err == cudaSuccess) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, bytes);
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.localSizeBytes);
    info[2] = blocks;
    info[3] = kThreads;
  }
  return static_cast<int>(err);
}

template <int V>
int launch_fwd(const float* x, const float* wd, float* y, int B, int K, int C, int T, int d, int kb, int tt,
               cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes(tt, d);
  const int err = allow_smem(dw_fwd_kernel<V>, bytes);
  if (err != 0) return err;
  const long long blocks = static_cast<long long>(B) * ((K + kb - 1) / kb) * ((T + tt - 1) / tt) * C;
  dw_fwd_kernel<V><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(x, wd, y, K, C, T, d, kb, tt);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_bwd(const float* g, const float* x, const float* wd, float* dx, float* part, float* out, int B, int K,
               int C, int T, int d, int kb, int tu, cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes(tu, d);
  const int err = allow_smem(dw_bwd_kernel<V>, bytes);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>(B) * ((K + kb - 1) / kb) * ((T + 2LL * d + tu - 1) / tu);
  dw_bwd_kernel<V><<<static_cast<unsigned>(tiles * C), kThreads, bytes, stream>>>(g, x, wd, dx, part, K, C, T, d,
                                                                                  kb, tu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dw_finish_kernel<<<(9 * C + kFinishWarps - 1) / kFinishWarps, kFinishThreads, 0, stream>>>(
      part, C, static_cast<int>(tiles), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: f32 [B, K, C, T + 2d]; wd: f32 [3, 3, C]; y: f32 [B, K, C, T]; the tile:
// kb bands (1..K) x tt frames (a multiple of 4, at most 640).
int dw_stencil_fwd_f32(const void* x, const void* wd, void* y, int B, int K, int C, int T, int d, int kb, int tt,
                       void* stream) {
  if (bad_tile(B, K, C, T, d, kb, tt, kFwdFrames) || fwd_smem_bytes(tt, d) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(wd);
  auto* yp = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vector_floats({x}, {T + 2LL * d})) {
    case 4: return launch_fwd<4>(xp, wp, yp, B, K, C, T, d, kb, tt, s);
    case 2: return launch_fwd<2>(xp, wp, yp, B, K, C, T, d, kb, tt, s);
    default: return launch_fwd<1>(xp, wp, yp, B, K, C, T, d, kb, tt, s);
  }
}

// g: f32 [B, K, C, T]; x: f32 [B, K, C, T + 2d]; wd: f32 [3, 3, C]; dx: f32
// [B, K, C, T + 2d]; part: f32 [C, 9, tiles] (tiles = B ceil(K / kb) ceil((T
// + 2d) / tu)); out: f32 [3, 3, C], the tap sums. The tile: kb bands x tu
// frames of dx (a multiple of 4, at most 768). Two launches.
int dw_stencil_bwd_f32(const void* g, const void* x, const void* wd, void* dx, void* part, void* out, int B,
                       int K, int C, int T, int d, int kb, int tu, void* stream) {
  if (bad_tile(B, K, C, T, d, kb, tu, kBwdFrames) || bwd_smem_bytes(tu, d) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* gp = static_cast<const float*>(g);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(wd);
  auto* dp = static_cast<float*>(dx);
  auto* pp = static_cast<float*>(part);
  auto* op = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vector_floats({g, x}, {T, T + 2LL * d})) {
    case 4: return launch_bwd<4>(gp, xp, wp, dp, pp, op, B, K, C, T, d, kb, tu, s);
    case 2: return launch_bwd<2>(gp, xp, wp, dp, pp, op, B, K, C, T, d, kb, tu, s);
    default: return launch_bwd<1>(gp, xp, wp, dp, pp, op, B, K, C, T, d, kb, tu, s);
  }
}

// The instance of the forward (backward = 0) or backward (1) kernel with
// `vec` floats a copy (1, 2, 4) on the current device: registers and local
// (spill) bytes a thread, blocks an SM at `bytes` of shared memory, threads
// a block.
int dw_stencil_info(int backward, int vec, int bytes, int* info) {
  if (bytes < 0 || static_cast<size_t>(bytes) > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(bytes);
  switch ((backward ? 8 : 0) + vec) {
    case 1: return kernel_info(dw_fwd_kernel<1>, n, info);
    case 2: return kernel_info(dw_fwd_kernel<2>, n, info);
    case 4: return kernel_info(dw_fwd_kernel<4>, n, info);
    case 9: return kernel_info(dw_bwd_kernel<1>, n, info);
    case 10: return kernel_info(dw_bwd_kernel<2>, n, info);
    case 12: return kernel_info(dw_bwd_kernel<4>, n, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
