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
// Read from the other side, the tap sum is
//   dwd[it, jf, c] = sum_{b, k, t} h1a[k, t] * dh2[k + 1 - jf, t + (2 - it) d]
// over the points of h1a: the same 9 neighbours of dh2 that dh1a takes, times
// the point's own h1a (both are zero outside [0, K) x [0, T), so the two sums
// take the same pairs). A point of phase B needs its own h1 and 9 neighbours
// of dh2, and nothing of h1 around it.
//
// What bounds them: bytes (two reads and one write of [B, K, C, T] each;
// about 10 and 60 operations a point).
//
// What the designs do about it. tail: a block owns one row (b, k, c) and
// walks its frames with lanes along T, so the channel's statistics are
// registers and the reads are coalesced; the row's sums go to part[row, :],
// and the caller adds the rows of a channel in f64.
//
// mid: a block owns a tile, one channel c of one batch item b, a group of kb
// bands and a span of tt frames (ops/tfcm_bwd_kernels.py::mid_plan picks kb
// and tt). It stages into shared memory dh2 of kb + 2 bands (one each side,
// zero outside [0, K)) over the tile's frames and the 2d after them, and h1 of
// its own bands, with 4-byte cp.async: a row of T = 626 floats is only 8-byte
// aligned and an odd T only 4-byte, and a tensor map (TMA) needs 16-byte
// strides. Then a thread owns a column of the tile and walks down its bands
// (kb <= kMaxBands, the loop unrolled) with a 3 x 3 window of dh2 in
// registers (3 new shared loads a point, whatever d), applies BN1 and PReLU1
// once a point, writes dh1n to device memory and keeps the 13 sums in
// registers. A tap past the last frame reads zero and nothing is padded, so
// T need not fill a tile and any dilation runs (mid_plan narrows the tile
// where 2d more frames a row would not fit). One f32 block sum a tile
// goes to part[c, :, tile], and mid_finish_kernel, launched after it by the
// same C call, adds each channel's tiles in f64 in a fixed order and writes
// dwd, dgamma1, dbeta1, dbd and da1 (over all channels): the sums do not
// depend on the order in which blocks run, and a call is two launches with
// nothing around them.
//
// The values that decide a PReLU's side are computed without fused
// multiply-adds, in the plain version's order (rsqrt(v + eps) as torch.rsqrt
// takes it), so the kernels take the same side of every point as the plain
// version does.
//
// Layouts: dh2a, h2, dh2n, dh2, h1, dh1n f32 [B, K, C, T]; stats f32 [4, C]
// (mean, rsqrt(var + eps), scale, bias); m1, v1, g1, be1 f32 [C]; slopes f32
// [1] on the device; wd f32 [3, 3, C]; tail part f32 [B * K * C, 4] (dgamma,
// dbeta, da, unused); mid part f32 [C, 13, tiles] (9 tap sums as it * 3 + jf,
// dgamma, dbeta, da, dbd); mid out f32 [12 C + 1] (dwd [3, 3, C], dgamma1 [C],
// dbeta1 [C], dbd [C], da1). All contiguous. Plain C interface (bound with
// ctypes): the launches are on the caller's stream, nothing is allocated
// here, and each entry returns cudaGetLastError() of its launches.

#include <cuda_runtime.h>

#include <algorithm>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMidThreads = 128;
constexpr int kMidWarps = kMidThreads / 32;
constexpr int kMidSums = 13;  // 9 tap sums (it * 3 + jf), dgamma, dbeta, da, dbd
constexpr int kMaxBands = 8;  // a tile's bands at most
constexpr int kFinishThreads = 256;
constexpr int kFinishWarps = kFinishThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

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

// 4-byte asynchronous copy from device to shared memory, and the wait for all
// of a thread's copies
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dh2 of one staged band at frames x + 2d, x + d, x (it = 0, 1, 2), from
// pointers p[it] to them; zero where the frame is past the last (in[it] false)
__device__ __forceinline__ void load_taps(const float* const (&p)[3], const bool (&in)[2], float (&v)[3]) {
  v[0] = in[0] ? *p[0] : 0.f;
  v[1] = in[1] ? *p[1] : 0.f;
  v[2] = *p[2];
}

__global__ void __launch_bounds__(kMidThreads)
mid_tile_kernel(const float* __restrict__ dh2, const float* __restrict__ h1,
                const float* __restrict__ wd, const float* __restrict__ m1,
                const float* __restrict__ v1, const float* __restrict__ g1,
                const float* __restrict__ be1, const float* __restrict__ slope, float eps,
                float* __restrict__ dh1n, float* __restrict__ part, int K, int C, int T, int d,
                int kb, int tt) {
  extern __shared__ float smem[];
  const int c = static_cast<int>(blockIdx.x % C);
  const int tile = static_cast<int>(blockIdx.x / C);  // (b * nk + kg) * nt + tg
  const int nt = (T + tt - 1) / tt, nk = (K + kb - 1) / kb;
  const int tg = tile % nt, kg = (tile / nt) % nk, b = tile / (nt * nk);
  const int t0 = tg * tt, k0 = kg * kb;
  const int nb = min(kb, K - k0), nf = min(tt, T - t0);  // the tile's own bands and frames
  const int lim = T - t0;                                 // the first tile frame past the last
  const int ws = min(tt + 2 * d, T);                      // a staged dh2 row's stride
  const int wv = min(tt + 2 * d, lim);                    // and the frames this tile stages
  float* g = smem;                                        // [nb + 2][ws]: bands k0 - 1 .. k0 + nb
  float* hs = smem + (kb + 2) * ws;                       // [nb][tt]: h1 of the own bands
  const long long band = static_cast<long long>(C) * T;
  const long long base = ((static_cast<long long>(b) * K + k0) * C + c) * T + t0;

  for (int r = 0; r < nb + 2; ++r) {
    float* dst = g + r * ws;
    const int k = k0 - 1 + r;
    if (k < 0 || k >= K) {
      for (int i = threadIdx.x; i < wv; i += kMidThreads) dst[i] = 0.f;
    } else {
      const float* src = dh2 + base + (r - 1) * band;
      for (int i = threadIdx.x; i < wv; i += kMidThreads) copy_async(dst + i, src + i);
    }
  }
  for (int r = 0; r < nb; ++r) {
    const float* src = h1 + base + r * band;
    for (int i = threadIdx.x; i < nf; i += kMidThreads) copy_async(hs + r * tt + i, src + i);
  }
  const Bn bn{m1[c], rsqrtf(__fadd_rn(v1[c], eps)), g1[c], be1[c], slope[0]};
  float w[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i / 3][i % 3] = wd[i * C + c];
  float s[kMidSums];
#pragma unroll
  for (int i = 0; i < kMidSums; ++i) s[i] = 0.f;

  copy_async_wait_all();
  __syncthreads();
  for (int x = threadIdx.x; x < nf; x += kMidThreads) {
    // the window: dh2 of bands k - 1 (lo), k (mi), k + 1 (hi), 3 taps each;
    // pointers walk down the staged rows, one row a band
    const bool in[2] = {x + 2 * d < lim, x + d < lim};
    const float* p[3] = {g + x + 2 * d, g + x + d, g + x};
    const float* hp = hs + x;
    float* out = dh1n + base + x;
    float lo[3], mi[3], hi[3];
    load_taps(p, in, lo);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] += ws;
    load_taps(p, in, mi);
#pragma unroll
    for (int r = 0; r < kMaxBands; ++r) {
      if (r == nb) break;
#pragma unroll
      for (int i = 0; i < 3; ++i) p[i] += ws;
      load_taps(p, in, hi);
      float acc = 0.f;  // dh1a = sum wd[it, jf] * dh2[k + 1 - jf, x + (2 - it) d]
#pragma unroll
      for (int it = 0; it < 3; ++it) {
        acc = fmaf(w[it][0], hi[it], acc);
        acc = fmaf(w[it][1], mi[it], acc);
        acc = fmaf(w[it][2], lo[it], acc);
      }
      const float xh = bn.xhat(*hp);
      const float hn = bn.norm(xh);
      const bool neg = hn < 0.f;
      const float ha = neg ? bn.a * hn : hn;
      const float dn = neg ? bn.a * acc : acc;
      *out = dn;
      hp += tt;
      out += band;
      s[9] = fmaf(dn, xh, s[9]);
      s[10] += dn;
      s[11] = fmaf(neg ? acc : 0.f, hn, s[11]);  // no branch: lanes of a warp take both sides
      s[12] += mi[2];
#pragma unroll
      for (int it = 0; it < 3; ++it) {
        s[it * 3] = fmaf(ha, hi[it], s[it * 3]);
        s[it * 3 + 1] = fmaf(ha, mi[it], s[it * 3 + 1]);
        s[it * 3 + 2] = fmaf(ha, lo[it], s[it * 3 + 2]);
        lo[it] = mi[it];
        mi[it] = hi[it];
      }
    }
  }
  const int tiles = static_cast<int>(gridDim.x / C);
  block_sum<kMidWarps>(s, part + static_cast<long long>(c) * kMidSums * tiles + tile, tiles);
}

// The sums over the tiles, in f64 in a fixed order: one warp a channel and
// sum (lanes along the tiles, then a shuffle tree) for output row o = 0 .. 10
// (part's column o) and row 11 (dbd, column 12), into out[o * C + c]; the last
// block adds column 11 (da) of every channel and tile into out[12 C] (a warp
// every kFinishWarps-th channel, lanes along the tiles, a shuffle tree, the
// warps in order).
__global__ void __launch_bounds__(kFinishThreads)
mid_finish_kernel(const float* __restrict__ part, int C, int tiles, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool da = blockIdx.x == gridDim.x - 1;
  const int item = static_cast<int>(blockIdx.x) * kFinishWarps + warp;
  if (!da && item >= 12 * C) return;  // a whole warp
  double acc = 0.0;
  if (da) {
    for (int c = warp; c < C; c += kFinishWarps) {
      const float* col = part + (static_cast<long long>(c) * kMidSums + 11) * tiles;
      for (int j = lane; j < tiles; j += 32) acc += col[j];
    }
  } else {
    const int c = item % C, o = item / C;
    const float* col = part + (static_cast<long long>(c) * kMidSums + (o == 11 ? 12 : o)) * tiles;
    for (int j = lane; j < tiles; j += 32) acc += col[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (!da) {
    if (lane == 0) out[item] = static_cast<float>(acc);  // item = o * C + c
    return;
  }
  __shared__ double warp_sums[kFinishWarps];
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kFinishWarps; ++w) total += warp_sums[w];
    out[12 * C] = static_cast<float>(total);
  }
}

// Shared memory of one tile block: dh2 of kb + 2 bands over min(tt + 2d, T)
// frames, and h1 of kb bands over tt frames (mid_smem_bytes in the wrapper).
size_t mid_smem_bytes(int kb, int tt, int T, int d) {
  const long long ws = std::min(static_cast<long long>(tt) + 2LL * d, static_cast<long long>(T));
  return static_cast<size_t>(4 * ((kb + 2) * ws + static_cast<long long>(kb) * tt));
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

int tfcm_mid_bwd_f32(const void* dh2, const void* h1, const void* wd, const void* m1, const void* v1,
                     const void* g1, const void* be1, const void* slope, float eps, void* dh1n,
                     void* part, void* out, int B, int K, int C, int T, int d, int kb, int tt,
                     void* stream) {
  if (bad_shape(B, K, C, T) || d < 1 || kb < 1 || kb > std::min(K, kMaxBands) || tt < 1 || tt > T)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(B) * ((K + kb - 1) / kb) * ((T + tt - 1) / tt);
  const size_t bytes = mid_smem_bytes(kb, tt, T, d);
  if (tiles * C > 2147483647LL || bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        mid_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mid_tile_kernel<<<static_cast<unsigned>(tiles * C), kMidThreads, bytes, s>>>(
      static_cast<const float*>(dh2), static_cast<const float*>(h1), static_cast<const float*>(wd),
      static_cast<const float*>(m1), static_cast<const float*>(v1), static_cast<const float*>(g1),
      static_cast<const float*>(be1), static_cast<const float*>(slope), eps,
      static_cast<float*>(dh1n), static_cast<float*>(part), K, C, T, d, kb, tt);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mid_finish_kernel<<<(12 * C + kFinishWarps - 1) / kFinishWarps + 1, kFinishThreads, 0, s>>>(
      static_cast<const float*>(part), C, static_cast<int>(tiles), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The tile kernel on the current device: registers and local (spill) bytes a
// thread, blocks an SM at `bytes` of shared memory, threads a block.
int tfcm_mid_tile_info(int bytes, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mid_tile_kernel);
  if (err == cudaSuccess && bytes > static_cast<int>(kDefaultSmem))
    err = cudaFuncSetAttribute(mid_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mid_tile_kernel, kMidThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  info[3] = kMidThreads;
  return 0;
}

}  // extern "C"
