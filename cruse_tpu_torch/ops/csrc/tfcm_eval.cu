// Eval-mode TFCM stack, one dilation layer a launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels cruse_tpu/ops/tfcm_kernel.py::
// fused_tfcm_stack_eval (body _stack_kernel) and fused_tfcm_block_eval (body
// _block_kernel). Per layer, with the BatchNorms folded into the convs on the
// host:
//
//   p1[k, o, t] = prelu(b1[o] + sum_c w1[c, o] * x[k, c, t], a1)
//   z[k, o, t]  = bd[o] + sum_{it, jf} wd[it, jf, o] * p1[k + jf - 1, o, t - (2 - it) * d]
//   y[k, o, t]  = x[k, o, t] + b2[o] + sum_c w2[c, o] * prelu(z[k, c, t], a2)
//
// where p1 is ZERO before t = 0 and outside the bands [0, K), as the
// reference zero-pads p1 (not x).
//
// What bounds it: FMAs. A layer costs 2C^2 + 9C multiply-adds a point
// (1,368 at C = 24, 5,040 at C = 48) on 8C bytes a point (x read, y
// written), near or above the card's f32 balance of ~10 FMA a byte.
//
// What the design does about it. The stack is launched one layer at a time
// (tfcm_eval_f32 makes the L launches), so a block needs only a one-layer
// halo, 1 band at each side and 2d frames before, and x passes between layers
// through device memory (the wrapper ping-pongs two buffers; a layer never
// reads the buffer it writes). A block owns kt bands x tt frames of one batch
// row and keeps only the layer's parameters and its p1 tile in shared
// memory, small enough for two blocks an SM, so one block's loads overlap
// another's arithmetic. The contractions are blocked in registers, so the
// shared-memory pipe (one warp-wide load a clock against four warp FMAs)
// does not set the pace alone:
//
// - phase 1 (p1 over the tile and its halo): a thread owns P positions,
//   strided by 32 over the flattened tile so a warp's loads are coalesced,
//   and one group of CO = C / G output channels. It walks the input channels,
//   reads x straight from device memory (CU channels ahead of use) and does
//   P x CO FMAs a channel against CO weight loads, each a warp-wide broadcast
//   used P times.
// - phase 2 (stencil, PReLU, second 1x1 conv, residual): a thread owns P
//   consecutive bands at one frame (lanes on consecutive frames: no bank
//   conflict) and a group of output channels. For each input channel c it
//   forms z for its P bands from 3 (P + 2) p1 loads (neighbouring bands share
//   taps), applies PReLU and at once adds w2[c][:] x p2 into P x CO
//   accumulators, so p2 is never held whole. The accumulators start from x
//   (read again, mostly from L2), so y = acc + b2 is written coalesced.
//
// Layouts: x, y float32 [B, K, C, T] contiguous; params float32 [L, NP] with
// NP = 2C^2 + 12C + 2: w1 [C][C] (in, out), b1 [C], wd [3][3][C], bd [C],
// w2 [C][C] (in, out), b2 [C], a1, a2. Plain C interface (bound with ctypes):
// pointers and the stream are void*, the launches are on the caller's
// stream, nothing is allocated here, and the entry returns the first error
// of its launches (or of an attribute call).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // blocks an SM the tiles are chosen for
constexpr int kSlack = 32;     // floats past the p1 tile that a ragged warp may read (and discard)
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// positions a thread owns, output-channel groups, channels x is fetched ahead
template <int C>
struct Blocking {
  static constexpr int P = C <= 12 ? 8 : 4;
  static constexpr int G = C >= 48 ? 2 : 1;
  static constexpr int CO = C / G;
  static constexpr int CU = 4;
  static constexpr int NP = 2 * C * C + 12 * C + 2;
  static constexpr int NP_PAD = (NP + 3) / 4 * 4;
};

// p1 tile bands: phase 2's band groups of P cover kt, plus the halo band at each side
inline int tile_bands(int kt, int p) { return (kt + p - 1) / p * p + 2; }

template <int C>
size_t smem_bytes(int kt, int tt, int d) {
  using S = Blocking<C>;
  return (static_cast<size_t>(S::NP_PAD) +
          static_cast<size_t>(tile_bands(kt, S::P)) * C * (tt + 2 * d) + kSlack) * sizeof(float);
}

__device__ __forceinline__ float prelu(float v, float a) { return v >= 0.f ? v : a * v; }

// x[c][p] = the CU channels from c0 at the thread's P positions (zero where src < 0)
template <int CU, int P>
__device__ __forceinline__ void load_channels(float (&v)[CU][P], const float* xb, const int (&src)[P], int c0,
                                              int T) {
#pragma unroll
  for (int cu = 0; cu < CU; ++cu)
#pragma unroll
    for (int p = 0; p < P; ++p) v[cu][p] = src[p] >= 0 ? __ldg(xb + src[p] + (c0 + cu) * T) : 0.f;
}

// acc[p][o] += w1[c0 + cu][o] x[cu][p] over the CU channels, CO outputs
template <int C, int CU, int P, int CO>
__device__ __forceinline__ void contract(float (&acc)[P][CO], const float (&v)[CU][P], const float* w1, int c0) {
#pragma unroll
  for (int cu = 0; cu < CU; ++cu) {
    const float* wr = w1 + (c0 + cu) * C;
#pragma unroll
    for (int o = 0; o < CO; ++o) {
      const float w = wr[o];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p][o] = fmaf(w, v[cu][p], acc[p][o]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tfcm_layer_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  float* __restrict__ y, int K, int T, int kt, int tt, int d) {
  using S = Blocking<C>;
  constexpr int P = S::P, G = S::G, CO = S::CO, CU = S::CU;
  extern __shared__ float smem[];
  const int TE = tt + 2 * d;  // tile frames, with the halo
  const int row = C * TE;     // one band of the p1 tile
  float* w_s = smem;              // [NP]: the layer's parameters
  float* p_s = smem + S::NP_PAD;  // [tile_bands][C][TE]: p1

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.y * kt;  // first band and frame of the block's own positions
  const int t0 = blockIdx.x * tt;
  const long long batch = static_cast<long long>(blockIdx.z) * K * C * T;
  const float* xb = x + batch;
  float* yb = y + batch;

  {
    // every parameter load of the thread in flight at once: one trip to L2
    constexpr int kLoads = (S::NP + kThreads - 1) / kThreads;
    float v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int at = threadIdx.x + i * kThreads;
      v[i] = at < S::NP ? __ldg(params + at) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      if (threadIdx.x + i * kThreads < S::NP) w_s[threadIdx.x + i * kThreads] = v[i];
  }
  __syncthreads();
  const float* w1 = w_s;
  const float* b1 = w1 + C * C;
  const float* wd = b1 + C;
  const float* bd = wd + 9 * C;
  const float* w2 = bd + C;
  const float* b2 = w2 + C * C;
  const float a1 = b2[C], a2 = b2[C + 1];

  // phase 1: p1 over tile bands [0, kt + 2) (global k0 - 1 + b) and frames
  // [0, TE) (global t0 - 2d + f); zero outside the sequence
  {
    const int n1 = (kt + 2) * TE;
    const int units = (n1 + 32 * P - 1) / (32 * P) * G;
    for (int u = warp; u < units; u += kWarps) {
      const int g = u % G, base = u / G * 32 * P;
      int src[P];  // offset of x[k][0][t] in the batch row, or -1: p1 is zero there
      int dst[P];  // offset of p1[b][0][f] in the tile, or -1: past the tile
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = base + lane + 32 * p;
        const int b = i / TE, f = i - b * TE;
        const int k = k0 - 1 + b, t = t0 - 2 * d + f;
        dst[p] = i < n1 ? b * row + f : -1;
        src[p] = (i < n1 && k >= 0 && k < K && t >= 0 && t < T) ? k * C * T + t : -1;
      }
      float acc[P][CO];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[p][o] = 0.f;
      // two register buffers in turn: the next CU channels are in flight
      // while the current ones are used
      float xa[CU][P], xz[CU][P];
      load_channels(xa, xb, src, 0, T);
      for (int c0 = 0; c0 < C; c0 += 2 * CU) {
        if (c0 + CU < C) load_channels(xz, xb, src, c0 + CU, T);
        contract<C>(acc, xa, w1 + g * CO, c0);
        if (c0 + CU >= C) break;
        if (c0 + 2 * CU < C) load_channels(xa, xb, src, c0 + 2 * CU, T);
        contract<C>(acc, xz, w1 + g * CO, c0 + CU);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (dst[p] < 0) continue;
#pragma unroll
        for (int o = 0; o < CO; ++o)
          p_s[dst[p] + (g * CO + o) * TE] = src[p] >= 0 ? prelu(acc[p][o] + b1[g * CO + o], a1) : 0.f;
      }
    }
  }
  __syncthreads();

  // phase 2: a thread's positions are tile bands kk0 .. kk0 + P - 1 at frame
  // ti; their taps are p1 bands kk0 .. kk0 + P + 1 at frames ti + it * d
  {
    const int chunks = (tt + 31) / 32;
    const int units = (kt + P - 1) / P * chunks * G;
    for (int u = warp; u < units; u += kWarps) {
      const int g = u % G, r = u / G;
      const int kk0 = r / chunks * P, ti = r % chunks * 32 + lane;
      const int t = t0 + ti;
      const float* taps = p_s + kk0 * row + ti;
      int at[P];  // offset of y[k][g * CO][t] in the batch row, or -1: not the block's
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + kk0 + j;
        at[j] = (ti < tt && t < T && kk0 + j < kt && k < K) ? (k * C + g * CO) * T + t : -1;
      }
      // the accumulators start from the residual, so its loads are in flight
      // during the first channels
      float acc[P][CO];
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int o = 0; o < CO; ++o) acc[j][o] = at[j] >= 0 ? __ldg(xb + at[j] + o * T) : 0.f;
      for (int c = 0; c < C; ++c) {
        float wt[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) wt[q] = wd[q * C + c];
        float z[P];
#pragma unroll
        for (int j = 0; j < P; ++j) z[j] = bd[c];
#pragma unroll
        for (int it = 0; it < 3; ++it) {
#pragma unroll
          for (int b = 0; b < P + 2; ++b) {
            const float v = taps[b * row + c * TE + it * d];
#pragma unroll
            for (int jf = 0; jf < 3; ++jf) {
              const int j = b - jf;
              if (j >= 0 && j < P) z[j] = fmaf(wt[it * 3 + jf], v, z[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < P; ++j) z[j] = prelu(z[j], a2);
        const float* wr = w2 + c * C + g * CO;
#pragma unroll
        for (int o = 0; o < CO; ++o) {
          const float w = wr[o];
#pragma unroll
          for (int j = 0; j < P; ++j) acc[j][o] = fmaf(w, z[j], acc[j][o]);
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (at[j] < 0) continue;
#pragma unroll
        for (int o = 0; o < CO; ++o) yb[at[j] + o * T] = acc[j][o] + b2[g * CO + o];
      }
    }
  }
}

template <int C>
int launch(const float* x, const float* params, float* y, int B, int K, int T, int d, int kt, int tt,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<C>(kt, tt, d);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        tfcm_layer_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((T + tt - 1) / tt, (K + kt - 1) / kt, B);
  tfcm_layer_kernel<C><<<grid, kThreads, bytes, stream>>>(x, params, y, K, T, kt, tt, d);
  return static_cast<int>(cudaGetLastError());
}

// info: registers a thread, local (spill) bytes a thread, blocks an SM at
// `bytes` of dynamic shared memory, threads a block
template <int C>
int describe(int bytes, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tfcm_layer_kernel<C>);
  if (err == cudaSuccess && bytes > static_cast<int>(kDefaultSmem))
    err = cudaFuncSetAttribute(tfcm_layer_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tfcm_layer_kernel<C>, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  info[3] = kThreads;
  return 0;
}

}  // namespace

extern "C" {

// srcs, dsts: L device pointers to f32 [B, K, C, T] contiguous (layer l reads
// srcs[l] and writes dsts[l], never the same buffer); params: f32
// [L, 2C^2 + 12C + 2] contiguous (folded on the host); dilations, kts, tts:
// L host ints, each layer's dilation and the band and time tile of its
// blocks (chosen by the caller to fit shared memory).
int tfcm_eval_f32(const void* const* srcs, const void* params, void* const* dsts, int B, int K, int C,
                  int T, int L, const int* dilations, const int* kts, const int* tts, void* stream) {
  const float* pf = static_cast<const float*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long np = 2LL * C * C + 12LL * C + 2;
  for (int l = 0; l < L; ++l) {
    const float* x = static_cast<const float*>(srcs[l]);
    float* y = static_cast<float*>(dsts[l]);
    const float* p = pf + l * np;
    const int d = dilations[l], kt = kts[l], tt = tts[l];
    if (d < 1 || kt < 1 || tt < 1 || x == y) return static_cast<int>(cudaErrorInvalidValue);
    int err;
    switch (C) {
      case 4: err = launch<4>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 8: err = launch<8>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 12: err = launch<12>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 16: err = launch<16>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 24: err = launch<24>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 32: err = launch<32>(x, p, y, B, K, T, d, kt, tt, s); break;
      case 48: err = launch<48>(x, p, y, B, K, T, d, kt, tt, s); break;
      default: err = static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  }
  return 0;
}

// The kernel instance for C: its registers, spills and blocks an SM at
// `bytes` of shared memory (see describe); returns a CUDA error or 0.
int tfcm_layer_info(int C, int bytes, int* info) {
  switch (C) {
    case 4: return describe<4>(bytes, info);
    case 8: return describe<8>(bytes, info);
    case 12: return describe<12>(bytes, info);
    case 16: return describe<16>(bytes, info);
    case 24: return describe<24>(bytes, info);
    case 32: return describe<32>(bytes, info);
    case 48: return describe<48>(bytes, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
