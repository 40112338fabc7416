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
// Step t + 1 needs all of step t's hidden state, so the T steps are strictly
// sequential, and each step is a small [BT, H] x [H, 3H] product per group.
// Run as plain PyTorch, every step costs a dozen launches. Both kernels here
// run all T steps in ONE launch: batch rows and groups are independent for
// the whole sequence, so a block (or a cluster of blocks) loops over time on
// its own rows of one group, a thread keeps the state of its hidden unit in
// registers and does all three gates of it, and the state is shared through
// a double-buffered [H][rows] tile in shared memory, one barrier a step. With
// bf16 weights the state is rounded to bf16 before the product (as the TPU
// kernel does), and products and sums stay f32. Accurate expf/tanhf: no
// fast-math. The two kernels differ in where the recurrent weight lives.
//
// gru_resident_kernel: the weight stays in shared memory for all T steps.
//   A cluster of CS blocks owns (group, 16 batch rows); block c of it owns the
//   hidden units [c*U, (c+1)*U), U = ceil(H / CS) rounded up to a multiple of
//   4, and loads its slice of the weight, [H][3][U] (packed on the host as
//   [G, CS, H, 3, U]), once, before the time loop. Every block keeps the whole
//   state tile [2][H][16]; after a step each thread stores its unit's new
//   state into that tile of every block of the cluster (distributed shared
//   memory), then one cluster barrier, split into arrive and wait with the y
//   store and the next step's x_proj loads between them. At config 1 (H = 176,
//   f32): CS = 2, U = 88, 186 KB of weights + 22 KB of state a block, grid
//   4 groups x 2 x 16 row tiles = 128 blocks of 352 threads. What bounds it:
//   the step's f32 multiply-adds (the product is blocked in registers so that
//   shared memory feeds them fast enough, see the kernel), then what is serial
//   in a step: the shuffle rounds that add the k parts, the gates, the cluster
//   barrier. Measured on an H100 at B=256, T=1001: 7.1 us a step, of which the
//   product 3.4 (its FMA floor 2.9), the gates 0.4, the remote stores and the
//   cluster barrier 0.3, the x loads and y stores 0.4. It takes the shapes
//   whose slice fits 227 KB with CS <= 8 and U <= 96 (f32: H <= ~350; bf16:
//   H <= ~475), at any T, which ops/gru_kernel.py::resident_plan decides.
//
// gru_sequence_kernel: the general-shape kernel (any H <= 512). One block
//   owns (group, 8 rows), thread j owns unit j, and the group's transposed
//   weight [H, 3H] is streamed every step through the read-only cache: at
//   config 1 that is 371 KB a block a step out of L2, more than an SM's L1,
//   so what bounds it is L2 latency and bandwidth (about 41 us a step), not
//   arithmetic. It takes the shapes the resident kernel cannot hold (and
//   would take sequences shorter than the resident kernel's least T, which
//   the measurements put at 1: at T = 1 the resident kernel takes 17-18 us on
//   the card, this one 45-46).
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// each entry returns the error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;            // streamed kernel: batch rows per block
constexpr int kMaxThreads = 512;    // streamed kernel: one thread per hidden unit, H <= 512
constexpr int kTile = 16;           // resident kernel: batch rows per cluster
constexpr int kHalf = kTile / 2;    // resident kernel: rows a thread multiplies
constexpr int kQuad = 4;            // resident kernel: rows a thread keeps the state of
constexpr int kUnits = 4;           // resident kernel: units a thread multiplies
constexpr int kSplit = 8;           // resident kernel: parts of the k range, one a lane
constexpr int kResidentThreads = 384;          // resident kernel: 4 threads a unit, U <= 96
constexpr size_t kSharedLimit = 232448;        // dynamic shared memory a block may have on sm_90
constexpr int kMaxDevices = 64;                // devices whose shared-memory grant is remembered

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

// The cluster barrier in its two halves. Every thread of every block of the
// cluster executes both, outside divergent code.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Four consecutive weights of one gate, as floats.
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);  // bf16 is the high half of an f32
  w[0] = __uint_as_float(v.x << 16), w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16), w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// One round of the sum over the k parts: the lane and its partner (lane ^ mask)
// each hold partial sums of the same 2N outputs; the lane keeps the upper or
// the lower N, adds the partner's partial sums of those, and gives the others
// away. After log2(kSplit) rounds every output is summed on exactly one lane.
template <int N>
__device__ __forceinline__ void halve(const float (&in)[2 * N], float (&out)[N], bool upper,
                                      int mask) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? in[i] : in[i + N];
    const float keep = upper ? in[i + N] : in[i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// x_proj [B, T, G, 3H], h0 [B, G, H], w_packed [G, CS, H, 3, U] (block c's
// slice [k][gate][u] holds w_hh[g, gate * H + c * U + u, k], zero where
// c * U + u >= H; U a multiple of 4), b_hh [G, 3H]; y [B, T, G, H],
// h_last [B, G, H]. Grid (CS * G, ceil(B / kTile)) in clusters of (CS, 1, 1).
//
// The product of a step is blocked in registers: a thread does 4 units x 8
// rows x 3 gates (96 sums) over every 8th k, so that a 16-byte load from
// shared memory feeds 24 or 12 multiply-adds and the FMA pipe, not the
// shared-memory pipe, is the limit. A warp is 8 k parts x 2 unit groups x 2
// row halves; the 8 partial sums of an output meet in three shuffle rounds
// that leave each lane with one unit x 4 rows x 3 gates, whose gates it
// computes and whose state it keeps in registers. The state tile is laid out
// [4 row quads][H][4 rows], so that the lanes of a quarter warp (4 k parts x 2
// unit groups) read 64 consecutive bytes of it and 128 of the weight.
template <typename W, int CS>
__global__ void __launch_bounds__(kResidentThreads)
gru_resident_kernel(const float* __restrict__ x_proj, const float* __restrict__ h0,
                    const W* __restrict__ w_packed, const float* __restrict__ b_hh,
                    float* __restrict__ y, float* __restrict__ h_last,
                    int B, int T, int G, int H, int U) {
  extern __shared__ float4 smem[];
  const size_t slice = static_cast<size_t>(H) * 3 * U;  // weights of this block
  W* wsm = reinterpret_cast<W*>(smem);                   // [H][3][U]
  float* hq = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + align16(slice * sizeof(W)));
  const int quad_stride = H * kQuad;                     // hq is [2][kTile / kQuad][H][kQuad]
  const int tile = H * kTile;

  int rank = 0;
  float* peers[CS];
  peers[0] = hq;
  if constexpr (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int c = 0; c < CS; ++c) peers[c] = cluster.map_shared_rank(hq, c);
  }
  const int g = blockIdx.x / CS;
  const int b0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // lane bits: 0, 1 and 4 the k part; 2 the unit group of the warp's two; 3 the row half
  const bool k0 = lane & 1, k1 = lane & 2, k2 = lane & 16;
  const int part = (lane & 3) + (k2 ? 4 : 0);
  const int group = 2 * (tid >> 5) + ((lane >> 2) & 1);  // units 4 * group .. 4 * group + 3 of the block
  const int half = (lane >> 3) & 1;                      // rows 8 * half .. 8 * half + 7 of the tile
  const bool loads = kUnits * group < U;
  // after the three rounds: unit 2 * k0 + k1 of the group, row quad 2 * half + k2 of the tile
  const int u = kUnits * group + 2 * k0 + k1;
  const int j = rank * U + u;  // this lane's hidden unit
  const bool active = u < U && j < H;
  const int quad = 2 * half + k2;
  const int row0 = b0 + kQuad * quad;  // this lane's first batch row
  const int H3 = 3 * H;

  // this block's slice of the weight, once: 16 bytes a load where it can be
  const W* wsrc = w_packed + (static_cast<size_t>(g) * CS + rank) * slice;
  if ((slice * sizeof(W)) % 16 == 0) {
    const int n16 = static_cast<int>(slice * sizeof(W) / 16);
    const float4* src = reinterpret_cast<const float4*>(wsrc);
#pragma unroll 8
    for (int i = tid; i < n16; i += blockDim.x) smem[i] = __ldg(src + i);
  } else {
    for (int i = tid; i < static_cast<int>(slice); i += blockDim.x) wsm[i] = wsrc[i];
  }
  // the whole state tile of step 0, every unit of the group: each block its own
  for (int i = tid; i < tile; i += blockDim.x) {
    const int r = i / H, k = i - r * H;
    const int b = b0 + r;
    hq[(r / kQuad) * quad_stride + k * kQuad + r % kQuad] =
        b < B ? product_operand<W>(h0[(static_cast<size_t>(b) * G + g) * H + k]) : 0.f;
  }

  float h[kQuad];
  float xr[kQuad], xz[kQuad], xn[kQuad];
  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  if (active) {
    bias_r = b_hh[g * H3 + j];
    bias_z = b_hh[g * H3 + H + j];
    bias_n = b_hh[g * H3 + 2 * H + j];
#pragma unroll
    for (int r = 0; r < kQuad; ++r) {
      const int b = row0 + r;
      h[r] = b < B ? h0[(static_cast<size_t>(b) * G + g) * H + j] : 0.f;
      if (b < B) {
        const float* xp = x_proj + (static_cast<size_t>(b) * T * G + g) * H3;  // t = 0
        xr[r] = xp[j];
        xz[r] = xp[H + j];
        xn[r] = xp[2 * H + j];
      } else {
        xr[r] = xz[r] = xn[r] = 0.f;
      }
    }
  }
  // weights and state in place; and no store into a peer before it has started
  if constexpr (CS > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  for (int t = 0; t < T; ++t) {
    // partial sums over k = part, part + 8, ...: index 8 * unit + row
    float acc_r[kUnits * kHalf], acc_z[kUnits * kHalf], acc_n[kUnits * kHalf];
#pragma unroll
    for (int i = 0; i < kUnits * kHalf; ++i) acc_r[i] = acc_z[i] = acc_n[i] = 0.f;
    if (loads) {
      const float* cur = hq + (t & 1) * tile + 2 * half * quad_stride;
      const W* wg = wsm + kUnits * group;
#pragma unroll 1  // measured: 2 is 1 % slower, 4 is 35 % slower
      for (int k = part; k < H; k += kSplit) {
        const W* wk = wg + static_cast<size_t>(k) * 3 * U;
        float wr[kUnits], wz[kUnits], wn[kUnits];
        load4(wk, wr);
        load4(wk + U, wz);
        load4(wk + 2 * U, wn);
        const float4 lo = *reinterpret_cast<const float4*>(cur + k * kQuad);
        const float4 hi = *reinterpret_cast<const float4*>(cur + quad_stride + k * kQuad);
        const float hv[kHalf] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int v = 0; v < kUnits; ++v) {
#pragma unroll
          for (int r = 0; r < kHalf; ++r) {
            acc_r[kHalf * v + r] = fmaf(hv[r], wr[v], acc_r[kHalf * v + r]);
            acc_z[kHalf * v + r] = fmaf(hv[r], wz[v], acc_z[kHalf * v + r]);
            acc_n[kHalf * v + r] = fmaf(hv[r], wn[v], acc_n[kHalf * v + r]);
          }
        }
      }
    }
    // every lane of every warp takes part: 32 -> 16 (units), 16 -> 8 (unit), 8 -> 4 (rows)
    float sum_r[kQuad], sum_z[kQuad], sum_n[kQuad];
    {
      float a16[16], a8[8];
      halve<16>(acc_r, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_r, k2, 16);
      halve<16>(acc_z, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_z, k2, 16);
      halve<16>(acc_n, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_n, k2, 16);
    }

    if (active) {
      float out[kQuad];
#pragma unroll
      for (int r = 0; r < kQuad; ++r) {
        const float rg = sigmoid(xr[r] + (sum_r[r] + bias_r));
        const float zg = sigmoid(xz[r] + (sum_z[r] + bias_z));
        const float ng = tanhf(xn[r] + rg * (sum_n[r] + bias_n));
        h[r] = (1.f - zg) * ng + zg * h[r];
        out[r] = product_operand<W>(h[r]);
      }
      // the new state of this unit into the next tile of every block of the cluster
      const int at = ((t + 1) & 1) * tile + quad * quad_stride + j * kQuad;
#pragma unroll
      for (int c = 0; c < CS; ++c)
        *reinterpret_cast<float4*>(peers[c] + at) = make_float4(out[0], out[1], out[2], out[3]);
    }
    // One barrier a step. A block stores into tile t & 1 at step t + 1 only
    // after this step's wait, which every peer's arrive precedes, and a peer
    // arrives only after its reads of that tile. Between arrive and wait: the
    // y store and the next step's input projections, whose latency the wait
    // and the next product hide.
    if constexpr (CS > 1) cluster_arrive();
    if (active) {
#pragma unroll
      for (int r = 0; r < kQuad; ++r) {
        const int b = row0 + r;
        if (b < B) {
          y[((static_cast<size_t>(b) * T + t) * G + g) * H + j] = h[r];
          if (t + 1 < T) {
            const float* xp = x_proj + ((static_cast<size_t>(b) * T + t + 1) * G + g) * H3;
            xr[r] = xp[j];
            xz[r] = xp[H + j];
            xn[r] = xp[2 * H + j];
          }
        }
      }
    }
    // after the last step's wait no peer stores into this block any more
    if constexpr (CS > 1) {
      cluster_wait();
    } else {
      __syncthreads();
    }
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < kQuad; ++r) {
      const int b = row0 + r;
      if (b < B) h_last[(static_cast<size_t>(b) * G + g) * H + j] = h[r];
    }
  }
}

template <typename W, int CS>
int launch_resident(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                    void* y, void* h_last, int B, int T, int G, int H, void* stream) {
  const int U = ((H + CS - 1) / CS + kUnits - 1) / kUnits * kUnits;
  const int threads = (U / kUnits * 2 * kSplit + 31) / 32 * 32;
  const size_t smem = align16(static_cast<size_t>(H) * 3 * U * sizeof(W)) +
                      2 * static_cast<size_t>(H) * kTile * sizeof(float);
  if (threads > kResidentThreads || smem > kSharedLimit) return cudaErrorInvalidValue;
  // the shared-memory grant is asked for once a device and size, not on every
  // launch: a streaming hop (T = 1) is bound by the host's time a launch
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_resident_kernel<W, CS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS * G, (B + kTile - 1) / kTile);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = CS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&config, gru_resident_kernel<W, CS>,
                           static_cast<const float*>(x_proj), static_cast<const float*>(h0),
                           static_cast<const W*>(w_packed), static_cast<const float*>(b_hh),
                           static_cast<float*>(y), static_cast<float*>(h_last), B, T, G, H, U);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename W>
int launch_resident_any(const void* x_proj, const void* h0, const void* w_packed,
                        const void* b_hh, void* y, void* h_last, int B, int T, int G, int H,
                        int CS, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1) return cudaErrorInvalidValue;
  switch (CS) {
    case 1: return launch_resident<W, 1>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
    case 2: return launch_resident<W, 2>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
    case 4: return launch_resident<W, 4>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
    case 8: return launch_resident<W, 8>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
    default: return cudaErrorInvalidValue;
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

// The resident kernel: w_packed is [G, CS, H, 3, U], U = ceil(H / CS) rounded up to a
// multiple of 4, CS in (1, 2, 4, 8).
int gru_resident_f32(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                     void* y, void* h_last, int B, int T, int G, int H, int CS, void* stream) {
  return launch_resident_any<float>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, CS, stream);
}

int gru_resident_bf16w(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                       void* y, void* h_last, int B, int T, int G, int H, int CS, void* stream) {
  return launch_resident_any<__nv_bfloat16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, CS,
                                            stream);
}

}  // extern "C"
