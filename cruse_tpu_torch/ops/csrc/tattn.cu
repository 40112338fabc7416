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
// What bounds it: multiply-adds, not bytes. Each (query, key) pair of the band
// costs c_q + C of them and one exp (c_q = 6..12, C = 24..48), on inputs of
// (2 c_q + C) * T floats a row; the plain version's cost is instead the
// [BF, T, T] logits and probabilities it writes and reads (1.6 GB each at
// BF = 1024, T = 626). On CUDA cores a pair is c_q + C FFMAs plus (c_q + C) / 4
// shared-memory reads and the softmax's few instructions (about 47 SASS
// instructions a key at c_q = 6, C = 24).
//
// What the design does about it:
// - The band at warp granularity. A warp owns 32 consecutive queries of one
//   row, one a lane, and walks only the 32-key tiles its own queries' band
//   touches: at window 126 it computes 1.27x the band's pairs (a block of 128
//   queries computed 2.03x), 1.05x without a window (1.21x). Warps are
//   numbered over (row, query block) without gaps, so no warp idles on the
//   ragged end of a row. A tile that lies inside every query's band runs
//   with no compare and no select; only the tiles at the window's edge and
//   the diagonal (for the non-causal walk the ragged last) are masked.
//   ops/asa_kernel.py::tattn_band_tiles is this walk's index arithmetic in
//   Python, tattn_online_reference the whole walk.
// - Warp-private tiles, staged ahead. A warp needs other tiles than its
//   neighbours, so each keeps its own ring of kStages tiles (c_q k rows, then
//   C v rows, 32 floats each) in shared memory. The next tile is requested by
//   4-byte cp.async (a row of 626 floats is only 8-byte aligned) while the
//   current one is computed; cp.async.wait_group and __syncwarp hand it over.
//   No __syncthreads: the warps of a block never wait for each other. k and v
//   of a row (75 KB at stage 0) are read again by several warps, from L2.
// - One query a thread, read as float4 broadcasts. A thread holds its query's
//   scaled q, running max and sum and C accumulators in registers; every
//   lane reads the same 4 keys of a k or v row at once, so each 16-byte
//   shared read feeds 4 multiply-adds. Logits are held for half a tile
//   (kHalf keys) at a time. Two queries a thread (each read feeding 8) were
//   slower on the card: 165-255 registers, 2-3 blocks an SM, and a warp of 64
//   queries computes 1.52x the band at window 126 (PERF.md, section 6).
// - Base-2 online softmax. log2(e) / sqrt(c_q) is folded into q once, p and
//   the correction are exp2f, and the accumulators are rescaled only when a
//   half tile raises the running max. Masked keys are -inf and the running
//   max starts at -1e30, so a half tile with no key in the query's band adds
//   nothing.
// - The head widths are template parameters, 11 instances (kInstances): one
//   for each of config 5b's stages (c_q, C) = (6, 24), (8, 32), (12, 48), and
//   others up to c_q = 16, C = 48; the first that holds (c, C) is taken.
//   Padded k rows are zero in shared memory, padded q channels zero in
//   registers; padded v rows feed accumulators that are never stored.
//
// For training the kernel also writes each query's natural-log logsumexp,
// lse[bf, t] = ln 2 * (m2 + log2 l) of its scaled logits, from which the
// backward (tattn_bwd.cu) recomputes the probabilities as exp(scale q.k - lse).
//
// Layouts: q, k f32 [BF, c, T], v f32 [BF, C, T], out f32 [BF, C, T], lse f32
// [BF, T] or null, all contiguous. Plain C interface (bound with ctypes):
// pointers and the stream are void*, the launch is on the caller's stream,
// nothing is allocated here, and the entry returns cudaGetLastError() of its
// launch.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kKeys = 32;   // keys a shared-memory tile
constexpr int kHalf = 16;   // keys whose logits a thread holds at once
constexpr int kWarps = 4;   // warps a block, each on its own 32 queries and ring
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // tiles in a warp's ring
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;  // the running max before any key
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Does some key of the tile [s0, s0 + kKeys) lie outside the band of some
// live query of [q0, q_hi]? (asa_kernel.py::tattn_band_tiles)
__device__ __forceinline__ bool tile_masked(int s0, int q0, int q_hi, int T, int window, int causal) {
  if (!causal) return s0 + kKeys > T;
  return s0 + kKeys - 1 > q0 || (window > 0 && s0 < q_hi - window + 1);
}

template <int CQ, int CV>
__global__ void __launch_bounds__(kThreads)
tattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int BF, int c, int cv, int T, int window, int causal, float scale2) {
  constexpr int kTileFloats = (CQ + CV) * kKeys;  // k rows, then v rows, kKeys floats each
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (T + 31) / 32;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= static_cast<long long>(BF) * per_row) return;  // no block-wide barrier follows
  const long long bf = gw / per_row;
  const int q0 = static_cast<int>(gw % per_row) * 32, q_hi = min(q0 + 32, T) - 1;
  const int t = q0 + lane;  // this lane's query
  const float* qb = q + bf * c * T;
  const float* kb = k + bf * c * T;
  const float* vb = v + bf * cv * T;
  float* ring = reinterpret_cast<float*>(smem4) + warp * (kStages * kTileFloats);

  float qr[CQ], acc[CV];
#pragma unroll
  for (int i = 0; i < CQ; ++i) qr[i] = (t < T && i < c) ? qb[static_cast<long long>(i) * T + t] * scale2 : 0.f;
#pragma unroll
  for (int i = 0; i < CV; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  // the keys the warp's live queries see, as whole tiles
  int s_lo = 0, s_hi = T - 1;
  if (causal) {
    s_hi = q_hi;
    if (window > 0) s_lo = max(0, q0 - window + 1);
  }
  const int first = s_lo / kKeys, n_tiles = s_hi / kKeys - first + 1;

  // padded rows stay zero in every stage
  for (int st = 0; st < kStages; ++st) {
    float* tile = ring + st * kTileFloats + lane;
    for (int r = c; r < CQ; ++r) tile[r * kKeys] = 0.f;
    for (int r = CQ + cv; r < CQ + CV; ++r) tile[r * kKeys] = 0.f;
  }
  // lane j copies key s0 + j of every row; keys past T are zero-filled
  auto request = [&](int tile_index) {
    const int s = tile_index * kKeys + lane;
    const bool live = s < T;
    const long long col = live ? s : 0;
    float* tile = ring + (tile_index % kStages) * kTileFloats + lane;
    for (int r = 0; r < c; ++r) copy_async(tile + r * kKeys, kb + r * static_cast<long long>(T) + col, live);
    for (int r = 0; r < cv; ++r)
      copy_async(tile + (CQ + r) * kKeys, vb + r * static_cast<long long>(T) + col, live);
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
    const int s0 = (first + it) * kKeys;
    const float* ks = ring + ((first + it) % kStages) * kTileFloats;
    const float* vs = ks + CQ * kKeys;
    const bool masked = tile_masked(s0, q0, q_hi, T, window, causal);
#pragma unroll 1
    for (int h = 0; h < kKeys; h += kHalf) {
      float s[kHalf];
#pragma unroll
      for (int j = 0; j < kHalf; ++j) s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < CQ; ++i)
#pragma unroll
        for (int j = 0; j < kHalf; j += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(ks + i * kKeys + h + j);
          s[j] = fmaf(qr[i], kk.x, s[j]);
          s[j + 1] = fmaf(qr[i], kk.y, s[j + 1]);
          s[j + 2] = fmaf(qr[i], kk.z, s[j + 2]);
          s[j + 3] = fmaf(qr[i], kk.w, s[j + 3]);
        }
      if (masked) {  // warp-uniform: only the band's edge tiles take it
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int key = s0 + h + j;
          const bool ok = causal ? key <= t && (window <= 0 || key > t - window) : key < T;
          s[j] = ok ? s[j] : -INFINITY;
        }
      }
      float top = s[0];
#pragma unroll
      for (int j = 1; j < kHalf; ++j) top = fmaxf(top, s[j]);
      if (top > m) {  // the running max rises: rescale once
        const float corr = exp2f(m - top);
        m = top;
        l *= corr;
#pragma unroll
        for (int i = 0; i < CV; ++i) acc[i] *= corr;
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        s[j] = exp2f(s[j] - m);
        sum += s[j];
      }
      l += sum;
#pragma unroll
      for (int i = 0; i < CV; ++i)
#pragma unroll
        for (int j = 0; j < kHalf; j += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + i * kKeys + h + j);
          acc[i] = fmaf(s[j], vv.x, acc[i]);
          acc[i] = fmaf(s[j + 1], vv.y, acc[i]);
          acc[i] = fmaf(s[j + 2], vv.z, acc[i]);
          acc[i] = fmaf(s[j + 3], vv.w, acc[i]);
        }
    }
    __syncwarp();  // the tile is consumed before its stage is requested again
  }

  if (t >= T) return;
  const float inv = 1.f / l;
  float* ob = out + bf * cv * T;
#pragma unroll
  for (int i = 0; i < CV; ++i)
    if (i < cv) ob[static_cast<long long>(i) * T + t] = acc[i] * inv;
  if (lse != nullptr) lse[bf * T + t] = kLn2 * (m + log2f(l));
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, int, int, int, int,
                        int, int, float);

struct Instance {
  int cq, cv;
  Kernel kernel;
};

// The instances, cheapest first: the first that holds (c, cv) is taken.
// Config 5b's three stages (c = C / 4) have their own.
const Instance kInstances[] = {
    {4, 24, tattn_fwd_kernel<4, 24>},   {6, 24, tattn_fwd_kernel<6, 24>},   {8, 16, tattn_fwd_kernel<8, 16>},
    {8, 24, tattn_fwd_kernel<8, 24>},   {8, 32, tattn_fwd_kernel<8, 32>},   {12, 24, tattn_fwd_kernel<12, 24>},
    {12, 32, tattn_fwd_kernel<12, 32>}, {8, 48, tattn_fwd_kernel<8, 48>},   {16, 32, tattn_fwd_kernel<16, 32>},
    {12, 48, tattn_fwd_kernel<12, 48>}, {16, 48, tattn_fwd_kernel<16, 48>},
};

// The instance for (c, cv) and its floats a staged tile, or null past the limits.
Kernel pick(int c, int cv, int* floats) {
  for (const Instance& instance : kInstances)
    if (c <= instance.cq && cv <= instance.cv) {
      *floats = (instance.cq + instance.cv) * kKeys;
      return instance.kernel;
    }
  return nullptr;
}

size_t smem_bytes(int floats) { return static_cast<size_t>(kWarps) * kStages * floats * sizeof(float); }

// Lets each instance that needs more than the default shared memory take it,
// once a device: the attribute holds for the device from then on, and setting
// it at every launch would add a driver call of host time to each.
cudaError_t allow_smem() {
  static std::once_flag once[kMaxDevices];
  static cudaError_t result[kMaxDevices];
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    cudaError_t set = cudaSuccess;
    for (const Instance& instance : kInstances) {
      const size_t bytes = smem_bytes((instance.cq + instance.cv) * kKeys);
      if (bytes > kDefaultSmem && set == cudaSuccess)
        set = cudaFuncSetAttribute(instance.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
    }
    result[device] = set;
  });
  return result[device];
}

}  // namespace

extern "C" {

// q, k: f32 [BF, c, T]; v, out: f32 [BF, cv, T]; all contiguous. c <= 16,
// cv <= 48. lse: f32 [BF, T], or null to skip it. window <= 0: no window.
// causal == 0: every key (window unused).
int tattn_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int BF, int c,
                  int cv, int T, int window, int causal, void* stream) {
  int floats = 0;
  const Kernel kernel = pick(c, cv, &floats);
  if (kernel == nullptr || BF < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(BF) * ((T + 31) / 32);
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(floats);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale2 = kLog2e / sqrtf(static_cast<float>(c));
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), BF, c, cv, T, window, causal, scale2);
  return static_cast<int>(cudaGetLastError());
}

// The instance that (c, cv) launches, on the current device: info = registers
// and local (spill) bytes a thread, blocks an SM, threads a block, dynamic
// shared memory a block (bytes), queries a warp.
int tattn_fwd_info(int c, int cv, int* info) {
  int floats = 0;
  const Kernel kernel = pick(c, cv, &floats);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(floats);
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

}  // extern "C"
