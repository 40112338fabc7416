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
// its own rows of one group. A thread multiplies 4 hidden units x 8 rows x 3
// gates (96 running sums), so that a 16-byte load of shared memory feeds 24
// or 12 multiply-adds and the FMA pipe, not the shared-memory pipe, is the
// limit. With bf16 weights the state is rounded to bf16 before the product
// (as the TPU kernel does), and products and sums stay f32. Accurate
// expf/tanhf: no fast-math. The two kernels differ in where the recurrent
// weight lives; ops/gru_kernel.py's resident_plan picks one from the shape
// and the card's count of co-resident 16-block clusters.
//
// gru_resident_kernel: the weight stays in shared memory for all T steps.
//   A cluster of CS blocks owns (group, ROWS batch rows); block c of it owns
//   the hidden units [c*U, (c+1)*U), U = ceil(H / CS) rounded up to a multiple
//   of 4, and loads its slice of the weight, [H][3][U] (packed on the host as
//   [G, CS, H, 3, U]), once, before the time loop. Every block keeps the whole
//   state tile [2][H][ROWS]; after a step each thread stores its unit's new
//   state into that tile of every block of the cluster (distributed shared
//   memory), then one cluster barrier, split into arrive and wait with the y
//   store and the next step's x_proj loads between them. Instances: CS = 1,
//   2, 4, 8 at ROWS = 16, and the non-portable CS = 16 at ROWS = 16 and 8,
//   which the plan tries only where no cluster of up to 8 holds the weight.
//   - Config 1 (H = 176, f32): CS = 2, U = 88, 186 KB of weights + 22 KB of
//     state a block, grid 4 groups x 2 x 16 row tiles = 128 blocks of 352
//     threads. What bounds it: the step's f32 multiply-adds, then what is
//     serial in a step: the shuffle rounds that add the k parts, the gates,
//     the cluster barrier. Measured on an H100 at B=256, T=1001: 7.1 us a
//     step, of which the product 3.4 (its FMA floor 2.9), the gates 0.4, the
//     remote stores and the cluster barrier 0.3, the x loads and y stores 0.4.
//   - FullSubNet's full band (H = 512, f32): no cluster of 8 holds [512][3][64]
//     (393 KB); 16 blocks hold U = 32 units each, 192 KB, and an 8-row state
//     tile, 32 KB: 229,376 of 232,448 bytes. ROWS = 8 leaves one row half, so
//     the k range is split 16 ways instead of 8 (a warp: 16 k parts x 2 unit
//     groups), which keeps 4U = 128 threads a block and adds a fourth shuffle
//     round; a lane keeps 2 rows. Its weight rows are 384 bytes, which would
//     put the 4 k parts of a quarter warp on one bank group: the slice's
//     16-byte chunks are XOR-swizzled by (k & 3) << 1 within each gate's
//     aligned 8 chunks, a permutation that costs no shared memory.
//   It takes the shapes whose slice fits 227 KB with CS <= 16 and U <= 96,
//   at any T, and CS = 16 only where the launch's clusters run in 2 waves at
//   T = 1, 8 over more steps (ops/gru_kernel.py::resident_plan; gru_resident_clusters asks the
//   card how many run at once: 7 on an H100). Measured on an H100 at the full
//   band (B = 16, T = 626): 4.4 us a step, 2 clusters.
//
// gru_rows_kernel: the row-tiled kernel, for many independent rows (H <= 512;
//   FullSubNet's sub band folds 257 bins into the batch: 4,112 rows at B=16).
//   A block owns R = 8, 16 or 32 rows and all H units of one group and walks
//   all T steps on its own: no cluster, no sync between blocks. The state is
//   an [H][R] f32 tile in shared memory (single-buffered: a barrier after the
//   product's last read, another after the update). The transposed weight
//   [H][3][Hp] (units padded to Hp, a multiple of 4 for f32 and 8 for bf16) is
//   streamed from L2 in chunks of 16 k rows through a ring of 2 to 8 stages
//   (as many as shared memory holds beside the tile) in shared memory, each
//   chunk one bulk copy (cp.async.bulk, the TMA's 1-D form) by thread 0,
//   stages - 1 chunks ahead, onto the stage's mbarrier; the warps release a
//   stage by one arrival each on its other mbarrier. The weight does not
//   depend on the state, so the ring runs on across steps. A thread owns 8 rows
//   x 4 units and ends the k loop with whole sums (k is not split): it
//   computes its 8 x 4 gates itself, with no shuffle, a row at a time with
//   the next row's x in flight. A block reads the whole weight each step
//   (1.77 MB f32 at H = 384), so R is as large as the plan can make it while
//   G x ceil(B / R) still fills the card; no cluster multicast (the L2 reads
//   at R = 32 stay under the L2's rate). At the sub band (B = 4112, H = 384,
//   f32): R = 32, 129 blocks of 384 threads, one an SM, 2 stages of 73,744 B
//   beside the 49,152 B tile. What bounds it: the f32 multiply-adds, 1.14 T
//   of them for T = 626 (54 us a step on 132 SMs). Measured on an H100 (ops/
//   gru_timing.py --breakdown): 102 us a step, of which the product ~76, the
//   update ~11 and the ring's waits ~8.
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// each entry returns the error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kHalf = 8;            // both kernels: rows a thread multiplies
constexpr int kUnits = 4;           // both kernels: units a thread multiplies
constexpr int kQuad = 4;            // resident kernel: rows of a quad of the state tile
constexpr int kResidentThreads = 384;          // resident kernel: 4 threads a unit, U <= 96
// resident kernel at ROWS = 8: U <= 64, so that a thread may keep up to 255
// registers (one block an SM: its shared memory allows no second)
constexpr int kResident8Threads = 256;
constexpr size_t kSharedLimit = 232448;        // dynamic shared memory a block may have on sm_90
constexpr int kMaxDevices = 64;                // devices whose shared-memory grant is remembered
// The row-tiled kernel. The Python plan (ops/gru_kernel.py) mirrors these:
// MAX_HIDDEN, ROW_TILES, ROWS_MAX_THREADS, ROWS_CHUNK, ROWS_STAGES.
constexpr int kMaxHidden = 512;
constexpr int kRowsMaxThreads = 384;   // threads: (R / 8) (Hp / 4), rounded up to warps
constexpr int kChunk = 16;             // k rows of the weight a ring stage holds (8 is 10 % slower: a
                                       // chunk's waits and arrivals cost ~0.5 us)
constexpr int kMinStages = 2;          // stages of the ring: as many as shared memory holds, 2 to 8
constexpr int kMaxStages = 8;
constexpr uint32_t kSpinLimit = 1u << 26;  // tries of an mbarrier wait before the kernel traps

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

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

// A lane's new state of its unit, its rows of one quad, into the tile at p.
__device__ __forceinline__ void put(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void put(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// x_proj [B, T, G, 3H], h0 [B, G, H], w_packed [G, CS, H, 3, U] (block c's
// slice [k][gate][u] holds w_hh[g, gate * H + c * U + u, k], zero where
// c * U + u >= H; U a multiple of 4), b_hh [G, 3H]; y [B, T, G, H],
// h_last [B, G, H]. Grid (CS * G, ceil(B / ROWS)) in clusters of (CS, 1, 1).
//
// The product of a step is blocked in registers: a thread does 4 units x 8
// rows x 3 gates (96 sums) over every kSplit-th k. At ROWS = 16 a warp is 8 k
// parts x 2 unit groups x 2 row halves, and the 8 partial sums of an output
// meet in three shuffle rounds that leave each lane with one unit x 4 rows x 3
// gates; at ROWS = 8 a warp is 16 k parts x 2 unit groups, and four rounds
// leave one unit x 2 rows x 3 gates. A lane computes the gates of what it is
// left with and keeps that state in registers. The state tile is laid out
// [ROWS / 4 row quads][H][4 rows], so that the lanes of a quarter warp (4 k
// parts x 2 unit groups) read 64 consecutive bytes of it and 128 of the weight.
template <typename W, int CS, int ROWS>
__global__ void __launch_bounds__(ROWS == 16 ? kResidentThreads : kResident8Threads)
gru_resident_kernel(const float* __restrict__ x_proj, const float* __restrict__ h0,
                    const W* __restrict__ w_packed, const float* __restrict__ b_hh,
                    float* __restrict__ y, float* __restrict__ h_last,
                    int B, int T, int G, int H, int U) {
  static_assert(ROWS == 16 || ROWS == 8, "a tile of 16 or 8 rows");
  constexpr int kSplit = ROWS == 16 ? 8 : 16;  // parts of the k range
  constexpr int kKeep = 32 / kSplit;           // rows a lane keeps the state of
  // ROWS = 8 keeps fewer warps on an SM: unroll the k loop so that the loads
  // of the next k are in flight during this one's multiply-adds
  constexpr int kUnroll = ROWS == 16 ? 1 : 4;
  extern __shared__ float4 smem[];
  const size_t slice = static_cast<size_t>(H) * 3 * U;  // weights of this block
  W* wsm = reinterpret_cast<W*>(smem);                   // [H][3][U]
  float* hq = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + align16(slice * sizeof(W)));
  const int quad_stride = H * kQuad;                     // hq is [2][ROWS / kQuad][H][kQuad]
  const int tile = H * ROWS;

  int rank = 0;
  float* peers[CS <= 8 ? CS : 1];  // CS = 16 maps each store instead: 16 pointers cost 32 registers
  peers[0] = hq;
  if constexpr (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    if constexpr (CS <= 8) {
#pragma unroll
      for (int c = 0; c < CS; ++c) peers[c] = cluster.map_shared_rank(hq, c);
    }
  }
  const int g = blockIdx.x / CS;
  const int b0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // lane bits, ROWS = 16: 0, 1 and 4 the k part; 2 the unit group of the warp's two; 3 the row half.
  // ROWS = 8: 0, 1, 3 and 4 the k part; 2 the unit group.
  const bool k0 = lane & 1, k1 = lane & 2, k2 = ROWS == 16 ? lane & 16 : lane & 8;
  const bool k3 = ROWS == 8 && (lane & 16);
  const int part = ROWS == 16 ? (lane & 3) + (k2 ? 4 : 0) : (lane & 3) + 4 * ((lane >> 3) & 3);
  const int group = 2 * (tid >> 5) + ((lane >> 2) & 1);  // units 4 * group .. 4 * group + 3 of the block
  const int half = ROWS == 16 ? (lane >> 3) & 1 : 0;     // rows 8 * half .. 8 * half + 7 of the tile
  const bool loads = kUnits * group < U;
  // after the rounds: unit 2 * k0 + k1 of the group; ROWS = 16: the 4 rows of quad 2 * half + k2;
  // ROWS = 8: rows 2 * k3, 2 * k3 + 1 of quad k2
  const int u = kUnits * group + 2 * k0 + k1;
  const int j = rank * U + u;  // this lane's hidden unit
  const bool active = u < U && j < H;
  const int quad = 2 * half + k2;
  const int in_quad = ROWS == 16 ? 0 : 2 * k3;
  const int row0 = b0 + kQuad * quad + in_quad;  // this lane's first batch row
  const int H3 = 3 * H;
  // ROWS = 8 with U a multiple of 32 (H = 512 in f32: weight rows of 24 chunks of 16 bytes): the
  // chunks of row k are stored at their index XOR (k & 3) << 1, within the gate's aligned 8 chunks.
  // k & 3 is part & 3 for every k a lane reads, so a lane reads its unit group at group ^ swizzle.
  const bool swizzled = ROWS == 8 && sizeof(W) == 4 && U % 32 == 0;
  const int swizzle = swizzled ? (part & 3) << 1 : 0;

  // this block's slice of the weight, once: 16 bytes a load where it can be
  const W* wsrc = w_packed + (static_cast<size_t>(g) * CS + rank) * slice;
  if ((slice * sizeof(W)) % 16 == 0) {
    const int n16 = static_cast<int>(slice * sizeof(W) / 16);
    const int row16 = 3 * U / 4;  // 16-byte chunks of a k row (f32)
    const float4* src = reinterpret_cast<const float4*>(wsrc);
#pragma unroll 8
    for (int i = tid; i < n16; i += blockDim.x)
      smem[swizzled ? i ^ (((i / row16) & 3) << 1) : i] = __ldg(src + i);
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

  float h[kKeep];
  float xr[kKeep], xz[kKeep], xn[kKeep];
  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f;
  if (active) {
    bias_r = b_hh[g * H3 + j];
    bias_z = b_hh[g * H3 + H + j];
    bias_n = b_hh[g * H3 + 2 * H + j];
#pragma unroll
    for (int r = 0; r < kKeep; ++r) {
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
    // partial sums over k = part, part + kSplit, ...: index 8 * unit + row
    float acc_r[kUnits * kHalf], acc_z[kUnits * kHalf], acc_n[kUnits * kHalf];
#pragma unroll
    for (int i = 0; i < kUnits * kHalf; ++i) acc_r[i] = acc_z[i] = acc_n[i] = 0.f;
    if (loads) {
      const float* cur = hq + (t & 1) * tile + 2 * half * quad_stride;
      const W* wg = wsm + kUnits * (group ^ swizzle);
#pragma unroll (kUnroll)  // ROWS = 16, measured: 2 is 1 % slower, 4 is 35 % slower
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
    // every lane of every warp takes part: 32 -> 16 (units), 16 -> 8 (unit), 8 -> 4 (rows)[, 4 -> 2 (rows)]
    float sum_r[kKeep], sum_z[kKeep], sum_n[kKeep];
    {
      float a16[16], a8[8];
      if constexpr (ROWS == 16) {
        halve<16>(acc_r, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_r, k2, 16);
        halve<16>(acc_z, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_z, k2, 16);
        halve<16>(acc_n, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, sum_n, k2, 16);
      } else {
        float a4[4];
        halve<16>(acc_r, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, a4, k2, 8);
        halve<2>(a4, sum_r, k3, 16);
        halve<16>(acc_z, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, a4, k2, 8);
        halve<2>(a4, sum_z, k3, 16);
        halve<16>(acc_n, a16, k0, 1), halve<8>(a16, a8, k1, 2), halve<4>(a8, a4, k2, 8);
        halve<2>(a4, sum_n, k3, 16);
      }
    }

    if (active) {
      float out[kKeep];
#pragma unroll
      for (int r = 0; r < kKeep; ++r) {
        const float rg = sigmoid(xr[r] + (sum_r[r] + bias_r));
        const float zg = sigmoid(xz[r] + (sum_z[r] + bias_z));
        const float ng = tanhf(xn[r] + rg * (sum_n[r] + bias_n));
        h[r] = (1.f - zg) * ng + zg * h[r];
        out[r] = product_operand<W>(h[r]);
      }
      // the new state of this unit into the next tile of every block of the cluster
      const int at = ((t + 1) & 1) * tile + quad * quad_stride + j * kQuad + in_quad;
#pragma unroll
      for (int c = 0; c < CS; ++c) {
        if constexpr (CS <= 8) {
          put(peers[c] + at, out);
        } else {
          put(cg::this_cluster().map_shared_rank(hq, c) + at, out);
        }
      }
    }
    // One barrier a step. A block stores into tile t & 1 at step t + 1 only
    // after this step's wait, which every peer's arrive precedes, and a peer
    // arrives only after its reads of that tile. Between arrive and wait: the
    // y store and the next step's input projections, whose latency the wait
    // and the next product hide.
    if constexpr (CS > 1) cluster_arrive();
    if (active) {
#pragma unroll
      for (int r = 0; r < kKeep; ++r) {
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
    for (int r = 0; r < kKeep; ++r) {
      const int b = row0 + r;
      if (b < B) h_last[(static_cast<size_t>(b) * G + g) * H + j] = h[r];
    }
  }
}

// Threads and shared memory of a resident block, and the kernel's attributes
// set once a device: the shared-memory grant, and for CS = 16 the permission
// of a non-portable cluster size. Returns cudaErrorInvalidValue where the
// shape does not fit the instance.
template <typename W, int CS, int ROWS>
cudaError_t resident_setup(int H, int& U, int& threads, size_t& smem) {
  U = ((H + CS - 1) / CS + kUnits - 1) / kUnits * kUnits;
  threads = (U / kUnits * 16 + 31) / 32 * 32;  // 16 lanes a unit group: 8 k parts x 2 halves, or 16 k parts
  smem = align16(static_cast<size_t>(H) * 3 * U * sizeof(W)) +
         2 * static_cast<size_t>(H) * ROWS * sizeof(float);
  if (threads > (ROWS == 16 ? kResidentThreads : kResident8Threads) || smem > kSharedLimit)
    return cudaErrorInvalidValue;
  // asked for once a device and size, not on every launch: a streaming hop
  // (T = 1) is bound by the host's time a launch
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_resident_kernel<W, CS, ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess && CS > 8)
      err = cudaFuncSetAttribute(gru_resident_kernel<W, CS, ROWS>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  return cudaSuccess;
}

template <typename W, int CS, int ROWS>
int launch_resident(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                    void* y, void* h_last, int B, int T, int G, int H, void* stream) {
  int U = 0, threads = 0;
  size_t smem = 0;
  cudaError_t err = resident_setup<W, CS, ROWS>(H, U, threads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS * G, (B + ROWS - 1) / ROWS);
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
  err = cudaLaunchKernelEx(&config, gru_resident_kernel<W, CS, ROWS>,
                           static_cast<const float*>(x_proj), static_cast<const float*>(h0),
                           static_cast<const W*>(w_packed), static_cast<const float*>(b_hh),
                           static_cast<float*>(y), static_cast<float*>(h_last), B, T, G, H, U);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of this instance the card runs at once (the occupancy API).
template <typename W, int CS, int ROWS>
int resident_clusters(int H, int* count) {
  int U = 0, threads = 0;
  size_t smem = 0;
  cudaError_t err = resident_setup<W, CS, ROWS>(H, U, threads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS, 1);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, gru_resident_kernel<W, CS, ROWS>, &config);
}

template <typename W>
int launch_resident_any(const void* x_proj, const void* h0, const void* w_packed,
                        const void* b_hh, void* y, void* h_last, int B, int T, int G, int H,
                        int CS, int rows, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1) return cudaErrorInvalidValue;
  if (rows == 16) {
    switch (CS) {
      case 1: return launch_resident<W, 1, 16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
      case 2: return launch_resident<W, 2, 16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
      case 4: return launch_resident<W, 4, 16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
      case 8: return launch_resident<W, 8, 16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
      case 16: return launch_resident<W, 16, 16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (rows == 8 && CS == 16)
    return launch_resident<W, 16, 8>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, stream);
  return cudaErrorInvalidValue;
}

template <typename W>
int resident_clusters_any(int H, int CS, int rows, int* count) {
  if (H < 1 || CS != 16) return cudaErrorInvalidValue;  // the plan asks for the non-portable size only
  if (rows == 16) return resident_clusters<W, 16, 16>(H, count);
  if (rows == 8) return resident_clusters<W, 16, 8>(H, count);
  return cudaErrorInvalidValue;
}

// The ring's mbarriers: "full" completes when a stage's bytes have landed
// (one arrival, the expect_tx of the thread that fills it, and the bulk
// copy's bytes), "empty" when every warp of the block has read it.
__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint32_t barrier, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(barrier), "r"(count) : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint32_t barrier) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(barrier) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint32_t barrier, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(barrier), "r"(bytes)
               : "memory");
}

// Until the phase of this parity has completed; a fault (trap) instead of a
// hang if it never does.
__device__ __forceinline__ void barrier_wait(uint32_t barrier, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(barrier), "r"(parity) : "memory");
    if (done) return;
    if (tries > kSpinLimit) __trap();
  }
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte aligned),
// counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t barrier) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(barrier) : "memory");
}

// The `valid` (<= 4) floats at p, zeros after them: one 16-byte load where
// `vec` (p 16-byte aligned and valid = 4), else one word at a time.
__device__ __forceinline__ void load_units(const float* p, bool vec, int valid, float (&out)[4]) {
  if (vec && valid == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) out[v] = v < valid ? p[v] : 0.f;
  }
}

__device__ __forceinline__ void store_units(float* p, bool vec, int valid, const float (&in)[4]) {
  if (vec && valid == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (v < valid) p[v] = in[v];
  }
}

// x_proj [B, T, G, 3H], h0 [B, G, H], w_t [G, H, 3, Hp] (w_t[g, k, gate, j] =
// w_hh[g, gate * H + j, k], zero for j >= H), b_hh [G, 3H]; y [B, T, G, H],
// h_last [B, G, H]. Grid (G, ceil(B / R)); a block is (R / 8) row groups x
// (Hp / 4) unit groups, rounded up to warps. Shared memory: the ring
// [S][kChunk][3][Hp] of W, the state tile [H][R] f32, then 2 S mbarriers.
// Thread 0 also fills the ring, S - 1 chunks ahead of its own
// product: no producer warp, whose 13th warp would cut every thread's
// registers from 168 to 128 (a quarter of the register file serves 4 warps).
// The tile's row k holds its R / 4 chunks of 4 rows at chunk c ^ ((k / 8) mod
// R / 4): the product's reads (every lane of a warp the same k and rows) stay
// broadcasts, with one swizzle each 8 k rows, and the update's (a quarter
// warp's lanes 8 units 4 apart, the same rows) fall on 4 bank groups at R =
// 32 instead of one.
template <typename W>
__global__ void __launch_bounds__(kRowsMaxThreads, 1)
gru_rows_kernel(const float* __restrict__ x_proj, const float* __restrict__ h0,
                const W* __restrict__ w_t, const float* __restrict__ b_hh,
                float* __restrict__ y, float* __restrict__ h_last,
                int B, int T, int G, int H, int Hp, int R, int S) {
  // chunk n + lead goes into the stage of chunk n - 1, which thread 0 waits
  // for every warp to have left
  const int lead = S - 1;
  extern __shared__ float4 smem[];
  const int stage = kChunk * 3 * Hp;  // elements of a stage
  W* ring = reinterpret_cast<W*>(smem);
  float* hs = reinterpret_cast<float*>(ring + S * stage);  // [H][R]
  const uint32_t full = shared_address(hs + static_cast<size_t>(H) * R);  // S mbarriers, 8 bytes each
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x;
  const int g = blockIdx.x;
  const int b0 = blockIdx.y * R;
  const int H3 = 3 * H;
  const int chunks = (H + kChunk - 1) / kChunk;  // of a step
  const int total = T * chunks;
  const int quads = R / 4 - 1;  // mask of a row's chunk index
  const W* wg = w_t + static_cast<size_t>(g) * H * 3 * Hp;
  auto at = [&](int k, int c) { return k * R + 4 * (c ^ ((k >> 3) & quads)); };  // rows 4c .. 4c + 3 of row k
  auto fill = [&](int n) {  // chunk n (of all T steps) into its stage
    const int s = n % S;
    if (n >= S) barrier_wait(empty + 8 * s, static_cast<uint32_t>((n / S - 1) & 1));
    const int c = n % chunks;
    const int rows = min(kChunk, H - c * kChunk);
    const uint32_t bytes = static_cast<uint32_t>(rows * 3 * Hp * sizeof(W));
    barrier_expect(full + 8 * s, bytes);
    bulk_copy(shared_address(ring + s * stage), wg + static_cast<size_t>(c) * kChunk * 3 * Hp, bytes,
              full + 8 * s);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      barrier_init(full + 8 * s, 1);
      barrier_init(empty + 8 * s, blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int n = 0; n < lead && n < total; ++n) fill(n);
  }
  // the state of step 0, exact f32: the product rounds it where the weight is bf16
  for (int i = tid; i < H * R; i += blockDim.x) {
    const int r = i / H, k = i - r * H;
    const int b = b0 + r;
    hs[at(k, r / 4) + r % 4] = b < B ? h0[(static_cast<size_t>(b) * G + g) * H + k] : 0.f;
  }
  __syncthreads();

  const int unit_groups = Hp / kUnits;
  const int row_group = tid / unit_groups;
  const bool live = row_group < R / kHalf;  // threads past the last row group only keep the ring and barriers going
  const int q0 = 2 * (live ? row_group : 0);  // the thread's rows: chunks q0 and q0 + 1 of the tile's rows
  const int r0 = 4 * q0;
  const int j0 = kUnits * (tid % unit_groups);
  const int lane = tid & 31;

  int i = 0, s = 0;  // chunks consumed; the stage of chunk i
  uint32_t phase = 0;  // the parity of chunk i's use of its stage
  for (int t = 0; t < T; ++t) {
    // index 8 * unit + row
    float acc_r[kUnits * kHalf], acc_z[kUnits * kHalf], acc_n[kUnits * kHalf];
#pragma unroll
    for (int a = 0; a < kUnits * kHalf; ++a) acc_r[a] = acc_z[a] = acc_n[a] = 0.f;
    for (int c = 0; c < chunks; ++c, ++i) {
      if (tid == 0 && i + lead < total) fill(i + lead);
      barrier_wait(full + 8 * s, phase);
      if (live) {
        const W* ws = ring + s * stage + j0;
        const int k0 = c * kChunk;
        const int rows = min(kChunk, H - k0);
        // 8 k rows at a time, which share the tile's swizzle
        for (int k8 = 0; k8 < rows; k8 += 8) {
          const float* lo_row = hs + at(k0 + k8, q0);
          const float* hi_row = hs + at(k0 + k8, q0 + 1);
          const W* w8 = ws + k8 * 3 * Hp;
          // 3 warps an SM quarter hide each other's load latency: no deeper unroll, and no spill
#pragma unroll 2
          for (int kk = 0; kk < min(8, rows - k8); ++kk) {
            float wr[kUnits], wz[kUnits], wn[kUnits];
            load4(w8 + kk * 3 * Hp, wr);
            load4(w8 + kk * 3 * Hp + Hp, wz);
            load4(w8 + kk * 3 * Hp + 2 * Hp, wn);
            const float4 lo = *reinterpret_cast<const float4*>(lo_row + kk * R);
            const float4 hi = *reinterpret_cast<const float4*>(hi_row + kk * R);
            const float hv[kHalf] = {product_operand<W>(lo.x), product_operand<W>(lo.y),
                                     product_operand<W>(lo.z), product_operand<W>(lo.w),
                                     product_operand<W>(hi.x), product_operand<W>(hi.y),
                                     product_operand<W>(hi.z), product_operand<W>(hi.w)};
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
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(empty + 8 * s);
      if (++s == S) s = 0, phase ^= 1;
    }
    __syncthreads();  // every read of the tile by this step's product is done
    // the update, a row at a time: x and y as 16 bytes of 4 units where H allows (coalesced across
    // the warp's unit groups), the state as 4 words of the tile
    if (live) {
      const int valid = min(kUnits, H - j0);  // units of the thread's group below H
      const bool vec = H % 4 == 0;            // rows of x and y 16-byte aligned at every unit group
      float bias[3][kUnits];
#pragma unroll
      for (int q = 0; q < 3; ++q) load_units(b_hh + g * H3 + q * H + j0, vec, valid, bias[q]);
      float* hrow = hs + j0 * R;  // unit j0's row of the tile
      // x of rows r .. r + kXRows - 1 in flight: they cover the latency that one row at a time left
      // exposed 8 times a step
      constexpr int kXRows = 2;
      float x[kXRows][3][kUnits];  // [row mod kXRows][gate][unit]
      auto load_row = [&](int r, float (&xr)[3][kUnits]) {
        const int b = b0 + r0 + r;
        const float* xp = x_proj + ((static_cast<size_t>(b) * T + t) * G + g) * H3 + j0;
#pragma unroll
        for (int q = 0; q < 3; ++q) load_units(xp + q * H, vec && b < B, b < B ? valid : 0, xr[q]);
      };
#pragma unroll
      for (int r = 0; r < kXRows - 1; ++r) load_row(r, x[r]);
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        if (r + kXRows - 1 < kHalf) load_row(r + kXRows - 1, x[(r + kXRows - 1) % kXRows]);
        const float(&xr)[3][kUnits] = x[r % kXRows];
        const int b = b0 + r0 + r;
        float hv[kUnits];
        // rows r0 + r of units j0 .. j0 + 3: chunk q0 + r / 4 (swizzled as row j0's), word r % 4
        float* hr = hrow + 4 * ((q0 + r / 4) ^ ((j0 >> 3) & quads)) + r % 4;
#pragma unroll
        for (int v = 0; v < kUnits; ++v) {
          hv[v] = v < valid ? hr[v * R] : 0.f;
          const float rg = sigmoid(xr[0][v] + (acc_r[kHalf * v + r] + bias[0][v]));
          const float zg = sigmoid(xr[1][v] + (acc_z[kHalf * v + r] + bias[1][v]));
          const float ng = tanhf(xr[2][v] + rg * (acc_n[kHalf * v + r] + bias[2][v]));
          hv[v] = (1.f - zg) * ng + zg * hv[v];
          if (v < valid) hr[v * R] = hv[v];
        }
        if (b < B) store_units(y + ((static_cast<size_t>(b) * T + t) * G + g) * H + j0, vec, valid, hv);
      }
    }
    __syncthreads();  // the whole new state is in the tile before the next product
  }

  if (live) {
    for (int v = 0; v < kUnits; ++v) {
      const int j = j0 + v;
      for (int r = 0; r < kHalf; ++r) {
        const int b = b0 + r0 + r;
        if (j < H && b < B) h_last[(static_cast<size_t>(b) * G + g) * H + j] = hs[at(j, q0 + r / 4) + r % 4];
      }
    }
  }
}

// Units of a weight row as the row-tiled kernel reads it: H rounded up so
// that a k row is a whole number of 16-byte chunks (4 f32, 8 bf16).
template <typename W>
constexpr int padded_units(int H) {
  constexpr int m = 16 / sizeof(W);
  return (H + m - 1) / m * m;
}

template <typename W>
int launch_rows(const void* x_proj, const void* h0, const void* w_t, const void* b_hh, void* y,
                void* h_last, int B, int T, int G, int H, int R, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1 || H > kMaxHidden) return cudaErrorInvalidValue;
  if (R != 8 && R != 16 && R != 32) return cudaErrorInvalidValue;
  if (T > (1 << 30) / kMaxHidden) return cudaErrorInvalidValue;  // the kernel counts T x H / 8 chunks in an int
  const int Hp = padded_units<W>(H);
  const int threads = ((R / kHalf) * (Hp / kUnits) + 31) / 32 * 32;
  // as many stages as shared memory holds beside the tile, up to kMaxStages
  const size_t stage = static_cast<size_t>(kChunk) * 3 * Hp * sizeof(W) + 2 * sizeof(uint64_t);
  const size_t tile = static_cast<size_t>(H) * R * sizeof(float);
  const size_t room = tile < kSharedLimit ? (kSharedLimit - tile) / stage : 0;
  const int S = static_cast<int>(room < kMaxStages ? room : kMaxStages);
  const size_t smem = S * stage + tile;
  if (threads > kRowsMaxThreads || S < kMinStages) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_rows_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  const dim3 grid(G, (B + R - 1) / R);
  gru_rows_kernel<W><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(h0), static_cast<const W*>(w_t),
      static_cast<const float*>(b_hh), static_cast<float*>(y), static_cast<float*>(h_last), B, T, G,
      H, Hp, R, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The row-tiled kernel: w_t is [G, H, 3, Hp] (transposed_weight), R in (8, 16, 32).
int gru_sequence_f32(const void* x_proj, const void* h0, const void* w_t, const void* b_hh,
                     void* y, void* h_last, int B, int T, int G, int H, int R, void* stream) {
  return launch_rows<float>(x_proj, h0, w_t, b_hh, y, h_last, B, T, G, H, R, stream);
}

int gru_sequence_bf16w(const void* x_proj, const void* h0, const void* w_t, const void* b_hh,
                       void* y, void* h_last, int B, int T, int G, int H, int R, void* stream) {
  return launch_rows<__nv_bfloat16>(x_proj, h0, w_t, b_hh, y, h_last, B, T, G, H, R, stream);
}

// The resident kernel: w_packed is [G, CS, H, 3, U], U = ceil(H / CS) rounded up to a
// multiple of 4; (CS, rows) in (1, 16), (2, 16), (4, 16), (8, 16), (16, 16), (16, 8).
int gru_resident_f32(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                     void* y, void* h_last, int B, int T, int G, int H, int CS, int rows,
                     void* stream) {
  return launch_resident_any<float>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, CS, rows,
                                    stream);
}

int gru_resident_bf16w(const void* x_proj, const void* h0, const void* w_packed, const void* b_hh,
                       void* y, void* h_last, int B, int T, int G, int H, int CS, int rows,
                       void* stream) {
  return launch_resident_any<__nv_bfloat16>(x_proj, h0, w_packed, b_hh, y, h_last, B, T, G, H, CS,
                                            rows, stream);
}

// Clusters of the resident kernel's CS = 16 instance (rows 16 or 8) at hidden
// size H that the current device runs at once, into *count; bf16 nonzero for
// bf16 weights.
int gru_resident_clusters(int bf16, int H, int CS, int rows, void* count) {
  int* out = static_cast<int*>(count);
  return bf16 ? resident_clusters_any<__nv_bfloat16>(H, CS, rows, out)
              : resident_clusters_any<float>(H, CS, rows, out);
}

}  // extern "C"
