// Backward of the grouped-GRU recurrence over a whole sequence, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX train step differentiates the plain
// recurrence cruse_tpu/nn/gru.py::gru_scan (lax.scan) under XLA's autodiff,
// and the Pallas kernel gru_sequence_pallas is forward only. It is the
// backward of csrc/gru_sequence.cu, torch gate order (r, z, n):
//
//   forward   hp = h_prev . w_hh^T + b_hh,  r = sigmoid(x_r + hp_r),
//             z = sigmoid(x_z + hp_z),      n = tanh(x_n + r * hp_n),
//             h = (1 - z) * n + z * h_prev
//   backward  dh     = dy_t + carry
//             dn_pre = dh (1 - z) (1 - n^2)
//             dz_pre = dh (h_prev - n) z (1 - z)
//             dr_pre = dn_pre hp_n r (1 - r)
//             dx_proj_t = [dr_pre, dz_pre, dn_pre],  dhp_t = [dr_pre, dz_pre, dn_pre r]
//             carry  = dh z + w_hh^T . dhp_t         (the carry of step t - 1)
//
// and dh0 is the carry left after t = 0. The caller gives hp for all t (one
// batched product of the saved states, outside the kernel) and takes
// dw_hh = sum dhp_t (x) h_prev and db_hh = sum dhp_t outside it too, so the
// kernel holds only what is sequential: the carry. Batch rows and groups are
// independent recurrences, walked from t = T - 1 down to 0. Accurate
// expf/tanhf, f32 throughout, no fast-math. Three kernels, which differ in
// where w_hh lives and how the carry's product is split;
// ops/gru_kernel.py::resident_bwd_plan picks one from the shape and, for the
// 16-block cluster, the card's count of co-resident clusters.
//
// gru_bwd_resident_kernel: the weight stays in shared memory for all T steps,
//   the forward's gru_resident_kernel mirrored (j, the 3H rows of w_hh, in
//   place of k). A cluster of CS blocks owns (group, R batch rows); block c
//   owns the hidden units [c*U, (c+1)*U), U = ceil(H / CS) rounded up to a
//   multiple of 4, and loads its slice of the weight, [3H][U] (packed on the
//   host as [G, CS, 3H, U], j-major so that 16 bytes are 4 units of one row),
//   once, before the time loop. Every block keeps the whole dhp tile of a
//   step, [2][R / 8][3H][8]. A step: the lane that owns (unit k, 2 rows)
//   finishes their gates from its carry (what does not depend on the carry
//   was taken during the previous product), and stores its 3 x 2 dhp values
//   into that tile of every block of the cluster (distributed shared memory)
//   with st.async, which counts the bytes on the receiving block's mbarrier;
//   then the dx_proj / dhp stores, the next step's loads and an L2 prefetch
//   of the step after; then each block waits for its tile's bytes and adds
//   sum_j w_hh[g, j, k] dhp[j] into the carry of its own units from shared
//   memory only. The direct term dh z stays in the owner's registers. The
//   mbarriers alone keep the blocks of a cluster within a step of each
//   other: no cluster barrier after the prologue. At config 2 (B = 128,
//   T = 1001, G = 4, H = 176): R = 8, CS = 2, U = 88, 186 KB of weights + 34
//   KB of tile a block, 4 groups x 2 x 16 row tiles = 128 blocks of 352
//   threads, 371,712 multiply-adds a block a step. ops/gru_bwd_timing.py
//   --breakdown times it with one part cut out at a time (PERF.md has the
//   table). It takes the shapes whose slice and tile fit 227 KB with CS <= 8
//   (f32: H <= ~320), which ops/gru_kernel.py's resident_bwd_plan decides.
//
// gru_bwd_scatter_kernel: the resident backward at a non-portable cluster of
//   16 blocks, for the widths where no cluster of up to 8 holds the slice
//   and the whole dhp tile (FullSubNet's full band, H = 512 f32: a block of
//   gru_bwd_resident_kernel would need 344,112 B). It splits the other way:
//   block c owns the j rows of its U units' three gates over all k, the
//   forward's slice [H][3][U] (packed_weight's cached copy, 196,608 B at
//   U = 32, rows of 3U floats XOR-swizzled by (k & 7) within aligned groups
//   of 8 chunks), and finishes its own units' gates: the dhp tile a block
//   needs is only its own [3U][R]. Its product is a partial carry of every
//   unit, sum over its 3U rows j of w[j, k] dhp[j], and it sends each block
//   the part for that block's units by st.async counted on the receiver's
//   mbarrier: a reduce-scatter. A block receives [CS][U][R] partials a step
//   (16 KB; 32 KB double-buffered), adds the 16 and the direct term dh z into
//   the carry of its units, and writes its step's dhp tile over the three
//   partial slots each lane has just read (no barrier between the two), so the
//   tile takes no shared memory of its own: 196,608 + 32,768 + 16 = 229,392
//   of 232,448 bytes at H = 512. A thread multiplies 4 k (k = 128 i + tid, so
//   a quarter warp reads 8 distinct bank groups through the swizzle) x 8 rows
//   over all 3U j, whole sums: no shuffle. One __syncthreads a step (the tile
//   whole before the product); the mbarriers keep the 16 blocks within a step
//   of each other, as in gru_bwd_resident_kernel. What bounds it: the step's
//   393 k multiply-adds a block from shared memory and the step's latency
//   (gates, the exchange, one barrier), at 1 cluster for FullSubNet's B = 8.
//
// gru_bwd_rows_kernel: the row-tiled backward, for many independent rows and
//   every shape no cluster takes (H <= 512; FullSubNet's sub band folds 257
//   bins into the batch: 2,056 rows at B = 8), the forward's gru_rows_kernel
//   mirrored. A block owns R = 8, 16 or 32 rows and all H units of one group
//   and walks all T steps on its own: no cluster. A lane keeps the carry of 4
//   units x 8 rows in registers; each step it finishes their gates (a row at
//   a time, the next row's inputs in flight) and writes their dhp into the
//   step's tile [3H][R] in shared memory (single-buffered, chunk c of row j at
//   c ^ ((j >> 3) mod R / 4)); after one barrier a lane pair multiplies 8
//   units x 8 rows, each lane over half of the rows j (64 multiply-adds to 4
//   16-byte loads), from w_hh [G, 3H, Hp] itself (padded_weight_bwd: j rows
//   contiguous over k, units padded to Hp, a multiple of 8), streamed from L2
//   in chunks of 32 j rows through a ring of 2 to 8 stages (cp.async.bulk
//   copies by thread 0, stages - 1 chunks ahead, on mbarriers; the warps
//   release a stage by one arrival each); one shuffle round adds the pair's
//   halves, and a second barrier ends the tile's reads. At the sub band (B =
//   2056, H = 384): R = 16, 129 blocks of 192 threads, 3 stages of 49,168 B
//   beside the 73,728 B tile. What bounds it: the f32 multiply-adds (909 M a
//   step, 5.1 ms over T = 188 on 132 SMs), each block's stream of the whole
//   weight (1.77 MB a step), then the gates' 14 H floats a row
//   (ops/gru_bwd_timing.py --breakdown times each part).
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// each entry returns the error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// The resident kernel. The Python plan (ops/gru_kernel.py) mirrors every one
// of these: BWD_TILE_ROWS, BWD_PLANE_ROWS, UNIT_GROUP, BWD_PARTS,
// BWD_MAX_THREADS, BWD_PLANE_PAD, SHARED_LIMIT and the bytes.
constexpr int kBwdRows = 8;            // R, the batch rows a cluster (a sweep on an H100 chose it over 16)
constexpr int kPlane = 8;              // batch rows a thread multiplies: the tile holds R / 8 planes
constexpr int kBwdUnits = 4;           // units a thread multiplies: one 16-byte load of a row of the slice
constexpr int kParts = 16;             // parts of the j range, one a lane of the 16 of a unit group
constexpr int kBwdMaxThreads = 512;    // (U / 4) (R / 8) unit groups x 16 lanes
constexpr int kPlanePad = 4;           // floats after each plane of the tile: planes start on other banks
constexpr size_t kSharedLimit = 232448;  // dynamic shared memory a block may have on sm_90
constexpr int kMaxDevices = 64;          // devices whose shared-memory grant is remembered
constexpr uint32_t kSpinLimit = 1u << 26;  // tries of an mbarrier wait before the kernel traps
// The 16-block resident kernel (gru_bwd_scatter_kernel); ops/gru_kernel.py's
// scatter_fit mirrors these (BWD_SCATTER_*).
constexpr int kScatterCS = 16;         // blocks a cluster: non-portable
constexpr int kScatterRows = 8;        // R, the batch rows a cluster
constexpr int kScatterThreads = 128;   // 4 warps: the gates' 32 units x 4 row pairs
constexpr int kScatterK = 4;           // k a thread multiplies, k = 128 i + tid: H <= 512
constexpr int kScatterMaxUnits = 32;   // U, the units a block owns
// The row-tiled kernel (gru_bwd_rows_kernel); mirrored by MAX_HIDDEN,
// ROW_TILES, ROWS_MAX_THREADS, BWD_ROWS_CHUNK and ROWS_STAGES.
constexpr int kMaxHidden = 512;
constexpr int kRowsMaxThreads = 384;   // 2 j halves x (R / 8) row groups x (Hp / 8) unit groups, in warps
constexpr int kRowsUnits = 8;          // units a lane pair multiplies (Hp: H rounded up to a multiple of 8)
constexpr int kRowsParts = 2;          // parts of the j range: the lanes of a pair
constexpr int kRowsChunk = 32;         // j rows of w_hh a ring stage holds (16: a chunk's waits and arrivals
                                       // cost more; ops/gru_bwd_timing.py --breakdown times that copy)
constexpr int kMinStages = 2;          // stages of the ring: as many as shared memory holds, 2 to 8
constexpr int kMaxStages = 8;

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The slice's row stride in shared memory, in 16-byte chunks: U / 4 rounded
// up to 2 mod 4, so that the 8 lanes of a quarter warp (4 consecutive rows j
// x 2 unit groups) read 8 different bank groups.
__host__ __device__ constexpr int slice_stride(int U) { return U / 4 + (6 - U / 4 % 4) % 4; }

__host__ __device__ constexpr int plane_floats(int H) { return 3 * H * kPlane + kPlanePad; }

// Weight slice + the double-buffered dhp tile + its 2 mbarriers, bytes.
__host__ __device__ constexpr size_t resident_bwd_bytes(int H, int U, int R) {
  return static_cast<size_t>(3 * H) * slice_stride(U) * 16 +
         2 * static_cast<size_t>(R / kPlane) * plane_floats(H) * sizeof(float) + 2 * sizeof(uint64_t);
}

// One round of the sum over the j parts: the lane and its partner (lane ^
// mask) hold partial sums of the same 2N outputs; the lane keeps the upper or
// the lower N, adds the partner's partial sums of those, and gives the others
// away. After log2(kParts) rounds every output is summed on exactly one lane.
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

// The dhp exchange: each owner lane stores its values into the tile of every
// block of the cluster with st.async, which counts the bytes on that block's
// mbarrier of the buffer; a block takes a step's tile once its mbarrier has
// seen all 3H x R x 4 bytes (its one arrival a phase is the expect_tx that
// announces them).
__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_address(uint32_t address, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(address), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_async(uint32_t address, float a, float b, uint32_t barrier) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
               :: "r"(address), "f"(a), "f"(b), "r"(barrier) : "memory");
}

__device__ __forceinline__ void store_async(uint32_t address, float4 v, uint32_t barrier) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(address), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(barrier) : "memory");
}

__device__ __forceinline__ void barrier_init(uint32_t barrier, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(barrier), "r"(count) : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint32_t barrier) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(barrier) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint32_t barrier, uint32_t bytes) {
  uint64_t state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(barrier), "r"(bytes) : "memory");
  (void)state;
}

// Until the phase of this parity has completed; a fault (trap) instead of a
// hang if it never does.
__device__ __forceinline__ void barrier_wait(uint32_t barrier, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(barrier), "r"(parity) : "memory");
    if (done) return;
    if (tries > kSpinLimit) __trap();
  }
}

// x_proj, hp, dx_proj, dhp [B, T, G, 3H]; y, dy [B, T, G, H]; h0, dh_last,
// dh0 [B, G, H] (dh_last may be null: zeros); w_packed [G, CS, 3H, U] (block
// c's slice [j][u] holds w_hh[g, j, c * U + u], zero where c * U + u >= H; U a
// multiple of 4, (CS - 1) U < H: every block owns a unit). Grid (CS * G,
// ceil(B / R)) in clusters of (CS, 1, 1).
//
// The product of a step is blocked in registers: a thread does 4 units x 8
// rows (32 sums) over every 16th j, so that a 16-byte load of the slice and
// two of the tile feed 32 multiply-adds. A warp is 2 unit groups (lane bit 0;
// at R = 16 it would be the two row planes of one) x 16 j parts (bits 1-4); the
// 16 partial sums of an output meet in four shuffle rounds that leave each
// lane with one unit x 2 rows, whose gates it computes and whose carry it
// keeps in registers.
template <int CS>
__global__ void __launch_bounds__(kBwdMaxThreads)
gru_bwd_resident_kernel(const float* __restrict__ x_proj, const float* __restrict__ hp,
                        const float* __restrict__ y, const float* __restrict__ h0,
                        const float* __restrict__ dy, const float* __restrict__ dh_last,
                        const float* __restrict__ w_packed, float* __restrict__ dx_proj,
                        float* __restrict__ dhp, float* __restrict__ dh0, int B, int T, int G, int H,
                        int U) {
  constexpr int R = kBwdRows;
  constexpr int kPlanes = R / kPlane;
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  const int stride = slice_stride(U);  // chunks a row of the slice
  const int chunks = U / kBwdUnits;    // chunks of a row in use: the block's unit groups
  const float4* wsm = smem;            // [3H][stride]
  float* tile = reinterpret_cast<float*>(smem + static_cast<size_t>(H3) * stride);
  const int plane = plane_floats(H);   // tile is [2][kPlanes][3H][8], each plane padded
  const int buffer = kPlanes * plane;
  const uint32_t full = shared_address(tile + 2 * buffer);  // the 2 buffers' mbarriers, 8 bytes each
  const uint32_t step_bytes = static_cast<uint32_t>(H3) * R * sizeof(float);

  int rank = 0;
  if constexpr (CS > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  uint32_t peer_tile[CS], peer_full[CS];  // this block's tile and mbarriers in every block's window
#pragma unroll
  for (int c = 0; c < CS; ++c) {
    peer_tile[c] = peer_address(shared_address(tile), c);
    peer_full[c] = peer_address(full, c);
  }
  const int g = blockIdx.x / CS;
  const int b0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int combo = 2 * (tid >> 5) + (lane & 1);  // (unit group, plane) of the block's
  const bool loads = combo < chunks * kPlanes;
  const int group = combo / kPlanes;               // units 4 * group .. 4 * group + 3
  const int my_plane = combo % kPlanes;            // rows 8 * my_plane .. + 7 of the tile
  const int part = lane >> 1;                      // j = part, part + 16, ...
  // after the four rounds: unit 2 * b1 + b2 of the group, rows 4 * b3 + 2 * b4 and the next
  const bool b1 = lane & 2, b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  const int k = rank * U + kBwdUnits * group + 2 * b1 + b2;  // this lane's hidden unit
  const bool active = loads && k < H;
  const int rloc = 4 * b3 + 2 * b4;
  const int row0 = b0 + kPlane * my_plane + rloc;  // this lane's first batch row

  // this block's slice of the weight, once, 16 bytes a load, into rows of `stride` chunks
  const float4* wsrc = reinterpret_cast<const float4*>(
      w_packed + (static_cast<size_t>(g) * CS + rank) * H3 * U);
  for (int i = tid; i < H3 * chunks; i += blockDim.x) {
    const int j = i / chunks;
    smem[j * stride + (i - j * chunks)] = __ldg(wsrc + i);
  }

  // the lane's inputs of a step, 2 rows: x_proj and hp of the 3 gates, h_prev, dy
  float xv[3][2], hv[3][2], pv[2], gv[2], carry[2];
  // what of the gates does not depend on the carry, taken while the product runs:
  // dn = dh fn, dz = dh fz, dr = dn fr, dhp_n = dn r, direct = dh z
  float fn[2], fz[2], fr[2], rv[2], zv[2];
  auto gate_factors = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float rg = sigmoid(xv[0][i] + hv[0][i]);
      const float zg = sigmoid(xv[1][i] + hv[1][i]);
      const float ng = tanhf(xv[2][i] + rg * hv[2][i]);
      fn[i] = (1.f - zg) * (1.f - ng * ng);
      fz[i] = (pv[i] - ng) * zg * (1.f - zg);
      fr[i] = hv[2][i] * rg * (1.f - rg);
      rv[i] = rg;
      zv[i] = zg;
    }
  };
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (active && b < B) {
        const size_t row = (static_cast<size_t>(b) * T + t) * G + g;  // (b, t, g)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[q][i] = x_proj[row * H3 + q * H + k];
          hv[q][i] = hp[row * H3 + q * H + k];
        }
        pv[i] = t > 0 ? y[(row - G) * H + k]  // (b, t - 1, g)
                      : h0[(static_cast<size_t>(b) * G + g) * H + k];
        gv[i] = dy[row * H + k];
      } else {  // rows past B: zeros in, so zeros out and a zero carry
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[q][i] = hv[q][i] = 0.f;
        pv[i] = gv[i] = 0.f;
      }
    }
  };
  // the same inputs into L2 a step before their loads: these rows are far
  // apart in device memory, and its latency would otherwise hold up the step
  auto prefetch_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (active && b < B) {
        const size_t row = (static_cast<size_t>(b) * T + t) * G + g;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          asm volatile("prefetch.global.L2 [%0];" :: "l"(x_proj + row * H3 + q * H + k));
          asm volatile("prefetch.global.L2 [%0];" :: "l"(hp + row * H3 + q * H + k));
        }
        if (t > 0) asm volatile("prefetch.global.L2 [%0];" :: "l"(y + (row - G) * H + k));
        asm volatile("prefetch.global.L2 [%0];" :: "l"(dy + row * H + k));
      }
    }
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = row0 + i;
    carry[i] = (active && b < B && dh_last != nullptr)
                   ? dh_last[(static_cast<size_t>(b) * G + g) * H + k] : 0.f;
  }
  load_step(T - 1);
  gate_factors();
  if (T > 1) prefetch_step(T - 2);
  if (tid == 0) {  // the mbarriers, and the bytes of the first use of each buffer
    barrier_init(full);
    barrier_init(full + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(full + 8 * ((T - 1) & 1), step_bytes);
    if (T > 1) barrier_expect(full + 8 * ((T - 2) & 1), step_bytes);
  }
  // weights and mbarriers in place; and no store into a peer before it has started
  if constexpr (CS > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  // A warp that owns no unit (all of its units padding) has nothing to send
  // and nothing to read, and leaves: no phase of an mbarrier waits on it.
  // Thread 0 always stays: its block owns a unit (the launch refuses a
  // cluster that would leave one without).
  if (!__any_sync(0xffffffffu, active)) return;

  for (int t = T - 1; t >= 0; --t) {
    const int s = t & 1;  // the buffer of this step
    float dx[3][2], dp[3][2], direct[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float dh = gv[i] + carry[i];
        const float dn = dh * fn[i];
        const float dz = dh * fz[i];
        const float dr = dn * fr[i];
        dx[0][i] = dp[0][i] = dr;
        dx[1][i] = dp[1][i] = dz;
        dx[2][i] = dn;
        dp[2][i] = dn * rv[i];
        direct[i] = dh * zv[i];  // the direct path; the product through w_hh is added below
      }
      // this unit's dhp of its 2 rows into this step's tile of every block of the cluster
      const uint32_t at = 4 * (s * buffer + my_plane * plane + k * kPlane + rloc);
#pragma unroll
      for (int c = 0; c < CS; ++c) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          store_async(peer_tile[c] + at + 4 * q * H * kPlane, dp[q][0], dp[q][1], peer_full[c] + 8 * s);
      }
    }
    // No cluster barrier a step. A lane sends step t - 2's dhp into buffer s
    // only after its wait for step t - 1's tile, which is whole only once
    // every active lane of the cluster has sent step t - 1, each after its
    // warp's product of step t, the last read of buffer s. So the mbarriers
    // alone keep the blocks within a step of each other, and no store lands
    // in a buffer that a block still reads. Before the wait for the tile:
    // the dx_proj and dhp stores, the next step's loads and the prefetch of
    // the one after.
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = row0 + i;
        if (b < B) {
          const size_t at = ((static_cast<size_t>(b) * T + t) * G + g) * H3 + k;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            dx_proj[at + q * H] = dx[q][i];
            dhp[at + q * H] = dp[q][i];
          }
        }
      }
      if (t > 0) load_step(t - 1);
      if (t > 1) prefetch_step(t - 2);
    }
    barrier_wait(full + 8 * s, ((T - 1 - t) >> 1) & 1);
    // this buffer's next use, step t - 2: its bytes come only after every
    // thread of this block has passed the wait above (they follow this
    // block's sends of step t - 1, thread 0's among them, which follow each
    // warp's product below)
    if (tid == 0 && t > 1) barrier_expect(full + 8 * s, step_bytes);

    // partial sums over j = part, part + 16, ...: index 8 * unit + row
    float acc[kBwdUnits * kPlane];
#pragma unroll
    for (int i = 0; i < kBwdUnits * kPlane; ++i) acc[i] = 0.f;
    if (loads) {
      const float* cur = tile + s * buffer + my_plane * plane;
      const float4* wg = wsm + group;
#pragma unroll 4  // measured at config 2: 1 is 14 % slower, 2 is 7 % slower
      for (int j = part; j < H3; j += kParts) {
        const float4 w = wg[j * stride];
        const float4 lo = *reinterpret_cast<const float4*>(cur + j * kPlane);
        const float4 hi = *reinterpret_cast<const float4*>(cur + j * kPlane + 4);
        const float wv[kBwdUnits] = {w.x, w.y, w.z, w.w};
        const float dv[kPlane] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int v = 0; v < kBwdUnits; ++v) {
#pragma unroll
          for (int r = 0; r < kPlane; ++r) acc[kPlane * v + r] = fmaf(wv[v], dv[r], acc[kPlane * v + r]);
        }
      }
    }
    if (active && t > 0) gate_factors();  // of step t - 1, whose inputs have come in meanwhile
    // every lane of the warp takes part: 32 -> 16, 8 (the unit) -> 4, 2 (the rows)
    float a16[16], a8[8], a4[4], sum[2];
    halve<16>(acc, a16, b1, 2), halve<8>(a16, a8, b2, 4), halve<4>(a8, a4, b3, 8), halve<2>(a4, sum, b4, 16);
    carry[0] = direct[0] + sum[0];
    carry[1] = direct[1] + sum[1];
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (b < B) dh0[(static_cast<size_t>(b) * G + g) * H + k] = carry[i];
    }
  }
}

template <int CS>
int launch_resident_bwd(const void* x_proj, const void* hp, const void* y, const void* h0,
                        const void* dy, const void* dh_last, const void* w_packed, void* dx_proj,
                        void* dhp, void* dh0, int B, int T, int G, int H, void* stream) {
  const int U = ((H + CS - 1) / CS + kBwdUnits - 1) / kBwdUnits * kBwdUnits;
  const int threads = (U / kBwdUnits * (kBwdRows / kPlane) + 1) / 2 * 32;
  const size_t smem = resident_bwd_bytes(H, U, kBwdRows);
  // a block with no unit would leave while its peers still send into it
  if (threads > kBwdMaxThreads || smem > kSharedLimit || (CS - 1) * U >= H) return cudaErrorInvalidValue;
  // the shared-memory grant is asked for once a device and size, not on every launch
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_bwd_resident_kernel<CS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CS * G, (B + kBwdRows - 1) / kBwdRows);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;  // a cluster launch also at CS = 1: the dhp exchange addresses the cluster's window
  err = cudaLaunchKernelEx(&config, gru_bwd_resident_kernel<CS>,
                           static_cast<const float*>(x_proj), static_cast<const float*>(hp),
                           static_cast<const float*>(y), static_cast<const float*>(h0),
                           static_cast<const float*>(dy), static_cast<const float*>(dh_last),
                           static_cast<const float*>(w_packed), static_cast<float*>(dx_proj),
                           static_cast<float*>(dhp), static_cast<float*>(dh0), B, T, G, H, U);
  return err != cudaSuccess ? err : cudaGetLastError();
}


// The 16-block kernel's shared memory: the slice, H rows of scatter_stride(U)
// 16-byte chunks (3U / 4 in use, padded to a multiple of 8 so that the XOR
// swizzle stays inside the row), the partials [2][CS][U][R] and 2 mbarriers.
__host__ __device__ constexpr int scatter_stride(int U) { return (3 * U / 4 + 7) / 8 * 8; }

__host__ __device__ constexpr size_t scatter_bytes(int H, int U) {
  return static_cast<size_t>(H) * scatter_stride(U) * 16 +
         2 * static_cast<size_t>(kScatterCS) * U * kScatterRows * sizeof(float) + 2 * sizeof(uint64_t);
}

// x_proj, hp, dx_proj, dhp [B, T, G, 3H]; y, dy [B, T, G, H]; h0, dh_last,
// dh0 [B, G, H] (dh_last may be null: zeros); w_packed [G, 16, H, 3, U]
// (packed_weight: block c's [k][gate][u] holds w_hh[g, gate * H + c * U + u,
// k], zero where c * U + u >= H; U a multiple of 4 up to 32, 15 U < H).
// Grid (16 G, ceil(B / 8)) in clusters of (16, 1, 1), 128 threads a block.
//
// A step t, in block c: the lane that owns (unit u, 2 rows) waits for the
// partials of product t + 1 (buffer (t + 1) & 1), adds the 16 slots and its
// direct term into its carry, finishes the gates, stores dx_proj and dhp, and
// writes its 3 x 2 dhp values into slots 0..2 of the same buffer at its own
// (u, rows), which only it has read: the tile [3U][R] is those three slots.
// After one __syncthreads every thread takes its 4 k x 8 rows of the partial
// carry over the 3U rows j, and stores them into block k / U's slot c of
// buffer t & 1 with st.async. No peer writes a buffer that a block still
// reads: the partials of product t - 1 into buffer (t + 1) & 1 follow a
// peer's wait for product t, which follows every lane's sends of it here,
// each after this block's reads of the tile.
__global__ void __launch_bounds__(kScatterThreads, 1)
gru_bwd_scatter_kernel(const float* __restrict__ x_proj, const float* __restrict__ hp,
                       const float* __restrict__ y, const float* __restrict__ h0,
                       const float* __restrict__ dy, const float* __restrict__ dh_last,
                       const float* __restrict__ w_packed, float* __restrict__ dx_proj,
                       float* __restrict__ dhp, float* __restrict__ dh0, int B, int T, int G, int H,
                       int U) {
  constexpr int CS = kScatterCS;
  constexpr int R = kScatterRows;
  extern __shared__ float4 smem[];
  const int H3 = 3 * H;
  const int stride = scatter_stride(U);  // chunks a k row of the slice
  const int row_chunks = 3 * U / 4;      // of them in use
  float* recv = reinterpret_cast<float*>(smem + static_cast<size_t>(H) * stride);  // [2][CS][U][R]
  const int buffer = CS * U * R;                                                  // floats a buffer
  const uint32_t full = shared_address(recv + 2 * buffer);  // the 2 buffers' mbarriers

  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int g = blockIdx.x / CS;
  const int b0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the gates: unit u of the block's (8 a warp), rows rloc and rloc + 1 (4 row pairs a unit)
  const int u = 8 * (tid >> 5) + (lane >> 2);
  const int k = rank * U + u;  // this lane's hidden unit
  const bool in_tile = u < U;
  const bool active = in_tile && k < H;
  const int rloc = 2 * (lane & 3);
  const int row0 = b0 + rloc;
  // bytes of a step's partials into this block: 16 senders x its units x R rows
  const uint32_t step_bytes = static_cast<uint32_t>(CS * min(U, H - rank * U) * R * sizeof(float));

  // the product's outputs: k_i = 128 i + tid for k_i < H, all R rows, sent to block k_i / U
  int rows_at[kScatterK];                  // k_i's row of the slice (k_i clamped below H)
  uint32_t to[kScatterK], to_full[kScatterK];  // this block's slot at k_i's unit in its owner, its mbarrier
#pragma unroll
  for (int i = 0; i < kScatterK; ++i) {
    const int kc = min(kScatterThreads * i + tid, H - 1);
    const int peer = kc / U;
    rows_at[i] = kc * stride;
    to[i] = peer_address(shared_address(recv + (rank * U + kc - peer * U) * R), peer);
    to_full[i] = peer_address(full, peer);
  }
  const int swizzle = tid & 7;  // k_i & 7 for every i

  // this block's slice, once, 16 bytes a load: chunk n of row k at n ^ (k & 7)
  const float4* wsrc = reinterpret_cast<const float4*>(w_packed + (static_cast<size_t>(g) * CS + rank) * H3 * U);
  for (int i = tid; i < H * row_chunks; i += kScatterThreads) {
    const int kr = i / row_chunks;
    smem[kr * stride + ((i - kr * row_chunks) ^ (kr & 7))] = __ldg(wsrc + i);
  }

  // the lane's step inputs and gate factors as in gru_bwd_resident_kernel, written out again: one struct
  // for both kernels grew that kernel's registers at config 2
  // the lane's inputs of a step, 2 rows: x_proj and hp of the 3 gates, h_prev, dy
  float xv[3][2], hv[3][2], pv[2], gv[2], carry[2];
  // what of the gates does not depend on the carry, taken while the product runs:
  // dn = dh fn, dz = dh fz, dr = dn fr, dhp_n = dn r, direct = dh z
  float fn[2], fz[2], fr[2], rv[2], zv[2];
  auto gate_factors = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float rg = sigmoid(xv[0][i] + hv[0][i]);
      const float zg = sigmoid(xv[1][i] + hv[1][i]);
      const float ng = tanhf(xv[2][i] + rg * hv[2][i]);
      fn[i] = (1.f - zg) * (1.f - ng * ng);
      fz[i] = (pv[i] - ng) * zg * (1.f - zg);
      fr[i] = hv[2][i] * rg * (1.f - rg);
      rv[i] = rg;
      zv[i] = zg;
    }
  };
  auto load_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (active && b < B) {
        const size_t row = (static_cast<size_t>(b) * T + t) * G + g;  // (b, t, g)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[q][i] = x_proj[row * H3 + q * H + k];
          hv[q][i] = hp[row * H3 + q * H + k];
        }
        pv[i] = t > 0 ? y[(row - G) * H + k]  // (b, t - 1, g)
                      : h0[(static_cast<size_t>(b) * G + g) * H + k];
        gv[i] = dy[row * H + k];
      } else {  // rows past B: zeros in, so zeros out and a zero carry
#pragma unroll
        for (int q = 0; q < 3; ++q) xv[q][i] = hv[q][i] = 0.f;
        pv[i] = gv[i] = 0.f;
      }
    }
  };
  // the same inputs into L2 a step before their loads: these rows are far
  // apart in device memory, and its latency would otherwise hold up the step
  auto prefetch_step = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (active && b < B) {
        const size_t row = (static_cast<size_t>(b) * T + t) * G + g;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          asm volatile("prefetch.global.L2 [%0];" :: "l"(x_proj + row * H3 + q * H + k));
          asm volatile("prefetch.global.L2 [%0];" :: "l"(hp + row * H3 + q * H + k));
        }
        if (t > 0) asm volatile("prefetch.global.L2 [%0];" :: "l"(y + (row - G) * H + k));
        asm volatile("prefetch.global.L2 [%0];" :: "l"(dy + row * H + k));
      }
    }
  };
  // the carry's 16 partial sums at this lane's (unit, rows) in a buffer, after the direct term
  auto add_partials = [&](const float* buf, const float (&direct)[2]) {
    float s0 = direct[0], s1 = direct[1];
#pragma unroll
    for (int c = 0; c < CS; ++c) {
      const float2 v = *reinterpret_cast<const float2*>(buf + (c * U + u) * R + rloc);
      s0 += v.x;
      s1 += v.y;
    }
    carry[0] = s0;
    carry[1] = s1;
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int b = row0 + i;
    carry[i] = (active && b < B && dh_last != nullptr) ? dh_last[(static_cast<size_t>(b) * G + g) * H + k] : 0.f;
  }
  load_step(T - 1);
  gate_factors();
  if (T > 1) prefetch_step(T - 2);
  if (tid == 0) {  // the mbarriers, and the bytes of products T - 1 and T - 2
    barrier_init(full);
    barrier_init(full + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    barrier_expect(full + 8 * ((T - 1) & 1), step_bytes);
    if (T > 1) barrier_expect(full + 8 * ((T - 2) & 1), step_bytes);
  }
  // slices and mbarriers in place; and no store into a peer before it has started
  cluster_arrive();
  cluster_wait();

  float direct[2] = {0.f, 0.f};
  for (int t = T - 1; t >= 0; --t) {
    const int s = (t + 1) & 1;
    float* buf = recv + s * buffer;  // product t + 1's partials: this step's carry, then its dhp tile
    if (t < T - 1) {
      barrier_wait(full + 8 * s, ((T - 2 - t) >> 1) & 1);
      // product t - 1's bytes: they follow every lane's sends of product t, after this wait
      if (tid == 0 && t > 0) barrier_expect(full + 8 * s, step_bytes);
      if (active) add_partials(buf, direct);
    }
    if (in_tile) {
      float dp[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};  // padding units: zero rows of the tile
      if (active) {
        float dx[3][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float dh = gv[i] + carry[i];
          const float dn = dh * fn[i];
          const float dz = dh * fz[i];
          const float dr = dn * fr[i];
          dx[0][i] = dp[0][i] = dr;
          dx[1][i] = dp[1][i] = dz;
          dx[2][i] = dn;
          dp[2][i] = dn * rv[i];
          direct[i] = dh * zv[i];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = row0 + i;
          if (b < B) {
            const size_t at = ((static_cast<size_t>(b) * T + t) * G + g) * H3 + k;
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              dx_proj[at + q * H] = dx[q][i];
              dhp[at + q * H] = dp[q][i];
            }
          }
        }
        if (t > 0) load_step(t - 1);
        if (t > 1) prefetch_step(t - 2);
      }
      // the tile row j = q U + u is slot q at unit u: what this lane alone has just read
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<float2*>(buf + (q * U + u) * R + rloc) = make_float2(dp[q][0], dp[q][1]);
    }
    __syncthreads();  // the tile is whole

    // partial carry of k_i, index R * i + row, over the block's 3U rows j
    float acc[kScatterK * R];
#pragma unroll
    for (int i = 0; i < kScatterK * R; ++i) acc[i] = 0.f;
    const float4* tile = reinterpret_cast<const float4*>(buf);  // [3U][R]: 2 chunks a row j
#pragma unroll 2
    for (int n = 0; n < row_chunks; ++n) {
      float wv[kScatterK][4];
#pragma unroll
      for (int i = 0; i < kScatterK; ++i) {
        const float4 w = smem[rows_at[i] + (n ^ swizzle)];
        wv[i][0] = w.x, wv[i][1] = w.y, wv[i][2] = w.z, wv[i][3] = w.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 lo = tile[2 * (4 * n + jj)], hi = tile[2 * (4 * n + jj) + 1];
        const float dv[R] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < kScatterK; ++i) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[R * i + r] = fmaf(wv[i][jj], dv[r], acc[R * i + r]);
        }
      }
    }
    // into the owners' buffer t & 1, 32 bytes a k
    const uint32_t off = (t & 1) * buffer * sizeof(float);
#pragma unroll
    for (int i = 0; i < kScatterK; ++i) {
      if (kScatterThreads * i + tid < H) {
        const float* a = acc + R * i;
        store_async(to[i] + off, make_float4(a[0], a[1], a[2], a[3]), to_full[i] + 8 * (t & 1));
        store_async(to[i] + off + 16, make_float4(a[4], a[5], a[6], a[7]), to_full[i] + 8 * (t & 1));
      }
    }
    if (active && t > 0) gate_factors();  // of step t - 1, whose inputs have come in meanwhile
  }

  // dh0: product 0's partials, in buffer 0; its wait is also the last store into this block
  barrier_wait(full, ((T - 1) >> 1) & 1);
  if (active) {
    add_partials(recv, direct);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = row0 + i;
      if (b < B) dh0[(static_cast<size_t>(b) * G + g) * H + k] = carry[i];
    }
  }
}

// The 16-block kernel's U and shared memory at hidden size H, and its
// attributes set once a device (the grant, the non-portable cluster size);
// cudaErrorInvalidValue where H does not fit it.
cudaError_t scatter_setup(int H, int& U, size_t& smem) {
  U = ((H + kScatterCS - 1) / kScatterCS + kBwdUnits - 1) / kBwdUnits * kBwdUnits;
  smem = scatter_bytes(H, U);
  // a block with no unit would expect no partials and send none to itself: refused, as in the resident kernel
  if (H < 1 || U > kScatterMaxUnits || (kScatterCS - 1) * U >= H || smem > kSharedLimit) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_bwd_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gru_bwd_scatter_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t scatter_config(int G, int B, size_t smem, cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kScatterCS * G, (B + kScatterRows - 1) / kScatterRows);
  config.blockDim = dim3(kScatterThreads);
  config.dynamicSmemBytes = smem;
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kScatterCS;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return config;
}

// The bulk copy of a ring stage (the TMA's 1-D form): bytes (a multiple of 16)
// from global src to shared dst, both 16-byte aligned, counted on the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t barrier) {
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

// x_proj, hp, dx_proj, dhp [B, T, G, 3H]; y, dy [B, T, G, H]; h0, dh_last,
// dh0 [B, G, H] (dh_last may be null: zeros); w_p [G, 3H, Hp] (w_hh with its
// rows padded by zeros to Hp units, a multiple of 8, 16-byte aligned); vec: H
// % 4 == 0 and every tensor 16-byte aligned (16-byte loads and stores). Grid
// (G, ceil(B / R)); a block is 2 j halves x (R / 8) row groups x (Hp / 8)
// unit groups, rounded up to warps. Shared memory: the ring [S][32][Hp], the
// tile [3H][R], then 2 S mbarriers.
//
// A lane pair (lane bit 0: the j half, even or odd rows j) owns 8 units x 8
// rows: in the product each lane sums over its half of j, two 16-byte loads
// of the weight row and two of the tile feeding 64 multiply-adds (a whole
// chunk unrolled, so that the loads run ahead of the multiply-adds); then one
// shuffle round (halve) leaves the lower lane with the whole sums of the
// first 4 units and the upper with the last 4, each started from its direct
// term, and each lane finishes the gates of its 4 units x 8 rows.
template <int R>
__global__ void __launch_bounds__(R == 32 ? kRowsMaxThreads : kRowsParts * (kMaxHidden / kRowsUnits) * (R / kPlane), 1)
gru_bwd_rows_kernel(const float* __restrict__ x_proj, const float* __restrict__ hp,
                    const float* __restrict__ y, const float* __restrict__ h0,
                    const float* __restrict__ dy, const float* __restrict__ dh_last,
                    const float* __restrict__ w_p, float* __restrict__ dx_proj,
                    float* __restrict__ dhp, float* __restrict__ dh0, int B, int T, int G, int H, int Hp,
                    int S, int vec) {
  // chunk n + lead goes into the stage of chunk n - 1, which thread 0 waits for every warp to have left
  const int lead = S - 1;
  extern __shared__ float4 smem[];
  const int stage = kRowsChunk * Hp;  // floats a stage
  float* ring = reinterpret_cast<float*>(smem);
  const int H3 = 3 * H;
  float* tile = ring + S * stage;  // [3H][R]
  const uint32_t full = shared_address(tile + static_cast<size_t>(H3) * R);  // S mbarriers, 8 bytes each
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = blockIdx.x;
  const int b0 = blockIdx.y * R;
  const int chunks = (H3 + kRowsChunk - 1) / kRowsChunk;  // of a step
  const int total = T * chunks;
  constexpr int quads = R / 4 - 1;  // mask of a row's chunk index
  const float* wg = w_p + static_cast<size_t>(g) * H3 * Hp;
  auto at = [&](int j, int c) { return j * R + 4 * (c ^ ((j >> 3) & quads)); };  // rows 4c .. 4c + 3 of row j
  auto fill = [&](int n) {  // chunk n (of all T steps) into its stage
    const int s = n % S;
    if (n >= S) barrier_wait(empty + 8 * s, static_cast<uint32_t>((n / S - 1) & 1));
    const int c = n % chunks;
    const int rows = min(kRowsChunk, H3 - c * kRowsChunk);
    const uint32_t bytes = static_cast<uint32_t>(rows * Hp * sizeof(float));
    barrier_expect(full + 8 * s, bytes);
    bulk_copy(shared_address(ring + s * stage), wg + static_cast<size_t>(c) * kRowsChunk * Hp, bytes, full + 8 * s);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      barrier_init(full + 8 * s);
      barrier_init(empty + 8 * s, blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int n = 0; n < lead && n < total; ++n) fill(n);
  }

  const int half = tid & 1;  // the lane's half of j (j = half, half + 2, ...), and of the pair's 8 units
  const int unit_groups = Hp / kRowsUnits;
  const int row_group = (tid >> 1) / unit_groups;
  const bool live = row_group < R / kPlane;  // threads past the last row group only keep the ring going
  const int q0 = 2 * (live ? row_group : 0);  // the pair's rows: chunks q0 and q0 + 1 of the tile's rows
  const int r0 = 4 * q0;
  const int k8 = kRowsUnits * ((tid >> 1) % unit_groups);  // the pair's units k8 .. k8 + 7
  const int k0 = k8 + kBwdUnits * half;                    // the lane's own 4 of them, whose gates it takes
  const int valid = live ? max(0, min(kBwdUnits, H - k0)) : 0;  // the lane's units below H

  // the carry of (row b0 + r0 + r, unit k0 + v) at index kPlane * v + r, then the direct term dh z
  float carry[kBwdUnits * kPlane];
#pragma unroll
  for (int v = 0; v < kBwdUnits; ++v) {
#pragma unroll
    for (int r = 0; r < kPlane; ++r) {
      const int b = b0 + r0 + r;
      carry[kPlane * v + r] = (v < valid && b < B && dh_last != nullptr)
                                  ? dh_last[(static_cast<size_t>(b) * G + g) * H + k0 + v] : 0.f;
    }
  }
  __syncthreads();  // the mbarriers are initialised

  int i = 0, s = 0;    // chunks consumed; the stage of chunk i
  uint32_t phase = 0;  // the parity of chunk i's use of its stage
  for (int t = T - 1; t >= 0; --t) {
    if (live) {
      // a row's inputs: x_proj [3][4], hp [3][4], h_prev [4], dy [4]; 2 rows in flight
      constexpr int kXRows = 2;
      float in[kXRows][8][kBwdUnits];
      auto load_row = [&](int r, float (&v)[8][kBwdUnits]) {
        const int b = b0 + r0 + r;
        const int n = b < B ? valid : 0;
        const bool vb = vec && b < B;
        const size_t row = (static_cast<size_t>(b) * T + t) * G + g;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          load_units(x_proj + row * H3 + q * H + k0, vb, n, v[q]);
          load_units(hp + row * H3 + q * H + k0, vb, n, v[3 + q]);
        }
        load_units(t > 0 ? y + (row - G) * H + k0 : h0 + (static_cast<size_t>(b) * G + g) * H + k0, vb, n, v[6]);
        load_units(dy + row * H + k0, vb, n, v[7]);
      };
#pragma unroll
      for (int r = 0; r < kXRows - 1; ++r) load_row(r, in[r]);
#pragma unroll
      for (int r = 0; r < kPlane; ++r) {
        if (r + kXRows - 1 < kPlane) load_row(r + kXRows - 1, in[(r + kXRows - 1) % kXRows]);
        const float(&v)[8][kBwdUnits] = in[r % kXRows];
        float dx[3][kBwdUnits], dp[3][kBwdUnits];
        // rows r0 + r of units k0 .. k0 + 3 in the tile: chunk q0 + r / 4 (swizzled by each row j's own), word r % 4
        const int c = q0 + r / 4;
#pragma unroll
        for (int u = 0; u < kBwdUnits; ++u) {
          const float rg = sigmoid(v[0][u] + v[3][u]);
          const float zg = sigmoid(v[1][u] + v[4][u]);
          const float ng = tanhf(v[2][u] + rg * v[5][u]);
          const float dh = v[7][u] + carry[kPlane * u + r];
          const float dn = dh * (1.f - zg) * (1.f - ng * ng);
          const float dz = dh * (v[6][u] - ng) * zg * (1.f - zg);
          const float dr = dn * v[5][u] * rg * (1.f - rg);
          dx[0][u] = dp[0][u] = dr;
          dx[1][u] = dp[1][u] = dz;
          dx[2][u] = dn;
          dp[2][u] = dn * rg;
          carry[kPlane * u + r] = dh * zg;  // the direct path; the product adds w_hh^T dhp to it
          if (u < valid) {
#pragma unroll
            for (int q = 0; q < 3; ++q) tile[at(q * H + k0 + u, c) + r % 4] = dp[q][u];
          }
        }
        const int b = b0 + r0 + r;
        if (b < B) {
          const size_t at_x = ((static_cast<size_t>(b) * T + t) * G + g) * H3 + k0;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            store_units(dx_proj + at_x + q * H, vec, valid, dx[q]);
            store_units(dhp + at_x + q * H, vec, valid, dp[q]);
          }
        }
      }
    }
    __syncthreads();  // the step's dhp tile is whole
    // the pair's 8 units x 8 rows over this lane's half of j, index kPlane * unit + row; the lane's
    // own 4 units start from their direct term
    float acc[kRowsUnits * kPlane];
#pragma unroll
    for (int a = 0; a < kBwdUnits * kPlane; ++a) {
      acc[a] = half ? 0.f : carry[a];
      acc[kBwdUnits * kPlane + a] = half ? carry[a] : 0.f;
    }
    // row j of the stage (row jj of its group of 8, whose tile rows start at lo_row and hi_row) into the sums
    auto multiply = [&](const float* ws, const float* lo_row, const float* hi_row, int j, int jj) {
      const float4 wa = *reinterpret_cast<const float4*>(ws + j * Hp);
      const float4 wb = *reinterpret_cast<const float4*>(ws + j * Hp + 4);
      const float4 lo = *reinterpret_cast<const float4*>(lo_row + jj * R);
      const float4 hi = *reinterpret_cast<const float4*>(hi_row + jj * R);
      const float wv[kRowsUnits] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float dv[kPlane] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int u = 0; u < kRowsUnits; ++u) {
#pragma unroll
        for (int r = 0; r < kPlane; ++r) acc[kPlane * u + r] = fmaf(wv[u], dv[r], acc[kPlane * u + r]);
      }
    };
    for (int c = 0; c < chunks; ++c, ++i) {
      if (tid == 0 && i + lead < total) fill(i + lead);
      barrier_wait(full + 8 * s, phase);
      if (live) {
        const float* ws = ring + s * stage + k8;
        const int j0 = c * kRowsChunk;
        const int rows = min(kRowsChunk, H3 - j0);
        // 8 j rows at a time, which share the tile's swizzle; this lane's 4 of them
        if (rows == kRowsChunk) {
#pragma unroll
          for (int j8 = 0; j8 < kRowsChunk; j8 += 8) {
            const float* lo_row = tile + at(j0 + j8, q0);
            const float* hi_row = tile + at(j0 + j8, q0 + 1);
#pragma unroll
            for (int m = 0; m < 8 / kRowsParts; ++m) {
              const int jj = kRowsParts * m + half;
              multiply(ws, lo_row, hi_row, j8 + jj, jj);
            }
          }
        } else {
          for (int j8 = 0; j8 < rows; j8 += 8) {
            const float* lo_row = tile + at(j0 + j8, q0);
            const float* hi_row = tile + at(j0 + j8, q0 + 1);
            for (int jj = half; jj < min(8, rows - j8); jj += kRowsParts) multiply(ws, lo_row, hi_row, j8 + jj, jj);
          }
        }
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(empty + 8 * s);
      if (++s == S) s = 0, phase ^= 1;
    }
    // the pair's two halves of j meet: the lower lane keeps units k8 .. k8 + 3, the upper the rest
    halve<kBwdUnits * kPlane>(acc, carry, half, 1);
    __syncthreads();  // every read of the tile by this step's product is done
  }

  if (live) {
#pragma unroll
    for (int v = 0; v < kBwdUnits; ++v) {
#pragma unroll
      for (int r = 0; r < kPlane; ++r) {
        const int b = b0 + r0 + r;
        if (v < valid && b < B) dh0[(static_cast<size_t>(b) * G + g) * H + k0 + v] = carry[kPlane * v + r];
      }
    }
  }
}

// The row-tiled kernel's plan at (H, R): Hp, its threads, the ring's depth
// (as many stages as shared memory holds beside the tile, up to kMaxStages)
// and its bytes.
void rows_plan(int H, int R, int& Hp, int& threads, int& S, size_t& smem) {
  Hp = (H + kRowsUnits - 1) / kRowsUnits * kRowsUnits;
  threads = (kRowsParts * (R / kPlane) * (Hp / kRowsUnits) + 31) / 32 * 32;
  const size_t stage = static_cast<size_t>(kRowsChunk) * Hp * sizeof(float) + 2 * sizeof(uint64_t);
  const size_t tile = 3 * static_cast<size_t>(H) * R * sizeof(float);
  const size_t room = tile < kSharedLimit ? (kSharedLimit - tile) / stage : 0;
  S = static_cast<int>(room < kMaxStages ? room : kMaxStages);
  smem = S * stage + tile;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int R>
int launch_bwd_rows(const void* x_proj, const void* hp, const void* y, const void* h0, const void* dy,
                    const void* dh_last, const void* w_p, void* dx_proj, void* dhp, void* dh0, int B, int T,
                    int G, int H, void* stream) {
  int Hp = 0, threads = 0, S = 0;
  size_t smem = 0;
  rows_plan(H, R, Hp, threads, S, smem);
  if (threads > kRowsMaxThreads || S < kMinStages) return cudaErrorInvalidValue;
  static size_t granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || smem > granted[device]) {
    err = cudaFuncSetAttribute(gru_bwd_rows_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = smem;
  }
  const void* all[] = {x_proj, hp, y, h0, dy, dh_last, dx_proj, dhp, dh0};
  bool vec = H % 4 == 0;
  for (const void* p : all) vec = vec && aligned16(p);  // dh_last may be null: aligned
  const dim3 grid(G, (B + R - 1) / R);
  gru_bwd_rows_kernel<R><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(hp), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(dy), static_cast<const float*>(dh_last),
      static_cast<const float*>(w_p), static_cast<float*>(dx_proj), static_cast<float*>(dhp),
      static_cast<float*>(dh0), B, T, G, H, Hp, S, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The row-tiled kernel: w_p is [G, 3H, Hp] (padded_weight_bwd), R in (8, 16, 32).
int gru_bwd_rows_f32(const void* x_proj, const void* hp, const void* y, const void* h0, const void* dy,
                     const void* dh_last, const void* w_p, void* dx_proj, void* dhp, void* dh0, int B, int T,
                     int G, int H, int R, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1 || H > kMaxHidden) return cudaErrorInvalidValue;
  if (T > (1 << 30) / ((3 * kMaxHidden + kRowsChunk - 1) / kRowsChunk)) return cudaErrorInvalidValue;  // chunks in an int
  if (!aligned16(w_p)) return cudaErrorMisalignedAddress;  // the ring's bulk copies
  switch (R) {
    case 8: return launch_bwd_rows<8>(x_proj, hp, y, h0, dy, dh_last, w_p, dx_proj, dhp, dh0, B, T, G, H, stream);
    case 16: return launch_bwd_rows<16>(x_proj, hp, y, h0, dy, dh_last, w_p, dx_proj, dhp, dh0, B, T, G, H, stream);
    case 32: return launch_bwd_rows<32>(x_proj, hp, y, h0, dy, dh_last, w_p, dx_proj, dhp, dh0, B, T, G, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The 16-block kernel: w_packed is the forward's [G, 16, H, 3, U] (packed_weight), U = ceil(H / 16)
// rounded up to a multiple of 4, at most 32, with 15 U < H.
int gru_bwd_scatter_f32(const void* x_proj, const void* hp, const void* y, const void* h0, const void* dy,
                        const void* dh_last, const void* w_packed, void* dx_proj, void* dhp, void* dh0, int B,
                        int T, int G, int H, void* stream) {
  if (B < 1 || T < 1 || G < 1) return cudaErrorInvalidValue;
  int U = 0;
  size_t smem = 0;
  cudaError_t err = scatter_setup(H, U, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t config = scatter_config(G, B, smem, cluster);
  config.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&config, gru_bwd_scatter_kernel, static_cast<const float*>(x_proj),
                           static_cast<const float*>(hp), static_cast<const float*>(y),
                           static_cast<const float*>(h0), static_cast<const float*>(dy),
                           static_cast<const float*>(dh_last), static_cast<const float*>(w_packed),
                           static_cast<float*>(dx_proj), static_cast<float*>(dhp), static_cast<float*>(dh0), B,
                           T, G, H, U);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of the 16-block kernel at hidden size H that the current device
// runs at once, into *count.
int gru_bwd_scatter_clusters(int H, void* count) {
  int U = 0;
  size_t smem = 0;
  cudaError_t err = scatter_setup(H, U, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cudaLaunchConfig_t config = scatter_config(1, 1, smem, cluster);
  return cudaOccupancyMaxActiveClusters(static_cast<int*>(count), gru_bwd_scatter_kernel, &config);
}

// The resident kernel: w_packed is [G, CS, 3H, U], U = ceil(H / CS) rounded up
// to a multiple of 4, CS in (1, 2, 4, 8) with (CS - 1) U < H.
int gru_bwd_resident_f32(const void* x_proj, const void* hp, const void* y, const void* h0,
                         const void* dy, const void* dh_last, const void* w_packed, void* dx_proj,
                         void* dhp, void* dh0, int B, int T, int G, int H, int CS, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1) return cudaErrorInvalidValue;
  switch (CS) {
    case 1: return launch_resident_bwd<1>(x_proj, hp, y, h0, dy, dh_last, w_packed, dx_proj, dhp, dh0, B, T, G, H, stream);
    case 2: return launch_resident_bwd<2>(x_proj, hp, y, h0, dy, dh_last, w_packed, dx_proj, dhp, dh0, B, T, G, H, stream);
    case 4: return launch_resident_bwd<4>(x_proj, hp, y, h0, dy, dh_last, w_packed, dx_proj, dhp, dh0, B, T, G, H, stream);
    case 8: return launch_resident_bwd<8>(x_proj, hp, y, h0, dy, dh_last, w_packed, dx_proj, dhp, dh0, B, T, G, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
