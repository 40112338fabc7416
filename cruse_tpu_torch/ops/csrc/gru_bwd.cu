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
// expf/tanhf, f32 throughout, no fast-math. Two kernels, which differ in
// where w_hh lives; ops/gru_kernel.py::resident_bwd_plan picks one from the
// shape alone.
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
// gru_bwd_kernel: the general-shape kernel (H <= 512). A block owns (group,
//   8 rows) and walks t down on its own, with no communication between
//   blocks. Thread k owns hidden unit k: it keeps the carry of its unit for
//   the 8 rows in registers, computes the gates of its unit, and stores its
//   three dhp values of each row into a double-buffered [3H][8] tile in
//   shared memory; after one barrier it takes its unit's column of the
//   product, carry[k] += sum_j w_hh[g, j, k] dhp[j], reading w_hh[g, j, k]
//   coalesced over k straight from L2 in the layout the weight already has
//   ([G, 3H, H]), 8 rows at a time, and the tile's row j as two float4
//   broadcasts. One barrier a step: the next step writes the other buffer.
//   What bounds it: each step streams the group's weight (3H x H floats: 371
//   KB at H = 176) from L2 into every block, more than an SM's L1 holds, so a
//   step costs the latency of that stream (31.7 us a step at config 2 on an
//   H100), not arithmetic. It takes the shapes no cluster holds.
//
// Plain C interface (bound with ctypes): every pointer and the stream is a
// void*, the launch is on the caller's stream, nothing is allocated here, and
// each entry returns the error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;          // streamed kernel: batch rows a block
constexpr int kMaxThreads = 512;  // streamed kernel: one thread a hidden unit, H <= 512
constexpr int kChunk = 8;         // streamed kernel: weights a thread loads before their multiply-adds
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

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// x_proj, hp, dx_proj, dhp [B, T, G, 3H]; y, dy [B, T, G, H]; h0, dh_last, dh0
// [B, G, H] (dh_last may be null: zeros); w_hh [G, 3H, H]. All contiguous f32.
__global__ void __launch_bounds__(kMaxThreads)
gru_bwd_kernel(const float* __restrict__ x_proj, const float* __restrict__ hp,
               const float* __restrict__ y, const float* __restrict__ h0,
               const float* __restrict__ dy, const float* __restrict__ dh_last,
               const float* __restrict__ w_hh, float* __restrict__ dx_proj,
               float* __restrict__ dhp, float* __restrict__ dh0, int B, int T, int G, int H) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);  // [2][3H][kRows]: a step's dhp, double-buffered

  const int g = blockIdx.x;
  const int b0 = blockIdx.y * kRows;
  const int k = threadIdx.x;
  const bool active = k < H;
  const int H3 = 3 * H;
  const float* w = w_hh + static_cast<size_t>(g) * H3 * H;  // [3H][H] of this group

  float carry[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int b = b0 + r;
    carry[r] = (active && b < B && dh_last != nullptr)
                   ? dh_last[(static_cast<size_t>(b) * G + g) * H + k] : 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    float* cur = tile + (t & 1) * H3 * kRows;
    if (active) {
      float d_r[kRows], d_z[kRows], d_n[kRows];  // this unit's dhp of each row
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = b0 + r;
        d_r[r] = d_z[r] = d_n[r] = 0.f;
        if (b < B) {
          const size_t row = (static_cast<size_t>(b) * T + t) * G + g;  // (b, t, g)
          const float* xp = x_proj + row * H3;
          const float* hq = hp + row * H3;
          const float xr = xp[k], xz = xp[H + k], xn = xp[2 * H + k];
          const float hr = hq[k], hz = hq[H + k], hn = hq[2 * H + k];
          const float h_prev = t > 0 ? y[(row - G) * H + k]  // (b, t - 1, g)
                                     : h0[(static_cast<size_t>(b) * G + g) * H + k];
          const float dh = dy[row * H + k] + carry[r];
          const float rg = sigmoid(xr + hr);
          const float zg = sigmoid(xz + hz);
          const float ng = tanhf(xn + rg * hn);
          const float dn = dh * (1.f - zg) * (1.f - ng * ng);
          const float dz = dh * (h_prev - ng) * zg * (1.f - zg);
          const float dr = dn * hn * rg * (1.f - rg);
          float* dx = dx_proj + row * H3;
          float* dp = dhp + row * H3;
          dx[k] = dr;
          dx[H + k] = dz;
          dx[2 * H + k] = dn;
          d_r[r] = dr;
          d_z[r] = dz;
          d_n[r] = dn * rg;
          dp[k] = d_r[r];
          dp[H + k] = d_z[r];
          dp[2 * H + k] = d_n[r];
          carry[r] = dh * zg;  // the direct path; the product through w_hh is added below
        }
      }
      float4* out = reinterpret_cast<float4*>(cur);
      out[2 * k] = make_float4(d_r[0], d_r[1], d_r[2], d_r[3]);
      out[2 * k + 1] = make_float4(d_r[4], d_r[5], d_r[6], d_r[7]);
      out[2 * (H + k)] = make_float4(d_z[0], d_z[1], d_z[2], d_z[3]);
      out[2 * (H + k) + 1] = make_float4(d_z[4], d_z[5], d_z[6], d_z[7]);
      out[2 * (2 * H + k)] = make_float4(d_n[0], d_n[1], d_n[2], d_n[3]);
      out[2 * (2 * H + k) + 1] = make_float4(d_n[4], d_n[5], d_n[6], d_n[7]);
    }
    __syncthreads();
    if (active) {
      const float4* d = reinterpret_cast<const float4*>(cur);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const int full = H3 / kChunk * kChunk;
      for (int j0 = 0; j0 < full; j0 += kChunk) {
        float wv[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) wv[u] = __ldg(w + static_cast<size_t>(j0 + u) * H + k);
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float4 lo = d[2 * (j0 + u)], hi = d[2 * (j0 + u) + 1];
          acc[0] = fmaf(wv[u], lo.x, acc[0]);
          acc[1] = fmaf(wv[u], lo.y, acc[1]);
          acc[2] = fmaf(wv[u], lo.z, acc[2]);
          acc[3] = fmaf(wv[u], lo.w, acc[3]);
          acc[4] = fmaf(wv[u], hi.x, acc[4]);
          acc[5] = fmaf(wv[u], hi.y, acc[5]);
          acc[6] = fmaf(wv[u], hi.z, acc[6]);
          acc[7] = fmaf(wv[u], hi.w, acc[7]);
        }
      }
      for (int j = full; j < H3; ++j) {
        const float wj = __ldg(w + static_cast<size_t>(j) * H + k);
        const float4 lo = d[2 * j], hi = d[2 * j + 1];
        acc[0] = fmaf(wj, lo.x, acc[0]);
        acc[1] = fmaf(wj, lo.y, acc[1]);
        acc[2] = fmaf(wj, lo.z, acc[2]);
        acc[3] = fmaf(wj, lo.w, acc[3]);
        acc[4] = fmaf(wj, hi.x, acc[4]);
        acc[5] = fmaf(wj, hi.y, acc[5]);
        acc[6] = fmaf(wj, hi.z, acc[6]);
        acc[7] = fmaf(wj, hi.w, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) carry[r] += acc[r];
    }
    // no second barrier: step t - 1 writes the other buffer, and a thread
    // reaches step t - 2's writes into this one only after every thread has
    // passed step t - 1's barrier, that is, has finished reading this one
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
      if (b < B) dh0[(static_cast<size_t>(b) * G + g) * H + k] = carry[r];
    }
  }
}

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

__device__ __forceinline__ void barrier_init(uint32_t barrier) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(barrier) : "memory");
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

}  // namespace

extern "C" {

int gru_bwd_f32(const void* x_proj, const void* hp, const void* y, const void* h0, const void* dy,
                const void* dh_last, const void* w_hh, void* dx_proj, void* dhp, void* dh0, int B,
                int T, int G, int H, void* stream) {
  if (B < 1 || T < 1 || G < 1 || H < 1 || H > kMaxThreads) return cudaErrorInvalidValue;
  const int threads = (H + 31) / 32 * 32;
  const dim3 grid(G, (B + kRows - 1) / kRows);
  const size_t smem = 2 * 3 * static_cast<size_t>(H) * kRows * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gru_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_proj), static_cast<const float*>(hp), static_cast<const float*>(y),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(w_hh),
      static_cast<float*>(dx_proj), static_cast<float*>(dhp), static_cast<float*>(dh0), B, T, G, H);
  return cudaGetLastError();
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
