// Complex multi-frame deep filter and its backward, for Hopper (sm_90a).
//
// The forward, deep_filter_kernel, replaces the Pallas TPU kernel
// cruse_tpu/ops/deep_filter_kernel.py::deep_filter_pallas (body _df_kernel).
// The backward, deep_filter_bwd_kernel, replaces no TPU kernel: the JAX
// package trains through the plain shift-MAC (cruse_tpu/models/
// deep_filter.py::deep_filter_apply_tm) and its autodiff, which is what it
// computes. Per output bin (b, t, f), with the taps in tap_offsets order (time
// offset outer, frequency offset inner):
//
//   out[t, f]       = sum_k coef[t, f, k] * spec[t - dt_k, f - df_k]              (complex)
//   dcoef[t, f, k]  = g[t, f] * conj(spec[t - dt_k, f - df_k])
//   dspec[tau, phi] = sum_k g[tau + dt_k, phi + df_k] * conj(coef[tau + dt_k, phi + df_k, k])
//
// with g = dL/dRe(out) + i dL/dIm(out), PyTorch's gradient of a complex
// tensor. dt runs over [0, 2*t_dim] (causal) or [-t_dim, t_dim] (symmetric),
// df over [-f_dim, f_dim]. A read outside the spectrum is zero, except that a
// forward read at t - dt < 0 takes history[H + t - dt] when a history of H =
// 2*t_dim past frames is given (causal only; the streaming hop, T = 1). The
// backward takes no history.
//
// What bounds them: device-memory bytes. A bin's forward does 4K
// multiply-adds on 8K + 16 bytes (coefficients, spectrum, output), its
// backward 8K on 16K + 24; about 1 multiply-add a 2 to 4 bytes, far below the
// card's f32 balance. The coefficients [B, T, F, K, 2] (and dcoefs) are K
// times the spectrum, so the least traffic is every tensor once.
//
// What the design does about it. A block owns one batch row b, a span of
// frames [t0, t0 + nt) and a range of bins [f0, f0 + nf)
// (ops/deep_filter_kernel.py::df_plan picks span and bins from the shape), and
// walks down its frames, one a step:
//
// - the step's coefficient row (and, backward, its gradient row) is staged
//   in shared memory through a ring of kRing slots filled by cp.async, so the
//   next kRing - 1 rows are in flight while the threads compute on this one;
//   the copy width (16, 8 or 4 bytes) is chosen per launch (a template
//   instance each): the forward's, the widest the base pointer allows, a
//   row that starts or ends off a 16-byte boundary (a config-5b row of 257 x
//   9 x 2 = 4,626 floats does at odd frames) taking one 8-byte copy at that
//   end and landing in its slot at the same offset mod 16 bytes; the
//   backward's, the widest the row length allows too (8 bytes at 5b: 16-byte
//   copies with ragged ends ran no faster in the backward, whose halo bins
//   would move in the slot from row to row);
// - the spectrum rows sit in a ring of 2*t_dim + kRing rows (2*t_dim + 1
//   read, the rest in flight), each staged once, with f_dim bins of halo a
//   side, zero-filled by cp.async's src-size where a read falls outside the
//   spectrum: each spectrum frame comes from device memory once a block,
//   and only the 2*t_dim frames before a span are read by two blocks;
// - a thread owns one bin j of the range, reads its taps out of shared
//   memory (a coefficient row as [bins][K][2], conflict-free float2 reads at
//   odd K), keeps its sums in registers and stores one float2 a frame,
//   consecutive across the warp.
//
// The backward walks the frames u = t0 + dt_min .. t0 + nt - 1 + dt_max: the
// span with the 2*t_dim frames of g and coefficients that reach into its
// dspec (past its end when causal, both sides when symmetric) as a halo, and
// f_dim bins of halo a side. At each step it takes
// - dcoef of frame u, if u is the block's own, from g[u, j] and the
//   spectrum ring, written into shared memory and stored from there as one
//   contiguous range of the row (16-, 8- or 4-byte stores);
// - row u's part of dspec[u - dt] for every dt, gathered over the df taps
//   from the staged g and coefficient rows, added into 2*t_dim + 1 running
//   sums of bin j (a ring in shared memory, column j of thread j); dspec[u -
//   dt_max] has all its parts and is stored, if the frame is the block's.
// So each value of dspec and dcoefs is written by exactly one block, in one
// order: no atomics, the same bits on every call.
//
// Layouts: spec complex64 [B, T, F] at (batch, row) strides in complex
// elements, bins contiguous (the low-bin slice of a wider spectrum needs no
// copy); history complex64 [B, 2*t_dim, F], frames and bins contiguous, at a
// batch stride; coefs f32 [B, T, F, K, 2] contiguous; out, g, dspec complex64
// [B, T, F] contiguous; dcoefs f32 [B, T, F, K, 2] contiguous. Plain C
// interface (bound with ctypes): pointers and the stream are void*, the
// launch is on the caller's stream, nothing is allocated here, and each entry
// returns cudaGetLastError() of its launch (or the error of its attribute
// call, or cudaErrorInvalidValue for a plan it refuses).

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kRing = 3;  // coefficient (and gradient) slots: one read, kRing - 1 in flight
constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Floats of a coefficient slot of `nb` bins: the bins' 2K floats each, plus
// the copy's rounding to its width at both ends (under 4 floats each).
__host__ __device__ constexpr int coef_slot_floats(int nb, int K) { return up4(nb * 2 * K + 8); }

__host__ __device__ constexpr int threads_for(int bins) { return (bins + 31) / 32 * 32; }

struct DfArgs {
  const float2* spec;
  long long spec_bs, spec_rs;  // complex elements
  const float2* hist;          // or null
  long long hist_bs;
  const float* coefs;
  const float2* grad;  // backward
  float2* out;         // the forward's output, or dspec
  float* dcoefs;       // backward
  int T, F, t_dim, f_dim, dt_min, span, bins;
};

// The tile of block blockIdx.x: bins fastest, then spans, then the batch row.
struct Tile {
  int b, t0, nt, f0, nf;
};

__device__ Tile tile_of(const DfArgs& a) {
  const int chunks = (a.F + a.bins - 1) / a.bins, spans = (a.T + a.span - 1) / a.span;
  const int blk = static_cast<int>(blockIdx.x);
  Tile t;
  t.f0 = (blk % chunks) * a.bins;
  t.nf = min(a.bins, a.F - t.f0);
  t.t0 = ((blk / chunks) % spans) * a.span;
  t.nt = min(a.span, a.T - t.t0);
  t.b = blk / (chunks * spans);
  return t;
}

// V floats (4 V bytes) from device to shared memory, asynchronously; with
// `valid` false nothing is read and the V floats are zeros.
template <int V>
__device__ __forceinline__ void copy_async(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(to), "l"(src), "n"(4 * V), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a backward block's bins [first, first + width) of a coefficient row
// are staged: bin phi's 2K floats at slot[shift + (phi - first) * 2K]. The copy
// takes the row's floats [lo, hi) (the bins inside [0, F), rounded out to
// the copy width V, which divides the row's length) to slot[at + x - lo].
struct CoefRange {
  int lo, hi, at, shift;
  int zero_lo, zero_hi;  // slot[shift, zero_lo) and [zero_hi, shift + width * 2K): bins outside [0, F)
};

template <int V>
__device__ CoefRange coef_range(int first, int width, int F, int K) {
  const int two_k = 2 * K;
  const int lo_bin = max(first, 0), hi_bin = min(first + width, F);
  CoefRange r;
  const int m = first * two_k;  // may be negative
  r.shift = ((m % V) + V) % V;  // even when V >= 2: 2K is
  r.lo = lo_bin * two_k;
  r.lo -= r.lo % V;
  r.hi = (hi_bin * two_k + V - 1) / V * V;
  r.at = r.shift + r.lo - m;
  r.zero_lo = r.shift + (lo_bin - first) * two_k;
  r.zero_hi = r.shift + (hi_bin - first) * two_k;
  return r;
}

template <int V>
__device__ __forceinline__ void stage_coefs(float* slot, const float* row, const CoefRange& r, bool valid,
                                            const float* any) {
  for (int x = r.lo + static_cast<int>(threadIdx.x) * V; x < r.hi; x += static_cast<int>(blockDim.x) * V)
    copy_async<V>(slot + r.at + (x - r.lo), valid ? row + x : any, valid);
}

// The forward's range of one coefficient row, floats [0, n) of src, into
// slot[shift + p], where shift is src's offset past a 16-byte boundary in
// floats (0 or 2 at V = 4, so a 16-byte-aligned float of the row lands
// 16-byte aligned in the slot; 0 otherwise): V-wide copies, and at V = 4 one
// 8-byte copy at each end of the row that is off a 16-byte boundary, so rows
// of any length take 16-byte copies.
template <int V>
__device__ __forceinline__ void stage_forward_row(float* slot, const float* src, int n, int shift) {
  const int tid = static_cast<int>(threadIdx.x), nthreads = static_cast<int>(blockDim.x);
  int p0 = 0, p1 = n;
  if constexpr (V == 4) {
    p0 = (4 - shift) & 3;
    p1 = p0 + (n - p0) / 4 * 4;
    if (tid == 0 && p0 > 0) copy_async<2>(slot + shift, src, true);
    if (tid == nthreads - 1 && p1 < n) copy_async<2>(slot + shift + p1, src + p1, true);
  }
  for (int p = p0 + tid * V; p < p1; p += nthreads * V) copy_async<V>(slot + shift + p, src + p, true);
}

// Complex bins [first, first + width) of a row into slot[0, width): 8-byte
// copies, zeros where the row is null or a bin lies outside [0, F).
__device__ __forceinline__ void stage_complex(float2* slot, const float2* row, int first, int width, int F,
                                              const float2* any) {
  for (int i = static_cast<int>(threadIdx.x); i < width; i += static_cast<int>(blockDim.x)) {
    const int phi = first + i;
    const bool ok = row != nullptr && phi >= 0 && phi < F;
    copy_async<2>(slot + i, ok ? row + phi : any, ok);
  }
}

// Spectrum row tau of batch row b: the spectrum inside [0, T), the history
// before it where there is one, else null (zeros).
__device__ __forceinline__ const float2* spec_row(const DfArgs& a, int b, int tau) {
  if (tau >= 0 && tau < a.T) return a.spec + b * a.spec_bs + tau * a.spec_rs;
  const int H = 2 * a.t_dim;
  if (tau < 0 && a.hist != nullptr && tau >= -H)
    return a.hist + b * a.hist_bs + static_cast<long long>(H + tau) * a.F;
  return nullptr;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
deep_filter_kernel(DfArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Tile tl = tile_of(a);
  const int K = (2 * a.t_dim + 1) * (2 * a.f_dim + 1);
  const int dt_max = a.dt_min + 2 * a.t_dim;
  const int SR = 2 * a.t_dim + kRing;  // spectrum ring rows
  const int W = a.bins + 2 * a.f_dim;  // a spectrum row's bins, with the halo
  const int cs = coef_slot_floats(a.bins, K);
  float* cring = smem;                                       // [kRing][cs]
  float2* sring = reinterpret_cast<float2*>(smem + kRing * cs);  // [SR][W]
  const long long row_floats = static_cast<long long>(a.F) * 2 * K;
  const long long c0 = (static_cast<long long>(tl.b) * a.T + tl.t0) * row_floats + tl.f0 * 2 * K;  // frame t0's range
  const int n = tl.nf * 2 * K;  // floats of a row's range
  // the range's offset past a 16-byte boundary at step w: (shift0 + w * step) mod 4 floats, each 0 or 2
  const int shift0 = V == 4 ? static_cast<int>(c0 & 3) : 0, step = V == 4 ? static_cast<int>(row_floats & 3) : 0;
  const int first = tl.f0 - a.f_dim;  // the spectrum rows' first bin
  const int sbase = tl.t0 - dt_max;   // spectrum row of ring slot 0

  auto issue = [&](int w) {  // step w's coefficient row and newest spectrum row, one commit group
    if (w < tl.nt) {
      stage_forward_row<V>(cring + (w % kRing) * cs, a.coefs + c0 + w * row_floats, n, (shift0 + w * step) & 3);
      stage_complex(sring + ((w + 2 * a.t_dim) % SR) * W, spec_row(a, tl.b, sbase + w + 2 * a.t_dim), first, W,
                    a.F, a.spec);
    }
    copy_commit();
  };
  for (int r = 0; r < 2 * a.t_dim; ++r) stage_complex(sring + r * W, spec_row(a, tl.b, sbase + r), first, W, a.F, a.spec);
  copy_commit();
#pragma unroll
  for (int w = 0; w < kRing - 1; ++w) issue(w);

  const int j = static_cast<int>(threadIdx.x);
  float2* out = a.out + (static_cast<long long>(tl.b) * a.T + tl.t0) * a.F + tl.f0 + j;
  for (int w = 0; w < tl.nt; ++w) {
    copy_wait<kRing - 2>();  // step w's rows have landed (each later step is one group)
    __syncthreads();         // for every thread; and step w - 1's slots are read out
    issue(w + kRing - 1);
    if (j < tl.nf) {
      const float2* c = reinterpret_cast<const float2*>(cring + (w % kRing) * cs + ((shift0 + w * step) & 3)) + j * K;
      float ar = 0.f, ai = 0.f;
      int k = 0;
      for (int dt = a.dt_min; dt <= dt_max; ++dt) {
        const float2* s = sring + ((w + dt_max - dt) % SR) * W + j + a.f_dim;  // frame t0 + w - dt, bin f0 + j
        for (int df = -a.f_dim; df <= a.f_dim; ++df, ++k) {
          const float2 sv = s[-df], cv = c[k];
          ar = fmaf(-sv.y, cv.y, fmaf(sv.x, cv.x, ar));
          ai = fmaf(sv.y, cv.x, fmaf(sv.x, cv.y, ai));
        }
      }
      out[static_cast<long long>(w) * a.F] = make_float2(ar, ai);
    }
  }
}

// Floats [lo, hi) of a row (row-relative; the row starts V-aligned) from
// stage[shift + x - lo], with shift = lo % V: V-wide stores where aligned,
// single floats at the ragged ends, so nothing outside [lo, hi) is written.
template <int V>
__device__ __forceinline__ void store_range(float* row, const float* stage, int lo, int hi) {
  const int shift = lo % V;
  const int body_lo = min((lo + V - 1) / V * V, hi), body_hi = max(hi / V * V, body_lo);
  const int tid = static_cast<int>(threadIdx.x), nthreads = static_cast<int>(blockDim.x);
  for (int x = lo + tid; x < body_lo; x += nthreads) row[x] = stage[shift + x - lo];
  for (int x = body_hi + tid; x < hi; x += nthreads) row[x] = stage[shift + x - lo];
  for (int x = body_lo + tid * V; x < body_hi; x += nthreads * V) {
    const float* s = stage + shift + x - lo;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(row + x) = *reinterpret_cast<const float4*>(s);
    else if constexpr (V == 2)
      *reinterpret_cast<float2*>(row + x) = *reinterpret_cast<const float2*>(s);
    else
      row[x] = *s;
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
deep_filter_bwd_kernel(DfArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Tile tl = tile_of(a);
  const int K = (2 * a.t_dim + 1) * (2 * a.f_dim + 1);
  const int dt_max = a.dt_min + 2 * a.t_dim;
  const int P = 2 * a.t_dim + 1;       // dspec frames in progress
  const int SR = 2 * a.t_dim + kRing;  // spectrum ring rows
  const int W = a.bins + 2 * a.f_dim;  // bins of a staged row, with the halo
  const int cs = coef_slot_floats(W, K), ds = coef_slot_floats(a.bins, K);
  const int nthreads = static_cast<int>(blockDim.x);
  float* cring = smem;                                            // [kRing][cs]
  float* stage = cring + kRing * cs;                              // [ds]: dcoefs of one frame
  float2* gring = reinterpret_cast<float2*>(stage + ds);          // [kRing][W]
  float2* sring = gring + kRing * W;                              // [SR][W]
  float2* acc = sring + SR * W;                                   // [P][nthreads]
  const long long row_floats = static_cast<long long>(a.F) * 2 * K;
  const long long brow = static_cast<long long>(tl.b) * a.T;
  const int first = tl.f0 - a.f_dim;
  const CoefRange cr = coef_range<V>(first, W, a.F, K);
  const int u0 = tl.t0 + a.dt_min;        // the walk's first frame
  const int steps = tl.nt + 2 * a.t_dim;  // and its length
  const int sbase = tl.t0 - 2 * a.t_dim;  // spectrum row of ring slot 0
  const int s_last = tl.t0 + tl.nt - 1 - a.dt_min;  // the last spectrum row an own dcoef reads
  const int j = static_cast<int>(threadIdx.x);

  // once: the coefficient bins outside [0, F) are zeros in every slot, and the sums start at zero
  for (int r = 0; r < kRing; ++r) {
    float* slot = cring + r * cs;
    for (int p = cr.shift + j; p < cr.zero_lo; p += nthreads) slot[p] = 0.f;
    for (int p = cr.zero_hi + j; p < cr.shift + W * 2 * K; p += nthreads) slot[p] = 0.f;
  }
  for (int i = 0; i < P; ++i) acc[i * nthreads + j] = make_float2(0.f, 0.f);

  auto issue = [&](int w) {  // step w's g and coefficient rows and newest spectrum row, one commit group
    if (w < steps) {
      const int u = u0 + w;
      const bool live = u >= 0 && u < a.T;
      stage_coefs<V>(cring + (w % kRing) * cs, a.coefs + (brow + u) * row_floats, cr, live, a.coefs);
      stage_complex(gring + (w % kRing) * W, live ? a.grad + (brow + u) * a.F : nullptr, first, W, a.F, a.grad);
      const int tau = sbase + w + 2 * a.t_dim;
      if (tau <= s_last) stage_complex(sring + ((w + 2 * a.t_dim) % SR) * W, spec_row(a, tl.b, tau), first, W,
                                       a.F, a.spec);
    }
    copy_commit();
  };
  for (int r = 0; r < 2 * a.t_dim; ++r) stage_complex(sring + r * W, spec_row(a, tl.b, sbase + r), first, W, a.F, a.spec);
  copy_commit();
#pragma unroll
  for (int w = 0; w < kRing - 1; ++w) issue(w);

  const int olo = tl.f0 * 2 * K, ohi = (tl.f0 + tl.nf) * 2 * K;  // a dcoefs row's own floats
  float2* dc = reinterpret_cast<float2*>(stage + olo % V) + j * K;
  for (int w = 0; w < steps; ++w) {
    copy_wait<kRing - 2>();
    __syncthreads();  // step w's rows have landed; step w - 1's slots and stage are read out
    issue(w + kRing - 1);
    const int u = u0 + w;
    const bool own = u >= tl.t0 && u < tl.t0 + tl.nt;
    if (j < tl.nf) {
      const float2* g = gring + (w % kRing) * W + j + a.f_dim;  // g[u, f0 + j + d] at g[d]
      const float2* c = reinterpret_cast<const float2*>(cring + (w % kRing) * cs + cr.shift) + (j + a.f_dim) * K;
      int k = 0;
      for (int dt = a.dt_min; dt <= dt_max; ++dt) {  // row u's part of dspec[u - dt, f0 + j]
        float pr = 0.f, pi = 0.f;
        for (int df = -a.f_dim; df <= a.f_dim; ++df, ++k) {
          const float2 gv = g[df], cv = c[df * K + k];
          pr = fmaf(gv.y, cv.y, fmaf(gv.x, cv.x, pr));
          pi = fmaf(-gv.x, cv.y, fmaf(gv.y, cv.x, pi));
        }
        float2& sum = acc[((u - dt - tl.t0 + 2 * P) % P) * nthreads + j];
        sum = make_float2(sum.x + pr, sum.y + pi);
      }
      const int done = u - dt_max;  // every part of dspec[done] is in
      float2& sum = acc[((done - tl.t0 + 2 * P) % P) * nthreads + j];
      if (done >= tl.t0 && done < tl.t0 + tl.nt) a.out[(brow + done) * a.F + tl.f0 + j] = sum;
      sum = make_float2(0.f, 0.f);
      if (own) {
        const float2 gu = g[0];
        k = 0;
        for (int dt = a.dt_min; dt <= dt_max; ++dt) {
          const float2* s = sring + ((w + dt_max - dt) % SR) * W + j + a.f_dim;  // frame u - dt, bin f0 + j
          for (int df = -a.f_dim; df <= a.f_dim; ++df, ++k) {
            const float2 sv = s[-df];
            dc[k] = make_float2(fmaf(gu.y, sv.y, gu.x * sv.x), fmaf(-gu.x, sv.y, gu.y * sv.x));
          }
        }
      }
    }
    __syncthreads();  // the stage holds frame u's dcoefs
    if (own) store_range<V>(a.dcoefs + (brow + u) * row_floats, stage, olo, ohi);
  }
}

size_t fwd_smem_bytes(int bins, int K, int t_dim, int f_dim) {
  return 4 * static_cast<size_t>(kRing) * coef_slot_floats(bins, K) +
         8 * static_cast<size_t>(2 * t_dim + kRing) * (bins + 2 * f_dim);
}

size_t bwd_smem_bytes(int bins, int K, int t_dim, int f_dim) {
  const int W = bins + 2 * f_dim;
  return 4 * (static_cast<size_t>(kRing) * coef_slot_floats(W, K) + coef_slot_floats(bins, K)) +
         8 * (static_cast<size_t>(kRing + 2 * t_dim + kRing) * W + static_cast<size_t>(2 * t_dim + 1) * threads_for(bins));
}

// The widest copy (floats) that both tensors' bases and the row length allow
// (the forward passes a row length of 4: it takes 16-byte copies whatever
// the rows' own alignment).
int vector_floats(const void* x, const void* y, long long row_floats) {
  for (int v : {4, 2}) {
    if (reinterpret_cast<std::uintptr_t>(x) % (4 * v) == 0 && reinterpret_cast<std::uintptr_t>(y) % (4 * v) == 0 &&
        row_floats % v == 0)
      return v;
  }
  return 1;
}

bool bad_plan(int B, int T, int F, int t_dim, int f_dim, int span, int bins, size_t smem) {
  if (B < 1 || T < 1 || F < 1 || t_dim < 0 || f_dim < 0 || span < 1 || span > T || bins < 1 || bins > F ||
      threads_for(bins) > kMaxThreads || smem > kMaxSmem)
    return true;
  const long long K = (2LL * t_dim + 1) * (2LL * f_dim + 1);
  const long long blocks = static_cast<long long>(B) * ((T + span - 1) / span) * ((F + bins - 1) / bins);
  return blocks > 2147483647LL || static_cast<long long>(F) * 2 * K * 4 > 2147483647LL ||
         static_cast<long long>(B) * T * F > (1LL << 40);
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <typename Kernel>
int launch(Kernel kernel, const DfArgs& a, int B, size_t bytes, cudaStream_t stream) {
  const int err = allow_smem(kernel, bytes);
  if (err != 0) return err;
  const long long blocks =
      static_cast<long long>(B) * ((a.T + a.span - 1) / a.span) * ((a.F + a.bins - 1) / a.bins);
  kernel<<<static_cast<unsigned>(blocks), threads_for(a.bins), bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int kernel_info(Kernel kernel, size_t bytes, int threads, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = static_cast<cudaError_t>(allow_smem(kernel, bytes));
  if (err == cudaSuccess) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
    info[0] = attr.numRegs;
    info[1] = static_cast<int>(attr.localSizeBytes);
    info[2] = blocks;
    info[3] = threads;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// spec: complex64 [B, T, F] at (batch, row) strides in complex elements, bins
// contiguous; history: complex64 [B, 2*t_dim, F] at a batch stride, frames
// and bins contiguous within a batch row, or null (causal only); coefs: f32
// [B, T, F, K, 2] contiguous; out: complex64 [B, T, F] contiguous. The plan:
// a block a span of `span` frames (1..T) x `bins` bins (1..F).
int deep_filter_f32(const void* spec, long long spec_bstride, long long spec_rstride, const void* history,
                    long long hist_bstride, const void* coefs, void* out, int B, int T, int F, int t_dim, int f_dim,
                    int causal, int span, int bins, void* stream) {
  const int K = (2 * t_dim + 1) * (2 * f_dim + 1);
  const size_t bytes = fwd_smem_bytes(bins, K, t_dim, f_dim);
  if (bad_plan(B, T, F, t_dim, f_dim, span, bins, bytes) || (history != nullptr && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  DfArgs a{static_cast<const float2*>(spec), spec_bstride, spec_rstride, static_cast<const float2*>(history),
           hist_bstride, static_cast<const float*>(coefs), nullptr, static_cast<float2*>(out), nullptr,
           T, F, t_dim, f_dim, causal ? 0 : -t_dim, span, bins};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vector_floats(coefs, coefs, 4)) {
    case 4: return launch(deep_filter_kernel<4>, a, B, bytes, s);
    case 2: return launch(deep_filter_kernel<2>, a, B, bytes, s);
    default: return launch(deep_filter_kernel<1>, a, B, bytes, s);
  }
}

// grad: complex64 [B, T, F] contiguous, the gradient of the forward's
// output; spec, coefs: as the forward's (no history); dspec: complex64 [B,
// T, F] contiguous; dcoefs: f32 [B, T, F, K, 2] contiguous. The plan as the
// forward's. One launch.
int deep_filter_bwd_f32(const void* grad, const void* spec, long long spec_bstride, long long spec_rstride,
                        const void* coefs, void* dspec, void* dcoefs, int B, int T, int F, int t_dim, int f_dim,
                        int causal, int span, int bins, void* stream) {
  const int K = (2 * t_dim + 1) * (2 * f_dim + 1);
  const size_t bytes = bwd_smem_bytes(bins, K, t_dim, f_dim);
  if (bad_plan(B, T, F, t_dim, f_dim, span, bins, bytes)) return static_cast<int>(cudaErrorInvalidValue);
  DfArgs a{static_cast<const float2*>(spec), spec_bstride, spec_rstride, nullptr, 0,
           static_cast<const float*>(coefs), static_cast<const float2*>(grad), static_cast<float2*>(dspec),
           static_cast<float*>(dcoefs), T, F, t_dim, f_dim, causal ? 0 : -t_dim, span, bins};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vector_floats(coefs, dcoefs, static_cast<long long>(F) * 2 * K)) {
    case 4: return launch(deep_filter_bwd_kernel<4>, a, B, bytes, s);
    case 2: return launch(deep_filter_bwd_kernel<2>, a, B, bytes, s);
    default: return launch(deep_filter_bwd_kernel<1>, a, B, bytes, s);
  }
}

// The forward (backward = 0) or backward (1) instance with `vec` floats a
// copy (1, 2, 4) on the current device: registers and local (spill) bytes a
// thread, blocks an SM at `bytes` of shared memory and `threads` a block,
// threads a block.
int deep_filter_info(int backward, int vec, int bytes, int threads, int* info) {
  if (bytes < 0 || static_cast<size_t>(bytes) > kMaxSmem || threads < 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(bytes);
  switch ((backward ? 8 : 0) + vec) {
    case 1: return kernel_info(deep_filter_kernel<1>, n, threads, info);
    case 2: return kernel_info(deep_filter_kernel<2>, n, threads, info);
    case 4: return kernel_info(deep_filter_kernel<4>, n, threads, info);
    case 9: return kernel_info(deep_filter_bwd_kernel<1>, n, threads, info);
    case 10: return kernel_info(deep_filter_bwd_kernel<2>, n, threads, info);
    case 12: return kernel_info(deep_filter_bwd_kernel<4>, n, threads, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
