// PDHG iteration burst over a COO operator, in the reference's COO order,
// for Hopper (sm_90a).
//
// Replaces no pallas_call.  The reference's default PDHG lowering
// (backend="xla": src/repro/core/solver.py::_pdhg_ops, run by _pdhg_resume
// and _pdhg_run_adaptive, :105-173 and :408-473) keeps K in COO and lets
// XLA lower both mat-vecs to scatter-adds, which on a CPU add one entry at
// a time in COO entry order.  This kernel runs the same steps in exactly
// that order, so the card gives the bits of the reference's own default
// trajectory (kernels/pdhg_coo.py writes the order down; its plain version
// is the model this kernel equals bitwise):
//
//   g_j  = c_j + the rounded products val_e * y[row_e] of column j, added
//          one at a time in COO entry order;
//   x'_j = clip(fma(-tau_j, g_j, x_j), 0, xmax_j), held where keep_n;
//   xbar = 2 x' - x;
//   k_i  = 0 + the rounded products val_e * xbar[col_e] of row i, in order;
//   y'_i = fma(sig_i, k_i - q_i, y_i), max(., 0) on inequality rows, held
//          where keep_m;
//
// and the residual entry: |K x - q| on equality rows, max(K x - q, 0) on
// inequalities, K x summed as k above.  Built with -fmad=false, so every
// product is rounded before it is added; the two updates that the
// reference contracts are written as explicit __fmaf_rn.  No atomics: the
// bits do not depend on the grid or the scheduling.
//
// What bounds it on this card.  One iteration reads each direction's
// gather index and value once (8 bytes an entry, two directions: 2.1 MB at
// the flagship, fat-tree k=16 with 132,656 entries) and a few fp32 vectors
// (about 1 MB), 1 us at 3.35 TB/s; the working set fits the 50 MB L2.  The
// order does: an output's sum is a chain of dependent fp32 adds as long as
// its entry count, and the longest row there holds 468 entries (the
// min-time LP's theta column 1,778), so a half-step takes at least that
// many add latencies.
//
// What this design does about it.  One cooperative launch a burst, as in
// pdhg_burst.cu, with grid.sync() between the half-steps.  Outputs with
// at most 32 entries (kernels.pdhg_coo.LONG; all columns and all but 476
// rows at the flagship) take a thread each and issue the loads of 8
// entries before their first add.  Longer outputs take a warp each: every
// lane loads and multiplies 8 entries (256 a round), then the warp adds
// the 256 products in entry order, each read from its lane by a shuffle,
// so the chain of adds waits on no load.  Empty outputs take the short
// path (g = c, k = 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// entries a thread (or a warp's lane) loads before it adds
constexpr int kBatch = 8;

// One direction: the entries grouped by output, COO order within each.
struct Side {
  int n_long, n_short;
  const int* off;       // (n_out + 1) first entry of each output
  const int* idx;       // gather index of each entry
  const float* val;     // coefficient of each entry
  const int* longs;     // outputs summed by a warp
  const int* shorts;    // outputs summed by a thread
};

// start(o) + sum of output o's rounded products val[e] * vec[idx[e]], in
// entry order; then emit(o, s).  Long outputs by warps (grid stride over
// warps), short ones by threads (grid stride over threads).  `vec` is read
// with plain loads: this launch writes it.
template <typename S, typename F>
__device__ __forceinline__ void sums(const Side& d, const float* vec,
                                     int tid, int n_threads, int warp,
                                     int n_warps, int lane, S&& start,
                                     F&& emit) {
  for (int w = warp; w < d.n_long; w += n_warps) {
    const int o = __ldg(d.longs + w);
    const int end = __ldg(d.off + o + 1);
    float s = start(o);
    for (int e0 = __ldg(d.off + o); e0 < end; e0 += 32 * kBatch) {
      int ix[kBatch];
      float coef[kBatch], p[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = e0 + k * 32 + lane;
        ix[k] = j < end ? __ldg(d.idx + j) : 0;
        coef[k] = j < end ? __ldg(d.val + j) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) p[k] = coef[k] * vec[ix[k]];
      // every lane adds the same products in the same order, so each
      // holds the sum; lane 0 writes it
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int base = e0 + k * 32;
#pragma unroll 8
        for (int src = 0; src < 32; ++src) {
          const float v = __shfl_sync(0xffffffffu, p[k], src);
          if (base + src < end) s = s + v;
        }
      }
    }
    if (lane == 0) emit(o, s);
  }
  for (int i = tid; i < d.n_short; i += n_threads) {
    const int o = __ldg(d.shorts + i);
    const int end = __ldg(d.off + o + 1);
    float s = start(o);
    for (int e0 = __ldg(d.off + o); e0 < end; e0 += kBatch) {
      int ix[kBatch];
      float coef[kBatch], got[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = e0 + k < end ? e0 + k : e0;
        ix[k] = __ldg(d.idx + j);
        coef[k] = __ldg(d.val + j);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) got[k] = vec[ix[k]];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (e0 + k < end) s = s + coef[k] * got[k];
      }
    }
    emit(o, s);
  }
}

struct Burst {
  int n, m, iters;
  const float *c, *tau, *xmax, *q, *sig;
  const uint8_t *ub, *keep_n, *keep_m;
  Side cols, rows;          // K^T y (an output a variable), K x
  const float *x0, *y0;
  float *xs[2], *ys[2];     // ping-pong buffers (the last step's: outputs)
  float* x_bar;
};

__global__ void __launch_bounds__(kThreads) pdhg_coo_kernel(const Burst p) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  // warps numbered block-minor, so neighbouring long outputs run on
  // different SMs
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int n_warps = n_threads >> 5;
  const float* x = p.x0;
  const float* y = p.y0;
  for (int k = 0; k < p.iters; ++k) {
    float* const xn = (k & 1) ? p.xs[1] : p.xs[0];
    float* const yn = (k & 1) ? p.ys[1] : p.ys[0];
    // primal: x' = clip(fma(-tau, c + K^T y, x), 0, xmax), xbar = 2x' - x
    sums(p.cols, y, tid, n_threads, warp, n_warps, lane,
         [&](int j) { return __ldg(p.c + j); },
         [&](int j, float g) {
           const float xj = x[j];
           float x1 = fminf(fmaxf(__fmaf_rn(-__ldg(p.tau + j), g, xj), 0.0f),
                            __ldg(p.xmax + j));
           if (__ldg(p.keep_n + j)) x1 = xj;
           xn[j] = x1;
           p.x_bar[j] = 2.0f * x1 - xj;
         });
    grid.sync();
    // dual: y' = fma(sig, K xbar - q, y), max(., 0) on inequality rows
    sums(p.rows, p.x_bar, tid, n_threads, warp, n_warps, lane,
         [](int) { return 0.0f; },
         [&](int r, float kx) {
           const float yr = y[r];
           float y1 = __fmaf_rn(__ldg(p.sig + r), kx - __ldg(p.q + r), yr);
           if (__ldg(p.ub + r)) y1 = fmaxf(y1, 0.0f);
           if (__ldg(p.keep_m + r)) y1 = yr;
           yn[r] = y1;
         });
    grid.sync();
    x = xn;
    y = yn;
  }
  if (p.iters == 0) {
    for (int i = tid; i < p.n; i += n_threads) p.xs[1][i] = __ldg(p.x0 + i);
    for (int i = tid; i < p.m; i += n_threads) p.ys[1][i] = __ldg(p.y0 + i);
  }
}

// worst_i = |K x - q|_i on equality rows, max(K x - q, 0)_i where ub
__global__ void __launch_bounds__(kThreads)
    coo_residual_kernel(const Side rows, const float* x, const float* q,
                        const uint8_t* ub, float* worst) {
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  sums(rows, x, tid, n_threads, warp, n_threads >> 5, lane,
       [](int) { return 0.0f; },
       [&](int r, float kx) {
         const float d = kx - __ldg(q + r);
         worst[r] = __ldg(ub + r) ? fmaxf(d, 0.0f) : fabsf(d);
       });
}

int max_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pdhg_coo_kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

Side side(int n_long, int n_short, const int* off, const int* idx,
          const float* val, const int* longs, const int* shorts) {
  return Side{n_long, n_short, off, idx, val, longs, shorts};
}

}  // namespace

// One burst: `iters` steps as one cooperative launch on `stream`, on
// `blocks` resident blocks (0: as many as fit).  Arguments:
//   ints: n, m, iters, blocks, device, then each direction's long and
//     short output counts (columns, then rows);
//   vectors: c, tau, xmax (n), q, sig (m) fp32; ub (m), keep_n (n),
//     keep_m (m) uint8;
//   per direction (columns, then rows): offsets, gather indices (int32),
//     values (fp32), long outputs, short outputs (int32);
//   x0 (n), y0 (m) fp32, read only; outputs x_out (n), y_out (m); scratch
//     x_tmp (n), y_tmp (m), x_bar (n), all fp32; stream.
// Returns 0, or the CUDA error of a refused launch.
extern "C" int pdhg_coo_burst_f32(
    int n, int m, int iters, int blocks, int device, int col_long_n,
    int col_short_n, int row_long_n, int row_short_n, const float* c,
    const float* tau, const float* xmax, const float* q, const float* sig,
    const uint8_t* ub, const uint8_t* keep_n, const uint8_t* keep_m,
    const int* col_off, const int* col_idx, const float* col_val,
    const int* col_long, const int* col_short, const int* row_off,
    const int* row_idx, const float* row_val, const int* row_long,
    const int* row_short, const float* x0, const float* y0, float* x_out,
    float* y_out, float* x_tmp, float* y_tmp, float* x_bar, void* stream) {
  Burst p{};
  p.n = n;
  p.m = m;
  p.iters = iters;
  p.c = c; p.tau = tau; p.xmax = xmax; p.q = q; p.sig = sig;
  p.ub = ub; p.keep_n = keep_n; p.keep_m = keep_m;
  p.cols = side(col_long_n, col_short_n, col_off, col_idx, col_val, col_long,
                col_short);
  p.rows = side(row_long_n, row_short_n, row_off, row_idx, row_val, row_long,
                row_short);
  p.x0 = x0; p.y0 = y0; p.x_bar = x_bar;
  // the last step (k = iters - 1) lands in the outputs; with no step the
  // inputs are copied into buffer 1, the outputs
  p.xs[0] = (iters % 2) ? x_out : x_tmp;
  p.xs[1] = (iters % 2) ? x_tmp : x_out;
  p.ys[0] = (iters % 2) ? y_out : y_tmp;
  p.ys[1] = (iters % 2) ? y_tmp : y_out;
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (blocks <= 0) blocks = max_blocks(device);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pdhg_coo_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The residual of x (n) over the row direction into worst (m), one plain
// launch on `stream`.  Returns 0 or the CUDA error of the launch.
extern "C" int pdhg_coo_residual_f32(int row_long_n, int row_short_n,
                                     const int* row_off, const int* row_idx,
                                     const float* row_val,
                                     const int* row_long,
                                     const int* row_short, const float* x,
                                     const float* q, const uint8_t* ub,
                                     float* worst, void* stream) {
  const int by_threads = (row_short_n + kThreads - 1) / kThreads;
  const int by_warps = (row_long_n + kThreads / 32 - 1) / (kThreads / 32);
  int blocks = by_threads > by_warps ? by_threads : by_warps;
  if (blocks < 1) blocks = 1;
  coo_residual_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      side(row_long_n, row_short_n, row_off, row_idx, row_val, row_long,
           row_short),
      x, q, ub, worst);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the burst kernel that fit on `device` at once (0 on an error).
extern "C" int pdhg_coo_max_blocks(int device) { return max_blocks(device); }
