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
// order does too: an output's sum is a chain of dependent fp32 adds as long
// as its entry count (the longest row at the flagship holds 468 entries,
// the min-time LP's theta column 1,778), and a half-step waits for its
// longest chain.  No design may shorten a chain; this one keeps everything
// else off it.
//
// The work.  The plan (kernels.pdhg_coo) lists each direction's outputs in
// work order: the long ones (more than LONG = 32 entries) first, longest
// first, then the rest cut into chunks of at most 32 outputs and 512
// entries, every output's entries contiguous and in COO order.  A warp
// takes one work item at a time (a grid stride over warps, numbered so
// that neighbouring items land on different SMs), so the longest chains
// start first and the short work fills the other warps around them.  For
// either kind of item the warp's lanes first load the item's entries
// (coalesced index and value loads, 16 a lane, all issued before the first
// gather), then gather and multiply, writing the rounded products to the
// warp's shared-memory buffer: two dependent loads deep, whatever the
// length.  Then the sums run from shared memory, one add at a time in
// entry order: a long output by lane 0 (16-byte reads, each group of
// products read while the one before is added), a chunk's outputs one a
// lane.  An output longer than a warp's buffer (the theta column) is a
// block's: its 16 warps stage it at once into a buffer of the block's, and
// one lane adds it while the other warps go on to their items.
//
// The barrier.  One cooperative launch a burst, with grid.sync()
// (cooperative groups' grid barrier: each block's first thread arrives on
// one counter in global memory and spins until the last arrives; its
// fences make the half-step's stores visible to every block) between the
// half-steps and between iterations.  The two barriers are a large part of
// an iteration at the flagship (tools/coo_parts.py times the kernel with
// the half-steps compiled out), and their cost grows with the blocks that
// arrive, so the grid is as small as the work allows: as many blocks as
// fit of 512 threads (two an SM: 264 on the H100's 132 SMs, 4,224 warps).
//
// Shared memory: a 2 KB buffer a warp, and a block buffer as large as all
// of them (64 KB a block, over the 48 KB that needs an opt-in).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// threads a block (chip_smoke.py's COO_THREADS prints it), and the blocks
// an SM the registers are capped for
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kWarps = kThreads / 32;
// entries a lane loads in one round; a warp's buffer holds 32 times that
// (kernels.pdhg_coo.CHUNK_ENTRIES)
constexpr int kPerLane = 16;
constexpr int kBuf = 32 * kPerLane;
// a buffer a warp, and one as large as all of them for the block's outputs
constexpr int kBlockBuf = kWarps * kBuf;
constexpr int kSmem = 2 * kBlockBuf * 4;

// One direction in work order (kernels.pdhg_coo.CooPlanSide).
struct Side {
  int n_block, n_long, n_chunks;
  const int* order;     // (n_out) the output at each position
  const int* off;       // (n_out + 1) first entry of each position
  const int* idx;       // gather index of each entry
  const float* val;     // coefficient of each entry
  const int* chunk;     // (n_chunks + 1) first position of each chunk
};

// buf[j - e0] = val[j] * vec[idx[j]] for the entries j of [e0, e1) (at
// most kBuf), each rounded; every index and value load of the lane is
// issued before its first gather.  `vec` is read with plain loads: the
// launch writes it.
__device__ __forceinline__ void stage(const Side& d, const float* vec, int e0,
                                     int e1, int lane, float* buf) {
  int ix[kPerLane];
  float cv[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = e0 + k * 32 + lane;
    ix[k] = j < e1 ? __ldg(d.idx + j) : 0;
    cv[k] = j < e1 ? __ldg(d.val + j) : 0.0f;
  }
  float g[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    g[k] = e0 + k * 32 + lane < e1 ? vec[ix[k]] : 0.0f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    if (e0 + k * 32 + lane < e1) buf[k * 32 + lane] = cv[k] * g[k];
  }
}

// s + buf[0] + ... + buf[n - 1], one add at a time in order; buf 16-byte
// aligned.  The products come in groups of 16 (four 16-byte reads), each
// group read while the one before is added, so the adds wait on nothing
// but each other.
__device__ __forceinline__ void add4(float& s, const float4& v) {
  s = s + v.x;
  s = s + v.y;
  s = s + v.z;
  s = s + v.w;
}

__device__ __forceinline__ float add_staged(float s, const float* buf,
                                            int n) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  int i = 0;
  if (n >= 16) {
    float4 cur[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = b4[k];
    for (; i + 32 <= n; i += 16) {
      float4 nxt[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) nxt[k] = b4[((i + 16) >> 2) + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) add4(s, cur[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) cur[k] = nxt[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) add4(s, cur[k]);
    i += 16;
  }
  for (; i < n; ++i) s = s + buf[i];
  return s;
}

// For each output o of direction d: a = load(o), then a.start + its
// rounded products val[e] * vec[idx[e]] in entry order, then emit(o, a,
// s).  `load` fetches the start and what the update reads before the
// item's gathers, so none of it waits behind the chain of adds.
//
// First the outputs longer than a warp's buffer (the min-time LP's theta
// column), a block each: every warp stages a slice into the block's
// buffer, then the block's last warp adds it all while the others go on
// to their own items (an output longer than the block's buffer goes round
// again, the block waiting on the adds between rounds).  Then the warps'
// items (long outputs, then chunks), a grid stride; `buf` is the warp's.
template <typename L, typename F>
__device__ __forceinline__ void sums(const Side& d, const float* vec,
                                     int warp, int n_warps, int lane,
                                     float* buf, float* block_buf, L&& load,
                                     F&& emit) {
  const int wib = threadIdx.x >> 5;
  const bool adder = wib == kWarps - 1 && lane == 0;
  for (int v = blockIdx.x; v < d.n_block; v += gridDim.x) {
    const int o = __ldg(d.order + v);
    const int first = __ldg(d.off + v), end = __ldg(d.off + v + 1);
    const auto a = load(o);
    float s = a.start;
    for (int b0 = first; b0 < end; b0 += kBlockBuf) {
      __syncthreads();          // the block's buffer is free
      const int w0 = b0 + wib * kBuf;
      stage(d, vec, w0, min(w0 + kBuf, end), lane, block_buf + wib * kBuf);
      __syncthreads();
      if (adder) s = add_staged(s, block_buf, min(kBlockBuf, end - b0));
    }
    if (adder) emit(o, a, s);
  }
  const int n_warp_long = d.n_long - d.n_block;
  const int items = n_warp_long + d.n_chunks;
  for (int it = warp; it < items; it += n_warps) {
    if (it < n_warp_long) {
      const int at = d.n_block + it;
      const int o = __ldg(d.order + at);
      const int end = __ldg(d.off + at + 1);
      const auto a = load(o);
      float s = a.start;
      for (int e0 = __ldg(d.off + at); e0 < end; e0 += kBuf) {
        const int e1 = min(e0 + kBuf, end);
        stage(d, vec, e0, e1, lane, buf);
        __syncwarp();
        if (lane == 0) s = add_staged(s, buf, e1 - e0);
        __syncwarp();
      }
      if (lane == 0) emit(o, a, s);
    } else {
      const int c = it - n_warp_long;
      const int p0 = __ldg(d.chunk + c), p1 = __ldg(d.chunk + c + 1);
      const int e0 = __ldg(d.off + p0), e1 = __ldg(d.off + p1);
      const int p = p0 + lane;
      const bool mine = p < p1;
      int o = 0, first = 0, n = 0;
      decltype(load(0)) a{};
      if (mine) {
        o = __ldg(d.order + p);
        first = __ldg(d.off + p) - e0;
        n = __ldg(d.off + p + 1) - e0 - first;
        a = load(o);
      }
      stage(d, vec, e0, e1, lane, buf);
      __syncwarp();
      if (mine) {
        float s = a.start;
#pragma unroll 4
        for (int i = 0; i < n; ++i) s = s + buf[first + i];
        emit(o, a, s);
      }
      __syncwarp();
    }
  }
}

// what each update reads besides its sum
struct PrimalIn {
  float start, x, tau, xmax;   // start: c_j
  bool keep;
};
struct DualIn {
  float start, y, sig, q;      // start: 0
  bool ub, keep;
};
struct ResidualIn {
  float start, q;              // start: 0
  bool ub;
};

struct Burst {
  int n, m, iters;
  const float *c, *tau, *xmax, *q, *sig;
  const uint8_t *ub, *keep_n, *keep_m;
  Side cols, rows;          // K^T y (an output a variable), K x
  const float *x0, *y0;
  float *xs[2], *ys[2];     // ping-pong buffers (the last step's: outputs)
  float* x_bar;
};

__device__ __forceinline__ float* warp_buffer() {
  extern __shared__ float4 smem[];
  return reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * kBuf;
}

__device__ __forceinline__ float* block_buffer() {
  extern __shared__ float4 smem[];
  return reinterpret_cast<float*>(smem) + kBlockBuf;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pdhg_coo_kernel(const Burst p) {
  cg::grid_group grid = cg::this_grid();
  float* const buf = warp_buffer();
  float* const block_buf = block_buffer();
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  // warps numbered block-minor: neighbouring items run on different SMs
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int n_warps = gridDim.x * kWarps;
  const float* x = p.x0;
  const float* y = p.y0;
  for (int k = 0; k < p.iters; ++k) {
    float* const xn = (k & 1) ? p.xs[1] : p.xs[0];
    float* const yn = (k & 1) ? p.ys[1] : p.ys[0];
    // primal: x' = clip(fma(-tau, c + K^T y, x), 0, xmax), xbar = 2x' - x
    // (tools/coo_parts.py finds this call and the dual's by their text)
    sums(p.cols, y, warp, n_warps, lane, buf, block_buf,
         [&](int j) {
           return PrimalIn{__ldg(p.c + j), x[j], __ldg(p.tau + j),
                           __ldg(p.xmax + j), __ldg(p.keep_n + j) != 0};
         },
         [&](int j, const PrimalIn& a, float g) {
           float x1 = fminf(fmaxf(__fmaf_rn(-a.tau, g, a.x), 0.0f), a.xmax);
           if (a.keep) x1 = a.x;
           xn[j] = x1;
           p.x_bar[j] = 2.0f * x1 - a.x;
         });
    grid.sync();
    // dual: y' = fma(sig, K xbar - q, y), max(., 0) on inequality rows
    sums(p.rows, p.x_bar, warp, n_warps, lane, buf, block_buf,
         [&](int r) {
           return DualIn{0.0f, y[r], __ldg(p.sig + r), __ldg(p.q + r),
                         __ldg(p.ub + r) != 0, __ldg(p.keep_m + r) != 0};
         },
         [&](int r, const DualIn& a, float kx) {
           float y1 = __fmaf_rn(a.sig, kx - a.q, a.y);
           if (a.ub) y1 = fmaxf(y1, 0.0f);
           if (a.keep) y1 = a.y;
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
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  sums(rows, x, warp, gridDim.x * kWarps, threadIdx.x & 31, warp_buffer(),
       block_buffer(),
       [&](int r) {
         return ResidualIn{0.0f, __ldg(q + r), __ldg(ub + r) != 0};
       },
       [&](int r, const ResidualIn& a, float kx) {
         const float d = kx - a.q;
         worst[r] = a.ub ? fmaxf(d, 0.0f) : fabsf(d);
       });
}

// a chain of n dependent fp32 adds in one thread (n a multiple of 8): the
// latency one add of a sum costs, for the order bound
__global__ void add_chain_kernel(int n, const float* ab, float* out) {
  const float a = ab[0], b = ab[1];
  float s = 0.0f;
  for (int i = 0; i < n; i += 8) {
    s = s + a; s = s + b; s = s + a; s = s + b;
    s = s + a; s = s + b; s = s + a; s = s + b;
  }
  out[0] = s;
}

// the dynamic shared memory (a buffer a warp) over 48 KB needs the opt-in
cudaError_t allow_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_coo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(coo_residual_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmem);
}

int max_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (allow_smem() != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pdhg_coo_kernel,
                                                    kThreads, kSmem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

Side side(int n_block, int n_long, int n_chunks, const int* order,
          const int* off, const int* idx, const float* val,
          const int* chunk) {
  return Side{n_block, n_long, n_chunks, order, off, idx, val, chunk};
}

}  // namespace

// One burst: `iters` steps as one cooperative launch on `stream`, on
// `blocks` resident blocks (0: as many as fit).  Arguments:
//   ints: n, m, iters, blocks, device, then each direction's counts of
//     block outputs, long outputs (block ones included) and chunks
//     (columns, then rows);
//   vectors: c, tau, xmax (n), q, sig (m) fp32; ub (m), keep_n (n),
//     keep_m (m) uint8;
//   per direction (columns, then rows): work order, offsets, gather
//     indices (int32), values (fp32), chunk starts (int32);
//   x0 (n), y0 (m) fp32, read only; outputs x_out (n), y_out (m); scratch
//     x_tmp (n), y_tmp (m), x_bar (n), all fp32; stream.
// Returns 0, or the CUDA error of a refused launch.
extern "C" int pdhg_coo_burst_f32(
    int n, int m, int iters, int blocks, int device, int col_n_block,
    int col_n_long, int col_n_chunks, int row_n_block, int row_n_long,
    int row_n_chunks, const float* c,
    const float* tau, const float* xmax, const float* q, const float* sig,
    const uint8_t* ub, const uint8_t* keep_n, const uint8_t* keep_m,
    const int* col_order, const int* col_off, const int* col_idx,
    const float* col_val, const int* col_chunk, const int* row_order,
    const int* row_off, const int* row_idx, const float* row_val,
    const int* row_chunk, const float* x0, const float* y0, float* x_out,
    float* y_out, float* x_tmp, float* y_tmp, float* x_bar, void* stream) {
  Burst p{};
  p.n = n;
  p.m = m;
  p.iters = iters;
  p.c = c; p.tau = tau; p.xmax = xmax; p.q = q; p.sig = sig;
  p.ub = ub; p.keep_n = keep_n; p.keep_m = keep_m;
  p.cols = side(col_n_block, col_n_long, col_n_chunks, col_order, col_off,
                col_idx, col_val, col_chunk);
  p.rows = side(row_n_block, row_n_long, row_n_chunks, row_order, row_off,
                row_idx, row_val, row_chunk);
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
  err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks <= 0) blocks = max_blocks(device);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pdhg_coo_kernel), dim3(blocks),
      dim3(kThreads), args, kSmem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The residual of x (n) over the row direction into worst (m), one plain
// launch on `stream` (a warp a work item).  Returns 0 or the CUDA error of
// the launch.
extern "C" int pdhg_coo_residual_f32(int row_n_block, int row_n_long,
                                     int row_n_chunks, const int* row_order,
                                     const int* row_off, const int* row_idx,
                                     const float* row_val,
                                     const int* row_chunk, const float* x,
                                     const float* q, const uint8_t* ub,
                                     float* worst, void* stream) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks =
      (row_n_long - row_n_block + row_n_chunks + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  coo_residual_kernel<<<blocks, kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      side(row_n_block, row_n_long, row_n_chunks, row_order, row_off,
           row_idx, row_val, row_chunk),
      x, q, ub, worst);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the burst kernel that fit on `device` at once (0 on an error).
extern "C" int pdhg_coo_max_blocks(int device) { return max_blocks(device); }

// The entries a warp stages at once (the plan's CHUNK_ENTRIES must equal
// it).
extern "C" int pdhg_coo_chunk_entries() { return kBuf; }

// n dependent fp32 adds (a multiple of 8) in one thread, adding ab[0] and
// ab[1] in turn, into out[0]; one launch on `stream`.  Timed at two n, it
// gives the latency of one add of a sum.
extern "C" int pdhg_coo_add_chain(int n, const float* ab, float* out,
                                  void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(n, ab,
                                                                   out);
  return static_cast<int>(cudaGetLastError());
}
