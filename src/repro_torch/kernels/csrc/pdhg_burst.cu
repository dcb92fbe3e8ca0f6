// Fused PDHG iteration burst over a blocked-ELL operator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pdhg_spmv.py::pdhg_burst, the Pallas TPU kernel
// (pl.pallas_call of _burst_kernel, body pdhg_update_burst, SpMV spmv_blocks),
// in both of its iterate storage types: fp32 (pdhg_burst_f32) and bf16
// storage with fp32 arithmetic (pdhg_burst_bf16, the body's bf16 branch).
// The split entries at the end (pdhg_split_*) replace the sharded form of
// the same body, src/repro/kernels/pdhg_spmv.py::pdhg_update_burst_sharded
// (plain jnp under shard_map there, no pallas_call): the same step, cut
// into plain launches around the one collective of a row-sharded
// iteration (see the note above them).
//
// What bounds it on this card.  One iteration reads both ELL tables once
// (8 bytes a slot: int32 index + fp32 value) and a handful of fp32 vectors:
// at the flagship size (fat-tree k=16, 280,000 row slots and 266,752
// column slots, n_pad 33,344, m_pad 20,856) that is about 4.4 MB of tables
// and about 1.4 MB of vectors, about 6 MB in all, or about 1.8 us at
// 3.35 TB/s.  The arithmetic is two multiply-adds a slot, far below the
// fp32 rate.  The working set fits the 50 MB L2, so after the first
// iteration the tables come from L2 (or L1), and each half-step is a few
// dependent round trips to L2: latency, not bandwidth, sets the pace.  Two
// grid-wide dependencies a step (K^T y needs all of y, K xbar all of xbar)
// make two grid-wide barriers a step.  Row widths are skewed (8 up to 472
// in the row direction at that size).  bf16 storage halves the iterate
// vectors' bytes and leaves the tables as they are.
//
// What this design does about it.  The TPU kernel has no grid: one program
// keeps both tables and every vector in VMEM for the whole burst.  Here one
// persistent cooperative launch runs the whole burst: as many blocks as fit
// on the card at once (or the number the caller asks for), each warp
// walking a work list with a grid stride (warps numbered block-minor, so
// neighbouring tasks run on different SMs), and cooperative_groups'
// grid.sync() in place of a launch boundary between the primal and the
// dual half-step and between iterations.  The bf16 entry's start rounding
// and end widening and the terminal residual run in the same launch, so a
// burst is one CUDA launch (it was 2 * iters + 1, bf16 + 4 more).
//
// Lane-split row sums.  Each stored row is summed by L lanes of one warp,
// L = min(32, the largest power of two <= max(1, len / 8)), where len is
// the row's length: its entry count in the sparsity pattern (the entries
// fill the row's first slots).  Lane l adds slots l, l + L, ... below len
// in ascending order, from +0.0, each product rounded before it is added
// (-fmad=false); then the L partials combine in a fixed __shfl_xor_sync
// butterfly, offsets L/2, ..., 1.  A lane takes at most 16 slots below 32
// lanes (15 in the widest row at the flagship, against 472 for a thread
// a row).  Neighbouring lanes read neighbouring slots, so the loads
// coalesce.  A lane issues the loads of 8 slots (indices, values, then
// the gathers) before its first add, so a row costs a round trip or two
// to L2, not one a slot; the register budget (kMinBlocks) leaves ptxas
// room to keep them all in flight.  The padding past a row's length is
// never read.
//
// The order depends on the sparsity pattern alone: not on the values, the
// grid, scheduling, or the rows that share its block, so a member of a
// block-stacked batch sums every row as it does alone (a rule on the
// block's width would not: stacking changes which rows share a block).
// The host builds the work list once per sparsity pattern
// (kernels.pdhg_spmv.work_list, with lane_count): the rows sorted by L,
// cut into warp tasks of 32 / L rows.  The same order in plain torch is
// kernels.pdhg_spmv.spmv_in_kernel_order, which this kernel equals
// bitwise.  No atomics, so two launches, on any grid, give the same bits.
//
// Iterates written inside the launch (x, y, their ping-pong buffers and
// xbar) are read with plain loads, which grid.sync() orders after the
// writes before it (its acquire invalidates the SM's L1); the
// non-coherent __ldg path could return a value from before the barrier.
// Tables and constant vectors keep __ldg.
//
// The two storage types are one kernel templated on the type T of the
// stored x and y.  With T = __nv_bfloat16 (the reference's
// pdhg_spmv.py:292-305): each step widens the stored x and y to fp32,
// computes x' in fp32, stores x' rounded to nearest even, and forms
// xbar = 2x' - x from the UNROUNDED x' in an fp32 buffer; y' likewise is
// computed in fp32 and stored rounded.  A frozen coordinate writes back
// its widened stored value, which rounds to itself.  x0/y0 come in as fp32
// and are rounded once at the start; x_out/y_out are the fp32 widenings
// of the final stored state, and the residual runs on that widened x.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// threads a block
constexpr int kThreads = 512;
// blocks an SM the compiler keeps room for (64 registers a thread): below
// that budget ptxas reuses one register for the gathers of a batch and so
// waits on each before it issues the next
constexpr int kMinBlocks = 2;
// slots a lane loads at once (a row's lane takes at most 16 below 32 lanes)
constexpr int kBatch = 8;

// Plain (coherent) loads of iterates, which this launch writes, widened to
// fp32 (exactly, for bf16); narrow() stores fp32 in the storage type (round
// to nearest even for bf16, as XLA's convert).
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One ELL direction and its work list.
struct Direction {
  int bm;                 // rows a block
  int n_items;            // warp tasks
  const int64_t* off;     // flat start of each block
  const int* width;       // padded width of each block
  const int* idx;         // gather index of each slot
  const float* val;       // coefficient of each slot
  const int* len;         // each stored row's length (padding past it)
  const int* order;       // the rows sorted by lane count
  const int2* items;      // [first position in order, log2 L | rows << 8]
};

// Walk the direction's warp tasks with a grid stride over warps: for every
// stored row r, s = sum_j val[r, j] * vec[idx[r, j]] in the lane-split
// order, then emit(r, s) on the row's lane 0.
template <typename V, typename F>
__device__ __forceinline__ void row_sums(const Direction& d,
                                         const V* vec, int warp,
                                         int n_warps, int lane, F&& emit) {
  for (int it = warp; it < d.n_items; it += n_warps) {
    const int2 item = __ldg(d.items + it);
    const int shift = item.y & 0xff;
    const int n_rows = item.y >> 8;
    const int L = 1 << shift;
    const int g = lane >> shift;      // which of the task's rows
    const int li = lane & (L - 1);    // which lane of that row
    int r = -1, w = 0;
    int64_t start = 0;
    if (g < n_rows) {
      r = __ldg(d.order + item.x + g);
      const int b = r / d.bm;
      w = __ldg(d.len + r);
      start = __ldg(reinterpret_cast<const long long*>(d.off) + b) +
              (int64_t)(r - b * d.bm) * __ldg(d.width + b);
    }
    // kBatch slots at a time: every load of the batch is issued before
    // the first add waits on one (the loads of slots past the row's length
    // re-read its first slot of the batch and are not added)
    float s = 0.0f;
    for (int j0 = li; j0 < w; j0 += kBatch * L) {
      int ix[kBatch];
      float coef[kBatch], got[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = j0 + k * L < w ? j0 + k * L : j0;
        ix[k] = __ldg(d.idx + start + j);
        coef[k] = __ldg(d.val + start + j);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) got[k] = load(vec + ix[k]);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (j0 + k * L < w) s += coef[k] * got[k];
      }
    }
    for (int o = L >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
    }
    if (r >= 0 && li == 0) emit(r, s);
  }
}

// The constant vectors of the update: x side (n_pad) c, tau, xmax,
// keep_n; y side (the rows a launch owns) q, sig, ub, keep_m.
struct Vecs {
  const float *c, *tau, *xmax, *q, *sig;
  const uint8_t *ub, *keep_n, *keep_m;
};

// The update's three formulas, shared by the fused burst and the split
// entries so that the two cannot drift apart.
//
// Primal, coordinate i, given kty = (K^T y)_i: x' = clip(x - tau (c +
// kty), 0, xmax), held where keep_n; stores x' in the storage type and
// xbar = 2x' - x from the unrounded x'.
template <typename T>
__device__ __forceinline__ void primal_step(const Vecs& v, int i, float xi,
                                            float kty, T* xn,
                                            float* x_bar) {
  float x1 = fminf(fmaxf(xi - __ldg(v.tau + i) * (__ldg(v.c + i) + kty),
                         0.0f),
                   __ldg(v.xmax + i));
  if (__ldg(v.keep_n + i)) x1 = xi;
  xn[i] = narrow<T>(x1);
  x_bar[i] = 2.0f * x1 - xi;
}

// Dual, row r, given kx = (K xbar)_r: y' = y + sig (kx - q), max(., 0) on
// inequality rows, held where keep_m.
__device__ __forceinline__ float dual_value(const Vecs& v, int r, float yr,
                                            float kx) {
  float y1 = yr + __ldg(v.sig + r) * (kx - __ldg(v.q + r));
  if (__ldg(v.ub + r)) y1 = fmaxf(y1, 0.0f);
  if (__ldg(v.keep_m + r)) y1 = yr;
  return y1;
}

// Residual, row r, given kx = (K x)_r: |kx - q| on equality rows,
// max(kx - q, 0) on inequalities.
__device__ __forceinline__ float residual_value(const Vecs& v, int r,
                                                float kx) {
  const float d = kx - __ldg(v.q + r);
  return __ldg(v.ub + r) ? fmaxf(d, 0.0f) : fabsf(d);
}

template <typename T>
struct Burst {
  int n_pad, m_pad, iters;
  Vecs v;
  Direction rows, cols;     // K x (one stored row a constraint), K^T y
  const float *x0, *y0;
  float *x_out, *y_out, *worst, *x_bar;
  T* xs[2];                 // ping-pong buffers of the stored x
  T* ys[2];
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pdhg_burst_kernel(const Burst<T> p) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  // warps numbered block-minor, so consecutive tasks land on different
  // SMs
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int n_warps = n_threads >> 5;
  constexpr bool kBf16 = sizeof(T) == 2;

  const T* x;
  const T* y;
  if constexpr (kBf16) {
    // x0/y0 rounded into buffer 1; step 0 reads it and writes buffer 0
    for (int i = tid; i < p.n_pad; i += n_threads)
      p.xs[1][i] = narrow<T>(__ldg(p.x0 + i));
    for (int i = tid; i < p.m_pad; i += n_threads)
      p.ys[1][i] = narrow<T>(__ldg(p.y0 + i));
    grid.sync();
    x = p.xs[1];
    y = p.ys[1];
  } else {
    x = reinterpret_cast<const T*>(p.x0);
    y = reinterpret_cast<const T*>(p.y0);
  }

  for (int k = 0; k < p.iters; ++k) {
    // (selected, not indexed: an indexed array of the parameter block
    // would be copied to local memory)
    T* const xn = (k & 1) ? p.xs[1] : p.xs[0];
    T* const yn = (k & 1) ? p.ys[1] : p.ys[0];
    // primal: x' = clip(x - tau (c + K^T y), 0, xmax), xbar = 2x' - x
    row_sums(p.cols, y, warp, n_warps, lane, [&](int i, float kty) {
      primal_step(p.v, i, load(x + i), kty, xn, p.x_bar);
    });
    grid.sync();
    // dual: y' = y + sig (K xbar - q), max(., 0) on inequality rows
    row_sums(p.rows, p.x_bar, warp, n_warps, lane, [&](int r, float kx) {
      yn[r] = narrow<T>(dual_value(p.v, r, load(y + r), kx));
    });
    grid.sync();
    x = xn;
    y = yn;
  }

  // the final iterates as fp32 outputs: bf16 widens its last stored state;
  // fp32's last step wrote x_out/y_out already (the host's parity rule),
  // and with iters == 0 the inputs are copied
  if (kBf16 || p.iters == 0) {
    for (int i = tid; i < p.n_pad; i += n_threads)
      p.x_out[i] = load(x + i);
    for (int i = tid; i < p.m_pad; i += n_threads)
      p.y_out[i] = load(y + i);
    grid.sync();
  }
  // residual: |K x - q| on equality rows, max(K x - q, 0) on inequalities
  row_sums(p.rows, static_cast<const float*>(p.x_out), warp, n_warps, lane,
           [&](int r, float kx) { p.worst[r] = residual_value(p.v, r, kx); });
}

// Blocks of the kernel that fit on `device` at once (0 on an error).
template <typename T>
int max_blocks(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pdhg_burst_kernel<T>, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// One cooperative launch of the burst on `stream`: `blocks` resident
// blocks, or as many as fit when it is 0.  A launch the runtime refuses
// (too many blocks for the card, no cooperative launch) returns its error.
template <typename T>
int launch(Burst<T> p, int blocks, int device, cudaStream_t stream) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (blocks <= 0) blocks = max_blocks<T>(device);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pdhg_burst_kernel<T>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it; the caller raises
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

Direction direction(int bm, int n_items, const int64_t* off,
                    const int* width, const int* idx, const float* val,
                    const int* len, const int* order, const int* items) {
  return Direction{bm, n_items, off, width, idx, val, len, order,
                   reinterpret_cast<const int2*>(items)};
}

// ---------------------------------------------------------------------------
// The split entries: the same step, cut where a collective must come in.
//
// A row-sharded burst (kernels.ops.pdhg_burst_sharded) gives each shard
// a block of the constraint rows; its K^T y is the sum over shards of
// each shard's partial K^T_loc y_loc, which needs all of them before any
// x can move.  One cooperative launch cannot wait on a collective, so
// an iteration is three plain launches with the collective between the
// first two:
//
//   split_kty      partial[i] = (K^T_loc y_loc)_i, every column, in the
//                  lane-split order (row_sums, as the fused kernel);
//   (the caller gathers every shard's partial, in shard order)
//   split_primal   g_i = ((p_0 + p_1) + p_2) + ..., then primal_step;
//   split_dual     the shard's rows: dual_value on K_loc xbar;
//
// and split_residual ends the burst.  Each is a grid-stride loop, so any
// grid gives the same bits; with one shard, g = p_0 is the fused
// kernel's kty, and the split burst equals the fused one bitwise.  The
// launches are plain (not cooperative), so ranks that share a card may
// interleave theirs.  Bound: the fused burst's bytes, plus the partials
// written once and read once a step.
// ---------------------------------------------------------------------------

// x0/y0 in the storage type (fp32 copied, bf16 rounded to nearest even)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_init(int n, int m, const float* x0, const float* y0, T* x, T* y) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    x[i] = narrow<T>(__ldg(x0 + i));
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m; i += stride)
    y[i] = narrow<T>(__ldg(y0 + i));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    split_kty(const Direction cols, const T* y, float* part) {
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  row_sums(cols, y, warp, (gridDim.x * kThreads) >> 5, threadIdx.x & 31,
           [&](int i, float s) { part[i] = s; });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    split_primal(int n_pad, int shards, const float* parts, const Vecs v,
                 const T* x, T* xn, float* x_bar) {
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_pad;
       i += stride) {
    float g = parts[i];
    for (int s = 1; s < shards; ++s) g += parts[(int64_t)s * n_pad + i];
    primal_step(v, i, load(x + i), g, xn, x_bar);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    split_dual(const Direction rows, const Vecs v, const float* x_bar,
               const T* y, T* yn) {
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  row_sums(rows, x_bar, warp, (gridDim.x * kThreads) >> 5, threadIdx.x & 31,
           [&](int r, float kx) {
             yn[r] = narrow<T>(dual_value(v, r, load(y + r), kx));
           });
}

// the burst's fp32 outputs: x widened (when x_out is not null), the
// shard's y widened, and its rows' residual on the stored x (widening is
// exact, so gathering the stored x equals gathering x_out)
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    split_residual(const Direction rows, int n_pad, int m_loc, const Vecs v,
                   const T* x, const T* y, float* x_out, float* y_out,
                   float* worst) {
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (x_out != nullptr)
    for (int i = tid; i < n_pad; i += stride) x_out[i] = load(x + i);
  for (int i = tid; i < m_loc; i += stride) y_out[i] = load(y + i);
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  row_sums(rows, x, warp, (gridDim.x * kThreads) >> 5, threadIdx.x & 31,
           [&](int r, float kx) { worst[r] = residual_value(v, r, kx); });
}

// blocks for a grid-stride loop over n elements, or over n warp tasks
int elem_blocks(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }
int task_blocks(int n) {
  constexpr int warps = kThreads / 32;
  return n > 0 ? (n + warps - 1) / warps : 1;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int split_init_launch(int n, int m, const float* x0, const float* y0, T* x,
                      T* y, void* stream) {
  split_init<T><<<elem_blocks(n > m ? n : m), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(n, m, x0, y0, x, y);
  return last_error();
}

template <typename T>
int split_kty_launch(Direction cols, const T* y, float* part, void* stream) {
  split_kty<T><<<task_blocks(cols.n_items), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(cols, y, part);
  return last_error();
}

template <typename T>
int split_primal_launch(int n_pad, int shards, const float* parts, Vecs v,
                        const T* x, T* xn, float* x_bar, void* stream) {
  split_primal<T><<<elem_blocks(n_pad), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      n_pad, shards, parts, v, x, xn, x_bar);
  return last_error();
}

template <typename T>
int split_dual_launch(Direction rows, Vecs v, const float* x_bar, const T* y,
                      T* yn, void* stream) {
  split_dual<T><<<task_blocks(rows.n_items), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(rows, v, x_bar, y,
                                                       yn);
  return last_error();
}

template <typename T>
int split_residual_launch(Direction rows, int n_pad, int m_loc, Vecs v,
                          const T* x, const T* y, float* x_out, float* y_out,
                          float* worst, void* stream) {
  const int tasks = task_blocks(rows.n_items);
  const int elems = elem_blocks(n_pad > m_loc ? n_pad : m_loc);
  split_residual<T><<<tasks > elems ? tasks : elems, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rows, n_pad, m_loc, v, x, y, x_out, y_out, worst);
  return last_error();
}

}  // namespace

// The arguments of both entries, in this order:
//   ints: n_pad, m_pad, iters, blocks (0: as many as fit), device,
//     then for the row direction (K x) and the column direction (K^T y)
//     each: bm, n_items;
//   vectors: c, tau, xmax (n_pad), q, sig (m_pad), ub, keep_n, keep_m (uint8);
//   per direction (rows, then columns): block offsets (int64), block
//     widths, slot indices (int32), slot values (fp32), row lengths (int32,
//     a stored row each), row order (int32), warp tasks (int32 pairs);
//   x0 (n_pad), y0 (m_pad) fp32, read only; outputs x_out, y_out, worst
//   (m_pad) fp32; scratch x_tmp, y_tmp and x_bar (n_pad fp32); stream.
// Return 0 on success, else the CUDA error of the refused launch.

// fp32 iterates; x_tmp (n_pad) and y_tmp (m_pad) fp32 scratch.
extern "C" int pdhg_burst_f32(
    int n_pad, int m_pad, int iters, int blocks, int device, int row_bm,
    int row_items_n, int col_bm, int col_items_n, const float* c,
    const float* tau, const float* xmax, const float* q, const float* sig,
    const uint8_t* ub, const uint8_t* keep_n, const uint8_t* keep_m,
    const int64_t* row_off, const int* row_w, const int* row_idx,
    const float* row_val, const int* row_len, const int* row_order,
    const int* row_items, const int64_t* col_off, const int* col_w,
    const int* col_idx, const float* col_val, const int* col_len,
    const int* col_order, const int* col_items, const float* x0,
    const float* y0, float* x_out, float* y_out, float* worst, float* x_tmp,
    float* y_tmp, float* x_bar, void* stream) {
  Burst<float> p{};
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.iters = iters;
  p.v = Vecs{c, tau, xmax, q, sig, ub, keep_n, keep_m};
  p.rows = direction(row_bm, row_items_n, row_off, row_w, row_idx, row_val,
                     row_len, row_order, row_items);
  p.cols = direction(col_bm, col_items_n, col_off, col_w, col_idx, col_val,
                     col_len, col_order, col_items);
  p.x0 = x0; p.y0 = y0;
  p.x_out = x_out; p.y_out = y_out; p.worst = worst; p.x_bar = x_bar;
  // the last step (k = iters - 1) must land in the output buffers
  p.xs[0] = (iters % 2) ? x_out : x_tmp;
  p.xs[1] = (iters % 2) ? x_tmp : x_out;
  p.ys[0] = (iters % 2) ? y_out : y_tmp;
  p.ys[1] = (iters % 2) ? y_tmp : y_out;
  return launch(p, blocks, device, static_cast<cudaStream_t>(stream));
}

// bf16-stored iterates; x_tmp (2 * n_pad) and y_tmp (2 * m_pad) bf16
// scratch for the two ping-pong buffers.  iters == 0 returns the
// bf16-rounded x0/y0, widened.
extern "C" int pdhg_burst_bf16(
    int n_pad, int m_pad, int iters, int blocks, int device, int row_bm,
    int row_items_n, int col_bm, int col_items_n, const float* c,
    const float* tau, const float* xmax, const float* q, const float* sig,
    const uint8_t* ub, const uint8_t* keep_n, const uint8_t* keep_m,
    const int64_t* row_off, const int* row_w, const int* row_idx,
    const float* row_val, const int* row_len, const int* row_order,
    const int* row_items, const int64_t* col_off, const int* col_w,
    const int* col_idx, const float* col_val, const int* col_len,
    const int* col_order, const int* col_items, const float* x0,
    const float* y0, float* x_out, float* y_out, float* worst,
    __nv_bfloat16* x_tmp, __nv_bfloat16* y_tmp, float* x_bar, void* stream) {
  Burst<__nv_bfloat16> p{};
  p.n_pad = n_pad;
  p.m_pad = m_pad;
  p.iters = iters;
  p.v = Vecs{c, tau, xmax, q, sig, ub, keep_n, keep_m};
  p.rows = direction(row_bm, row_items_n, row_off, row_w, row_idx, row_val,
                     row_len, row_order, row_items);
  p.cols = direction(col_bm, col_items_n, col_off, col_w, col_idx, col_val,
                     col_len, col_order, col_items);
  p.x0 = x0; p.y0 = y0;
  p.x_out = x_out; p.y_out = y_out; p.worst = worst; p.x_bar = x_bar;
  p.xs[0] = x_tmp;
  p.xs[1] = x_tmp + n_pad;
  p.ys[0] = y_tmp;
  p.ys[1] = y_tmp + m_pad;
  return launch(p, blocks, device, static_cast<cudaStream_t>(stream));
}

// Blocks of the burst kernel that fit on `device` at once (bf16 != 0: the
// bf16-storage kernel); 0 on an error.
extern "C" int pdhg_burst_max_blocks(int bf16, int device) {
  return bf16 ? max_blocks<__nv_bfloat16>(device) : max_blocks<float>(device);
}


// The split entries (see above), in fp32 (_f32) and bf16 (_bf16) storage
// of the iterates x and y: T* below is float* or __nv_bfloat16*.  A
// direction is passed as bm, n_items, block offsets (int64), block
// widths, slot indices, slot values, row lengths, row order and warp
// tasks (int32 pairs), as in the fused entries, for one shard.  Each
// entry is one plain launch on `stream`; it returns 0, or the CUDA error
// of a launch the runtime refused.
#define PDHG_DIR_ARGS                                                   \
  int bm, int n_items, const int64_t *off, const int *w, const int *idx, \
      const float *val, const int *len, const int *order, const int *items
#define PDHG_DIR direction(bm, n_items, off, w, idx, val, len, order, items)

#define PDHG_SPLIT_ENTRIES(SUFFIX, T)                                        \
  /* x (n) and y (m) in storage from fp32 x0 and y0 */                       \
  extern "C" int pdhg_split_init_##SUFFIX(int n, int m, const float* x0,     \
                                          const float* y0, T* x, T* y,       \
                                          void* stream) {                    \
    return split_init_launch<T>(n, m, x0, y0, x, y, stream);                 \
  }                                                                          \
  /* part (n_pad fp32) = K^T_loc y_loc over the shard's column pack */       \
  extern "C" int pdhg_split_kty_##SUFFIX(PDHG_DIR_ARGS, const T* y,          \
                                         float* part, void* stream) {        \
    return split_kty_launch<T>(PDHG_DIR, y, part, stream);                   \
  }                                                                          \
  /* x' and xbar from the shards' partials (shards x n_pad, shard order) */ \
  extern "C" int pdhg_split_primal_##SUFFIX(                                 \
      int n_pad, int shards, const float* parts, const float* c,             \
      const float* tau, const float* xmax, const uint8_t* keep_n,            \
      const T* x, T* xn, float* x_bar, void* stream) {                       \
    return split_primal_launch<T>(                                           \
        n_pad, shards, parts,                                                \
        Vecs{c, tau, xmax, nullptr, nullptr, nullptr, keep_n, nullptr}, x,   \
        xn, x_bar, stream);                                                  \
  }                                                                          \
  /* y' of the shard's rows from K_loc xbar */                               \
  extern "C" int pdhg_split_dual_##SUFFIX(                                   \
      PDHG_DIR_ARGS, const float* q, const float* sig, const uint8_t* ub,    \
      const uint8_t* keep_m, const float* x_bar, const T* y, T* yn,          \
      void* stream) {                                                        \
    return split_dual_launch<T>(                                             \
        PDHG_DIR,                                                            \
        Vecs{nullptr, nullptr, nullptr, q, sig, ub, nullptr, keep_m}, x_bar, \
        y, yn, stream);                                                      \
  }                                                                          \
  /* fp32 x_out (n_pad; skipped when null), y_out and worst (m_loc) */       \
  extern "C" int pdhg_split_residual_##SUFFIX(                               \
      PDHG_DIR_ARGS, int n_pad, int m_loc, const float* q,                   \
      const uint8_t* ub, const T* x, const T* y, float* x_out,               \
      float* y_out, float* worst, void* stream) {                            \
    return split_residual_launch<T>(                                         \
        PDHG_DIR, n_pad, m_loc,                                              \
        Vecs{nullptr, nullptr, nullptr, q, nullptr, ub, nullptr, nullptr}, x, \
        y, x_out, y_out, worst, stream);                                     \
  }

PDHG_SPLIT_ENTRIES(f32, float)
PDHG_SPLIT_ENTRIES(bf16, __nv_bfloat16)
