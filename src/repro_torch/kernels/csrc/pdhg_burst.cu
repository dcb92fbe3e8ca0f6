// Fused PDHG iteration burst over a blocked-ELL operator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pdhg_spmv.py::pdhg_burst, the Pallas TPU kernel
// (pl.pallas_call of _burst_kernel, body pdhg_update_burst, SpMV spmv_blocks),
// in both of its iterate storage types: fp32 (pdhg_burst_f32) and bf16
// storage with fp32 arithmetic (pdhg_burst_bf16, the body's bf16 branch).
// The split step at the end (pdhg_split_step_*) replaces the sharded form
// of the same body, src/repro/kernels/pdhg_spmv.py::pdhg_update_burst_sharded
// (plain jnp under shard_map there, no pallas_call): the same iteration on
// the same persistent cooperative grid, cut where the one collective of a
// row-sharded iteration comes in, so that a whole burst is one launch
// without a collective and one launch an iteration with one, the
// iterations replayed as a CUDA graph over NCCL (see the note above it).
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
#include <stddef.h>
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

// Blocks of `kernel` that fit on `device` at once (0 on an error).
template <typename P>
int fit_blocks(void (*kernel)(P), int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// One cooperative launch of `kernel` on `stream`: `blocks` resident
// blocks, or as many as fit when it is 0.  A launch the runtime refuses
// (too many blocks for the card, no cooperative launch) returns its error.
template <typename P>
int cooperative(void (*kernel)(P), P p, int blocks, int device,
                cudaStream_t stream) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (blocks <= 0) blocks = fit_blocks(kernel, device);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    stream);
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
// The split step: the same iteration, cut where a collective comes in.
//
// A row-sharded burst (kernels.ops.ShardedBurst) gives each shard a block
// of the constraint rows; its K^T y is the sum over the S shards of each
// shard's partial K^T_loc y_loc, which needs all of them before any x can
// move.  A process holds k consecutive shards (k = S when it is alone; at
// most kMaxLocal on the card), their directions in the parameter block.
// One launch of pdhg_split_step runs a sequence of phases on a persistent
// cooperative grid, as the fused kernel does, with grid.sync() between two
// consecutive phases:
//
//   begin   x, y in storage from fp32 x0, y0 (bf16 rounded to nearest
//           even), then kty;
//   a step  primal: g_i = ((p_0 + p_1) + p_2) + ... over the S gathered
//           partials in shard order (pdhg_spmv.ordered_sum), then
//           primal_step; dual: the k local shards' rows, dual_value on
//           K_loc xbar; kty: the k local shards' columns, in the
//           lane-split order, into parts[s]: the NEXT step's partials
//           (left out where the finish follows);
//   finish  x and y widened to fp32, and each local row's residual on the
//           stored x (widening is exact, so this is the residual of x_out).
//
// Without a collective (one process holds all S shards; the gathered
// partials are `parts` itself) a whole burst is one launch: begin, iters
// steps, finish.  With one, the collective sits between a step's kty and
// the next step's primal, so the host launches begin, then one step a
// launch with the all_gather between two launches, then finish; over NCCL
// it captures two iterations (all_gather, step, all_gather, step: both
// parities of the ping-pong buffers) into a CUDA graph once per plan and
// replays it.  Any grid gives the same bits (every row summed by one warp
// in the lane-split order, nothing atomic); with one shard g = p_0 is the
// fused kernel's kty, and the split burst equals the fused one bitwise.
// Ranks that share a card each launch a grid of the whole card: the card
// time-slices the processes' contexts, and a cooperative grid is resident
// within its own process's slice.  chip_smoke.py phase 30(c) runs two
// ranks so on one H100, bitwise the single-process model, at gloo's pace
// (about 1.7 ms an iteration, 1.2 ms of it the gather).
// Bound: the fused burst's bytes, plus the partials written once and read
// once a step.
// ---------------------------------------------------------------------------

// local shards a process may hold (kernels.ops.SPLIT_MAX_LOCAL): their
// directions live in the parameter block, as the fused kernel's do, and
// the loops over them unroll to constant indices (from a table in device
// memory, a direction's nine fields sat in registers across its row sums
// and the kernel spilled)
constexpr int kMaxLocal = 4;

// The operands of a split burst, fixed for the life of a burst plan
// (kernels.ops._SplitArgs mirrors this layout and checks it against
// pdhg_split_layout).  The y side, y_out and worst hold the k local
// shards' rows, shard-major: k * m_loc each.
struct SplitArgs {
  int n_pad, m_loc, k, shards;
  Direction rows[kMaxLocal];  // the k local shards' directions (k first)
  Direction cols[kMaxLocal];
  const float *c, *tau, *xmax;
  const uint8_t* keep_n;
  const float *q, *sig;
  const uint8_t *ub, *keep_m;
  const float *x0, *y0;      // the burst's start (fp32)
  const float* gathered;     // shards x n_pad: every shard's partial
  float* parts;              // k x n_pad: the local shards' partials
  void* xs[2];               // the stored x's ping-pong buffers (n_pad)
  void* ys[2];               // the stored y's (k * m_loc)
  float* x_bar;
  float *x_out, *y_out, *worst;
};

// One launch: the begin phases (when begin), `steps` steps from the
// ping-pong buffer `parity`, then the finish (when finish).
struct Step {
  SplitArgs a;
  int steps, begin, finish, parity;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pdhg_split_step(const Step p) {
  cg::grid_group grid = cg::this_grid();
  const SplitArgs& s = p.a;
  const int lane = threadIdx.x & 31;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  // warps numbered block-minor, as in the fused kernel
  const int warp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int n_warps = n_threads >> 5;
  const int m_all = s.k * s.m_loc;
  const Vecs v{s.c, s.tau, s.xmax, s.q, s.sig, s.ub, s.keep_n, s.keep_m};
  // grid.sync() between two phases of the launch, none before the first
  bool started = false;
  auto phase = [&]() {
    if (started) grid.sync();
    started = true;
  };
  // the ping-pong buffers (selected, not indexed; see the fused kernel)
  auto xs = [&](int a) { return static_cast<T*>(a ? s.xs[1] : s.xs[0]); };
  auto ys = [&](int a) { return static_cast<T*>(a ? s.ys[1] : s.ys[0]); };
  auto kty = [&](const T* y) {
#pragma unroll
    for (int sh = 0; sh < kMaxLocal; ++sh) {
      if (sh >= s.k) break;
      float* part = s.parts + (int64_t)sh * s.n_pad;
      row_sums(s.cols[sh], y + sh * s.m_loc, warp, n_warps, lane,
               [&](int i, float sum) { part[i] = sum; });
    }
  };

  int a = p.parity;
  if (p.begin) {
    phase();
    T* x = xs(a);
    T* y = ys(a);
    for (int i = tid; i < s.n_pad; i += n_threads)
      x[i] = narrow<T>(__ldg(s.x0 + i));
    for (int i = tid; i < m_all; i += n_threads)
      y[i] = narrow<T>(__ldg(s.y0 + i));
    if (p.steps > 0 || !p.finish) {
      phase();
      kty(y);
    }
  }
  for (int step = 0; step < p.steps; ++step) {
    const T* x = xs(a);
    const T* y = ys(a);
    T* const xn = xs(a ^ 1);
    T* const yn = ys(a ^ 1);
    // primal: the partials summed in shard order (plain loads: without a
    // collective this launch wrote them), then x' and xbar
    phase();
    for (int i = tid; i < s.n_pad; i += n_threads) {
      float g = s.gathered[i];
      for (int sh = 1; sh < s.shards; ++sh)
        g += s.gathered[(int64_t)sh * s.n_pad + i];
      primal_step(v, i, load(x + i), g, xn, s.x_bar);
    }
    // dual: y' of the local shards' rows from K_loc xbar
    phase();
#pragma unroll
    for (int sh = 0; sh < kMaxLocal; ++sh) {
      if (sh >= s.k) break;
      const int off = sh * s.m_loc;
      row_sums(s.rows[sh], static_cast<const float*>(s.x_bar), warp,
               n_warps, lane,
               [&](int r, float kx) {
                 yn[off + r] =
                     narrow<T>(dual_value(v, off + r, load(y + off + r), kx));
               });
    }
    a ^= 1;
    if (step + 1 < p.steps || !p.finish) {
      phase();
      kty(yn);
    }
  }
  if (p.finish) {
    phase();
    const T* x = xs(a);
    const T* y = ys(a);
    for (int i = tid; i < s.n_pad; i += n_threads) s.x_out[i] = load(x + i);
    for (int i = tid; i < m_all; i += n_threads) s.y_out[i] = load(y + i);
#pragma unroll
    for (int sh = 0; sh < kMaxLocal; ++sh) {
      if (sh >= s.k) break;
      const int off = sh * s.m_loc;
      row_sums(s.rows[sh], x, warp, n_warps, lane, [&](int r, float kx) {
        s.worst[off + r] = residual_value(v, off + r, kx);
      });
    }
  }
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
  return cooperative(pdhg_burst_kernel<float>, p, blocks, device,
                     static_cast<cudaStream_t>(stream));
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
  return cooperative(pdhg_burst_kernel<__nv_bfloat16>, p, blocks, device,
                     static_cast<cudaStream_t>(stream));
}

// Blocks of the burst kernel that fit on `device` at once (bf16 != 0: the
// bf16-storage kernel); 0 on an error.
extern "C" int pdhg_burst_max_blocks(int bf16, int device) {
  return bf16 ? fit_blocks(pdhg_burst_kernel<__nv_bfloat16>, device)
              : fit_blocks(pdhg_burst_kernel<float>, device);
}


// The split step (see above), in fp32 (_f32) and bf16 (_bf16) storage of
// the iterates: one cooperative launch on `stream` of `blocks` resident
// blocks (0: as many as fit) over the operands *args, running the begin
// phases when begin != 0, then `steps` steps from the ping-pong buffer
// `parity`, then the finish when finish != 0.  Returns 0, or the CUDA
// error of a launch the runtime refused.
#define PDHG_SPLIT_STEP(SUFFIX, T)                                            \
  extern "C" int pdhg_split_step_##SUFFIX(                                    \
      const void* args, int steps, int begin, int finish, int parity,         \
      int blocks, int device, void* stream) {                                 \
    return cooperative(                                                       \
        pdhg_split_step<T>,                                                   \
        Step{*static_cast<const SplitArgs*>(args), steps, begin, finish,      \
             parity},                                                         \
        blocks, device, static_cast<cudaStream_t>(stream));                   \
  }

PDHG_SPLIT_STEP(f32, float)
PDHG_SPLIT_STEP(bf16, __nv_bfloat16)

// Blocks of the split step that fit on `device` at once (bf16 != 0: the
// bf16-storage kernel); 0 on an error.
extern "C" int pdhg_split_max_blocks(int bf16, int device) {
  return bf16 ? fit_blocks(pdhg_split_step<__nv_bfloat16>, device)
              : fit_blocks(pdhg_split_step<float>, device);
}

// The layout the host's mirrors of Direction and SplitArgs must match:
// sizeof(Direction), offsetof(Direction, items), sizeof(SplitArgs),
// offsetof(SplitArgs, cols), offsetof(SplitArgs, xs),
// offsetof(SplitArgs, worst) and kMaxLocal, into out[0..6].
extern "C" void pdhg_split_layout(long long* out) {
  out[0] = sizeof(Direction);
  out[1] = offsetof(Direction, items);
  out[2] = sizeof(SplitArgs);
  out[3] = offsetof(SplitArgs, cols);
  out[4] = offsetof(SplitArgs, xs);
  out[5] = offsetof(SplitArgs, worst);
  out[6] = kMaxLocal;
}
