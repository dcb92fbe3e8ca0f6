// Fused PDHG iteration burst over a blocked-ELL operator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pdhg_spmv.py::pdhg_burst, the Pallas TPU kernel
// (pl.pallas_call of _burst_kernel, body pdhg_update_burst, SpMV spmv_blocks),
// in both of its iterate storage types: fp32 (pdhg_burst_f32) and bf16
// storage with fp32 arithmetic (pdhg_burst_bf16, the body's bf16 branch).
//
// What bounds it on this card.  One iteration reads both ELL tables once
// (8 bytes a slot: int32 index + fp32 value) and a handful of fp32 vectors:
// at the flagship size (fat-tree k=16, 280,000 row slots and 266,752
// column slots, n_pad 33,344, m_pad 20,856) that is about 4.4 MB of tables
// and about 1.4 MB of vectors, about 6 MB in all, or about 1.8 us at
// 3.35 TB/s.  The arithmetic is two multiply-adds a slot, far below the
// fp32 rate.  The working set fits the 50 MB L2, so after the first
// iteration the tables come from L2, and at this size each launch does a
// few microseconds of work: launch latency (two launches an iteration),
// not memory, sets the pace.  Row widths are skewed (8 up to 472 in the
// row direction at that size), so a thread per row is imbalanced: the
// widest rows' threads set each dual launch's length.  bf16 storage halves
// the iterate vectors' bytes and leaves the tables as they are.
//
// What this design does about it.  The TPU kernel has no grid: one program
// keeps both tables and every vector in VMEM for the whole burst.  Here
// every step has two grid-wide dependencies (K^T y needs all of y, K xbar
// all of xbar), so each iteration is two launches and the launch boundary
// is the grid-wide barrier:
//   primal kernel, one thread per padded variable: a fixed-order loop over
//     its column-direction ELL row (K^T y), prox, clip, freeze; writes x'
//     and xbar = 2x' - x into separate buffers;
//   dual kernel, one thread per padded constraint: a fixed-order loop over
//     its row-direction ELL row (K xbar), ascent, projection, freeze;
//   residual kernel, after the last step: worst = |Kx - q| on equality
//     rows, max(Kx - q, 0) on inequality rows.
// The 2*iters+1 launches are issued by the host function below on the
// caller's stream, so Python makes one call per burst.  No atomics and a
// fixed summation order in every row: two runs give bitwise-equal
// iterates.  The iterates ping-pong between two buffers.  Making it fast
// (a CUDA graph or one persistent cooperative kernel, a warp per wide row,
// column-major storage inside a block for coalescing) is later work.
//
// The two storage types are one set of kernels templated on the type T of
// the stored x and y.  With T = __nv_bfloat16 (the reference's
// pdhg_spmv.py:292-305): each step widens the stored x and y to fp32,
// computes x' in fp32, stores x' rounded to nearest even, and forms
// xbar = 2x' - x from the UNROUNDED x' in an fp32 buffer; y' likewise is
// computed in fp32 and stored rounded.  A frozen coordinate writes back
// its widened stored value, which rounds to itself.  x0/y0 come in as fp32
// and are rounded once at the start; x_out/y_out are the fp32 widenings
// of the final stored state, and the residual runs on that widened x.
//
// Built with -fmad=false, so each product is rounded before it is added,
// as in the plain version; only the order of the row sums differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// storage <-> fp32: identity for float; for bf16 an exact widening and a
// round-to-nearest-even narrowing (as XLA's convert)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const uint16_t*>(p)))
      << 16);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// sum_j val[r, j] * vec[idx[r, j]] over row r's padded width, j ascending
template <typename V>
__device__ __forceinline__ float ell_row_dot(
    int r, int bm, const int64_t* __restrict__ offsets,
    const int* __restrict__ widths, const int* __restrict__ idx,
    const float* __restrict__ val, const V* __restrict__ vec) {
  const int b = r / bm;
  const int w = widths[b];
  const int64_t start = offsets[b] + (int64_t)(r - b * bm) * w;
  float s = 0.0f;
#pragma unroll 4
  for (int j = 0; j < w; ++j) {
    s += val[start + j] * load(vec + idx[start + j]);
  }
  return s;
}

template <typename T>
__global__ void primal_step(
    int n_pad, const float* __restrict__ c, const float* __restrict__ tau,
    const float* __restrict__ xmax, const uint8_t* __restrict__ keep_n,
    int bm, const int64_t* __restrict__ col_off,
    const int* __restrict__ col_w, const int* __restrict__ col_idx,
    const float* __restrict__ col_val, const T* __restrict__ x,
    const T* __restrict__ y, T* __restrict__ x_new,
    float* __restrict__ x_bar) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const float kty = ell_row_dot(i, bm, col_off, col_w, col_idx, col_val, y);
  const float xi = widen(x[i]);
  float v = fminf(fmaxf(xi - tau[i] * (c[i] + kty), 0.0f), xmax[i]);
  if (keep_n[i]) v = xi;
  x_new[i] = narrow<T>(v);
  x_bar[i] = 2.0f * v - xi;
}

template <typename T>
__global__ void dual_step(
    int m_pad, const float* __restrict__ q, const float* __restrict__ sig,
    const uint8_t* __restrict__ ub, const uint8_t* __restrict__ keep_m,
    int bm, const int64_t* __restrict__ row_off,
    const int* __restrict__ row_w, const int* __restrict__ row_idx,
    const float* __restrict__ row_val, const float* __restrict__ x_bar,
    const T* __restrict__ y, T* __restrict__ y_new) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m_pad) return;
  const float kx = ell_row_dot(r, bm, row_off, row_w, row_idx, row_val, x_bar);
  const float yr = widen(y[r]);
  float v = yr + sig[r] * (kx - q[r]);
  if (ub[r]) v = fmaxf(v, 0.0f);
  if (keep_m[r]) v = yr;
  y_new[r] = narrow<T>(v);
}

__global__ void residual(
    int m_pad, const float* __restrict__ q, const uint8_t* __restrict__ ub,
    int bm, const int64_t* __restrict__ row_off,
    const int* __restrict__ row_w, const int* __restrict__ row_idx,
    const float* __restrict__ row_val, const float* __restrict__ x,
    float* __restrict__ worst) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m_pad) return;
  const float d =
      ell_row_dot(r, bm, row_off, row_w, row_idx, row_val, x) - q[r];
  worst[r] = ub[r] ? fmaxf(d, 0.0f) : fabsf(d);
}

// out[i] = narrow(widen(in[i])): fp32 -> bf16 rounding at the start of a
// bf16 burst, bf16 -> fp32 widening at its end
template <typename S, typename D>
__global__ void convert(int n, const S* __restrict__ in, D* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = narrow<D>(widen(in[i]));
}

struct Operator {
  int n_pad, m_pad, row_bm, col_bm;
  const float *c, *tau, *xmax, *q, *sig;
  const uint8_t *ub, *keep_n, *keep_m;
  const int64_t* row_off;
  const int *row_w, *row_idx;
  const float* row_val;
  const int64_t* col_off;
  const int *col_w, *col_idx;
  const float* col_val;
};

// `iters` steps from (x, y): step k reads the previous step's output (x, y
// for k = 0) and writes buffer k % 2 of (xs, ys)
template <typename T>
void run_steps(const Operator& op, int iters, const T* x, const T* y,
               T* const xs[2], T* const ys[2], float* x_bar, cudaStream_t s) {
  const int gx = (op.n_pad + kThreads - 1) / kThreads;
  const int gy = (op.m_pad + kThreads - 1) / kThreads;
  for (int k = 0; k < iters; ++k) {
    T* xn = xs[k % 2];
    T* yn = ys[k % 2];
    primal_step<T><<<gx, kThreads, 0, s>>>(
        op.n_pad, op.c, op.tau, op.xmax, op.keep_n, op.col_bm, op.col_off,
        op.col_w, op.col_idx, op.col_val, x, y, xn, x_bar);
    dual_step<T><<<gy, kThreads, 0, s>>>(
        op.m_pad, op.q, op.sig, op.ub, op.keep_m, op.row_bm, op.row_off,
        op.row_w, op.row_idx, op.row_val, x_bar, y, yn);
    x = xn;
    y = yn;
  }
}

void run_residual(const Operator& op, const float* x, float* worst,
                  cudaStream_t s) {
  const int gy = (op.m_pad + kThreads - 1) / kThreads;
  residual<<<gy, kThreads, 0, s>>>(op.m_pad, op.q, op.ub, op.row_bm,
                                   op.row_off, op.row_w, op.row_idx,
                                   op.row_val, x, worst);
}

}  // namespace

// One burst of `iters` PDHG steps plus the terminal residual vector, all
// enqueued on `stream`, fp32 iterates.  x0/y0 are read only; the result is
// written to x_out/y_out/worst, with x_tmp/y_tmp/x_bar as fp32 scratch of
// the same lengths.  Returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int pdhg_burst_f32(
    int n_pad, int m_pad, int iters, int row_bm, int col_bm,
    const float* c, const float* tau, const float* xmax, const float* q,
    const float* sig, const uint8_t* ub, const uint8_t* keep_n,
    const uint8_t* keep_m, const int64_t* row_off, const int* row_w,
    const int* row_idx, const float* row_val, const int64_t* col_off,
    const int* col_w, const int* col_idx, const float* col_val,
    const float* x0, const float* y0, float* x_out, float* y_out,
    float* worst, float* x_tmp, float* y_tmp, float* x_bar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operator op{n_pad, m_pad, row_bm, col_bm, c, tau, xmax, q, sig,
                    ub, keep_n, keep_m, row_off, row_w, row_idx, row_val,
                    col_off, col_w, col_idx, col_val};
  if (iters == 0) {
    cudaMemcpyAsync(x_out, x0, sizeof(float) * (size_t)n_pad,
                    cudaMemcpyDeviceToDevice, s);
    cudaMemcpyAsync(y_out, y0, sizeof(float) * (size_t)m_pad,
                    cudaMemcpyDeviceToDevice, s);
  }
  // the last step (k = iters - 1) must land in the output buffers
  float* const xs[2] = {(iters % 2) ? x_out : x_tmp,
                        (iters % 2) ? x_tmp : x_out};
  float* const ys[2] = {(iters % 2) ? y_out : y_tmp,
                        (iters % 2) ? y_tmp : y_out};
  run_steps<float>(op, iters, x0, y0, xs, ys, x_bar, s);
  run_residual(op, x_out, worst, s);
  return static_cast<int>(cudaGetLastError());
}

// The same burst with the iterates stored in bfloat16 between steps (all
// arithmetic in fp32; see the note at the top).  Inputs x0/y0 and outputs
// x_out/y_out/worst are fp32; x_store (2 * n_pad) and y_store (2 * m_pad)
// are bf16 scratch for the two ping-pong buffers, x_bar fp32 scratch.
// iters == 0 returns the bf16-rounded x0/y0, widened.
extern "C" int pdhg_burst_bf16(
    int n_pad, int m_pad, int iters, int row_bm, int col_bm,
    const float* c, const float* tau, const float* xmax, const float* q,
    const float* sig, const uint8_t* ub, const uint8_t* keep_n,
    const uint8_t* keep_m, const int64_t* row_off, const int* row_w,
    const int* row_idx, const float* row_val, const int64_t* col_off,
    const int* col_w, const int* col_idx, const float* col_val,
    const float* x0, const float* y0, float* x_out, float* y_out,
    float* worst, __nv_bfloat16* x_store, __nv_bfloat16* y_store,
    float* x_bar, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operator op{n_pad, m_pad, row_bm, col_bm, c, tau, xmax, q, sig,
                    ub, keep_n, keep_m, row_off, row_w, row_idx, row_val,
                    col_off, col_w, col_idx, col_val};
  const int gx = (n_pad + kThreads - 1) / kThreads;
  const int gy = (m_pad + kThreads - 1) / kThreads;
  __nv_bfloat16* const xs[2] = {x_store, x_store + n_pad};
  __nv_bfloat16* const ys[2] = {y_store, y_store + m_pad};
  // x0/y0 rounded into buffer 1; step 0 reads it and writes buffer 0
  convert<float, __nv_bfloat16><<<gx, kThreads, 0, s>>>(n_pad, x0, xs[1]);
  convert<float, __nv_bfloat16><<<gy, kThreads, 0, s>>>(m_pad, y0, ys[1]);
  run_steps<__nv_bfloat16>(op, iters, xs[1], ys[1], xs, ys, x_bar, s);
  const int last = iters == 0 ? 1 : (iters - 1) % 2;
  convert<__nv_bfloat16, float><<<gx, kThreads, 0, s>>>(n_pad, xs[last],
                                                        x_out);
  convert<__nv_bfloat16, float><<<gy, kThreads, 0, s>>>(m_pad, ys[last],
                                                        y_out);
  run_residual(op, x_out, worst, s);
  return static_cast<int>(cudaGetLastError());
}
