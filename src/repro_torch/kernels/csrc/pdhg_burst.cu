// Fused PDHG iteration burst over a blocked-ELL operator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/pdhg_spmv.py::pdhg_burst, the Pallas TPU kernel
// (pl.pallas_call of _burst_kernel, body pdhg_update_burst, SpMV spmv_blocks).
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
// widest rows' threads set each dual launch's length.
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
// iterates.  The iterates ping-pong between the output and a scratch
// buffer so that the last step lands in the output.  Making it fast (a
// CUDA graph or one persistent cooperative kernel, a warp per wide row,
// column-major storage inside a block for coalescing) is later work.
//
// Built with -fmad=false, so each product is rounded before it is added,
// as in the plain version; only the order of the row sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// sum_j val[r, j] * vec[idx[r, j]] over row r's padded width, j ascending
__device__ __forceinline__ float ell_row_dot(
    int r, int bm, const int64_t* __restrict__ offsets,
    const int* __restrict__ widths, const int* __restrict__ idx,
    const float* __restrict__ val, const float* __restrict__ vec) {
  const int b = r / bm;
  const int w = widths[b];
  const int64_t start = offsets[b] + (int64_t)(r - b * bm) * w;
  float s = 0.0f;
#pragma unroll 4
  for (int j = 0; j < w; ++j) {
    s += val[start + j] * __ldg(vec + idx[start + j]);
  }
  return s;
}

__global__ void primal_step(
    int n_pad, const float* __restrict__ c, const float* __restrict__ tau,
    const float* __restrict__ xmax, const uint8_t* __restrict__ keep_n,
    int bm, const int64_t* __restrict__ col_off,
    const int* __restrict__ col_w, const int* __restrict__ col_idx,
    const float* __restrict__ col_val, const float* __restrict__ x,
    const float* __restrict__ y, float* __restrict__ x_new,
    float* __restrict__ x_bar) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const float kty = ell_row_dot(i, bm, col_off, col_w, col_idx, col_val, y);
  const float xi = x[i];
  float v = fminf(fmaxf(xi - tau[i] * (c[i] + kty), 0.0f), xmax[i]);
  if (keep_n[i]) v = xi;
  x_new[i] = v;
  x_bar[i] = 2.0f * v - xi;
}

__global__ void dual_step(
    int m_pad, const float* __restrict__ q, const float* __restrict__ sig,
    const uint8_t* __restrict__ ub, const uint8_t* __restrict__ keep_m,
    int bm, const int64_t* __restrict__ row_off,
    const int* __restrict__ row_w, const int* __restrict__ row_idx,
    const float* __restrict__ row_val, const float* __restrict__ x_bar,
    const float* __restrict__ y, float* __restrict__ y_new) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m_pad) return;
  const float kx = ell_row_dot(r, bm, row_off, row_w, row_idx, row_val, x_bar);
  const float yr = y[r];
  float v = yr + sig[r] * (kx - q[r]);
  if (ub[r]) v = fmaxf(v, 0.0f);
  if (keep_m[r]) v = yr;
  y_new[r] = v;
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

}  // namespace

// One burst of `iters` PDHG steps plus the terminal residual vector, all
// enqueued on `stream`.  x0/y0 are read only; the result is written to
// x_out/y_out/worst, with x_tmp/y_tmp/x_bar as scratch of the same lengths.
// Returns cudaGetLastError() after the launches (0 on success).
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
  const int gx = (n_pad + kThreads - 1) / kThreads;
  const int gy = (m_pad + kThreads - 1) / kThreads;
  if (iters == 0) {
    cudaMemcpyAsync(x_out, x0, sizeof(float) * (size_t)n_pad,
                    cudaMemcpyDeviceToDevice, s);
    cudaMemcpyAsync(y_out, y0, sizeof(float) * (size_t)m_pad,
                    cudaMemcpyDeviceToDevice, s);
  }
  // step k writes buffer k % 2 of (first, second); the last step
  // (k = iters - 1) must land in the output buffers
  float* xs[2] = {(iters % 2) ? x_out : x_tmp, (iters % 2) ? x_tmp : x_out};
  float* ys[2] = {(iters % 2) ? y_out : y_tmp, (iters % 2) ? y_tmp : y_out};
  const float* x = x0;
  const float* y = y0;
  for (int k = 0; k < iters; ++k) {
    float* xn = xs[k % 2];
    float* yn = ys[k % 2];
    primal_step<<<gx, kThreads, 0, s>>>(n_pad, c, tau, xmax, keep_n, col_bm,
                                        col_off, col_w, col_idx, col_val, x,
                                        y, xn, x_bar);
    dual_step<<<gy, kThreads, 0, s>>>(m_pad, q, sig, ub, keep_m, row_bm,
                                      row_off, row_w, row_idx, row_val,
                                      x_bar, y, yn);
    x = xn;
    y = yn;
  }
  residual<<<gy, kThreads, 0, s>>>(m_pad, q, ub, row_bm, row_off, row_w,
                                   row_idx, row_val, x_out, worst);
  return static_cast<int>(cudaGetLastError());
}
