// RG-LRU linear recurrence (prefill scan), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan, the Pallas TPU
// kernel (pl.pallas_call of _kernel), reached through the reference's
// kernels/ops.py::rglru.  Same function: h_t = a_t * h_{t-1} + b_t
// elementwise over (batch, feature), t = 0 .. S-1, from h0 (zeros when
// none is given); returns every h_t and h_last = h_{S-1}.  The port calls
// it from models/rglru.py's train and prefill modes (impl="kernel"), where
// the reference's model takes an associative scan of the same recurrence.
//
// What bounds it on this card.  Each step reads a_t and b_t once and writes
// h_t once; h0 is read and h_last written once: (3*B*S*R + 2*B*R) * 4
// bytes.  At the serving shape (recurrentgemma-2b prefill, B=4, S=4096,
// R=2560) that is 503,398,400 B, 0.150 ms at 3.35 TB/s; the 2*B*S*R =
// 83.9 M flop are negligible.  Memory bounds it.
//
// What this design does about it.  The TPU kernel streams a (S, 128) slab
// of a and b through VMEM per grid step and runs a fori_loop over S on one
// 128-lane row.  Here each thread owns one (batch, feature) column: blocks
// of 128 threads, B * ceil(R/128) of them on the grid's x axis (its limit
// is 2^31 - 1), each thread walking S in order, so a warp's loads of a_t
// and b_t (and its store of h_t) are 32 consecutive floats of one row:
// coalesced.  The loop is unrolled 8 ways with
// __restrict__ pointers, so the loads of the next steps are issued ahead
// of the dependent multiply-add chain.  Any R is allowed (the last block
// is ragged).  Each step rounds the product and the sum separately
// (__fmul_rn, __fadd_rn; the file is also built with -fmad=false), which
// is the plain version's order (kernels/rglru_scan.py), so the two agree
// bitwise.  No atomics: two launches give the same bits.
//
// What this simple design leaves on the table.  At the serving shape only
// B*R = 10,240 columns exist: 80 blocks of 128 threads for 132 SMs, each
// thread a 4096-step dependent chain, so the card holds far too few loads
// in flight to reach its memory rate.  A chunked two-pass scan (local
// scans over S-chunks, then a carry pass over the chunk ends) would fill
// the card; it changes the summation order, and its plain version with it.
// That is a later kernel PR's work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ h_last, int S, int R) {
  // blockIdx.x = batch * ceil(R / kThreads) + feature block
  const int r_blocks = (R + kThreads - 1) / kThreads;
  const int batch = blockIdx.x / r_blocks;
  const int r = (blockIdx.x % r_blocks) * kThreads + threadIdx.x;
  if (r >= R) return;
  const int64_t row = (int64_t)batch * R + r;      // (batch, feature)
  const int64_t col = (int64_t)batch * S * R + r;  // its t = 0 element
  const float* ap = a + col;
  const float* bp = b + col;
  float* hp = h + col;
  float hc = h0 != nullptr ? h0[row] : 0.0f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const int64_t i = (int64_t)t * R;
    hc = __fadd_rn(__fmul_rn(__ldg(ap + i), hc), __ldg(bp + i));
    hp[i] = hc;
  }
  h_last[row] = hc;
}

}  // namespace

// a, b and h are contiguous (B, S, R) float32; h0 (B, R) float32 or null
// (zeros); h_last (B, R).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); the caller checks shapes.
extern "C" int rglru_scan_f32(int B, int S, int R, const void* a,
                              const void* b, const void* h0, void* h,
                              void* h_last, void* stream) {
  if (B < 0 || S < 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  // one axis, where the limit is 2^31 - 1
  const int64_t blocks = (int64_t)B * ((R + kThreads - 1) / kThreads);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, R);
  return (int)cudaGetLastError();
}
