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
// 83.9 M flop are negligible.  Memory bounds it.  The dependent chain does
// not: a step adds one rounded product and one rounded sum to it, about
// 8 cycles, so 4096 steps take about 20 us.  What the card needs is bytes
// in flight, several MB over its 132 SMs, and work on every SM.
//
// What this design does about it.  The TPU kernel streams a (S, 128) slab
// of a and b through VMEM per grid step and runs a fori_loop over S on one
// 128-lane row.  Here a group is 32 consecutive features of one batch row,
// one warp, one block: a time step of a group is one 128-byte row segment.
// The B * ceil(R/32) groups lie on the grid's x axis (its limit is
// 2^31 - 1): 320 at the serving shape, two or three an SM.  Each group
// streams its a and b through a ring of kStages slots in shared memory,
// each slot T steps (a step: a_t's 32 floats, then b_t's), filled by
// cp.async: the copies of stage k + kStages - 1 are issued before stage k
// is computed, so kStages - 1 stages are in flight.  The wrapper
// (kernels/ops.py::scan_steps) picks T so that about 4 MB are in flight
// over the card (the memory rate times its latency under load; more only
// queues) and every group of the launch is resident at once: T = 16 at
// the serving shape, 12 KB in flight a group, 3.9 MB over the card.  Each
// lane then reads its column's a_t and b_t from shared memory (consecutive
// words, no bank conflicts, eight steps at a time), runs the chain, and
// stores h_t: 128 bytes a warp, coalesced.  One warp issues every
// instruction of its group, so the loops keep a step to about ten
// instructions: pointers that advance, no index arithmetic.
//
// Copies are 16 bytes a lane (8 lanes a step) where R % 4 == 0 and a and
// b start on 16-byte boundaries; otherwise 4 bytes a lane (its own
// feature), so every contiguous operand works.  The last group of a row
// copies and computes no feature past R, the last stage no step past S.
//
// Bits.  Each column walks S in order, and each step rounds the product and
// the sum separately (__fmul_rn, __fadd_rn; the file is also built with
// -fmad=false), which is the plain version's order (kernels/rglru_scan.py),
// so the two agree bitwise, whatever T, the copy width or the grid.  No
// atomics: two launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;   // features a group: the lanes of its warp
constexpr int kStages = 4;   // ring slots a group
constexpr int kUnroll = 8;   // steps read from shared memory at a time
constexpr int kMaxSteps = 1 << 16;

// bytes of shared memory a block: kStages slots of a and b, T steps each
size_t ring_bytes(int steps) {
  return (size_t)kStages * 2 * steps * kGroup * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kVec>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  if (kVec)
    copy16(dst, src);
  else
    copy4(dst, src);
}

template <bool kVec>
__global__ void __launch_bounds__(kGroup)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      float* __restrict__ h_last, int S, int R, int T) {
  // kStages slots of T steps; a step is a_t's 32 floats, then b_t's
  extern __shared__ __align__(16) float ring[];
  constexpr int kStep = 2 * kGroup;  // floats a step in a slot
  // blockIdx.x = batch * ceil(R / kGroup) + group of the row
  const int row_groups = (R + kGroup - 1) / kGroup;
  const int batch = blockIdx.x / row_groups;
  const int f0 = (blockIdx.x % row_groups) * kGroup;
  const int width = min(kGroup, R - f0);
  const int lane = threadIdx.x;
  const bool live = lane < width;
  const int64_t row = (int64_t)batch * R + f0;      // (batch, f0)
  const int64_t col = (int64_t)batch * S * R + f0;  // (batch, 0, f0)
  const int slot = T * kStep;
  const int n_stages = (S + T - 1) / T;

  // A lane's copies: 16 bytes (features cf .. cf+3) of steps r0, r0+4, ...
  // (8 lanes a step), or 4 bytes (its own feature) of every step.  The
  // last group of a row copies no feature past R.
  const int r0 = kVec ? lane / 8 : 0;
  constexpr int dr = kVec ? kGroup / 8 : 1;
  const int cf = kVec ? (lane % 8) * 4 : lane;
  const bool copies = cf < width;

  // stage k (steps k*T ..) into slot k % kStages; one commit group a
  // stage, empty past the last, so wait_pending counts stages
  auto issue = [&](int k) {
    if (k < n_stages && copies) {
      const int t0 = k * T;
      const int n = min(T, S - t0);
      float* s = ring + (k % kStages) * slot + r0 * kStep + cf;
      const int64_t off = col + (int64_t)(t0 + r0) * R + cf;
      const float* ga = a + off;
      const float* gb = b + off;
      for (int t = r0; t < n; t += dr) {
        copy<kVec>(s, ga);
        copy<kVec>(s + kGroup, gb);
        s += dr * kStep;
        ga += (int64_t)dr * R;
        gb += (int64_t)dr * R;
      }
    }
    commit();
  };
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  float hc = live && h0 != nullptr ? h0[row + lane] : 0.0f;
  float* hp = h + col + lane;
  for (int k = 0; k < n_stages; ++k) {
    wait_pending<kStages - 2>();  // this lane's copies of stage k landed
    __syncwarp();  // every lane's copies seen; slot (k-1) % kStages free
    issue(k + kStages - 1);
    if (!live) continue;
    const float* sp = ring + (k % kStages) * slot + lane;
    const int n = min(T, S - k * T);
    for (int t = 0; t < n; t += kUnroll, sp += kUnroll * kStep) {
      // T is a multiple of kUnroll: the reads stay inside the slot
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = sp[u * kStep];
        bv[u] = sp[u * kStep + kGroup];
      }
      if (t + kUnroll <= n) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          hc = __fadd_rn(__fmul_rn(av[u], hc), bv[u]);
          *hp = hc;
          hp += R;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u < n) {
            hc = __fadd_rn(__fmul_rn(av[u], hc), bv[u]);
            *hp = hc;
            hp += R;
          }
        }
      }
    }
  }
  if (live) h_last[row + lane] = hc;
}

bool vec_copies(int R, const void* a, const void* b) {
  return R % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

// The kernel for the copy width, its dynamic shared memory allowed up to
// `bytes`.  A request the card refuses returns its error.
cudaError_t kernel_for(bool vec, size_t bytes, const void** fn) {
  *fn = vec ? reinterpret_cast<const void*>(rglru_scan_kernel<true>)
            : reinterpret_cast<const void*>(rglru_scan_kernel<false>);
  const cudaError_t err = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller raises
  return err;
}

}  // namespace

// a, b and h are contiguous (B, S, R) float32; h0 (B, R) float32 or null
// (zeros); h_last (B, R).  `steps` is T, the steps of a ring stage: a
// multiple of 8 (kernels/ops.py::scan_steps picks it).  Launches on
// `stream` and returns the CUDA error (0 on success); the caller checks
// shapes.
extern "C" int rglru_scan_f32(int B, int S, int R, int steps, const void* a,
                              const void* b, const void* h0, void* h,
                              void* h_last, void* stream) {
  if (B < 0 || S < 0 || R < 0 || steps < kUnroll || steps % kUnroll != 0 ||
      steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || R == 0) return 0;
  // one axis, where the limit is 2^31 - 1
  const int64_t groups = (int64_t)B * ((R + kGroup - 1) / kGroup);
  if (groups > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t bytes = ring_bytes(steps);
  const void* fn = nullptr;
  cudaError_t err = kernel_for(vec_copies(R, a, b), bytes, &fn);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a, &b, &h0, &h, &h_last, &S, &R, &steps};
  err = cudaLaunchKernel(fn, dim3((unsigned)groups), dim3(kGroup), args,
                         bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // clear it; the caller raises
  return (int)err;
}

// What the card offers the kernel on `device`: out[0] SMs, out[1] shared
// memory bytes an SM, out[2] bytes a block may ask for, out[3] bytes the
// card reserves a block.  Returns the CUDA error (0 on success).
extern "C" int rglru_scan_limits(int device, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(out + i, attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// What a launch of the 16-byte copy kernel at stage length `steps` uses:
// out[0] registers a thread, out[1] dynamic shared memory bytes a block,
// out[2] blocks that fit on an SM at once, out[3] local (spill) bytes a
// thread.  Returns the CUDA error (0 on success).
extern "C" int rglru_scan_occupancy(int steps, int* out) {
  if (steps < kUnroll || steps % kUnroll != 0 || steps > kMaxSteps)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = ring_bytes(steps);
  const void* fn = nullptr;
  cudaError_t err = kernel_for(true, bytes, &fn);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kGroup,
                                                      bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)bytes;
  out[2] = per_sm;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}
