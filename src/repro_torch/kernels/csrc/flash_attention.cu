// Forward flash attention (online softmax), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_bhsd, the
// Pallas TPU kernel (pl.pallas_call of _kernel), reached through the
// reference's kernels/ops.py::flash_attention from models/attention.py when
// impl="pallas" and S > 1 (the prefill).  Same function: GQA (query head h
// reads kv head h / (H / Hkv)), causal and sliding-window masks
// (q_idx - k_idx < window), tanh logit softcap applied before the mask,
// masked scores filled with the finite NEG_INF = -2.3819763e38, fp32
// m / l / acc, out = acc / max(l, 1e-30) rounded once to the input type.
// Inputs fp32 or bf16; every product and sum is fp32 (bf16 is widened on
// load; p stays fp32 in p . v).
//
// Layout.  The kernel reads q (B, S, H, hd) and k, v (B, T, Hkv, hd) as the
// model produces them, contiguous, with the position stride H * hd (Hkv * hd)
// and writes out (B, S, H, hd): no transposes and no padding of hd in device
// memory (the reference's wrapper transposes to (B*H, S, hd) and pads hd to
// 128).  hd is any multiple of 8 up to 256; inside the block it is padded
// with zeros in shared memory to HDP = 16 * NJ (16, 32, 64, 128 or 256).
//
// What bounds it at the main-path shape (phi4-mini-3.8b prefill: q (4, 2048,
// 24, 128), k / v (4, 2048, 8, 128), bf16, causal): 4*B*H*S*T*hd/2 = 1.03e11
// useful flop a launch, 134 MB of input and output.  At the card's bf16
// tensor-core peak (989 TFLOP/s) that is 0.104 ms against 0.040 ms for the
// bytes at 3.35 TB/s: compute bounds it.  The TPU kernel's 512 x 512 tiles
// and 128-lane padding were shaped for the MXU and VMEM; they do not carry
// over.
//
// What this design does about it, for now.  It is the simple, exact form:
// one block of 256 threads per (b * h, 64-row query tile); a loop over
// 64-row kv tiles staged in shared memory as fp32; per row m and l in
// shared memory and the 64 x HDP accumulator in registers (a 4 x NJ
// register tile a thread).  S = Q K^T reads both operands as float4 from
// rows padded to HDP + 4 floats (no bank conflicts); P V reads P as float4.
// kv tiles wholly above the causal diagonal or wholly outside the window
// are skipped: such a tile leaves m, l and acc unchanged in the reference
// (its exp(NEG_INF - NEG_INF) = 1 weights are wiped by alpha = 0 at the
// row's first real score), so skipping is exact.  Keys past T get -inf,
// i.e. no weight at all.  All arithmetic runs on the fp32 FMA units, not
// the tensor cores, so it sits far above the bf16 bound: with fp32 p
// kept, p . v cannot go through bf16 tensor cores unchanged, and wgmma,
// TMA, pipelining and warp specialisation are later work.  No atomics:
// two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a kv tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kLDS = kBK + 4;  // row stride of the score tile (floats)
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a (len, n_heads, hd) sequence -> fp32 rows of
// `ld` floats in shared memory; rows past `len` and columns past hd are 0
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int row0,
                                          int len, int hd) {
  for (int i = threadIdx.x; i < 64 * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    const int row = row0 + r;
    dst[r * ld + d] =
        (row < len && d < hd) ? to_f32(src[row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
              int H, int Hkv, int hd, int causal, int window, float cap,
              float scale) {
  constexpr int HDP = 16 * NJ;
  constexpr int LDQ = HDP + 4;  // float4 rows, 4-bank shift between rows
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [kBQ][LDQ]
  float* kvs = qs + kBQ * LDQ;    // [kBK][LDQ]: K, then V of the same tile
  float* ps = kvs + kBK * LDQ;    // [kBQ][kLDS]: scores, then p
  float* m_s = ps + kBQ * kLDS;   // [kBQ] running max
  float* l_s = m_s + kBQ;         // [kBQ] running denominator
  float* a_s = l_s + kBQ;         // [kBQ] this tile's rescale alpha

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t k_stride = (int64_t)Hkv * hd;
  const T* qb = q + ((int64_t)b * S * H + h) * hd;
  const T* kb = k + ((int64_t)b * Tk * Hkv + hk) * hd;
  const T* vb = v + ((int64_t)b * Tk * Hkv + hk) * hd;

  load_tile<T, HDP>(qs, LDQ, qb, q_stride, q0, S, hd);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    if (causal && k0 > q_last) break;  // wholly above the diagonal
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // outside
    __syncthreads();  // the previous tile's reads of V and p are done
    load_tile<T, HDP>(kvs, LDQ, kb, k_stride, k0, Tk, hd);
    __syncthreads();

    // s = (Q K^T) * scale for rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // softcap, then the mask (the reference's order)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qi = q0 + r, ki = k0 + c;
        float x = s[i][j] * scale;
        if (cap != 0.0f) x = cap * tanhf(x / cap);
        bool keep = true;
        if (causal) keep = keep && qi >= ki;
        if (window > 0) keep = keep && (qi - ki) < window;
        x = keep ? x : kNegInf;
        if (ki >= Tk) x = -INFINITY;  // no such key: weight exactly 0
        ps[r * kLDS + c] = x;
      }
    __syncthreads();

    // online softmax: 4 lanes a row, lane `part` takes columns part + 4jj
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ps + r * kLDS;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) mx = fmaxf(mx, row[part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float l_prev = l_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kBK / 4; ++jj) {
        const float p = expf(row[part + 4 * jj] - m_new);
        row[part + 4 * jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_prev + sum;
        m_s[r] = m_new;
      }
    }
    // K is no longer read: stage V in its place
    load_tile<T, HDP>(kvs, LDQ, vb, k_stride, k0, Tk, hd);
    __syncthreads();

    // acc = alpha * acc + p . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kLDS + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* vc = kvs + c * LDQ + tx + 16 * j;
        const float v0 = vc[0], v1 = vc[LDQ], v2 = vc[2 * LDQ],
                    v3 = vc[3 * LDQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(pv[i].x, v0, acc[i][j]);
          acc[i][j] = fmaf(pv[i].y, v1, acc[i][j]);
          acc[i][j] = fmaf(pv[i].z, v2, acc[i][j]);
          acc[i][j] = fmaf(pv[i].w, v3, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    T* orow = out + ((int64_t)b * S + qi) * q_stride + (int64_t)h * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store_out(orow + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch(int B, int S, int Tk, int H, int Hkv, int hd, int causal,
                   int window, float cap, float scale, const void* q,
                   const void* k, const void* v, void* out,
                   cudaStream_t stream) {
  constexpr int LDQ = 16 * NJ + 4;
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * LDQ + kBQ * kLDS + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, Hkv, hd,
      causal, window, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int B, int S, int Tk, int H, int Hkv, int hd,
                     int causal, int window, float cap, float scale,
                     const void* q, const void* k, const void* v, void* out,
                     cudaStream_t stream) {
#define FA_ARGS B, S, Tk, H, Hkv, hd, causal, window, cap, scale, q, k, v, \
                out, stream
  if (hd <= 16) return launch<T, 1>(FA_ARGS);
  if (hd <= 32) return launch<T, 2>(FA_ARGS);
  if (hd <= 64) return launch<T, 4>(FA_ARGS);
  if (hd <= 128) return launch<T, 8>(FA_ARGS);
  return launch<T, 16>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q, k, v
// and out are contiguous (B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd),
// (B, S, H, hd).  window 0 means no window.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); the caller checks shapes.
extern "C" int flash_attention_fwd(int dtype, int B, int S, int Tk, int H,
                                   int Hkv, int hd, int causal, int window,
                                   float softcap, float scale, const void* q,
                                   const void* k, const void* v, void* out,
                                   void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || Hkv <= 0 || H % Hkv != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? dispatch<__nv_bfloat16>(B, S, Tk, H, Hkv, hd, causal, window,
                                    softcap, scale, q, k, v, out, st)
          : dispatch<float>(B, S, Tk, H, Hkv, hd, causal, window, softcap,
                            scale, q, k, v, out, st);
  return (int)err;
}
