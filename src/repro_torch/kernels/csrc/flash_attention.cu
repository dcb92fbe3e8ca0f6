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
//
// Layout.  Both entries read q (B, S, H, hd) and k, v (B, T, Hkv, hd) as the
// model produces them, contiguous, with the position stride H * hd (Hkv * hd)
// and write out (B, S, H, hd): no transposes and no padding of hd in device
// memory (the reference's wrapper transposes to (B*H, S, hd) and pads hd to
// 128).  hd is any multiple of 8 up to 256; inside the block it is padded
// with zeros in shared memory to HDP (16, 32, 64, 128 or 256).
//
// What bounds it at the main-path shape (phi4-mini-3.8b prefill: q (4, 2048,
// 24, 128), k / v (4, 2048, 8, 128), bf16, causal): 4*B*H*S*T*hd/2 = 1.03e11
// useful flop a launch, 134 MB of input and output.  At the card's bf16
// tensor-core peak (989 TFLOP/s) that is 0.104 ms against 0.040 ms for the
// bytes at 3.35 TB/s: the tensor cores bound it.  The TPU kernel's 512 x 512
// tiles and 128-lane padding were shaped for the MXU and VMEM; they do not
// carry over.
//
// Two entries, chosen by the input dtype (never as a fallback):
//
// bf16, flash_fwd_tc (the served path: models serve in bf16).  Both products
// run on the tensor cores as mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// operands brought from shared memory by ldmatrix.  One block of 4 warps
// owns 64 query rows (16 a warp, kept as the m16 of the product); K and V
// tiles of BKV keys stream through a two-stage ring filled by cp.async, so
// tile j+1's load overlaps tile j's math, with one barrier a tile.  Rows of
// shared memory are padded by 16 bytes, so ldmatrix's eight row reads fall
// in distinct banks.  mma.sync is synchronous in the warp, so what hides
// its latency and the softmax between the products is other warps: the
// tiles are sized for three or four resident blocks an SM, and a warp
// skips a tile that is wholly masked for its own 16 rows.
//   * S = Q K^T: products of bf16 values are exact in fp32.  Scale, softcap,
//     mask, the row max, p = exp(s - m_new) (ex2 of scores kept times
//     log2 e) and l run in fp32 registers on the accumulator fragment (4
//     lanes share a row); l is summed from the fp32 p.
//   * O += P V as two bf16 products, hi . V + lo . V with hi = bf16(p) and
//     lo = bf16(p - hi), summed in fp32: p keeps 16 significant bits, where
//     a single rounding of p to bf16 would move the output by several bf16
//     places.  The split costs 1.5x the useful tensor work.  The S
//     fragment is already P's A-operand layout, so P never touches shared
//     memory; V feeds ldmatrix.trans in its stored (T, hd) layout.
// This is the mma.sync form, not the faster wgmma/TMA form (a producer warp
// with TMA and mbarriers, warpgroup products): that is the next step.
//
// fp32, flash_fwd_simt: the exact form of the first port, every product and
// sum on the fp32 FMA units.  One block of 256 threads per (b * h, 64-row
// query tile); 64-row kv tiles staged in shared memory; the 64 x HDP
// accumulator in registers (a 4 x NJ register tile a thread).  The fp32
// FMA units (67 TFLOP/s) bound it, far above the tensor-core bound.  No
// served path runs attention in fp32; it is the float32 reference on the
// card.
//
// Both entries skip kv tiles wholly above the causal diagonal or wholly
// outside the window: such a tile leaves m, l and acc unchanged in the
// reference (its exp(NEG_INF - NEG_INF) = 1 weights are wiped by alpha = 0 at
// the row's first real score), so skipping is exact.  Keys past T get -inf,
// i.e. no weight at all, and ragged rows are masked in the kernel.  No
// atomics and no split over kv: two runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;

// ---------------------------------------------------------------------------
// fp32 entry: the SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a kv tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kLDS = kBK + 4;  // row stride of the score tile (floats)

// rows [row0, row0 + 64) of a (len, n_heads, hd) sequence -> rows of `ld`
// floats in shared memory; rows past `len` and columns past hd are 0
template <int HDP>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int row0,
                                          int len, int hd) {
  for (int i = threadIdx.x; i < 64 * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    const int row = row0 + r;
    dst[r * ld + d] = (row < len && d < hd) ? src[row * row_stride + d] : 0.0f;
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out, int S,
                   int Tk, int H, int Hkv, int hd, int causal, int window,
                   float cap, float scale) {
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
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t k_stride = (int64_t)Hkv * hd;
  const float* qb = q + ((int64_t)b * S * H + h) * hd;
  const float* kb = k + ((int64_t)b * Tk * Hkv + hk) * hd;
  const float* vb = v + ((int64_t)b * Tk * Hkv + hk) * hd;

  load_tile<HDP>(qs, LDQ, qb, q_stride, q0, S, hd);
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
    load_tile<HDP>(kvs, LDQ, kb, k_stride, k0, Tk, hd);
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
    load_tile<HDP>(kvs, LDQ, vb, k_stride, k0, Tk, hd);
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
    float* orow = out + ((int64_t)b * S + qi) * q_stride + (int64_t)h * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = acc[i][j] / denom;
    }
  }
}

template <int NJ>
cudaError_t launch_simt(int B, int S, int Tk, int H, int Hkv, int hd,
                        int causal, int window, float cap, float scale,
                        const void* q, const void* k, const void* v,
                        void* out, cudaStream_t stream) {
  constexpr int LDQ = 16 * NJ + 4;
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * LDQ + kBQ * kLDS + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // (batch, head) on x, where the limit is 2^31 - 1; query tiles on y
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_simt<NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Tk, H, Hkv,
      hd, causal, window, cap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 entry: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;  // query rows a block, 16 a warp
constexpr int kStages = 2;            // K/V tiles in the copy ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16((x, y) - hi), packed as the
// A operand wants them (x in the low half)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + ROWS) of a (len, n_heads, hd) bf16 sequence -> rows of
// LD bf16 in shared memory, 16 bytes a copy; rows past `len` and columns
// past hd are zero-filled
template <int ROWS, int HDP, int LD>
__device__ __forceinline__ void load_rows_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int64_t row_stride, int row0,
                                                int len, int hd) {
  constexpr int kChunks = HDP / 8;                // 16-byte copies a row
  constexpr int kRowStep = kTcThreads / kChunks;  // rows a pass
  static_assert(kTcThreads % kChunks == 0 && ROWS % kRowStep == 0,
                "whole rows a pass, whole passes a tile");
  // a thread copies the same column of rows r, r + kRowStep, ...
  const int c = threadIdx.x % kChunks, r = threadIdx.x / kChunks;
  const bool col_ok = c * 8 < hd;
  const bf16* g = src + (int64_t)(row0 + r) * row_stride + c * 8;
  const uint32_t d = smem_u32(dst + r * LD + c * 8);
#pragma unroll
  for (int n = 0; n < ROWS / kRowStep; ++n) {
    const bool ok = col_ok && row0 + r + n * kRowStep < len;
    cp_async16(d + n * kRowStep * LD * (int)sizeof(bf16),
               ok ? g + n * kRowStep * row_stride : src, ok);
  }
}

// grid (B * H, query tiles): x walks the heads, y the query tiles from the
// last (the most kv tiles under a causal mask) to the first.  Warp w owns
// rows q0 + 16 w .. q0 + 16 w + 15.  K/V tiles of BKV keys pass through a
// ring of kStages stages.  MINB blocks an SM bound the registers: the
// kernel waits on its own loads and barriers, so resident warps are what
// hides that latency.
template <int HDP, int BKV, int MINB>
__global__ void __launch_bounds__(kTcThreads, MINB)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int Tk, int H, int Hkv, int hd, int causal, int window,
                 float cap, float scale) {
  constexpr int LD = HDP + 8;   // bf16 row stride: 16-byte shift a row
  constexpr int NDB = HDP / 8;  // n8 blocks of the output row
  constexpr int NKB = BKV / 8;  // n8 blocks of the score row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcBQ][LD]
  bf16* ks = qs + kTcBQ * LD;                     // [kStages][BKV][LD]
  bf16* vs = ks + kStages * BKV * LD;             // [kStages][BKV][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;
  const int64_t q_stride = (int64_t)H * hd;
  const int64_t k_stride = (int64_t)Hkv * hd;
  const bf16* qb = q + ((int64_t)b * S * H + h) * hd;
  const bf16* kb = k + ((int64_t)b * Tk * Hkv + hk) * hd;
  const bf16* vb = v + ((int64_t)b * Tk * Hkv + hk) * hd;

  // the kv tiles [j_lo, j_hi) not wholly above the diagonal or wholly
  // outside the window for the block's rows
  const int q_last = min(q0 + kTcBQ, S) - 1;
  int j_hi = (Tk + BKV - 1) / BKV;
  if (causal) j_hi = min(j_hi, q_last / BKV + 1);
  int j_lo = 0;
  if (window > 0) {
    const int first = q0 - window - BKV + 2;  // tile j is in iff j*BKV >= it
    if (first > 0) j_lo = (first + BKV - 1) / BKV;
  }
  // the same for this warp's rows: a tile it skips is masked in all of
  // them (exact, as for the block)
  const int wq0 = q0 + 16 * warp;
  const int wq_last = min(wq0 + 16, S) - 1;

  // copy groups: Q with tile j_lo, then one a tile (empty past j_hi)
  auto load_kv = [&](int j, int stage) {
    if (j < j_hi) {
      load_rows_async<BKV, HDP, LD>(ks + stage * BKV * LD, kb, k_stride,
                                    j * BKV, Tk, hd);
      load_rows_async<BKV, HDP, LD>(vs + stage * BKV * LD, vb, k_stride,
                                    j * BKV, Tk, hd);
    }
    cp_async_commit();
  };
  load_rows_async<kTcBQ, HDP, LD>(qs, qb, q_stride, q0, S, hd);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_kv(j_lo + i, i);

  float acc[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // scores are kept times log2(e), so p = 2^(y - m).  Per thread: rows
  // q_row ([0]) and q_row + 8 ([1]); m is the row's max of y, l this
  // thread's part of the row sum (summed over the row's 4 lanes at the end)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  const int q_row = wq0 + g;
  const float scale2 = scale * kLog2e;
  // ldmatrix row addresses: lane l supplies row l % 8 of matrix l / 8
  const int lrow = lane & 7, lm = lane >> 3;
  const bf16* q_frag =
      qs + (16 * warp + lrow + 8 * (lm & 1)) * LD + 8 * (lm >> 1);

  for (int j = j_lo, st = 0; j < j_hi;
       ++j, st = st + 1 < kStages ? st + 1 : 0) {
    cp_async_wait<kStages - 2>();  // tile j has landed (stage st)
    // tile j is visible to every warp, and every warp is done with tile
    // j-1, whose stage now takes tile j+kStages-1: that load overlaps the
    // math of tiles j .. j+kStages-2
    __syncthreads();
    load_kv(j + kStages - 1, st > 0 ? st - 1 : kStages - 1);
    const int k0 = j * BKV;
    if (wq0 >= S || (causal && k0 > wq_last) ||
        (window > 0 && wq0 - (k0 + BKV - 1) >= window))
      continue;
    const bf16* kt = ks + st * BKV * LD;
    const bf16* vt = vs + st * BKV * LD;

    // S = Q K^T on the tensor cores (exact products, fp32 sums)
    float s[NKB][4];
#pragma unroll
    for (int n = 0; n < NKB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < HDP / 16; ++kc) {
      if (16 * kc >= hd) break;  // zero columns of the padding
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(q_frag + 16 * kc));
#pragma unroll
      for (int nb = 0; nb < NKB; nb += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(kt + (8 * nb + lrow + 8 * (lm >> 1)) * LD +
                                 16 * kc + 8 * (lm & 1)));
        mma_bf16(s[nb], a, bk[0], bk[1]);
        mma_bf16(s[nb + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, then the mask (the reference's order); element e of
    // s[nb] is row q_row + 8 (e / 2), key k0 + 8 nb + 2 t + e % 2
    const bool edge = (causal && k0 + BKV - 1 > wq0) ||
                      (window > 0 && wq_last - k0 >= window) || k0 + BKV > Tk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float y;
        if (cap != 0.0f)
          y = cap * tanhf(s[nb][e] * scale / cap) * kLog2e;
        else
          y = s[nb][e] * scale2;
        if (edge) {
          const int qi = q_row + 8 * (e >> 1);
          const int ki = k0 + 8 * nb + 2 * t + (e & 1);
          bool keep = true;
          if (causal) keep = keep && qi >= ki;
          if (window > 0) keep = keep && (qi - ki) < window;
          y = keep ? y : kNegInf;
          if (ki >= Tk) y = -INFINITY;  // no such key: weight exactly 0
        }
        s[nb][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }

    // online softmax in fp32: the 4 lanes of a row group share its max
    float alpha[2];
    bool moved = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = mx[r];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m_r[r], x);
      const bool up = m_new != m_r[r];
      alpha[r] = up ? fast_exp2(m_r[r] - m_new) : 1.0f;
      moved = moved || up;
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[nb][e] - m_r[e >> 1]);
        s[nb][e] = p;
        l_r[e >> 1] += p;
      }
    if (__any_sync(0xffffffffu, moved)) {  // alpha is 1 where no max moved
#pragma unroll
      for (int n = 0; n < NDB; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    // O += hi . V + lo . V: blocks 2kc and 2kc+1 of S are the A operand of
    // key chunk kc; V (keys x hd) is read transposed by ldmatrix
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_bf16(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int nd = 0; nd < NDB; nd += 2) {
        if (8 * nd >= hd) break;  // zero columns of the padding
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vt + (16 * kc + lrow + 8 * (lm & 1)) *
                                               LD + 8 * nd + 8 * (lm >> 1)));
        mma_bf16(acc[nd], ph, bv[0], bv[1]);
        mma_bf16(acc[nd + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[nd], pl, bv[0], bv[1]);
        mma_bf16(acc[nd + 1], pl, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q_row + 8 * r;
    if (qi >= S) continue;
    const float denom = fmaxf(l, 1e-30f);
    bf16* orow = out + ((int64_t)b * S + qi) * q_stride + (int64_t)h * hd;
#pragma unroll
    for (int n = 0; n < NDB; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

template <int HDP, int BKV, int MINB>
cudaError_t launch_tc(int B, int S, int Tk, int H, int Hkv, int hd,
                      int causal, int window, float cap, float scale,
                      const void* q, const void* k, const void* v, void* out,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (size_t)(kTcBQ + 2 * kStages * BKV) * (HDP + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HDP, BKV, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kTcBQ - 1) / kTcBQ);
  flash_fwd_tc<HDP, BKV, MINB><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Tk, H, Hkv, hd,
      causal, window, cap, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the tensor-core
// kernel); q, k, v and out share it.  q, k, v and out are contiguous
// (B, S, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd), (B, S, H, hd); for
// bfloat16 each starts on a 16-byte boundary.  window 0 means no window.
// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// caller checks shapes.
extern "C" int flash_attention_fwd(int dtype, int B, int S, int Tk, int H,
                                   int Hkv, int hd, int causal, int window,
                                   float softcap, float scale, const void* q,
                                   const void* k, const void* v, void* out,
                                   void* stream) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS B, S, Tk, H, Hkv, hd, causal, window, softcap, scale, q, k, \
                v, out, st
  if (dtype == 1) {
    // (HDP, BKV, MINB): four blocks an SM up to hd 128 (128 registers a
    // thread, 52 KB of shared memory at hd 128), three at hd 256 (16-key
    // tiles, 68 KB): the fastest of the tile sizes timed on the H100 by
    // tools/attention_tiles.py
    if (hd <= 16) return (int)launch_tc<16, 64, 4>(FA_ARGS);
    if (hd <= 32) return (int)launch_tc<32, 64, 4>(FA_ARGS);
    if (hd <= 64) return (int)launch_tc<64, 64, 4>(FA_ARGS);
    if (hd <= 128) return (int)launch_tc<128, 32, 4>(FA_ARGS);
    return (int)launch_tc<256, 16, 3>(FA_ARGS);
  }
  if (hd <= 16) return (int)launch_simt<1>(FA_ARGS);
  if (hd <= 32) return (int)launch_simt<2>(FA_ARGS);
  if (hd <= 64) return (int)launch_simt<4>(FA_ARGS);
  if (hd <= 128) return (int)launch_simt<8>(FA_ARGS);
  return (int)launch_simt<16>(FA_ARGS);
#undef FA_ARGS
}
