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
// with zeros in shared memory to HDP (fp32: 16, 32, 64, 128 or 256; bf16:
// 64, 128 or 256).
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
// bf16, flash_fwd_wgmma (the served path: models serve in bf16), the
// Hopper form: warp-specialized, TMA loads and asynchronous warpgroup
// products.  A persistent grid of one block an SM walks the items (b, h,
// 128 query rows), heaviest first.  A block is three warpgroups: one
// producer thread keeps TMA loads in flight (each item's Q, then the K and
// V tiles of BKV keys into a ring of STAGES slots, each slot with a full
// and an empty mbarrier for K and for V, so that S = Q K^T can start
// before V lands; the ring runs on across items, so the next item's first
// tiles load while the last one finishes), and two consumer warpgroups
// each own 64 rows, the M of wgmma.m64nNk16.  setmaxnreg hands the
// producer's registers to the consumers (24 and 240 a thread).  The TMA reads q (B, S, H, hd) and
// k / v (B, T, Hkv, hd) through 4-D tensor maps over the tensors as they
// lie, in boxes of 64 columns (128 bytes) under the 128-byte swizzle, so a
// row of HDP = 64, 128 or 256 columns is HDP / 64 column blocks in shared
// memory; columns past hd and rows past S or T arrive as zeros.
//   * S = Q K^T: wgmma with both operands in shared memory (K-major,
//     descriptors with the TMA's swizzle), N = BKV.  bf16 products are
//     exact in fp32.  Scale, softcap, mask (only on tiles that cross the
//     diagonal, the window's edge or T), the row max, p = exp(s - m_new)
//     (ex2 of scores kept times log2 e) and l run in fp32 registers on
//     the accumulator fragment (4 lanes share a row); l is summed from the
//     fp32 p.
//   * O += P V as two bf16 products, hi . V + lo . V with hi = bf16(p) and
//     lo = bf16(p - hi), summed in fp32: p keeps 16 significant bits, where
//     a single rounding of p to bf16 would move the output by several bf16
//     places.  The split costs 1.5x the useful tensor work.  The S
//     accumulator fragment is already the register A operand's layout, so
//     P never touches shared memory; V is the B operand in its stored
//     (T, hd) layout through the descriptor's transpose bit, one
//     m64n64k16 product a 64-column block.
//   * Overlap inside a consumer: tile j's S = Q K^T and tile j-1's P V are
//     in flight together, and tile j's softmax runs under tile j-1's P V;
//     O's rescale waits for that product.
// The tile plan (HDP, BKV, STAGES, shared bytes) comes from the caller
// (kernels/flash_attention.py::tile_plan); FA_WGMMA_TEMPLATES lists the
// plans built.

// fp32, flash_fwd_simt: every product and sum on the fp32 FMA units (no
// tensor-core instruction, no TF32), which bound it: 67 TFLOP/s, 1.54 ms
// at the shape above.  No served path runs attention in fp32; it is the
// float32 reference on the card.  One block a (b * h, query tile of BQ
// rows), the heaviest query tiles first.  K and V tiles of BK keys arrive
// by 16-byte cp.async into separate rings of STAGES slots, so tile t+1's
// loads run under tile t's products, with two barriers a tile.  Both
// products are register tiles fed by float4 shared loads: a thread owns 8
// rows x 8 columns of O (256 FMAs per 16 loads of p and V) and 8 rows x
// TNS keys of S, the head dim split over DS lanes where that keeps TNS at
// 8 (256 FMAs per 16 loads of Q and K) and the split sums joined by a
// recursive halving of shuffles.  The online softmax stays in the
// registers of the lanes that computed the scores (row max and sum by
// shuffles; ex2 of scores kept times log2 e, the mask applied after the
// scaling so that the NEG_INF fill stays finite); p goes to shared memory
// once, as the operand of P V.  Q and K rows are swizzled (float4 column c
// of row r at c ^ (r & 7)) so that no load of either product conflicts in
// the banks.  The tile plan (HDP, BQ, BK, STAGES, shared bytes) comes from
// the caller (kernels/flash_attention.py::simt_plan); FA_SIMT_TEMPLATES
// lists the plans built.
//
// Both entries skip kv tiles wholly above the causal diagonal or wholly
// outside the window: such a tile leaves m, l and acc unchanged in the
// reference (its exp(NEG_INF - NEG_INF) = 1 weights are wiped by alpha = 0 at
// the row's first real score), so skipping is exact.  Keys past T get -inf,
// i.e. no weight at all, and ragged rows are masked in the kernel.  No
// atomics and no split over kv: two runs are bitwise equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;

// ---------------------------------------------------------------------------
// bf16 entry: the warp-specialized wgmma / TMA kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kConsumers = 2;             // consumer warpgroups a block
constexpr int kTcBQ = 64 * kConsumers;    // query rows a block, 64 a consumer
constexpr int kTcThreads = kWg * (kConsumers + 1);  // + the producer
constexpr int kAtom = 64;                 // bf16 columns of one 128-byte row
constexpr int kProducerRegs = 24;         // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;        //   <= the SM's 65,536 registers
constexpr float kLog2e = 1.4426950408889634f;
// tries of a barrier wait before the kernel traps (each try may suspend
// the thread for a while): seconds, where any wait of a working launch
// lasts microseconds
constexpr int kWaitTries = 1 << 24;

// The shared memory of one block, from a base aligned to 1024 bytes (the
// 128-byte swizzle repeats every 8 rows of 128 bytes): Q, the K ring, the
// V ring, then the barriers.  A tile of R rows x HDP columns is stored as
// HDP / 64 column blocks of R rows x 128 bytes, each as TMA's 128-byte
// swizzle writes it.  kernels/flash_attention.py::tile_plan computes the
// same bytes; the entry refuses a plan that disagrees.
template <int HDP, int BKV, int STAGES>
struct TcLayout {
  static constexpr int kQBytes = kTcBQ * HDP * 2;
  static constexpr int kTileBytes = BKV * HDP * 2;  // one K or one V tile
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + STAGES * kTileBytes;
  static constexpr int kBar = kV + STAGES * kTileBytes;
  // q_full, q_empty, then k_full, k_empty, v_full, v_empty for each stage
  static constexpr int kBars = 2 + 4 * STAGES;
  static constexpr int kSmem = 1024 + kBar + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of TMA writes before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed.  The loop is
// PTX alone (a loop in C++ around try_wait, with a clock, costs the
// consumers registers and serializes their wgmma); after kWaitTries
// unsuccessful tries, a phase or byte count that never completes, it traps
// rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.ge.u32 p, n, %2;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity), "n"(kWaitTries)
      : "memory");
}

// TMA: the box at (c0, c1, c2, c3) of a 4-D tensor map -> shared memory,
// completing `bar`'s expected bytes; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading byte offset (between 64-column blocks; read only for an
// MN-major operand wider than 64), stride byte offset 1024 (between groups
// of 8 rows of 128 bytes), swizzle mode 1 (128 bytes)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the last committed group
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// registers an asynchronous wgmma writes or reads: no access to them may
// move across this point (the compiler sees the asm as done at issue)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (+)= A B, A (64 x 16) and B (16 x 64) both from shared memory,
// K-major, 128-byte swizzle; d is zeroed first when !accumulate
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with B 16 x 128
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  wgmma_ss_n64(d, a, b, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  wgmma_ss_n128(d, a, b, accumulate);
}

// d += A B, A (64 x 16) from registers in the accumulator's layout, B
// (16 x 64) from shared memory, MN-major (the transpose bit), 128-byte
// swizzle
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
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

// The work: items (b, h, query tile of kTcBQ rows), heaviest first (the
// last query tiles have the most kv tiles under a causal mask), each block
// walking its share in place of a grid of one block an item.
struct Work {
  int S, Tk, H, Hkv, causal, window, n_items, n_qt;
};

struct Item {
  int b, h, q0;
};

// item i of the heaviest-first order: query tiles from the last, then the
// (b, h) pairs
__device__ __forceinline__ Item item_at(const Work& w, int i) {
  const int bh = i % (w.n_items / w.n_qt);
  const int qt = w.n_qt - 1 - i / (w.n_items / w.n_qt);
  return {bh / w.H, bh % w.H, qt * kTcBQ};
}

// block k's r-th item: rounds of gridDim.x items, dealt in a snake (block
// k takes k in even rounds, gridDim.x - 1 - k in odd ones) so that the
// heavy first rounds even out; -1 past the end
__device__ __forceinline__ int item_of(int k, int r, int n_items) {
  const int g = gridDim.x;
  const int i = r * g + ((r & 1) ? g - 1 - k : k);
  return i < n_items ? i : -1;
}

// the kv tiles [j_lo, j_hi) not wholly above the diagonal or wholly
// outside the window for rows [r0, r_last]
__device__ __forceinline__ void tile_range(const Work& w, int BKV, int r0,
                                           int r_last, int& j_lo,
                                           int& j_hi) {
  j_hi = (w.Tk + BKV - 1) / BKV;
  if (w.causal) j_hi = min(j_hi, r_last / BKV + 1);
  j_lo = 0;
  if (w.window > 0) {
    const int first = r0 - w.window - BKV + 2;  // tile j is in iff j*BKV >= it
    if (first > 0) j_lo = (first + BKV - 1) / BKV;
  }
  j_lo = min(j_lo, j_hi);
}

// A persistent grid of at most one block an SM.  Warpgroups 0 ..
// kConsumers-1 each own 64 query rows of the block's item (warp w of a
// warpgroup rows 16w .. 16w+15, the wgmma's M); warpgroup kConsumers is the
// producer, of which one thread issues every TMA load.  The ring runs on
// across items, so the next item's Q and first tiles load while the
// consumers finish the last one.
template <int HDP, int BKV, int STAGES>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    bf16* __restrict__ out, const Work w, int hd, float cap,
                    float scale) {
  using L = TcLayout<HDP, BKV, STAGES>;
  constexpr int NCB = HDP / kAtom;  // 64-column blocks of a row
  constexpr int NKC = BKV / 16;     // k16 chunks of a kv tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (2 + STAGES + s); };
  auto v_full = [&](int s) { return q_full + 8u * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (2 + 3 * STAGES + s); };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers * kWg);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kConsumers * kWg);
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kConsumers * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWg;
  if (wg == kConsumers) {
    // ---- producer: per item Q, then K and V of each tile into the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % kWg == 0) {
      int it = 0;  // tiles through the ring so far
      for (int r = 0, i; (i = item_of(blockIdx.x, r, w.n_items)) >= 0; ++r) {
        const Item m = item_at(w, i);
        const int hk = m.h / (w.H / w.Hkv);
        int j_lo, j_hi;
        tile_range(w, BKV, m.q0, min(m.q0 + kTcBQ, w.S) - 1, j_lo, j_hi);
        // Q once the consumers are done with the last item's
        auto load_q = [&] {
          if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
          mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
          for (int c = 0; c < NCB; ++c)
            tma_load(q_s + c * kTcBQ * 128, &tm_q, q_full, c * kAtom, m.h,
                     m.q0, m.b);
        };
        if (j_lo == j_hi) load_q();
        for (int j = j_lo; j < j_hi; ++j, ++it) {
          const int st = it % STAGES;
          const uint32_t par = ((it / STAGES) & 1) ^ 1;  // the round before
          mbar_wait(k_empty(st), par);
          mbar_expect_tx(k_full(st), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < NCB; ++c)
            tma_load(k_s + st * L::kTileBytes + c * BKV * 128, &tm_k,
                     k_full(st), c * kAtom, hk, j * BKV, m.b);
          // the item's first K tile loads while the last item finishes
          if (j == j_lo) load_q();
          mbar_wait(v_empty(st), par);
          mbar_expect_tx(v_full(st), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < NCB; ++c)
            tma_load(v_s + st * L::kTileBytes + c * BKV * 128, &tm_v,
                     v_full(st), c * kAtom, hk, j * BKV, m.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int ctid = threadIdx.x % kWg;
    const int warp = ctid / 32, lane = ctid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
    const float scale2 = scale * kLog2e;
    const uint32_t q_wg = q_s + wg * 64 * 128;  // its rows of each block

    // O: column block c, n8 block nb, element e at row q_row + 8 (e / 2),
    // column 64 c + 8 nb + 2 t + e % 2 (wgmma's accumulator layout)
    float o[NCB][32];
    // scores are kept times log2(e), so p = 2^(y - m); m is the row's max
    // of y, l this thread's part of the row sum (summed over the row's 4
    // lanes at the end)
    float m_r[2], l_r[2];
    // S = Q K^T of a tile: s[4 nb + e] is row q_row + 8 (e / 2), key 8 nb +
    // 2 t + e % 2 of the tile; then p in place
    float s[BKV / 2];
    // P as the A operand of key chunk kc, p = hi + lo
    uint32_t p_hi[NKC][4], p_lo[NKC][4];
    float alpha[2];
    bool rescale = false;

    int it0 = 0;  // the ring position of the item's first tile
    for (int r = 0, i; (i = item_of(blockIdx.x, r, w.n_items)) >= 0; ++r) {
      const Item m = item_at(w, i);
      const int wq0 = m.q0 + 64 * wg;  // the warpgroup's first row
      const int wq_last = min(wq0 + 64, w.S) - 1;
      const int q_row = wq0 + 16 * warp + g;  // rows q_row and q_row + 8
      int j_lo, j_hi;
      tile_range(w, BKV, m.q0, min(m.q0 + kTcBQ, w.S) - 1, j_lo, j_hi);
      // the ring slot and parity of tile j
      auto slot = [&](int j) { return (it0 + j - j_lo) % STAGES; };
      auto parity = [&](int j) {
        return (uint32_t)(((it0 + j - j_lo) / STAGES) & 1);
      };
      // a tile this warpgroup does not compute still takes part in the ring
      auto pass = [&](int j) {
        mbar_wait(k_full(slot(j)), parity(j));
        mbar_arrive(k_empty(slot(j)));
        mbar_wait(v_full(slot(j)), parity(j));
        mbar_arrive(v_empty(slot(j)));
      };
      // S = Q K^T of tile j on the tensor cores (exact products, fp32
      // sums), issued, not waited for
      auto issue_s = [&](int j) {
        const uint32_t kt = k_s + slot(j) * L::kTileBytes;
        mbar_wait(k_full(slot(j)), parity(j));
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < NCB; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<BKV>(s,
                          sw128_desc(q_wg + c * kTcBQ * 128 + kk * 32, 16),
                          sw128_desc(kt + c * BKV * 128 + kk * 32, 16),
                          (c | kk) != 0);
        wgmma_commit();
      };
      // O += hi . V + lo . V of tile j, issued: V (keys x hd) is read in
      // its stored layout through the descriptor's transpose bit
      auto issue_pv = [&](int j) {
        const uint32_t vt = v_s + slot(j) * L::kTileBytes;
        mbar_wait(v_full(slot(j)), parity(j));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < NKC; ++kc)
#pragma unroll
          for (int c = 0; c < NCB; ++c) {
            const uint64_t dv =
                sw128_desc(vt + c * BKV * 128 + kc * 16 * 128, BKV * 128);
            wgmma_rs_n64(o[c], p_hi[kc], dv);
            wgmma_rs_n64(o[c], p_lo[kc], dv);
          }
        wgmma_commit();
      };
      auto pv_done = [&] {
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NCB; ++c) fence_regs(o[c]);
        fence_regs(p_hi);
        fence_regs(p_lo);
      };
      // the online softmax of tile j on s, in fp32: scale, softcap, then
      // the mask (the reference's order; the mask only on tiles that cross
      // the diagonal, the window's edge or T), the row max over the row's
      // 4 lanes, p = 2^(y - m) in s, l; O's rescale is left in alpha (O
      // may be in flight)
      auto softmax = [&](int j) {
        const int k0 = j * BKV;
        const bool edge = (w.causal && k0 + BKV - 1 > wq0) ||
                          (w.window > 0 && wq_last - k0 >= w.window) ||
                          k0 + BKV > w.Tk;
        float mx[2] = {-INFINITY, -INFINITY};
        if (cap == 0.0f && !edge) {
#pragma unroll
          for (int x = 0; x < BKV / 2; ++x) {
            s[x] *= scale2;
            mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
          }
        } else {
#pragma unroll
          for (int x = 0; x < BKV / 2; ++x) {
            float y;
            if (cap != 0.0f)
              y = cap * tanhf(s[x] * scale / cap) * kLog2e;
            else
              y = s[x] * scale2;
            if (edge) {
              const int qi = q_row + 8 * ((x >> 1) & 1);
              const int ki = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
              bool keep = true;
              if (w.causal) keep = keep && qi >= ki;
              if (w.window > 0) keep = keep && (qi - ki) < w.window;
              y = keep ? y : kNegInf;
              if (ki >= w.Tk) y = -INFINITY;  // no such key: weight 0
            }
            s[x] = y;
            mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], y);
          }
        }
        bool moved = false;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float x = mx[q];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float m_new = fmaxf(m_r[q], x);
          const bool up = m_new != m_r[q];
          alpha[q] = up ? fast_exp2(m_r[q] - m_new) : 1.0f;
          moved = moved || up;
          m_r[q] = m_new;
          l_r[q] *= alpha[q];
        }
#pragma unroll
        for (int x = 0; x < BKV / 2; ++x) {
          const float p = fast_exp2(s[x] - m_r[(x >> 1) & 1]);
          s[x] = p;
          l_r[(x >> 1) & 1] += p;
        }
        rescale = __any_sync(0xffffffffu, moved);  // alpha is 1 elsewhere
      };
      auto rescale_o = [&] {
        if (rescale) {
#pragma unroll
          for (int c = 0; c < NCB; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];
        }
      };
      // n8 blocks 2 kc and 2 kc + 1 of S are already in the A fragment's
      // layout for key chunk kc
      auto split_p = [&] {
#pragma unroll
        for (int kc = 0; kc < NKC; ++kc)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_bf16(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1], p_hi[kc][e],
                       p_lo[kc][e]);
      };

#pragma unroll
      for (int c = 0; c < NCB; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;
      m_r[0] = m_r[1] = kNegInf;
      l_r[0] = l_r[1] = 0.0f;
      // this warpgroup's tiles [a, z): those not wholly masked for its
      // rows (a tile wholly masked changes nothing in them: exact, as for
      // the block)
      int a = j_hi, z = j_hi;
      if (wq0 < w.S) tile_range(w, BKV, wq0, wq_last, a, z);
      a = max(a, j_lo);
      z = max(min(z, j_hi), a);
      mbar_wait(q_full, r & 1);
      for (int j = j_lo; j < a; ++j) pass(j);
      if (a < z) {
        issue_s(a);
        wgmma_wait_all();
        fence_regs(s);
        mbar_arrive(k_empty(slot(a)));
        softmax(a);
        split_p();
        // tile j's S = Q K^T and tile j-1's P V in flight together, and
        // the softmax of tile j under tile j-1's P V
        for (int j = a + 1; j < z; ++j) {
          issue_s(j);
          rescale_o();
          issue_pv(j - 1);
          wgmma_wait_one();
          fence_regs(s);
          mbar_arrive(k_empty(slot(j)));
          softmax(j);
          pv_done();
          mbar_arrive(v_empty(slot(j - 1)));
          split_p();
        }
        rescale_o();
        issue_pv(z - 1);
        pv_done();
        mbar_arrive(v_empty(slot(z - 1)));
      }
      for (int j = z; j < j_hi; ++j) pass(j);
      mbar_arrive(q_empty);  // the producer may load the next Q
      it0 += j_hi - j_lo;

      // out = O / max(l, 1e-30), rounded once, rows < S, columns < hd
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float l = l_r[q];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int qi = q_row + 8 * q;
        if (qi >= w.S) continue;
        const float denom = fmaxf(l, 1e-30f);
        bf16* orow = out + (((int64_t)m.b * w.S + qi) * w.H + m.h) * hd;
#pragma unroll
        for (int c = 0; c < NCB; ++c)
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int d = c * kAtom + 8 * nb + 2 * t;
            if (d < hd)
              *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                  __floats2bfloat162_rn(o[c][4 * nb + 2 * q] / denom,
                                        o[c][4 * nb + 2 * q + 1] / denom);
          }
      }
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no -lcuda; null when the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, len, heads, hd) bf16 tensor as a 4-D map (innermost first) read in
// boxes of 64 columns x 1 head x `rows` positions, 128-byte swizzled; the
// maps are encoded on the host at every launch (a few hundred ns each)
bool encode_map(CUtensorMap* map, const void* ptr, int B, int len, int heads,
                int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)len * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int BKV, int STAGES>
cudaError_t launch_wgmma(int B, int S, int Tk, int H, int Hkv, int hd,
                         int causal, int window, float cap, float scale,
                         const void* q, const void* k, const void* v,
                         void* out, cudaStream_t stream) {
  using L = TcLayout<HDP, BKV, STAGES>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map(&tm_q, q, B, S, H, hd, kTcBQ) ||
      !encode_map(&tm_k, k, B, Tk, Hkv, hd, BKV) ||
      !encode_map(&tm_v, v, B, Tk, Hkv, hd, BKV))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HDP, BKV, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const long long items = (long long)B * H * n_qt;
  if (items > 0x7fffffff) return cudaErrorInvalidValue;
  const Work w{S, Tk, H, Hkv, causal, window, (int)items, n_qt};
  const int grid = (int)(items < sms ? items : sms);
  flash_fwd_wgmma<HDP, BKV, STAGES><<<grid, kTcThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(out), w, hd, cap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 entry: the SIMT kernel (no tensor-core instruction below this line
// up to "end of the fp32 entry")
// ---------------------------------------------------------------------------

// The tiling of one FA_SIMT_TEMPLATES entry (HDP, BQ, BK, STAGES).  A
// thread owns 8 query rows, rg + R i (R = BQ / 8 row groups), and 8
// columns of O, the float4 column blocks cg and cg + G (G = HDP / 8 lanes
// a row group, contiguous in a warp).  For S = Q K^T the G lanes of a row
// group are KL key lanes x DS slices of the head dim: lane (dq, kl) sums
// the keys kl + KL jn (jn < TNS) over its slice of HDP / DS columns, and a
// recursive halving over the DS slices leaves it TNO = TNS / DS whole
// scores a row, keys kl + KL (dq TNO + u).  Both products then load
// float4 operands from shared memory: 8 of Q and TNS of K for 32 TNS
// FMAs, 8 of p and 8 of V for 256 FMAs.
__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <int HDP, int BQ, int BK, int STAGES>
struct SimtTile {
  static constexpr int G = HDP / 8;
  static constexpr int R = BQ / 8;
  static constexpr int kThreads = R * G;
  static constexpr int DS = G > 8 ? G / 8 : 1;
  static constexpr int KL = G / DS;
  static constexpr int TNS = BK / KL;
  static constexpr int TNO = TNS / DS;
  static constexpr int NC = HDP / 4;        // float4 columns of a row
  static constexpr int NCH = NC / DS;       // float4 columns of a d slice
  static constexpr int LDP = BK + 4;        // row stride of p (floats)
  // shared memory, in floats: Q, the K ring, the V ring, p.  Q and K rows
  // keep float4 column c at c ^ (row & 7); V and p are plain row-major.
  // kernels/flash_attention.py::simt_plan computes the same bytes; the
  // entry refuses a plan that disagrees.
  static constexpr int kK = BQ * HDP;
  static constexpr int kV = kK + STAGES * BK * HDP;
  static constexpr int kP = kV + STAGES * BK * HDP;
  static constexpr int kSmem = 4 * (kP + BQ * LDP);
  static_assert(HDP % 32 == 0 && HDP <= 256 && 32 % G == 0, "head dim");
  // R a multiple of 8: a thread's rows share row & 7, its Q swizzle
  static_assert(BQ % 64 == 0 && kThreads % 32 == 0 && kThreads <= 1024,
                "threads");
  static_assert(BK % (4 * KL) == 0 && TNS % DS == 0 && NCH >= 8 &&
                    (NCH & (NCH - 1)) == 0 && DS <= 8,
                "tiles");
  static_assert(STAGES >= 2 && kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (len, heads, hd) sequence -> ROWS rows of
// HDP floats at dst through 16-byte asynchronous copies, float4 column c
// of row r at c ^ (r & 7) when SWZ; rows past len and columns past hd
// arrive as zeros
template <int ROWS, int HDP, int THREADS, bool SWZ>
__device__ __forceinline__ void copy_rows(uint32_t dst,
                                          const float* __restrict__ src,
                                          int64_t stride, int row0, int len,
                                          int hd) {
  constexpr int NC = HDP / 4;
  static_assert(ROWS * NC % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int e = 0; e < ROWS * NC / THREADS; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int r = i / NC, c = i % NC;
    const bool ok = row0 + r < len && 4 * c < hd;
    const int slot = r * NC + (SWZ ? c ^ (r & 7) : c);
    cp_async16(dst + 16 * slot, ok ? src + (row0 + r) * stride + 4 * c : src,
               ok);
  }
}

// One block a (b * h, query tile of BQ rows), the heaviest tiles first
// (blockIdx.y 0 takes the last query tile, which has the most kv tiles
// under a causal mask).  K and V of each kv tile arrive through a ring of
// STAGES slots each, fed by cp.async: tile t + STAGES - 1's V is issued
// at barrier A of tile t, once every warp is done with tile t - 1's
// P V, and tile t + STAGES's K at barrier B, once every warp is done with
// tile t's Q K^T, so both load under the products of the tiles between.
// Two barriers a tile: A (K of tile t landed, p and the old V slot free)
// and B (p written, V of tile t landed, the old K slot free).
template <int HDP, int BQ, int BK, int STAGES>
__global__ void __launch_bounds__(SimtTile<HDP, BQ, BK, STAGES>::kThreads, 1)
    flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   const Work w, int hd, float cap, float scale) {
  using L = SimtTile<HDP, BQ, BK, STAGES>;
  constexpr int G = L::G, R = L::R, KL = L::KL, DS = L::DS;
  constexpr int TNS = L::TNS, TNO = L::TNO, NC = L::NC, NCH = L::NCH;
  constexpr int LDP = L::LDP;
  constexpr int LOG_G = ilog2(G), LOG_DS = ilog2(DS);
  extern __shared__ __align__(16) float smem[];
  const float4* qs4 = reinterpret_cast<const float4*>(smem);
  float* ps = smem + L::kP;
  const uint32_t s_base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int cg = tid % G, rg = tid / G;
  const int kl = cg % KL, dq = cg / KL;
  const int q0 = (w.n_qt - 1 - (int)blockIdx.y) * BQ;
  const int b = blockIdx.x / w.H, h = blockIdx.x % w.H;
  const int hk = h / (w.H / w.Hkv);
  const int64_t q_stride = (int64_t)w.H * hd;
  const int64_t k_stride = (int64_t)w.Hkv * hd;
  const float* kb = k + ((int64_t)b * w.Tk * w.Hkv + hk) * hd;
  const float* vb = v + ((int64_t)b * w.Tk * w.Hkv + hk) * hd;
  const int q_last = min(q0 + BQ, w.S) - 1;
  int j_lo, j_hi;
  tile_range(w, BK, q0, q_last, j_lo, j_hi);
  const int n = j_hi - j_lo;

  // the ring: every call commits one group, empty past the last tile, so
  // that the groups run K_0 V_0 K_1 V_1 ... and each wait below leaves
  // exactly the 2 STAGES - 2 younger groups in flight
  auto load_k = [&](int t) {
    if (t < n)
      copy_rows<BK, HDP, L::kThreads, true>(
          s_base + 4 * (L::kK + (t % STAGES) * BK * HDP), kb, k_stride,
          (j_lo + t) * BK, w.Tk, hd);
    cp_async_commit();
  };
  auto load_v = [&](int t) {
    if (t < n)
      copy_rows<BK, HDP, L::kThreads, false>(
          s_base + 4 * (L::kV + (t % STAGES) * BK * HDP), vb, k_stride,
          (j_lo + t) * BK, w.Tk, hd);
    cp_async_commit();
  };
  copy_rows<BQ, HDP, L::kThreads, true>(
      s_base, q + ((int64_t)b * w.S * w.H + h) * hd, q_stride, q0, w.S, hd);
  load_k(0);  // one group with Q
  for (int t = 1; t < STAGES; ++t) {
    load_v(t - 1);
    load_k(t);
  }

  // O: acc[i][e] is row rg + R i, column 4 cg + e (e < 4) or 4 (cg + G) +
  // e - 4.  Scores are kept times log2(e): p = 2^(y - m), m the row's max
  // of y (the same in the row group's lanes), l this lane's part of the
  // row sum (summed over the row group's lanes at the end).
  float acc[8][8];
  float m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  }
  const float scale2 = scale * kLog2e;
  // this lane's d slice, walked from float4 column (8 / DS) dq on so that
  // the slices of one row fall in different banks; Q and K swizzled by row
  const int rot = dq * (8 / DS);
  const int xq = rg & 7;
  const float4* q_lane = qs4 + rg * NC + dq * NCH;

  for (int t = 0; t < n; ++t) {
    const int k0 = (j_lo + t) * BK;
    const int st = t % STAGES;
    cp_async_wait<2 * STAGES - 2>();
    __syncthreads();  // A
    load_v(t + STAGES - 1);

    // S = Q K^T: s[i][jn] is row rg + R i, key kl + KL jn, over this
    // lane's d slice
    const float4* k_lane = reinterpret_cast<const float4*>(
                               smem + L::kK + st * BK * HDP) +
                           kl * NC + dq * NCH;
    float s[8][TNS];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jn = 0; jn < TNS; ++jn) s[i][jn] = 0.0f;
#pragma unroll 2
    for (int u = 0; u < NCH; ++u) {
      const int c = (u + rot) & (NCH - 1);
      float4 kv[TNS];
#pragma unroll
      for (int jn = 0; jn < TNS; ++jn) {
        const int xk = KL % 8 == 0 ? kl & 7 : (kl + KL * jn) & 7;
        kv[jn] = k_lane[jn * KL * NC + (c ^ xk)];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = q_lane[i * R * NC + (c ^ xq)];
#pragma unroll
        for (int jn = 0; jn < TNS; ++jn) {
          s[i][jn] = fmaf(qv.x, kv[jn].x, s[i][jn]);
          s[i][jn] = fmaf(qv.y, kv[jn].y, s[i][jn]);
          s[i][jn] = fmaf(qv.z, kv[jn].z, s[i][jn]);
          s[i][jn] = fmaf(qv.w, kv[jn].w, s[i][jn]);
        }
      }
    }
    // recursive halving over the d slices: at each level the lanes whose
    // dq has the level's bit keep the upper half of their keys and send
    // the lower half; the kept sums move to the front of s
#pragma unroll
    for (int lvl = 0; lvl < LOG_DS; ++lvl) {
      const int bit = DS >> (lvl + 1), half = TNS >> (lvl + 1);
      const bool up = (dq & bit) != 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int x = 0; x < half; ++x) {
          const float send = up ? s[i][x] : s[i][x + half];
          const float keep = up ? s[i][x + half] : s[i][x];
          s[i][x] = keep + __shfl_xor_sync(0xffffffffu, send, KL * bit);
        }
    }

    // the online softmax in fp32: scale, softcap, then the mask (the
    // reference's order; the mask only on tiles that cross the diagonal,
    // the window's edge or T), the row max over the row group's lanes,
    // p = 2^(y - m) written to shared memory once, l, and O rescaled
    const bool edge = (w.causal && k0 + BK - 1 > q0) ||
                      (w.window > 0 && q_last - k0 >= w.window) ||
                      k0 + BK > w.Tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qi = q0 + rg + R * i;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < TNO; ++u) {
        float y;
        if (cap != 0.0f)
          y = cap * tanhf(s[i][u] * scale / cap) * kLog2e;
        else
          y = s[i][u] * scale2;
        if (edge) {
          const int ki = k0 + kl + KL * (dq * TNO + u);
          bool keep = true;
          if (w.causal) keep = keep && qi >= ki;
          if (w.window > 0) keep = keep && (qi - ki) < w.window;
          y = keep ? y : kNegInf;
          if (ki >= w.Tk) y = -INFINITY;  // no such key: weight 0
        }
        s[i][u] = y;
        mx = fmaxf(mx, y);
      }
#pragma unroll
      for (int o = 0; o < LOG_G; ++o)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1 << o));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = m_new != m_r[i] ? fast_exp2(m_r[i] - m_new) : 1.0f;
      m_r[i] = m_new;
      float sum = 0.0f;
      float* prow = ps + (rg + R * i) * LDP + kl + KL * dq * TNO;
#pragma unroll
      for (int u = 0; u < TNO; ++u) {
        const float p = fast_exp2(s[i][u] - m_new);
        prow[KL * u] = p;
        sum += p;
      }
      l_r[i] = l_r[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    cp_async_wait<2 * STAGES - 2>();
    __syncthreads();  // B
    load_k(t + STAGES);

    // O += P V, four keys a step: 8 float4 of p, 8 of V
    const float* p_lane = ps + rg * LDP;
    const float* v_lane = smem + L::kV + st * BK * HDP + 4 * cg;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_lane + i * R * LDP + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = v_lane + (kk + e) * HDP;
        const float4 v0 = *reinterpret_cast<const float4*>(vr);
        const float4 v1 = *reinterpret_cast<const float4*>(vr + 4 * G);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float p = e == 0 ? pv[i].x
                          : e == 1 ? pv[i].y
                          : e == 2 ? pv[i].z
                                   : pv[i].w;
          acc[i][0] = fmaf(p, v0.x, acc[i][0]);
          acc[i][1] = fmaf(p, v0.y, acc[i][1]);
          acc[i][2] = fmaf(p, v0.z, acc[i][2]);
          acc[i][3] = fmaf(p, v0.w, acc[i][3]);
          acc[i][4] = fmaf(p, v1.x, acc[i][4]);
          acc[i][5] = fmaf(p, v1.y, acc[i][5]);
          acc[i][6] = fmaf(p, v1.z, acc[i][6]);
          acc[i][7] = fmaf(p, v1.w, acc[i][7]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the last tile

  // out = O / max(l, 1e-30), rows < S, columns < hd
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int o = 0; o < LOG_G; ++o)
      l += __shfl_xor_sync(0xffffffffu, l, 1 << o);
    const int qi = q0 + rg + R * i;
    if (qi >= w.S) continue;
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + ((int64_t)b * w.S + qi) * q_stride + (int64_t)h * hd;
    if (4 * cg < hd)
      *reinterpret_cast<float4*>(orow + 4 * cg) =
          make_float4(acc[i][0] / denom, acc[i][1] / denom,
                      acc[i][2] / denom, acc[i][3] / denom);
    if (4 * (cg + G) < hd)
      *reinterpret_cast<float4*>(orow + 4 * (cg + G)) =
          make_float4(acc[i][4] / denom, acc[i][5] / denom,
                      acc[i][6] / denom, acc[i][7] / denom);
  }
}

template <int HDP, int BQ, int BK, int STAGES>
cudaError_t launch_simt(int B, int S, int Tk, int H, int Hkv, int hd,
                        int causal, int window, float cap, float scale,
                        const void* q, const void* k, const void* v,
                        void* out, cudaStream_t stream) {
  using L = SimtTile<HDP, BQ, BK, STAGES>;
  // the 16-byte copies and stores need 16-byte aligned rows: hd is a
  // multiple of 8, so the base pointers decide
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return cudaErrorInvalidValue;
  const int n_qt = (S + BQ - 1) / BQ;
  if (n_qt > 65535 || (long long)B * H > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<HDP, BQ, BK, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const Work w{S, Tk, H, Hkv, causal, window, 0, n_qt};
  // (batch, head) on x, where the limit is 2^31 - 1; query tiles on y
  const dim3 grid(B * H, n_qt);
  flash_fwd_simt<HDP, BQ, BK, STAGES><<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), w, hd, cap,
      scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// end of the fp32 entry
// ---------------------------------------------------------------------------

}  // namespace

// The bf16 templates built, as (HDP, BKV, STAGES): the plans that
// kernels/flash_attention.py::tile_plan may name.
#define FA_WGMMA_TEMPLATES(X) X(64, 128, 2) X(128, 128, 2) X(256, 64, 2)
// The fp32 templates built, as (HDP, BQ, BK, STAGES): the plans that
// kernels/flash_attention.py::simt_plan may name.
#define FA_SIMT_TEMPLATES(X) \
  X(32, 256, 32, 2) X(64, 256, 64, 2) X(128, 128, 64, 2) X(256, 64, 32, 2)

// dtype: 0 = float32 (the SIMT kernel), 1 = bfloat16 (the wgmma kernel);
// q, k, v and out share it.  q, k, v and out are contiguous (B, S, H,
// hd), (B, T, Hkv, hd), (B, T, Hkv, hd), (B, S, H, hd), each starting on a
// 16-byte boundary.  window 0 means no window.  (hdp, bq, bkv, stages,
// smem) is the tile plan of kernels/flash_attention.py::tile_plan for
// bfloat16 and ::simt_plan for float32: a built template with these
// parameters and these shared bytes, else cudaErrorInvalidValue.  Launches
// on `stream` and returns cudaGetLastError() (0 on success); the caller
// checks shapes.
extern "C" int flash_attention_fwd(int dtype, int B, int S, int Tk, int H,
                                   int Hkv, int hd, int causal, int window,
                                   float softcap, float scale, const void* q,
                                   const void* k, const void* v, void* out,
                                   void* stream, int hdp, int bq, int bkv,
                                   int stages, int smem) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS B, S, Tk, H, Hkv, hd, causal, window, softcap, scale, q, k, \
                v, out, st
  if (dtype == 1) {
#define FA_PLAN(HDP_, BKV_, ST_)                                           \
  if (hdp == HDP_ && bkv == BKV_ && stages == ST_)                         \
    return hd <= HDP_ && bq == kTcBQ &&                                      \
                   smem == TcLayout<HDP_, BKV_, ST_>::kSmem                \
               ? (int)launch_wgmma<HDP_, BKV_, ST_>(FA_ARGS)               \
               : (int)cudaErrorInvalidValue;
    FA_WGMMA_TEMPLATES(FA_PLAN)
#undef FA_PLAN
    return (int)cudaErrorInvalidValue;
  }
#define FA_SIMT_PLAN(HDP_, BQ_, BK_, ST_)                                  \
  if (hdp == HDP_ && bq == BQ_ && bkv == BK_ && stages == ST_)             \
    return hd <= HDP_ && smem == SimtTile<HDP_, BQ_, BK_, ST_>::kSmem       \
               ? (int)launch_simt<HDP_, BQ_, BK_, ST_>(FA_ARGS)            \
               : (int)cudaErrorInvalidValue;
  FA_SIMT_TEMPLATES(FA_SIMT_PLAN)
#undef FA_SIMT_PLAN
  return (int)cudaErrorInvalidValue;
#undef FA_ARGS
}
