// The gradient of masked softmax attention, causal or not, on [B, L, H, d]
// views with any batch, sequence and head strides (the last dimension
// contiguous).  Routes (ops/attention.py::bwd_route): bf16 at head_dim 64
// the two wgmma kernels, f32 at head_dim 64 their three-pass TF32 twins,
// any L; bf16 or f32 at another head_dim (1 to 256), any L, the two SIMT
// kernels at the end of the file.
//
// Replaces no TPU kernel: the JAX package differentiates its attention with
// XLA autodiff and has no Pallas backward.  The port's forward is the
// hand-written csrc/attention.cu, whose output autograd cannot see through,
// so ops/attention.py::AttentionFunction takes its gradient here.  It is the
// exact gradient of the forward's arithmetic, with the forward's rounding of
// p to v's type taken as the identity, as autodiff of a cast takes it (and,
// as autodiff does, the cotangent of that rounded p rounded to v's type):
//   s = scale * (q . k^T) in f32, keys >= l_valid and, under causal,
//     keys after the query at -inf;
//   p = exp(s - rowmax) / rowsum in f32 (IEEE division);
//   dV = T(p)^T . dO;
//   dP = T(dO . V^T);
//   D = rowsum(p * dP);  dS = p * (dP - D);
//   dQ = scale * dS . K;  dK = scale * dS^T . Q,
// all accumulated in f32 and stored once in T (bf16 or f32).  Keys at or past
// l_valid get dK = dV = 0.  No kernel uses atomics: every output element is
// summed by one thread (or one warpgroup's tensor-core products) in a fixed
// order, so a repeat gives the same bits.
//
// Causal (the text tower's mask), on every route: a query tile sweeps no
// key tile wholly past its last row, a key tile visits no query tile
// wholly before its first key, and the tile on the diagonal masks its
// keys after the row with -inf before the exp, in the same select as the
// l_valid mask (key_limit: a row sees keys [0, min(l_valid, row + 1))).
// The bf16 dQ kernel is a template on it: the non-causal instance keeps
// four blocks an SM, the causal one runs at three (its row limits do not
// fit the 128-register bound).
//
// What bounds it on an H100: at the training shape (B 256, L 197, H 12,
// d 64, bf16) the bytes (q, k, v and dO read, dq, dk, dv written once) are
// 0.162 ms at 3.35 TB/s; the five products a gradient needs (s, dP, dV, dQ,
// dK over the kept score pairs) 0.077 ms at 989 TFLOP/s bf16.  The design
// below does nine products over 64 x 64 tiles (s and dP three times each,
// dQ, dK, dV), 2.3e11 FLOP at L 197 padded to 256, 0.23 ms at the peak, and
// three exps per score pair (6e8 at that shape); the softmax's instructions,
// not the bytes, are what it spends most on.
//
// bf16 at head_dim 64 (every shipped tower), any L >= 1: two kernels on
// wgmma fed by TMA, each block one warpgroup on one 64-row tile, the
// forward's 4-D tensor maps over the strided views (dims d, H, L, B; box 64
// x 1 x 64 x 1, 128-byte swizzle; rows past L arrive as zeros), its SS
// wgmma m64n64k16 and its RS wgmma with an MN-major B (the transpose bit).
//   1. attn_bwd_dq_kernel, one block per (batch, head, 64-query tile): the
//      Q and dO tiles stay resident; the 64-key tiles of K and V stream
//      through a ring of stages, twice.  Sweep 1: S = Q . K^T and
//      dP = dO . V^T, then per row, online, the max, the sum of
//      exp(s - max) and the sum of exp(s - max) * dP, both rescaled when the
//      max moves, merged over the row's four threads at the end:
//      D = that sum / the row sum.  Sweep 2: S and dP again,
//      p = quot(exp(s - max), sum) (the correctly rounded quotient, as in
//      the forward), dS = p * (dP - D) rounded to bf16 in its accumulator
//      layout (a 16-key piece of it is a 16-deep A operand), then
//      dQ += dS . K (K as an MN-major B).  Each row's max, sum, 1 / sum and
//      D go to the caller's scratch, 64 rows of a tile together.  When a
//      head's key tiles all fit in the ring (L <= 128) they stay for sweep 2.
//   2. attn_bwd_dkv_kernel, one block per (batch, head, 64-key tile): the K
//      and V tiles stay resident; the Q and dO tiles and their rows'
//      statistics (one 1 KB bulk copy) stream through a ring.  Per half
//      of 32 queries: S^T = K . Q^T and dP^T = V . dO^T (m64n32); P^T and
//      dS^T from the statistics, each rounded to bf16 in registers;
//      dV += P^T . dO and dK += dS^T . Q.  Halves keep the two 64 x 64
//      accumulators and the scores within 128 registers (whole 64-query
//      tiles spilled even at 168).
// exp is __expf (ex2.approx of x log2 e): ~1e-6 relative where p matters,
// far inside the tolerance below, and faster than expf.
// The rounding of dS to bf16 for the dQ and dK products is one rounding the
// contract above does not make: it moves each term by at most 2^-9 of
// |dS| |K| (or |Q|), inside the bf16 tolerance (2^-7 |want| + 2^-6 M,
// scd_tpu_torch/testing/attention_grad.py).  Kernel 2's S^T is another
// instruction than kernel 1's S, so p and dS may differ there in their
// last bits.  No wgmma sits under a runtime branch (ptxas would serialize
// it): loop bounds are uniform in the warpgroup, the key mask is a select
// in every tile (see scale_mask), and rows past L (zeros from TMA) get
// finite statistics (max 0, sum l_valid, D 0), so their terms are exactly
// 0.  A key tile wholly past l_valid visits no query tile and stores zeros.
//
// f32 at head_dim 64 (the end-to-end NCD baselines, metric_learn --bf16
// 0), any L >= 1: two kernels on the bf16 kernels' plan, on wgmma .tf32
// fed by TMA, with each f32 product three TF32 products of hi / lo halves
// summed in f32, as the forward's f32 kernel runs them (csrc/attention.cu
// says why: split-bf16 products miss the f32 tolerance where the softmax
// is sharp): hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), a . b =
// a_lo . b_hi + a_hi . b_lo (issued first) + a_hi . b_hi.  Everything
// else is the contract above: p = exp(s - max) / sum (the correctly
// rounded quotient), its rounding to T and dP's the identity, every sum
// in f32, no atomics, dK = dV = 0 past l_valid.  What bounds it: at B 128,
// L 197, H 12 the bytes (4-byte elements) are 542 MB, 0.162 ms at 3.35
// TB/s, and the five products at three TF32 passes 114 GFLOP, 0.231 ms at
// 495 TFLOP/s: the products.  `.tf32` wgmma has no transpose bit, so every
// operand is K-major over the reduced axis: S, S^T, dP and dP^T take
// q, k, v and dO as they land (d contiguous), while dQ = dS . K, dV =
// P^T . dO and dK = dS^T . Q need K, dO and Q transposed, rows permuted
// inside each 8 to the order in which the accumulator hands a thread its
// columns (2t, 2t + 1 where a k8 A fragment takes t, t + 4).  f32 halves
// double the bytes of every staged tile, so each block has two warpgroups
// that share one split copy of each streamed unit of 32 rows, and the
// resident tiles (64 KB a warpgroup) leave room for one block an SM.
//   1. attn_bwd_dq_f32_kernel, one block per (batch, head, pair of
//      64-query tiles): Q and dO split once and held as A fragments in
//      registers (218 registers a thread: with both operands in shared
//      memory the m64n32 products read 3 KB a 16-cycle step, more than
//      shared memory gives; 0.92 -> 0.82 ms at B 128 · L 197 on an H100);
//      K and V stream in units of 32 keys through one landing buffer,
//      twice, each unit split by the block (sweep 2: K^T too) as the next
//      one lands.
//      Sweep 1: S and dP (m64n32), the online max, sum and sum of e * dP;
//      sweep 2: p, dS = p * (dP - D) split in its registers, dQ += dS . K.
//   2. attn_bwd_dkv_f32_kernel, one block per (batch, head, pair of
//      64-key tiles): K and V resident; Q and dO stream in units of 32
//      queries with their rows' statistics, split into hi / lo and into
//      their transposes; S^T and dP^T (m64n32), P^T and dS^T split in
//      registers, dV += P^T . dO, dK += dS^T . Q.
//
// bf16 or f32 at another head_dim (the micro ViT's 32; 1 to 256), any L:
// two SIMT kernels, a template on T, inputs staged in f32, every product
// an fmaf in f32 (exact for bf16 inputs), the keys streamed through
// shared memory in tiles of 32, so no score row is held whole:
// attn_bwd_dq_simt_kernel, one block per 32-query tile, sweeps the key
// tiles twice (sweep 1: per row the online max, sum of exp(s - max) and
// sum of exp(s - max) * T(dP), merged over the warp, D = that sum / the
// row sum, stored in the (max, sum, D) planes; sweep 2: p = exp(s - max)
// / sum (IEEE division), dS = p * (T(dP) - D) in f32, dQ += dS . K), and
// attn_bwd_dkv_simt_kernel, one block per 32-key tile, streams the query
// tiles that see its keys (p and dS recomputed by the same instructions;
// dV += T(p) . dO, dK += dS . Q).  dS is not rounded to T here: the
// contract above, with no extra rounding.  What bounds it: at the micro
// ViT's B 256 x L 197 x H 2 x d 32 (bf16) the bytes are 0.013 ms at 3.35
// TB/s, and the kernels took 3.6 ms there on an H100 (PERF.md): a simple
// kernel that is right, its SIMT products and staging left for a later
// redesign.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, l, h;  // element strides of batch, sequence and head
};

// ---- the bf16 path: wgmma fed by TMA

constexpr int HD = 64;                      // head dimension of the bf16 path
constexpr int ROW_BYTES = HD * 2;           // one head row: 128 bytes, the swizzle span
constexpr int TR = 64;                      // rows of a tile (the wgmma M)
constexpr int TILE_BYTES = TR * ROW_BYTES;  // one tile of q, k, v or dO: 8 KB
constexpr int STAT_BYTES = TR * 16;         // a tile's row statistics: 64 float4
constexpr int THREADS = 128;                // one warpgroup

// Shared memory, after a pad to a 1024-byte boundary: kernel 1 Q, dO, then
// NS stages of (K, V); kernel 2 K, V, then NS stages of (Q, dO,
// statistics); the mbarriers after them.  Four blocks an SM (<= 128
// registers a thread, ~51 KB each) with two stages ran faster than three
// blocks with three stages: other blocks' work hides a block's waits.
constexpr int NS = 2, PER_SM = 4;
constexpr int DQ_STAGE = 2 * TILE_BYTES;
constexpr int DKV_STAGE = 2 * TILE_BYTES + 1024;  // statistics padded to keep 1024-byte alignment
constexpr int DQ_SMEM = 1024 + 2 * TILE_BYTES + NS * DQ_STAGE + 64;
constexpr int DKV_SMEM = 1024 + 2 * TILE_BYTES + NS * DKV_STAGE + 64;

struct Shape {
  int heads, L, lv, tiles;  // lv = min(l_valid, L); tiles = ceil(L / 64)
  float scale;
  int causal;  // keys after the query masked
};

// The keys a row sees are [0, key_limit): those before l_valid and,
// under causal, none after the row itself.
__device__ __forceinline__ int key_limit(int row, int lv, int causal) {
  return causal ? min(lv, row + 1) : lv;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Waits for the phase of `parity` to complete.  A wait past 10 s (a load
// that never lands) traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = global_ns();
    else if (global_ns() - start > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a plain bulk copy of `bytes` (a multiple of 16) from global memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register accesses across wgmma
template <int N, typename T>
__device__ __forceinline__ void reg_fence(T* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(*reinterpret_cast<uint32_t*>(&r[i]))::"memory");
}

// the same for f32 accumulators, bound as floats: a "+r" binding moves
// each value through an integer register, and ptxas counts those moves as
// reads of the accumulator inside the pipeline and serializes the wgmma
template <int N>
__device__ __forceinline__ void acc_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory operand descriptor of rows of 128 bytes with the 128-byte
// swizzle (what TMA writes): start address >> 4, LBO 1 (unused), 8-row
// groups 1024 bytes apart (SBO), layout type 1 (128B swizzle).  It serves a
// K-major operand (d contiguous: Q, K, V, dO as the A or B of a product over
// d) and an MN-major B (a product over the tile's rows); a 16-deep step
// along d advances the start by 32 bytes (2 units), one along the rows by 16
// rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_bf16_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_rs_n64_tb(float* d, const uint32_t* a, uint64_t db,
                                                     int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// X = A_x . B_x^T and Y = A_y . B_y^T over d (four 16-deep steps each), N
// rows of B (32 or 64), both operands K-major in shared memory; one commit,
// one wait
template <int N>
__device__ __forceinline__ void two_products(float* x, float* y, uint64_t ax, uint64_t bx,
                                             uint64_t ay, uint64_t by) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (N == 64)
      wgmma_bf16_ss_n64(x, ax + 2 * kk, bx + 2 * kk, kk);
    else
      wgmma_bf16_ss_n32(x, ax + 2 * kk, bx + 2 * kk, kk);
  }
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (N == 64)
      wgmma_bf16_ss_n64(y, ay + 2 * kk, by + 2 * kk, kk);
    else
      wgmma_bf16_ss_n32(y, ay + 2 * kk, by + 2 * kk, kk);
  }
  wg_commit();
  wg_wait_all();
  reg_fence<N / 2>(x);
  reg_fence<N / 2>(y);
}

// acc += A . B over the tile's 64 rows: A from registers (a[j] the j-th
// 16-deep piece), B a [64 rows][64 d] tile as an MN-major operand; `first`
// overwrites acc instead
__device__ __forceinline__ void rs_product(float* acc, const uint32_t (&a)[4][4], uint32_t b_addr,
                                           bool first) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_bf16_rs_n64_tb(acc, a[j], desc_sw128(b_addr + j * 16 * ROW_BYTES), !(first && j == 0));
}

// e / sum, correctly rounded, from inv = RN(1 / sum) (Markstein)
__device__ __forceinline__ float quot(float e, float sum, float inv) {
  const float q = __fmul_rn(e, inv);
  return fmaf(fmaf(-sum, q, e), inv, q);
}

// p of an unscaled score from its row's (max, sum, 1 / sum, D)
__device__ __forceinline__ float prob(float s, float4 row, float scale) {
  return quot(__expf(__fsub_rn(__fmul_rn(s, scale), row.x)), row.y, row.z);
}

// (m, sum, wsum) of two partial softmax states, m the larger max; a state
// with m = -inf (no key seen yet) has sums 0 and adds nothing
__device__ __forceinline__ void merge_state(float& m, float& sum, float& wsum, float m2,
                                            float sum2, float wsum2) {
  const float mn = fmaxf(m, m2);
  const float ms = mn == -INFINITY ? 0.f : mn;
  const float c1 = __expf(m - ms), c2 = __expf(m2 - ms);
  sum = sum * c1 + sum2 * c2;
  wsum = wsum * c1 + wsum2 * c2;
  m = mn;
}

// The scaled scores of one tile of 8 NC keys (64 by default) starting at
// key k0, keys at or past the row's limit (key_limit: la for row a, lb
// for row b) at -inf.  Thread (lane 4g + t) holds rows g (a: s[4c],
// s[4c + 1]) and g + 8 (b: s[4c + 2], s[4c + 3]) of its warp's 16 at keys
// k0 + 8c + 2t + {0, 1}.
// A masked score is 1 * -inf: the mask picks the operands of the one
// multiply (a select of the result, or a branch around the masking, has
// ptxas serialize the wgmma that wrote s, C7514).
template <int NC = 8>
__device__ __forceinline__ void scale_mask(float* s, int k0, int la, int lb, int t,
                                           float scale) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = k0 + c * 8 + 2 * t + e;
      const bool ka = key < la, kb = key < lb;
      s[4 * c + e] = __fmul_rn(ka ? s[4 * c + e] : 1.f, ka ? scale : -INFINITY);
      s[4 * c + 2 + e] = __fmul_rn(kb ? s[4 * c + 2 + e] : 1.f, kb ? scale : -INFINITY);
    }
}

// the tiles of rows [row0, row0 + 64) of (b, h) from two maps into dst, dst
// + TILE_BYTES, completing on bar with `extra` bytes more that the caller
// loads (one thread: one arrival a phase)
__device__ __forceinline__ void load_pair(const CUtensorMap* m1, const CUtensorMap* m2,
                                          uint32_t dst, uint32_t bar, int row0, int b, int h,
                                          uint32_t extra = 0) {
  mbar_expect_tx(bar, 2 * TILE_BYTES + extra);
  tma_load_4d(dst, m1, bar, 0, h, row0, b);
  tma_load_4d(dst + TILE_BYTES, m2, bar, 0, h, row0, b);
}

// Kernel 1: dQ and the row statistics.  Load sequence: sweep 1's key tiles
// 0 .. nkt - 1, then sweep 2's again (item nkt + j), unless nkt <= NS: then
// sweep 2 reads the stages sweep 1 filled.  Item i lives in stage i % NS,
// its load completing phase i / NS of that stage's mbarrier; a stage is
// refilled with item i + NS once every thread is done with item i.
// CAUSAL (1: keys after the row masked) is a template argument: the
// non-causal kernel (every training step) keeps its 128-register bound
// and four blocks an SM; the causal one's row limits take registers that
// bound leaves no room for, so it runs at three blocks an SM (168).
template <int CAUSAL>
__global__ void __launch_bounds__(THREADS, CAUSAL ? 3 : PER_SM)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                   __nv_bfloat16* __restrict__ dq, float4* __restrict__ stats, Strides sdq,
                   Shape sh) {
  extern __shared__ unsigned char sm_raw[];
  const uint32_t raw = smem_u32(sm_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qbuf = base, obuf = base + TILE_BYTES, ring = base + 2 * TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm_raw + (base - raw) + 2 * TILE_BYTES +
                                               NS * DQ_STAGE);  // [0] Q and dO, [1 + s] stage s

  const int tile = blockIdx.x % sh.tiles;
  const int bh = blockIdx.x / sh.tiles;
  const int b = bh / sh.heads, h = bh % sh.heads;
  const int q0 = tile * TR;
  const int lv = sh.lv;
  // key tiles with a key some row of the tile sees (causal: none past the
  // diagonal tile)
  const int nkt = (key_limit(q0 + TR - 1, lv, CAUSAL) + TR - 1) / TR;
  const bool resident = nkt <= NS;
  const int items = resident ? nkt : 2 * nkt;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // row a's key limit; row b's (8 rows on) is min(lim_a + 8, lv)
  const int lim_a = key_limit(q0 + 16 * warp + g, lv, CAUSAL);

  if (threadIdx.x == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_pair(&mq, &mo, qbuf, smem_u32(&bars[0]), q0, b, h);
    for (int i = 0; i < NS && i < items; ++i)
      load_pair(&mk, &mv, ring + i * DQ_STAGE, smem_u32(&bars[1 + i]), (i % nkt) * TR, b, h);
  }
  __syncthreads();
  mbar_wait(smem_u32(&bars[0]), 0);
  const uint64_t dq_a = desc_sw128(qbuf), do_a = desc_sw128(obuf);

  // item i is read: wait for it, and once every thread is done, refill its
  // stage with item i + NS
  auto acquire = [&](int i) {
    mbar_wait(smem_u32(&bars[1 + i % NS]), (i / NS) & 1);
    return ring + (i % NS) * DQ_STAGE;
  };
  auto release = [&](int i) {
    if (i + NS < items) {
      __syncthreads();
      if (threadIdx.x == 0)
        load_pair(&mk, &mv, ring + (i % NS) * DQ_STAGE, smem_u32(&bars[1 + i % NS]),
                  ((i + NS) % nkt) * TR, b, h);
    }
  };

  // ---- sweep 1: per row (a: g, b: g + 8 of the warp's 16) the max, the sum
  // of e = exp(s - max) and the sum of e * dP, online
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, ua = 0.f, ub = 0.f;
  for (int j = 0; j < nkt; ++j) {
    const uint32_t st = acquire(j);
    float s[32], dp[32];
    two_products<64>(s, dp, dq_a, desc_sw128(st), do_a, desc_sw128(st + TILE_BYTES));
    release(j);
    scale_mask(s, j * TR, lim_a, min(lim_a + 8, lv), t, sh.scale);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ta = fmaxf(ta, fmaxf(s[4 * c], s[4 * c + 1]));
      tb = fmaxf(tb, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    const float za = na == -INFINITY ? 0.f : na, zb = nb == -INFINITY ? 0.f : nb;
    float ea = 0.f, eb = 0.f, wa = 0.f, wb = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xa = __expf(s[4 * c + e] - za), xb = __expf(s[4 * c + 2 + e] - zb);
        ea += xa;
        eb += xb;
        wa = fmaf(xa, round_bf16(dp[4 * c + e]), wa);
        wb = fmaf(xb, round_bf16(dp[4 * c + 2 + e]), wb);
      }
    const float ca = __expf(ma - za), cb = __expf(mb - zb);
    la = la * ca + ea;
    ua = ua * ca + wa;
    lb = lb * cb + eb;
    ub = ub * cb + wb;
    ma = na;
    mb = nb;
  }
  // the row's four threads; every row sees key 0, so its max is finite (a
  // row past L has q = 0: max 0, sum lv, D 0)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    merge_state(ma, la, ua, __shfl_xor_sync(0xffffffffu, ma, off),
                __shfl_xor_sync(0xffffffffu, la, off), __shfl_xor_sync(0xffffffffu, ua, off));
    merge_state(mb, lb, ub, __shfl_xor_sync(0xffffffffu, mb, off),
                __shfl_xor_sync(0xffffffffu, lb, off), __shfl_xor_sync(0xffffffffu, ub, off));
  }
  const float ia = __frcp_rn(la), ib = __frcp_rn(lb);
  const float da = __fdiv_rn(ua, la), db = __fdiv_rn(ub, lb);
  const int ra = 16 * warp + g, rb = ra + 8;  // rows in the tile
  if (t == 0) {
    float4* out = stats + ((long long)bh * sh.tiles + tile) * TR;
    out[ra] = make_float4(ma, la, ia, da);
    out[rb] = make_float4(mb, lb, ib, db);
  }

  // ---- sweep 2: p, dS = p * (dP - D) in bf16, dQ += dS . K
  float acc[32];
  for (int j = 0; j < nkt; ++j) {
    const int item = resident ? j : nkt + j;
    const uint32_t st = acquire(item);
    float s[32], dp[32];
    two_products<64>(s, dp, dq_a, desc_sw128(st), do_a, desc_sw128(st + TILE_BYTES));
    scale_mask(s, j * TR, lim_a, min(lim_a + 8, lv), t, sh.scale);
    uint32_t ds[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool row_b = e & 2;  // elements 2, 3, 6, 7 are row g + 8
        const float x = s[8 * jj + e];
        const float p = row_b ? quot(__expf(__fsub_rn(x, mb)), lb, ib)
                              : quot(__expf(__fsub_rn(x, ma)), la, ia);
        v[e] = __fmul_rn(p, __fsub_rn(round_bf16(dp[8 * jj + e]), row_b ? db : da));
      }
      ds[jj][0] = pack_bf16(v[0], v[1]);
      ds[jj][1] = pack_bf16(v[2], v[3]);
      ds[jj][2] = pack_bf16(v[4], v[5]);
      ds[jj][3] = pack_bf16(v[6], v[7]);
    }
    reg_fence<16>(&ds[0][0]);
    wg_fence();
    rs_product(acc, ds, st, j == 0);
    wg_commit();
    wg_wait_all();
    reg_fence<32>(acc);
    release(item);
  }

  // ---- store the rows that exist: chunk c holds columns 8c + 2t, + 1
  __nv_bfloat16* out = dq + b * sdq.b + h * sdq.h;
  const int qa = q0 + ra, qb = q0 + rb;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    if (qa < sh.L)
      *reinterpret_cast<uint32_t*>(out + qa * sdq.l + c * 8 + 2 * t) =
          pack_bf16(__fmul_rn(acc[4 * c], sh.scale), __fmul_rn(acc[4 * c + 1], sh.scale));
    if (qb < sh.L)
      *reinterpret_cast<uint32_t*>(out + qb * sdq.l + c * 8 + 2 * t) =
          pack_bf16(__fmul_rn(acc[4 * c + 2], sh.scale), __fmul_rn(acc[4 * c + 3], sh.scale));
  }
}

// Kernel 2: dK and dV of one 64-key tile.  The query tiles it visits are
// i0 .. tiles - 1 (i0 = 0, or under causal the key tile's own: earlier
// queries see none of its keys); visit n (tile i0 + n) lives in stage
// n % NS (Q, dO, then its 64 rows' statistics), its loads completing phase
// n / NS of that stage's mbarrier; the stage is refilled with visit n + NS
// once every thread is done with visit n.  A thread holds keys k0 + 16
// warp + g (a) and + 8 (b) against queries q0 + 8c + 2t + {0, 1}.
__global__ void __launch_bounds__(THREADS, PER_SM)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                    const float4* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv, Shape sh) {
  extern __shared__ unsigned char sm_raw[];
  const uint32_t raw = smem_u32(sm_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kbuf = base, vbuf = base + TILE_BYTES, ring = base + 2 * TILE_BYTES;
  unsigned char* ring_ptr = sm_raw + (base - raw) + 2 * TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_ptr + NS * DKV_STAGE);

  const int tile = blockIdx.x % sh.tiles;
  const int bh = blockIdx.x / sh.tiles;
  const int b = bh / sh.heads, h = bh % sh.heads;
  const int k0 = tile * TR;
  const int lv = sh.lv;
  const int i0 = sh.causal ? tile : 0;
  const int nqt = k0 < lv ? sh.tiles - i0 : 0;  // a tile of masked keys visits none
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float4* stats_bh = stats + (long long)bh * sh.tiles * TR;

  auto load_q = [&](int n) {
    const uint32_t st = ring + (n % NS) * DKV_STAGE, bar = smem_u32(&bars[1 + n % NS]);
    load_pair(&mq, &mo, st, bar, (i0 + n) * TR, b, h, STAT_BYTES);
    bulk_load(st + 2 * TILE_BYTES, stats_bh + (i0 + n) * TR, STAT_BYTES, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= NS; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nqt > 0) load_pair(&mk, &mv, kbuf, smem_u32(&bars[0]), k0, b, h);
    for (int i = 0; i < NS && i < nqt; ++i) load_q(i);
  }
  __syncthreads();
  if (nqt > 0) mbar_wait(smem_u32(&bars[0]), 0);
  const uint64_t k_a = desc_sw128(kbuf), v_a = desc_sw128(vbuf);
  const int ra = 16 * warp + g, rb = ra + 8;  // keys in the tile
  const bool keep_a = k0 + ra < lv, keep_b = k0 + rb < lv;

  float adk[32], adv[32];
  for (int i = 0; i < nqt; ++i) {
    mbar_wait(smem_u32(&bars[1 + i % NS]), (i / NS) & 1);
    const uint32_t st = ring + (i % NS) * DKV_STAGE;
    const float4* rs = reinterpret_cast<const float4*>(ring_ptr + (i % NS) * DKV_STAGE +
                                                       2 * TILE_BYTES);
    const int qt0 = (i0 + i) * TR;  // the tile's first query
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {  // queries 32 hq .. 32 hq + 31 of the tile
      const uint32_t qo = hq * 32 * ROW_BYTES;
      float s[16], dp[16];
      two_products<32>(s, dp, k_a, desc_sw128(st + qo), v_a, desc_sw128(st + TILE_BYTES + qo));
      uint32_t pf[2][4], df[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        float pv[8], dsv[8];
#pragma unroll
        for (int cb = 0; cb < 2; ++cb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // query 32 hq + 16 jj + 8 cb + 2t + e: (max, sum, 1 / sum, D)
            const int qi = 32 * hq + 16 * jj + 8 * cb + 2 * t + e;
            const float4 r = rs[qi];
            const int ia = 8 * jj + 4 * cb + e, ib = ia + 2;  // keys a, b
            const bool sa = keep_a && k0 + ra < key_limit(qt0 + qi, lv, sh.causal);
            const bool sb = keep_b && k0 + rb < key_limit(qt0 + qi, lv, sh.causal);
            const float pa = sa ? prob(s[ia], r, sh.scale) : 0.f;
            const float pb = sb ? prob(s[ib], r, sh.scale) : 0.f;
            pv[4 * cb + e] = pa;
            pv[4 * cb + 2 + e] = pb;
            dsv[4 * cb + e] = __fmul_rn(pa, __fsub_rn(round_bf16(dp[ia]), r.w));
            dsv[4 * cb + 2 + e] = __fmul_rn(pb, __fsub_rn(round_bf16(dp[ib]), r.w));
          }
        pf[jj][0] = pack_bf16(pv[0], pv[1]);
        pf[jj][1] = pack_bf16(pv[2], pv[3]);
        pf[jj][2] = pack_bf16(pv[4], pv[5]);
        pf[jj][3] = pack_bf16(pv[6], pv[7]);
        df[jj][0] = pack_bf16(dsv[0], dsv[1]);
        df[jj][1] = pack_bf16(dsv[2], dsv[3]);
        df[jj][2] = pack_bf16(dsv[4], dsv[5]);
        df[jj][3] = pack_bf16(dsv[6], dsv[7]);
      }
      reg_fence<8>(&pf[0][0]);
      reg_fence<8>(&df[0][0]);
      wg_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_bf16_rs_n64_tb(adv, pf[j], desc_sw128(st + TILE_BYTES + qo + j * 16 * ROW_BYTES),
                             (i | hq | j) != 0);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_bf16_rs_n64_tb(adk, df[j], desc_sw128(st + qo + j * 16 * ROW_BYTES),
                             (i | hq | j) != 0);
      wg_commit();
      wg_wait_all();
      reg_fence<32>(adv);
      reg_fence<32>(adk);
    }
    if (i + NS < nqt) {
      __syncthreads();
      if (threadIdx.x == 0) load_q(i + NS);
    }
  }

  // ---- store the keys that exist; keys past l_valid get zeros
  __nv_bfloat16* ok = dk + b * sdk.b + h * sdk.h;
  __nv_bfloat16* ov = dv + b * sdv.b + h * sdv.h;
  const int ka = k0 + ra, kb = k0 + rb;
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    if (ka < sh.L) {
      *reinterpret_cast<uint32_t*>(ok + ka * sdk.l + c * 8 + 2 * t) =
          keep_a ? pack_bf16(__fmul_rn(adk[4 * c], sh.scale), __fmul_rn(adk[4 * c + 1], sh.scale))
                 : 0u;
      *reinterpret_cast<uint32_t*>(ov + ka * sdv.l + c * 8 + 2 * t) =
          keep_a ? pack_bf16(adv[4 * c], adv[4 * c + 1]) : 0u;
    }
    if (kb < sh.L) {
      *reinterpret_cast<uint32_t*>(ok + kb * sdk.l + c * 8 + 2 * t) =
          keep_b ? pack_bf16(__fmul_rn(adk[4 * c + 2], sh.scale),
                             __fmul_rn(adk[4 * c + 3], sh.scale))
                 : 0u;
      *reinterpret_cast<uint32_t*>(ov + kb * sdv.l + c * 8 + 2 * t) =
          keep_b ? pack_bf16(adv[4 * c + 2], adv[4 * c + 3]) : 0u;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded, so the library needs no -lcuda at link time.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a strided [B, L, H, 64] view: dims (d, H, L, B),
// innermost first, byte strides of H, L and B (a size-1 dimension gets the
// stride it would have in a contiguous layout), the 128-byte swizzle, rows
// past L read as zeros.  bf16: box 64 x 1 x 64 x 1; f32: box 32 x 1 x 32 x
// 1 (a 128-byte row of 32 columns by 32 rows).
bool make_map(CUtensorMap* map, const void* ptr, Strides st, int batch, int L, int heads,
              bool f32 = false) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long elem_bytes = f32 ? 4 : 2;
  const long long sh = heads > 1 ? st.h : HD;
  const long long sl = L > 1 ? st.l : sh * heads;
  const long long sb = batch > 1 ? st.b : sl * L;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(sh * elem_bytes), (cuuint64_t)(sl * elem_bytes),
                                 (cuuint64_t)(sb * elem_bytes)};
  const cuuint32_t box[4] = {f32 ? 32u : (cuuint32_t)HD, 1u, f32 ? 32u : (cuuint32_t)TR, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                void* dv, float* stats, Strides sq, Strides sk, Strides sv, Strides so,
                Strides sdq, Strides sdk, Strides sdv, int batch, int heads, int L, int lv,
                int causal, float scale, cudaStream_t stream) {
  Shape sh{heads, L, lv, (L + TR - 1) / TR, scale, causal};
  const long long blocks = (long long)batch * heads * sh.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, sq, batch, L, heads) || !make_map(&mk, k, sk, batch, L, heads) ||
      !make_map(&mv, v, sv, batch, L, heads) || !make_map(&mo, dout, so, batch, L, heads))
    return (int)cudaErrorInvalidValue;
  auto dq_kernel = causal ? attn_bwd_dq_kernel<1> : attn_bwd_dq_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  float4* st4 = reinterpret_cast<float4*>(stats);
  dq_kernel<<<(unsigned)blocks, THREADS, DQ_SMEM, stream>>>(
      mq, mk, mv, mo, static_cast<__nv_bfloat16*>(dq), st4, sdq, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<<<(unsigned)blocks, THREADS, DKV_SMEM, stream>>>(
      mq, mk, mv, mo, st4, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sdk,
      sdv, sh);
  return (int)cudaGetLastError();
}

// ---- the f32 path at head_dim 64, any L: three TF32 passes on wgmma fed by TMA

constexpr int FU = 32;                      // rows of a streamed unit (keys, then queries)
constexpr int F_ROW = 128;                  // a 32-wide f32 atom row: the swizzle span
constexpr int F_THALF = TR * F_ROW;         // a tile's atom column [64 rows][32]: 8 KB
constexpr int F_TILE = 2 * F_THALF;         // a [64 rows][64] f32 tile: 16 KB
constexpr int F_UHALF = FU * F_ROW;         // a unit's atom column [32 rows][32]: 4 KB
constexpr int F_UNIT = 2 * F_UHALF;         // a [32 rows][64] f32 unit: 8 KB
constexpr int F_UT = TR * F_ROW;            // a unit's transpose [64][32 rows]: 8 KB
constexpr int FWGS = 2;                     // warpgroups a block
constexpr int FTHR = FWGS * 128;
constexpr int F_STATS = FU * 16;            // a unit's row statistics: 32 float4
// after the 1024-byte pad: per warpgroup four resident tiles, the split
// unit, the landing buffer, the mbarriers
constexpr int FDQ_SMEM = 1024 + FWGS * 4 * F_TILE + 4 * F_UNIT + 2 * F_UT + 2 * F_UNIT + 64;
constexpr int FDKV_SMEM = 1024 + FWGS * 4 * F_TILE + 4 * F_UNIT + 4 * F_UT + 2 * F_UNIT +
                          2 * F_STATS + 64;

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero (cvt.rna.tf32.f32), in f32 bits with the low 13 bits clear
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// shared-memory writes of the generic proxy made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The byte offset of k8 step kk in a K-major operand 64 deep: two atom
// columns `half` bytes apart, 32 bytes (8 f32) a step inside each
__device__ __forceinline__ uint32_t kstep(int kk, uint32_t half) {
  return (kk >> 2) * half + (kk & 3) * 32;
}

// x -> (tf32 hi, tf32 lo) over n float4 of one layout; hi may be x
__device__ __forceinline__ void split_flat(const float4* x, float4* hi, float4* lo, int n, int tid,
                                           int nthr) {
  for (int i = tid; i < n; i += nthr) {
    const float4 v = x[i];
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                        tf32_rna(v.w - h.w));
    hi[i] = h;
  }
}

// A [32 rows][64] f32 unit as TMA lands it (two swizzled atom columns) ->
// the tf32 hi and lo of its transpose, [64][32 rows] K-major over the rows
// (one atom column), the rows permuted inside each 8: column 8c + j holds
// row 8c + 2j (j < 4) or 8c + 2j - 7 (j >= 4), the order in which a wgmma
// accumulator hands a thread its columns (2t and 2t + 1 where a k8 A
// fragment takes t and t + 4).  A sum over the rows does not see the
// order.  Lanes take consecutive output rows: reads of one source row hit
// 32 banks, writes fill 4 wavefronts.
__device__ __forceinline__ void split_t32(const unsigned char* raw, unsigned char* hi,
                                          unsigned char* lo, int tid, int nthr) {
  for (int i = tid; i < 16 * FU; i += nthr) {
    const int d = i & 63, q4 = i >> 6;        // output row d, float4 column q4
    const int r0 = 8 * (q4 >> 1) + (q4 & 1);  // source rows r0, + 2, + 4, + 6
    const unsigned char* col = raw + (d >> 5) * F_UHALF + (d & 3) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 2 * e;
      v[e] = *reinterpret_cast<const float*>(col + r * F_ROW + ((((d & 31) >> 2) ^ (r & 7)) << 4));
    }
    const float4 h = make_float4(tf32_rna(v[0]), tf32_rna(v[1]), tf32_rna(v[2]), tf32_rna(v[3]));
    const float4 l = make_float4(tf32_rna(v[0] - h.x), tf32_rna(v[1] - h.y),
                                 tf32_rna(v[2] - h.z), tf32_rna(v[3] - h.w));
    const int off = d * F_ROW + ((q4 ^ (d & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// Rows [row0, row0 + n) (n 32 or 64) of (b, h) of an f32 [B, L, H, 64] view
// into dst as two atom columns n * 128 bytes apart: boxes of 32 x 32 (one
// thread; the caller arms the mbarrier)
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                              int row0, int n, int b, int h) {
  for (int rr = 0; rr < n; rr += FU)
#pragma unroll
    for (int dh = 0; dh < 2; ++dh)
      tma_load_4d(dst + dh * n * F_ROW + rr * F_ROW, m, bar, 32 * dh, h, row0 + rr, b);
}

// X = A . B^T over d, three TF32 passes (a_lo.b_hi and a_hi.b_lo over the
// eight k8 steps, then a_hi.b_hi): A a resident [64][64] tile, B a [32][64]
// unit, each with its lo `lo` bytes after its hi; wgmma m64n32k8, both
// K-major from shared memory.  The caller fences, commits and waits.
__device__ __forceinline__ void products3_n32(float* x, uint32_t a_hi, uint32_t b_hi,
                                              uint32_t b_lo) {
  const uint32_t a_lo = a_hi + F_TILE;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n32(x, desc_sw128(a_lo + kstep(kk, F_THALF)),
                      desc_sw128(b_hi + kstep(kk, F_UHALF)), kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n32(x, desc_sw128(a_hi + kstep(kk, F_THALF)),
                      desc_sw128(b_lo + kstep(kk, F_UHALF)), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n32(x, desc_sw128(a_hi + kstep(kk, F_THALF)),
                      desc_sw128(b_hi + kstep(kk, F_UHALF)), 1);
}

// The k8 A fragments of a resident split [64][64] tile (hi at `hi`, lo
// F_TILE after) for this warp's 16 rows: step kk holds rows g and g + 8 at
// columns 8 kk + t and 8 kk + t + 4 (a0 .. a3: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4))
__device__ __forceinline__ void tile_frags(const unsigned char* hi, uint32_t (&fh)[8][4],
                                           uint32_t (&fl)[8][4], int warp, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = 16 * warp + g + 8 * (x & 1), c = 8 * kk + t + 4 * (x >> 1);
      const int off = (c >> 5) * F_THALF + r * F_ROW + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                      (c & 3) * 4;
      fh[kk][x] = *reinterpret_cast<const uint32_t*>(hi + off);
      fl[kk][x] = *reinterpret_cast<const uint32_t*>(hi + F_TILE + off);
    }
}

// X = A . B^T over d, three TF32 passes (a_lo.b_hi and a_hi.b_lo over the
// eight k8 steps, then a_hi.b_hi): A from registers (tile_frags), B a
// [32][64] unit K-major in shared memory (hi at b_hi, lo at b_lo); wgmma
// m64n32k8.  The caller fences, commits and waits.
__device__ __forceinline__ void rs_scores3_n32(float* x, const uint32_t (&ah)[8][4],
                                               const uint32_t (&al)[8][4], uint32_t b_hi,
                                               uint32_t b_lo) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_rs_n32(x, al[kk], desc_sw128(b_hi + kstep(kk, F_UHALF)), kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_rs_n32(x, ah[kk], desc_sw128(b_lo + kstep(kk, F_UHALF)), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_rs_n32(x, ah[kk], desc_sw128(b_hi + kstep(kk, F_UHALF)), 1);
}

// acc += A . B^T over a unit's 32 rows: A from registers (the tf32 hi and
// lo of each k8 piece), B a [64][32] transposed unit (hi, lo `F_UT` bytes
// after); lo.hi and hi.lo first, then hi.hi.  `first` overwrites acc.
__device__ __forceinline__ void rs_products3(float* acc, const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4], uint32_t b_hi,
                                             bool first) {
  const uint32_t b_lo = b_hi + F_UT;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    wgmma_tf32_rs_n64(acc, al[c], desc_sw128(b_hi + 32 * c), !(first && c == 0));
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_tf32_rs_n64(acc, ah[c], desc_sw128(b_lo + 32 * c), 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_tf32_rs_n64(acc, ah[c], desc_sw128(b_hi + 32 * c), 1);
}

// The A fragments of an m64n32 accumulator x as a k8-by-4 operand: piece c
// holds columns 8c + 2t (as the fragment's t) and 8c + 2t + 1 (as t + 4) of
// rows g and g + 8, split into tf32 hi and lo
__device__ __forceinline__ void a_frags(const float* x, uint32_t (&ah)[4][4],
                                        uint32_t (&al)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float v[4] = {x[4 * c], x[4 * c + 2], x[4 * c + 1], x[4 * c + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hv = tf32_rna(v[e]);
      ah[c][e] = __float_as_uint(hv);
      al[c][e] = __float_as_uint(tf32_rna(v[e] - hv));
    }
  }
}

// Kernel 1, f32: dQ and the row statistics.  One block per (batch, head,
// pair of 64-query tiles), warpgroup w on tile 2 p + w: its Q and dO tiles
// loaded once by TMA, split in place into tf32 hi and lo (64 KB a
// warpgroup) and read into A fragments, which stay in registers for the
// whole kernel (S and dP take A from registers).  The keys stream in units
// of 32 through one landing
// buffer, twice (sweep 1 then sweep 2); per unit the block splits K and V
// into hi and lo (sweep 2: and K's transpose, for dQ += dS . K) and the
// landing buffer takes the next unit at once.  Sweep 1: S = Q . K^T and
// dP = dO . V^T (m64n32, three passes each), the online max, sum and
// sum of e * dP per thread, merged over the row's four threads at the end:
// (max, sum, 1 / sum, D) to the caller's scratch.  Sweep 2: S and dP
// again, p = quot(exp(s - max), sum), dS = p * (dP - D), split into tf32
// hi and lo in the accumulator's registers, dQ += dS . K.
__global__ void __launch_bounds__(FTHR, 1)
attn_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                       float* __restrict__ dq, float4* __restrict__ stats, Strides sdq, Shape sh,
                       int tpairs) {
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* sm = fsm_raw + ((1024u - (smem_u32(fsm_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid / 32) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // per warpgroup: Q hi, Q lo, dO hi, dO lo; the unit: K hi, K lo, V hi,
  // V lo, K^T hi, K^T lo; the landing buffer: K, V
  const uint32_t mine = base + wg * 4 * F_TILE;
  const uint32_t unit = base + FWGS * 4 * F_TILE;
  const uint32_t kt_hi = unit + 4 * F_UNIT;
  unsigned char* unit_p = sm + FWGS * 4 * F_TILE;
  unsigned char* land_p = unit_p + 4 * F_UNIT + 2 * F_UT;
  const uint32_t land = unit + 4 * F_UNIT + 2 * F_UT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(land_p + 2 * F_UNIT);  // [0] landing, [1 + w]
  const uint32_t land_bar = smem_u32(&bars[0]), mine_bar = smem_u32(&bars[1 + wg]);

  const int tp = blockIdx.x % tpairs, bh = blockIdx.x / tpairs;
  const int b = bh / sh.heads, h = bh % sh.heads;
  const int tq = 2 * tp + wg, q0 = tq * TR;
  const bool has = tq < sh.tiles;  // uniform in the warpgroup
  const int lv = sh.lv;
  // key units with a key some row of the pair sees; under causal a
  // warpgroup skips the units past its own tile's last row (uniform in it)
  const int nu = (key_limit(min(sh.L, 2 * tp * TR + 2 * TR) - 1, lv, sh.causal) + FU - 1) / FU;
  const int ulast = (key_limit(q0 + TR - 1, lv, sh.causal) - 1) / FU;
  const int ra = 16 * warp + g, rb = ra + 8;  // rows in the tile
  const int lim_a = key_limit(q0 + ra, lv, sh.causal), lim_b = key_limit(q0 + rb, lv, sh.causal);
  int ld = 0;                         // thread 0: the next item to land (unit ld % nu)
  auto land_next = [&]() {
    if (ld >= 2 * nu) return;
    const int row0 = (ld % nu) * FU;
    mbar_expect_tx(land_bar, 2 * F_UNIT);
    load_rows_f32(land, &mk, land_bar, row0, FU, b, h);
    load_rows_f32(land + F_UNIT, &mv, land_bar, row0, FU, b, h);
    ++ld;
  };
  if (tid == 0) {
    for (int i = 0; i <= FWGS; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    land_next();
  }
  __syncthreads();
  if (has) {
    if ((tid & 127) == 0) {
      mbar_expect_tx(mine_bar, 2 * F_TILE);
      load_rows_f32(mine, &mq, mine_bar, q0, TR, b, h);
      load_rows_f32(mine + 2 * F_TILE, &mo, mine_bar, q0, TR, b, h);
    }
    mbar_wait(mine_bar, 0);
    float4* mp = reinterpret_cast<float4*>(sm + wg * 4 * F_TILE);
    split_flat(mp, mp, mp + F_TILE / 16, F_TILE / 16, tid & 127, 128);
    split_flat(mp + 2 * F_TILE / 16, mp + 2 * F_TILE / 16, mp + 3 * F_TILE / 16, F_TILE / 16,
               tid & 127, 128);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  // Q and dO as A fragments in registers for the whole kernel: S and dP
  // read only K and V from shared memory
  uint32_t qh[8][4], ql[8][4], oh[8][4], ol[8][4];
  tile_frags(sm + wg * 4 * F_TILE, qh, ql, warp, g, t);
  tile_frags(sm + wg * 4 * F_TILE + 2 * F_TILE, oh, ol, warp, g, t);
  const uint32_t k_hi = unit, v_hi = unit + 2 * F_UNIT;

  // one landed unit into the split unit, by the block; the landing buffer
  // then takes the next item
  auto take_unit = [&](int item, bool transpose) {
    __syncthreads();  // every warpgroup is done with the last split unit
    mbar_wait(land_bar, item & 1);
    const float4* lk = reinterpret_cast<const float4*>(land_p);
    float4* up = reinterpret_cast<float4*>(unit_p);
    split_flat(lk, up, up + F_UNIT / 16, F_UNIT / 16, tid, FTHR);
    split_flat(lk + F_UNIT / 16, up + 2 * F_UNIT / 16, up + 3 * F_UNIT / 16, F_UNIT / 16, tid,
               FTHR);
    if (transpose) split_t32(land_p, unit_p + 4 * F_UNIT, unit_p + 4 * F_UNIT + F_UT, tid, FTHR);
    fence_async_smem();
    __syncthreads();
    if (tid == 0) land_next();
  };

  // ---- sweep 1: per row (a: g, b: g + 8 of the warp's 16) the max, the sum
  // of e = exp(s - max) and the sum of e * dP, online
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f, ua = 0.f, ub = 0.f;
  for (int u = 0; u < nu; ++u) {
    take_unit(u, false);
    if (has && u <= ulast) {
      uint32_t ka = k_hi, va = v_hi;
      asm volatile("" : "+r"(ka), "+r"(va));  // descriptors formed here
      float s[16], dp[16];
      wg_fence();
      rs_scores3_n32(s, qh, ql, ka, ka + F_UNIT);
      rs_scores3_n32(dp, oh, ol, va, va + F_UNIT);
      wg_commit();
      wg_wait_all();
      acc_fence<16>(s);
      acc_fence<16>(dp);
      scale_mask<4>(s, u * FU, lim_a, lim_b, t, sh.scale);
      float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ta = fmaxf(ta, fmaxf(s[4 * c], s[4 * c + 1]));
        tb = fmaxf(tb, fmaxf(s[4 * c + 2], s[4 * c + 3]));
      }
      const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
      const float za = na == -INFINITY ? 0.f : na, zb = nb == -INFINITY ? 0.f : nb;
      float ea = 0.f, eb = 0.f, wa = 0.f, wb = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xa = __expf(s[4 * c + e] - za), xb = __expf(s[4 * c + 2 + e] - zb);
          ea += xa;
          eb += xb;
          wa = fmaf(xa, dp[4 * c + e], wa);
          wb = fmaf(xb, dp[4 * c + 2 + e], wb);
        }
      const float ca = __expf(ma - za), cb = __expf(mb - zb);
      la = la * ca + ea;
      ua = ua * ca + wa;
      lb = lb * cb + eb;
      ub = ub * cb + wb;
      ma = na;
      mb = nb;
    }
  }
  // the row's four threads; every row sees key 0, so its max is finite (a
  // row past L has q = 0: max 0, sum lv, D 0)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    merge_state(ma, la, ua, __shfl_xor_sync(0xffffffffu, ma, off),
                __shfl_xor_sync(0xffffffffu, la, off), __shfl_xor_sync(0xffffffffu, ua, off));
    merge_state(mb, lb, ub, __shfl_xor_sync(0xffffffffu, mb, off),
                __shfl_xor_sync(0xffffffffu, lb, off), __shfl_xor_sync(0xffffffffu, ub, off));
  }
  const float ia = __frcp_rn(la), ib = __frcp_rn(lb);
  const float da = __fdiv_rn(ua, la), db = __fdiv_rn(ub, lb);
  if (has && t == 0) {
    float4* out = stats + ((long long)bh * sh.tiles + tq) * TR;
    out[ra] = make_float4(ma, la, ia, da);
    out[rb] = make_float4(mb, lb, ib, db);
  }

  // ---- sweep 2: p, dS = p * (dP - D), dQ += dS . K
  float acc[32];
  for (int u = 0; u < nu; ++u) {
    take_unit(nu + u, true);
    if (has && u <= ulast) {
      uint32_t ka = k_hi, va = v_hi, kta = kt_hi;
      asm volatile("" : "+r"(ka), "+r"(va), "+r"(kta));
      float s[16], dp[16];
      wg_fence();
      rs_scores3_n32(s, qh, ql, ka, ka + F_UNIT);
      rs_scores3_n32(dp, oh, ol, va, va + F_UNIT);
      wg_commit();
      wg_wait_all();
      acc_fence<16>(s);
      acc_fence<16>(dp);
      scale_mask<4>(s, u * FU, lim_a, lim_b, t, sh.scale);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const bool row_b = e & 2;  // elements 2, 3 of each 4 are row g + 8
        const float p = row_b ? quot(__expf(__fsub_rn(s[e], mb)), lb, ib)
                              : quot(__expf(__fsub_rn(s[e], ma)), la, ia);
        s[e] = __fmul_rn(p, __fsub_rn(dp[e], row_b ? db : da));
      }
      uint32_t dh[4][4], dl[4][4];
      a_frags(s, dh, dl);
      reg_fence<16>(&dh[0][0]);
      reg_fence<16>(&dl[0][0]);
      wg_fence();
      rs_products3(acc, dh, dl, kta, u == 0);
      wg_commit();
      wg_wait_all();
      acc_fence<32>(acc);
    }
  }

  // ---- store the rows that exist: chunk c holds columns 8c + 2t, + 1
  if (has) {
    float* out = dq + b * sdq.b + h * sdq.h;
    const int qa = q0 + ra, qb = q0 + rb;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      if (qa < sh.L)
        *reinterpret_cast<float2*>(out + qa * sdq.l + c * 8 + 2 * t) =
            make_float2(__fmul_rn(acc[4 * c], sh.scale), __fmul_rn(acc[4 * c + 1], sh.scale));
      if (qb < sh.L)
        *reinterpret_cast<float2*>(out + qb * sdq.l + c * 8 + 2 * t) =
            make_float2(__fmul_rn(acc[4 * c + 2], sh.scale), __fmul_rn(acc[4 * c + 3], sh.scale));
    }
  }
}

// Kernel 2, f32: dK and dV.  One block per (batch, head, pair of 64-key
// tiles), warpgroup w on key tile 2 p + w: its K and V tiles loaded once by
// TMA and split in place into tf32 hi and lo.  The queries stream in units
// of 32 with their rows' statistics (one 512-byte bulk copy) through one
// landing buffer; per unit the block splits Q and dO into hi and lo and
// into the hi and lo of their transposes (for dK += dS^T . Q and dV +=
// P^T . dO), copies the statistics, and the landing buffer takes the next
// unit at once.  Per unit: S^T = K . Q^T and dP^T = V . dO^T (m64n32, three
// passes each); P^T and dS^T from the statistics, split into tf32 hi and
// lo in the accumulator's registers; dV += P^T . dO and dK += dS^T . Q.
// A thread holds keys k0 + 16 warp + g (a) and + 8 (b) against queries
// 8c + 2t + {0, 1} of the unit.
__global__ void __launch_bounds__(FTHR, 1)
attn_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                        const float4* __restrict__ stats, float* __restrict__ dk,
                        float* __restrict__ dv, Strides sdk, Strides sdv, Shape sh, int tpairs) {
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* sm = fsm_raw + ((1024u - (smem_u32(fsm_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid / 32) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // per warpgroup: K hi, K lo, V hi, V lo; the unit: Q hi, Q lo, dO hi,
  // dO lo, Q^T hi, Q^T lo, dO^T hi, dO^T lo; the landing buffer: Q, dO;
  // the landed statistics, the unit's statistics
  const uint32_t mine = base + wg * 4 * F_TILE;
  const uint32_t unit = base + FWGS * 4 * F_TILE;
  const uint32_t qt_hi = unit + 4 * F_UNIT, ot_hi = qt_hi + 2 * F_UT;
  const uint32_t land = unit + 4 * F_UNIT + 4 * F_UT;
  unsigned char* unit_p = sm + FWGS * 4 * F_TILE;
  unsigned char* land_p = unit_p + 4 * F_UNIT + 4 * F_UT;
  const float4* land_stats = reinterpret_cast<const float4*>(land_p + 2 * F_UNIT);
  float4* ustats = reinterpret_cast<float4*>(land_p + 2 * F_UNIT + F_STATS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(land_p + 2 * F_UNIT + 2 * F_STATS);
  const uint32_t land_bar = smem_u32(&bars[0]), mine_bar = smem_u32(&bars[1 + wg]);

  const int tp = blockIdx.x % tpairs, bh = blockIdx.x / tpairs;
  const int b = bh / sh.heads, h = bh % sh.heads;
  const int kt = 2 * tp + wg, k0 = kt * TR;
  const int lv = sh.lv;
  const bool has = kt < sh.tiles && k0 < lv;  // a key tile with a valid key
  // the first tile of the pair has a valid key: the block visits every
  // query unit (rows past L are zeros from TMA and add exactly 0) from u0
  // on (causal: the pair's first key; a warpgroup starts at its own, at
  // ustart, uniform in it)
  const int u0 = sh.causal ? 2 * tp * TR / FU : 0, ustart = sh.causal ? k0 / FU : 0;
  const int nu = 2 * tp * TR < lv ? (sh.L + FU - 1) / FU : 0;
  const float4* stats_bh = stats + (long long)bh * sh.tiles * TR;
  int ld = u0;  // thread 0: the next unit to land
  auto land_next = [&]() {
    if (ld >= nu) return;
    mbar_expect_tx(land_bar, 2 * F_UNIT + F_STATS);
    load_rows_f32(land, &mq, land_bar, ld * FU, FU, b, h);
    load_rows_f32(land + F_UNIT, &mo, land_bar, ld * FU, FU, b, h);
    bulk_load(land + 2 * F_UNIT, stats_bh + ld * FU, F_STATS, land_bar);
    ++ld;
  };
  if (tid == 0) {
    for (int i = 0; i <= FWGS; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    land_next();
  }
  __syncthreads();
  if (has) {
    if ((tid & 127) == 0) {
      mbar_expect_tx(mine_bar, 2 * F_TILE);
      load_rows_f32(mine, &mk, mine_bar, k0, TR, b, h);
      load_rows_f32(mine + 2 * F_TILE, &mv, mine_bar, k0, TR, b, h);
    }
    mbar_wait(mine_bar, 0);
    float4* mp = reinterpret_cast<float4*>(sm + wg * 4 * F_TILE);
    split_flat(mp, mp, mp + F_TILE / 16, F_TILE / 16, tid & 127, 128);
    split_flat(mp + 2 * F_TILE / 16, mp + 2 * F_TILE / 16, mp + 3 * F_TILE / 16, F_TILE / 16,
               tid & 127, 128);
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  const uint32_t k_hi = mine, v_hi = mine + 2 * F_TILE;
  const uint32_t q_hi = unit, o_hi = unit + 2 * F_UNIT;
  const int ra = 16 * warp + g, rb = ra + 8;  // keys in the tile
  const bool keep_a = k0 + ra < lv, keep_b = k0 + rb < lv;

  float adk[32], adv[32];
  for (int u = u0; u < nu; ++u) {
    __syncthreads();  // every warpgroup is done with the last split unit
    mbar_wait(land_bar, (u - u0) & 1);
    {
      const float4* lq = reinterpret_cast<const float4*>(land_p);
      float4* up = reinterpret_cast<float4*>(unit_p);
      split_flat(lq, up, up + F_UNIT / 16, F_UNIT / 16, tid, FTHR);
      split_flat(lq + F_UNIT / 16, up + 2 * F_UNIT / 16, up + 3 * F_UNIT / 16, F_UNIT / 16, tid,
                 FTHR);
      split_t32(land_p, unit_p + 4 * F_UNIT, unit_p + 4 * F_UNIT + F_UT, tid, FTHR);
      split_t32(land_p + F_UNIT, unit_p + 4 * F_UNIT + 2 * F_UT, unit_p + 4 * F_UNIT + 3 * F_UT,
                tid, FTHR);
      if (tid < FU) ustats[tid] = land_stats[tid];
    }
    fence_async_smem();
    __syncthreads();  // the split unit is whole; the landing buffer is free
    if (tid == 0) land_next();
    if (has && u >= ustart) {
      uint32_t ka = k_hi, va = v_hi, qa = q_hi, oa = o_hi, qta = qt_hi, ota = ot_hi;
      asm volatile("" : "+r"(ka), "+r"(va), "+r"(qa), "+r"(oa), "+r"(qta), "+r"(ota));
      float s[16], dp[16];
      wg_fence();
      products3_n32(s, ka, qa, qa + F_UNIT);
      products3_n32(dp, va, oa, oa + F_UNIT);
      wg_commit();
      wg_wait_all();
      acc_fence<16>(s);
      acc_fence<16>(dp);
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // query 8c + 2t + e of the unit: (max, sum, 1 / sum, D)
          const int qi = 8 * c + 2 * t + e;
          const float4 r = ustats[qi];
          const int ia = 4 * c + e, ib = ia + 2;  // keys a, b
          const int lim = key_limit(u * FU + qi, lv, sh.causal);
          const float pa = keep_a && k0 + ra < lim ? prob(s[ia], r, sh.scale) : 0.f;
          const float pb = keep_b && k0 + rb < lim ? prob(s[ib], r, sh.scale) : 0.f;
          s[ia] = pa;
          s[ib] = pb;
          dp[ia] = __fmul_rn(pa, __fsub_rn(dp[ia], r.w));
          dp[ib] = __fmul_rn(pb, __fsub_rn(dp[ib], r.w));
        }
      uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
      a_frags(s, ph, pl);
      a_frags(dp, dh, dl);
      reg_fence<16>(&ph[0][0]);
      reg_fence<16>(&pl[0][0]);
      reg_fence<16>(&dh[0][0]);
      reg_fence<16>(&dl[0][0]);
      wg_fence();
      rs_products3(adv, ph, pl, ota, u == ustart);
      rs_products3(adk, dh, dl, qta, u == ustart);
      wg_commit();
      wg_wait_all();
      acc_fence<32>(adv);
      acc_fence<32>(adk);
    }
  }

  // ---- store the keys that exist; keys past l_valid get zeros
  if (kt < sh.tiles) {
    float* ok = dk + b * sdk.b + h * sdk.h;
    float* ov = dv + b * sdv.b + h * sdv.h;
    const int ka = k0 + ra, kb = k0 + rb;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      if (ka < sh.L) {
        *reinterpret_cast<float2*>(ok + ka * sdk.l + c * 8 + 2 * t) =
            keep_a ? make_float2(__fmul_rn(adk[4 * c], sh.scale),
                                 __fmul_rn(adk[4 * c + 1], sh.scale))
                   : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(ov + ka * sdv.l + c * 8 + 2 * t) =
            keep_a ? make_float2(adv[4 * c], adv[4 * c + 1]) : make_float2(0.f, 0.f);
      }
      if (kb < sh.L) {
        *reinterpret_cast<float2*>(ok + kb * sdk.l + c * 8 + 2 * t) =
            keep_b ? make_float2(__fmul_rn(adk[4 * c + 2], sh.scale),
                                 __fmul_rn(adk[4 * c + 3], sh.scale))
                   : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(ov + kb * sdv.l + c * 8 + 2 * t) =
            keep_b ? make_float2(adv[4 * c + 2], adv[4 * c + 3]) : make_float2(0.f, 0.f);
      }
    }
  }
}

int launch_f32_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, float* stats, Strides sq, Strides sk, Strides sv,
                     Strides so, Strides sdq, Strides sdk, Strides sdv, int batch, int heads, int L,
                     int lv, int causal, float scale, cudaStream_t stream) {
  const Shape sh{heads, L, lv, (L + TR - 1) / TR, scale, causal};
  const int tpairs = (sh.tiles + 1) / 2;
  const long long blocks = (long long)batch * heads * tpairs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, sq, batch, L, heads, true) || !make_map(&mk, k, sk, batch, L, heads, true) ||
      !make_map(&mv, v, sv, batch, L, heads, true) || !make_map(&mo, dout, so, batch, L, heads, true))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FDQ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dkv_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FDKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  float4* st4 = reinterpret_cast<float4*>(stats);
  attn_bwd_dq_f32_kernel<<<(unsigned)blocks, FTHR, FDQ_SMEM, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(dq), st4, sdq, sh, tpairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_f32_kernel<<<(unsigned)blocks, FTHR, FDKV_SMEM, stream>>>(
      mq, mk, mv, mo, st4, static_cast<float*>(dk), static_cast<float*>(dv), sdk, sdv, sh, tpairs);
  return (int)cudaGetLastError();
}

// ---- the SIMT route: bf16 or f32 at another head_dim (<= 256), any L

constexpr int MAX_HD_SIMT = 256;
constexpr int FTR = 32;             // queries (kernel 1) or keys (kernel 2) per block; keys a tile
constexpr int FWARPS = 8;
constexpr int FTHREADS = 32 * FWARPS;
constexpr int RPW = FTR / FWARPS;   // rows of a tile per warp: 4
constexpr int MAXC = MAX_HD_SIMT / 32;  // output columns per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_t(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to T's precision and back: p as dV's product takes it, dP as
// its cotangent reaches the softmax
__device__ __forceinline__ float round_t(float x, const float*) { return x; }
__device__ __forceinline__ float round_t(float x, const __nv_bfloat16*) { return round_bf16(x); }

// Rows [row0, row0 + FTR) of one (batch, head) of x into dst [FTR][ld] in
// f32, zeros past L.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* base, long long sl,
                                           int row0, int L, int hd) {
  for (int i = threadIdx.x; i < FTR * hd; i += FTHREADS) {
    const int r = i / hd, c = i % hd;
    dst[r * ld + c] = row0 + r < L ? to_f32(base[(long long)(row0 + r) * sl + c]) : 0.f;
  }
}

// The dot products of this warp's RPW rows of A ([.][hd], rows arow0..) with
// row `lane` of B ([FTR][hd + 1]), fmaf in d order.  Both kernels form every
// score and every dP through this one function, so they agree bit for bit.
__device__ __forceinline__ void row_dots(float (&out)[RPW], const float* A, int arow0,
                                         const float* Bt, int hd, int lane) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) out[r] = 0.f;
  const int ldb = hd + 1;
  for (int d = 0; d < hd; ++d) {
    const float bd = Bt[lane * ldb + d];
#pragma unroll
    for (int r = 0; r < RPW; ++r) out[r] = fmaf(A[(arow0 + r) * hd + d], bd, out[r]);
  }
}

// p of one scaled score from its row's max and sum, as both kernels form it
__device__ __forceinline__ float prob_f32(float s, float m, float sum) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), sum);
}

// (m, sum, wsum) of two partial softmax states with expf: merge_state's
// rule (a state with m = -inf adds nothing)
__device__ __forceinline__ void merge_exact(float& m, float& sum, float& wsum, float m2,
                                            float sum2, float wsum2) {
  const float mn = fmaxf(m, m2);
  const float ms = mn == -INFINITY ? 0.f : mn;
  const float c1 = expf(m - ms), c2 = expf(m2 - ms);
  sum = sum * c1 + sum2 * c2;
  wsum = wsum * c1 + wsum2 * c2;
  m = mn;
}

// Kernel 1: dQ and the row statistics of one 32-query tile.  The key tiles
// of 32 that some row of the tile sees stream through shared memory twice.
// Sweep 1: per (row, lane) the online max, sum of e = exp(s - max) and sum
// of e * T(dP) over the lane's keys, merged over the warp: D = that sum /
// the row sum; (max, sum, D) to the stats planes.  Sweep 2: p =
// exp(s - max) / sum (IEEE division), dS = p * (T(dP) - D) in f32, dQ +=
// dS . K in key order (each lane its columns, dS broadcast by shuffle).
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
attn_bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        T* __restrict__ dq, float* __restrict__ stats, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdq, int heads, int L, int hd, int lv,
                        int causal, float scale, int qtiles, long long bhl) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [FTR][hd]
  float* dOs = Qs + FTR * hd;       // [FTR][hd]
  float* Ks = dOs + FTR * hd;       // [FTR][hd + 1]
  float* Vs = Ks + FTR * (hd + 1);  // [FTR][hd + 1]

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * FTR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * RPW;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = dout + b * sdo.b + h * sdo.h;
  // the keys some row of the block sees, in tiles: uniform in the block
  const int kend = key_limit(q0 + FTR - 1, lv, causal);
  const int ntiles = (kend + FTR - 1) / FTR;
  int lim[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) lim[r] = key_limit(q0 + r0 + r, lv, causal);

  stage_rows(Qs, hd, qb, sq.l, q0, L, hd);
  stage_rows(dOs, hd, ob, sdo.l, q0, L, hd);
  // this warp's rows against key t * FTR + lane: scaled, masked scores and
  // T(dP), by the same instructions in both sweeps and in kernel 2
  auto scores = [&](int t, float (&s)[RPW], float (&dp)[RPW]) {
    __syncthreads();  // the last tile's readers are done
    stage_rows(Ks, hd + 1, kb, sk.l, t * FTR, L, hd);
    stage_rows(Vs, hd + 1, vb, sv.l, t * FTR, L, hd);
    __syncthreads();
    row_dots(s, Qs, r0, Ks, hd, lane);
    row_dots(dp, dOs, r0, Vs, hd, lane);
    const int key = t * FTR + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      s[r] = key < lim[r] ? __fmul_rn(s[r], scale) : -INFINITY;
      dp[r] = round_t(dp[r], q);
    }
  };

  // ---- sweep 1: the row statistics
  float m[RPW], sum[RPW], wsum[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.f;
    wsum[r] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    float s[RPW], dp[RPW];
    scores(t, s, dp);
#pragma unroll
    for (int r = 0; r < RPW; ++r) merge_exact(m[r], sum[r], wsum[r], s[r], 1.f, dp[r]);
  }
  float dd[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      merge_exact(m[r], sum[r], wsum[r], __shfl_xor_sync(0xffffffffu, m[r], off),
                  __shfl_xor_sync(0xffffffffu, sum[r], off),
                  __shfl_xor_sync(0xffffffffu, wsum[r], off));
    dd[r] = __fdiv_rn(wsum[r], sum[r]);  // every row sees key 0: sum >= 1
    if (lane == 0 && q0 + r0 + r < L) {
      const long long row = (long long)bh * L + q0 + r0 + r;
      stats[row] = m[r];
      stats[bhl + row] = sum[r];
      stats[2 * bhl + row] = dd[r];
    }
  }

  // ---- sweep 2: dQ = scale * dS . K
  float acc[RPW][MAXC];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    float s[RPW], dp[RPW], ds[RPW];
    scores(t, s, dp);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
      ds[r] = __fmul_rn(prob_f32(s[r], m[r], sum[r]), __fsub_rn(dp[r], dd[r]));
    const int nk = min(FTR, kend - t * FTR);
    for (int j = 0; j < nk; ++j) {
      const float* krow = Ks + j * (hd + 1);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (lane + 32 * c < hd) acc[r][c] = fmaf(dsj, krow[lane + 32 * c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (q0 + r0 + r >= L) continue;
    T* orow = dq + b * sdq.b + (long long)(q0 + r0 + r) * sdq.l + h * sdq.h;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (lane + 32 * c < hd) store_t(orow + lane + 32 * c, __fmul_rn(acc[r][c], scale));
  }
}

// Kernel 2: dK and dV of one 32-key tile.  The query tiles of 32 that see
// a key of the tile (causal: from the tile's own first key on) stream
// through shared memory with their rows' statistics; p and dS as kernel 1
// forms them, dV += T(p) . dO and dK += dS . Q in query order.
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
attn_bwd_dkv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dk, T* __restrict__ dv,
                         const float* __restrict__ stats, Strides sq, Strides sk, Strides sv,
                         Strides sdo, Strides sdk, Strides sdv, int heads, int L, int hd, int lv,
                         int causal, float scale, int ktiles, long long bhl) {
  extern __shared__ float smem[];
  float* Ks = smem;                  // [FTR][hd + 1]
  float* Vs = Ks + FTR * (hd + 1);   // [FTR][hd + 1]
  float* Qs = Vs + FTR * (hd + 1);   // [FTR][hd]
  float* dOs = Qs + FTR * hd;        // [FTR][hd]
  float* Ps = dOs + FTR * hd;        // [FTR queries][FTR + 1 keys]: T(p)
  float* Gs = Ps + FTR * (FTR + 1);  // [FTR][FTR + 1]: dS
  float* rm = Gs + FTR * (FTR + 1);  // [FTR] row max, sum and D of the query tile
  float* rs = rm + FTR;
  float* rd = rs + FTR;

  const int tile = blockIdx.x % ktiles;
  const int bh = blockIdx.x / ktiles;
  const int b = bh / heads, h = bh % heads;
  const int k0 = tile * FTR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = warp * RPW;  // this warp's keys in the tile, for the sums
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = dout + b * sdo.b + h * sdo.h;

  float adk[RPW][MAXC], adv[RPW][MAXC];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) adk[r][c] = adv[r][c] = 0.f;

  if (k0 < lv) {  // else every key of the tile is masked: zeros
    stage_rows(Ks, hd + 1, kb, sk.l, k0, L, hd);
    stage_rows(Vs, hd + 1, vb, sv.l, k0, L, hd);
    const int key = k0 + lane;
    for (int i0 = causal ? k0 : 0; i0 < L; i0 += FTR) {
      __syncthreads();  // the last query tile's readers are done
      stage_rows(Qs, hd, qb, sq.l, i0, L, hd);
      stage_rows(dOs, hd, ob, sdo.l, i0, L, hd);
      for (int i = threadIdx.x; i < FTR; i += FTHREADS) {
        const long long row = (long long)bh * L + i0 + i;
        const bool in = i0 + i < L;
        rm[i] = in ? stats[row] : 0.f;
        rs[i] = in ? stats[bhl + row] : 1.f;
        rd[i] = in ? stats[2 * bhl + row] : 0.f;
      }
      __syncthreads();
      // this warp's RPW queries against key `lane`: p and dS as kernel 1 has them
      float s[RPW], dp[RPW];
      row_dots(s, Qs, warp * RPW, Ks, hd, lane);
      row_dots(dp, dOs, warp * RPW, Vs, hd, lane);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = warp * RPW + r;
        const float p = key < key_limit(i0 + i, lv, causal)
                            ? prob_f32(__fmul_rn(s[r], scale), rm[i], rs[i])
                            : 0.f;
        Ps[i * (FTR + 1) + lane] = round_t(p, q);
        Gs[i * (FTR + 1) + lane] = __fmul_rn(p, __fsub_rn(round_t(dp[r], q), rd[i]));
      }
      __syncthreads();
      const int ni = min(FTR, L - i0);
      for (int i = 0; i < ni; ++i) {
        const float* qrow = Qs + i * hd;
        const float* orow = dOs + i * hd;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float p = Ps[i * (FTR + 1) + j0 + r];
          const float ds = Gs[i * (FTR + 1) + j0 + r];
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (lane + 32 * c < hd) {
              adv[r][c] = fmaf(p, orow[lane + 32 * c], adv[r][c]);
              adk[r][c] = fmaf(ds, qrow[lane + 32 * c], adk[r][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int key = k0 + j0 + r;
    if (key >= L) continue;
    const bool keep = key < lv;
    T* krow = dk + b * sdk.b + (long long)key * sdk.l + h * sdk.h;
    T* vrow = dv + b * sdv.b + (long long)key * sdv.l + h * sdv.h;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (lane + 32 * c < hd) {
        store_t(krow + lane + 32 * c, keep ? __fmul_rn(adk[r][c], scale) : 0.f);
        store_t(vrow + lane + 32 * c, keep ? adv[r][c] : 0.f);
      }
    }
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, float* stats, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdq, Strides sdk, Strides sdv, int batch, int heads, int L,
                int hd, int lv, int causal, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > MAX_HD_SIMT) return (int)cudaErrorInvalidValue;
  const int tiles = (L + FTR - 1) / FTR;
  const long long bhl = (long long)batch * heads * L;
  const long long blocks = (long long)batch * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem1 = 4 * (2 * FTR * hd + 2 * FTR * (hd + 1));
  const int smem2 = 4 * (2 * FTR * (hd + 1) + 2 * FTR * hd + 2 * FTR * (FTR + 1) + 3 * FTR);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_simt_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_simt_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  attn_bwd_dq_simt_kernel<T><<<(unsigned)blocks, FTHREADS, (size_t)smem1, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dq), stats, sq, sk, sv, sdo, sdq, heads, L, hd, lv, causal,
      scale, tiles, bhl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_simt_kernel<T><<<(unsigned)blocks, FTHREADS, (size_t)smem2, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dk), static_cast<T*>(dv), stats, sq, sk, sv, sdo, sdk, sdv,
      heads, L, hd, lv, causal, scale, tiles, bhl);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v (the forward's inputs), dout (the gradient of its output) and dq,
// dk, dv (written): [batch, L, heads, hd] views with element strides (b, l, h)
// each and the last dimension contiguous, all bf16 or all f32 (is_bf16);
// 1 <= l_valid, causal 0 or 1, any L >= 1.  hd == 64 (bf16 or f32): every
// base and stride 16-byte aligned; stats: 4 * batch * heads * ceil(L / 64)
// * 64 floats of scratch, 16-byte aligned.  Another hd, 1 <= hd <= 256
// (the SIMT kernels): stats: 3 * batch * heads * L floats.
// cudaErrorInvalidValue for anything else.  Launches two kernels on
// `stream` and returns the CUDA error code.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, float* stats, int is_bf16,
                             long long qsb, long long qsl, long long qsh, long long ksb,
                             long long ksl, long long ksh, long long vsb, long long vsl,
                             long long vsh, long long osb, long long osl, long long osh,
                             long long dqsb, long long dqsl, long long dqsh, long long dksb,
                             long long dksl, long long dksh, long long dvsb, long long dvsl,
                             long long dvsh, int batch, int heads, int L, int hd, int l_valid,
                             int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || L < 1 || l_valid < 1 || (causal != 0 && causal != 1))
    return (int)cudaErrorInvalidValue;
  const int lv = l_valid < L ? l_valid : L;
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh}, so{osb, osl, osh};
  const Strides sdq{dqsb, dqsl, dqsh}, sdk{dksb, dksl, dksh}, sdv{dvsb, dvsl, dvsh};
  if (hd == HD && is_bf16)
    return launch_bf16(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk, sdv, batch,
                       heads, L, lv, causal, scale, stream);
  if (hd == HD)
    return launch_f32_wgmma(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk, sdv, batch,
                            heads, L, lv, causal, scale, stream);
  if (is_bf16)
    return launch_simt<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk,
                                      sdv, batch, heads, L, hd, lv, causal, scale, stream);
  return launch_simt<float>(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk, sdv,
                            batch, heads, L, hd, lv, causal, scale, stream);
}
