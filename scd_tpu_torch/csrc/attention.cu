// Masked softmax attention, on [B, L, H, d] views with any batch, sequence
// and head strides (the last dimension contiguous).
//
// Replaces the TPU kernels scd_tpu/ops/pallas_kernels.py::vit_attention_pallas
// (kernel body _vit_attn_kernel) and ::qkv_attention_pallas (kernel body
// _qkv_attn_kernel).  Both compute, per (batch, head):
//   s = (q . k^T) in f32 from products of the input type, times `scale`;
//   keys >= l_valid and, under `causal`, keys with col > row masked to -inf;
//   p = exp(s - rowmax) / rowsum in f32, then cast to v's type;
//   out = p . v accumulated in f32, stored in v's type.
// A packed qkv [B, L, 3W] is three strided [B, L, H, d] views of one buffer,
// so one kernel serves both entry points without transpose copies.
//
// What bounds it on an H100: bytes.  At the image towers' shape (B 128,
// L 197, H 12, d 64, bf16) q, k, v and the output are 155 MB, 0.046 ms at
// 3.35 TB/s, against 15 GFLOP of products (0.015 ms at 989 TFLOP/s bf16);
// the text tower's (B 5,120, L 77, H 8, causal) moves 1.6 GB, 0.48 ms.
//
// Design of the bf16 path (Hopper: TMA, mbarriers, wgmma).  L <= 256, so
// no online softmax is needed (the Pallas kernels make the same choice):
// a whole score row stays in registers.  The work unit is a whole head:
// its K, V and Q are staged once in shared memory and every query tile of
// the head runs against that one copy.  Blocks are persistent (1, 2 or 3
// per SM as the score registers allow) and walk the (batch, head) pairs
// with a stride of the grid; a block has three warpgroups where a score
// row fits in 168 registers (128 and 208 keys), else two.  A ring of
// stages holds the next heads (as many as fit: 2 at L 208, 3 at L 80):
// per head three TMA loads of a 4-D tensor map over the strided view
// (dims d, H, L, B; box 64 x 1 x rows x 1, 128-byte swizzle: a head row is
// 128 bytes) complete on the stage's `full` mbarrier; rows past L arrive
// as zeros.  The warpgroup that finishes with a stage last refills it, so
// no warp is spent on loads alone.  Each query tile of 64 rows belongs to
// one warpgroup (tile t of the block's n-th head to warpgroup (n + t) % W
// of the block's W, which balances both the 4 tiles of L 197 and the
// single tile of L <= 64):
//   S = Q . K^T: wgmma m64nNk16, A and B from shared memory, both K-major
//     (d contiguous), N = all the keys held (16 to 256);
//   scale, mask, row max, expf, the row sum, then p = e / sum by one
//     correctly rounded reciprocal per row and an FMA correction step
//     (Markstein: the correctly rounded quotient, as IEEE division), and
//     p rounded to bf16 in the registers that held the scores: the
//     accumulator layout of a 16-key tile is the A-register layout of a
//     16-deep wgmma;
//   O = P . V: wgmma m64n64k16 with A from registers and V from shared
//     memory as an MN-major B (the transpose bit).
// No wgmma sits under a runtime branch (the compiler would serialize it),
// so the products run over every key tile; a key tile that a warp's rows
// all mask skips the softmax and feeds p = 0, and masks are applied only
// in the tiles that straddle l_valid or the diagonal.  The ragged query
// tile (5 rows at L 197, 13 at L 77) costs its m64 products, which are far
// below the bound, while the warps whose 16 rows all lie past L skip the
// softmax: the instructions, not the tensor cores, are what a ragged tile
// would waste.  The number of 16-key tiles is a template argument (1, 2,
// 5, 8, 13 or 16: the text buckets 16 / 32 / 80, 128, the padded image
// sequence 208, and 256).  The tensor maps encode the base pointers, so
// the host builds three per call (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint: the library links no -lcuda).
//
// f32 at head_dim 64, any L (the end-to-end NCD baselines train ViT-B/16
// in f32): attn_f32_wgmma_kernel, below, on three TF32 passes.  f32 at
// another head_dim takes a plain SIMT kernel with the same contract at
// L <= 256 when its K, V, Q and score rows fit in shared memory (32
// queries per block, scores staged there, fmaf dot products;
// f32_short_smem counts the bytes before any launch), else the key-tiled
// SIMT kernel (head_dim <= 256).
//
// Long sequences (L > 256: a tower at image 256, 288, 384 or 448 gives
// L 257, 325, 577 or 785) take one of two long paths, chosen by shape in
// attention_fwd before any launch; neither holds a whole score row.
//
// bf16 at head_dim 64 (every shipped tower: ViT-B/S/T/16, CLIP text) takes
// the wgmma long path, on the short path's tensor maps, wgmma wrappers and
// register layouts.  What bounds it: at B 128, L 257, H 12 the bytes are
// 0.060 ms at 3.35 TB/s and the products (q . k twice, p . v) 0.04 ms at
// 989 TFLOP/s, so, as on the short path, the softmax's instructions, here
// in both sweeps.  A block owns one (batch, head) pair and stages the key
// tiles its rows see once by TMA (64-row boxes, 16 KB of K and V per tile:
// 80 KB at L 257, 96 KB at L 325, two blocks an SM; up to 13 tiles, L 832,
// resident); each warpgroup takes 64-row query tiles and sweeps the 64-key
// tiles twice, recomputing S = Q . K^T (four wgmma m64n64k16): first the
// row max and sum (online, the sum rescaled when the max moves: row sums
// in another order, inside the short path's tolerance), then
// p = quot(exp(s - max), sum) rounded to bf16 and O += P . V.  Longer
// heads stream their key tiles through the same buffers in chunks of 13,
// reloaded per sweep.
//
// bf16 at another head_dim, at any L (the micro ViT, width 64 over 2
// heads: head_dim 32), f32 at another head_dim past L 256, and f32 at
// L <= 256 whose rows do not fit the whole-row kernel take a key-tiled
// SIMT kernel, head_dim <= 256: a block owns 32 queries
// of one (batch, head) (4 per warp) and sweeps the keys in tiles of 32
// (one per lane) three times, recomputing the same scores in each: first
// the row max, then the row sum of exp(s - max), then p = e / sum (IEEE
// division), rounded to v's type, accumulated as p . v in f32 in key
// order.  That is the short paths' order of operations, so one tolerance
// serves all of them.
//
// The f32 kernel at head_dim 64 (attn_f32_wgmma_kernel).  Contract: the
// one above, with each f32 product three TF32 products of hi / lo halves,
// summed in f32: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and
// a . b = a_lo . b_hi + a_hi . b_lo (issued first) + a_hi . b_hi; lo . lo
// (~2^-22 of |a||b|) is dropped.  Why three TF32 passes: one pass keeps
// ~3 digits, which the repo's parity rule refuses; the split-bf16
// products of estep.cu, topk_softmax.cu and fused_em.cu (~2^-16) cost
// attention 3.5e-5 of max|v| on inputs of amplitude 3, past the f32
// tolerance of 1e-5 (chip_smoke.py ATTN_F32_VREL), where the TF32 split
// costs 4.5e-7, and 1.6e-6 at amplitude 6 (tests/test_torch_attention.py,
// on the CPU against float64).  The softmax runs online in one sweep:
// O accumulates e . v and is rescaled when the row max moves, then each
// row is divided once by its sum (IEEE division); p's rounding to v's
// type is the identity in f32, so this differs from the order above by
// f32 rounding alone.  Masking, every sum in f32 and the repeat of bits
// are as above.
//   What bounds it: at B 128, L 197, H 12 the bytes (q, k, v read, out
// written, 4-byte elements) are 310 MB, 0.092 ms at 3.35 TB/s, and the
// products three passes of q . k and p . v, 45.8 GFLOP, 0.093 ms at 495
// TFLOP/s TF32: both, so the design keeps the tensor cores fed and reads
// each byte once from device memory.
//   Design: one block per (batch, head) pair, four warpgroups (the four
// 64-query tiles of L 197; longer heads in rounds of four).  K and V
// stream in 64-key tiles by TMA (the bf16 paths' 4-D tensor maps at 4-byte
// elements: a 128-byte swizzle row holds 32 f32, so a tile lands as two
// atom columns of 32) into one landing buffer.  `.tf32` wgmma has no
// transpose bit, so both operands are K-major: K as it lands (d
// contiguous), V only through a transpose.  Per key tile the block splits
// K into hi and lo and V into the hi and lo of V^T (keys contiguous, and
// permuted inside each 8 to the order in which the score accumulator hands
// a thread its keys: 2t, 2t + 1 where a k8 A fragment takes t, t + 4), and
// the landing buffer takes the next tile at once; the split is paid once
// per key tile for every query tile of the round.  Each warpgroup splits
// its Q tile in place once per round; S = Q . K^T is wgmma m64n64k8 with
// both operands from shared memory, O += E . V takes E's hi and lo from
// registers.  Shared memory: 4 x 32 KB of Q, 64 KB of split tile, 32 KB of
// landing buffer: 224 KB, one block an SM.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SHORT_MAX_L = 256;   // longest sequence of the whole-row paths
constexpr int HD = 64;             // head dimension of the bf16 path
constexpr int ROW_BYTES = HD * 2;  // one head row: 128 bytes, the swizzle span
constexpr int QT = 64;             // query rows per tile (the wgmma M)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;   // the SM's 227 KB
constexpr int FQT = 32;            // query rows per block, f32 path
constexpr int FTHREADS = 256;

struct Strides {
  long long b, l, h;  // element strides of batch, sequence and head
};

struct Shape {
  int heads, L, l_valid, causal, pairs, stages, qtiles;
  float scale;
  long long osb, osl, osh;  // output element strides
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
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

// ---- wgmma

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
// groups 1024 bytes apart (SBO), layout type 1 (128B swizzle).  One
// descriptor serves the K-major Q and K and the MN-major V.  A 16-deep step
// along d advances the start by 32 bytes (2 units) inside the swizzle atom.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_bf16_ss_n16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
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

__device__ __forceinline__ void wgmma_bf16_ss_n80(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_ss_n208(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %106, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, %104, %105, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_bf16_ss_n256(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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


// S = Q . K^T over all 16 KT keys: one wgmma m64nNk16 (N = 16 KT) per
// 16-deep step of d.  One instruction per step keeps the compiler from
// serializing them (it does when several accumulator pieces interleave),
// and no key tile is skipped (a wgmma under a runtime branch is serialized
// too); the products cost far less than the bound.
template <int KT>
__device__ __forceinline__ void scores(float* s, uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    if constexpr (KT == 1)
      wgmma_bf16_ss_n16(s, dq + 2 * kk, dk + 2 * kk, kk);
    else if constexpr (KT == 2)
      wgmma_bf16_ss_n32(s, dq + 2 * kk, dk + 2 * kk, kk);
    else if constexpr (KT == 5)
      wgmma_bf16_ss_n80(s, dq + 2 * kk, dk + 2 * kk, kk);
    else if constexpr (KT == 8)
      wgmma_bf16_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk);
    else if constexpr (KT == 13)
      wgmma_bf16_ss_n208(s, dq + 2 * kk, dk + 2 * kk, kk);
    else
      wgmma_bf16_ss_n256(s, dq + 2 * kk, dk + 2 * kk, kk);
  }
}

// e / sum, correctly rounded, from inv = RN(1 / sum) (Markstein)
__device__ __forceinline__ float quot(float e, float sum, float inv) {
  const float q = __fmul_rn(e, inv);
  return fmaf(fmaf(-sum, q, e), inv, q);
}

// One 64-row query tile [q0, q0 + 64) of a staged head, by one warpgroup.
// Thread (warp w, lane 4g + t) holds rows q0 + 16w + g and + 8; in each
// 16-key tile j its scores s[8j .. 8j + 7] are keys 16j + 2t + {0, 1}
// (rows g: 0-1, g + 8: 2-3) and 16j + 8 + 2t + {0, 1} (4-5, 6-7).
template <int KT>
__device__ __forceinline__ void attend_tile(uint32_t q_addr, uint32_t k_addr, uint32_t v_addr,
                                            __nv_bfloat16* __restrict__ out_bh, const Shape& sh,
                                            int q0, int warp) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int L = sh.L, lv = min(sh.l_valid, L);
  const bool causal = sh.causal != 0;

  float s[KT * 8];
  wg_fence();
  scores<KT>(s, desc_sw128(q_addr), desc_sw128(k_addr));
  wg_commit();
  wg_wait_all();
  reg_fence<KT * 8>(s);

  // A warp whose 16 rows all lie past L sees no key: its p is all 0.
  const int r_lo = q0 + warp * 16;
  const int ra = r_lo + g, rb = ra + 8;
  const bool live = r_lo < L;
  const int kmax = !live ? 0 : causal ? min(lv, r_lo + 16) : lv;  // keys any row sees
  const int kfull = !live ? 0 : causal ? min(lv, r_lo + 1) : lv;  // keys every row sees
  uint32_t p[KT][4];
  {
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j * 16 >= kmax) continue;
      float* sj = s + 8 * j;
      if (j * 16 + 16 <= kfull) {
#pragma unroll
        for (int e = 0; e < 8; ++e) sj[e] = __fmul_rn(sj[e], sh.scale);
      } else {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 16 + c * 8 + 2 * t + e;
            const bool ka = col < lv && (!causal || col <= ra);
            const bool kb = col < lv && (!causal || col <= rb);
            sj[4 * c + e] = ka ? __fmul_rn(sj[4 * c + e], sh.scale) : -INFINITY;
            sj[4 * c + 2 + e] = kb ? __fmul_rn(sj[4 * c + 2 + e], sh.scale) : -INFINITY;
          }
      }
      ma = fmaxf(ma, fmaxf(fmaxf(sj[0], sj[1]), fmaxf(sj[4], sj[5])));
      mb = fmaxf(mb, fmaxf(fmaxf(sj[2], sj[3]), fmaxf(sj[6], sj[7])));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    // every row sees key 0, so its max is finite
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j * 16 >= kmax) continue;
      float* sj = s + 8 * j;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sj[4 * c + e] = expf(sj[4 * c + e] - ma);
          sj[4 * c + 2 + e] = expf(sj[4 * c + 2 + e] - mb);
          sa += sj[4 * c + e];
          sb += sj[4 * c + 2 + e];
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    const float ia = __frcp_rn(sa), ib = __frcp_rn(sb);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float* sj = s + 8 * j;
      if (j * 16 >= kmax) {  // every key masked: p is exactly 0
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0u;
        continue;
      }
      p[j][0] = pack_bf16(quot(sj[0], sa, ia), quot(sj[1], sa, ia));
      p[j][1] = pack_bf16(quot(sj[2], sb, ib), quot(sj[3], sb, ib));
      p[j][2] = pack_bf16(quot(sj[4], sa, ia), quot(sj[5], sa, ia));
      p[j][3] = pack_bf16(quot(sj[6], sb, ib), quot(sj[7], sb, ib));
    }
  }

  // ---- out = p . v
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  reg_fence<32>(o);
  reg_fence<4 * KT>(&p[0][0]);
  wg_fence();
#pragma unroll
  for (int j = 0; j < KT; ++j)
    wgmma_bf16_rs_n64_tb(o, p[j], desc_sw128(v_addr + j * 16 * ROW_BYTES), 1);
  wg_commit();
  wg_wait_all();
  reg_fence<32>(o);

  // ---- store the rows that exist: chunk c holds columns 8c + 2t, + 1
  if (live) {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      if (ra < L)
        *reinterpret_cast<uint32_t*>(out_bh + ra * sh.osl + c * 8 + 2 * t) =
            pack_bf16(o[4 * c], o[4 * c + 1]);
      if (rb < L)
        *reinterpret_cast<uint32_t*>(out_bh + rb * sh.osl + c * 8 + 2 * t) =
            pack_bf16(o[4 * c + 2], o[4 * c + 3]);
    }
  }
}

// Start the three loads of pair `pr` into the stage at `st`, completing on
// the mbarrier `fb` (one thread).
__device__ __forceinline__ void load_head(const CUtensorMap* mq, const CUtensorMap* mk,
                                          const CUtensorMap* mv, uint32_t st, uint32_t fb,
                                          uint32_t kv_bytes, uint32_t stage_bytes, int pr,
                                          int heads) {
  const int b = pr / heads, h = pr % heads;
  mbar_expect_tx(fb, stage_bytes);
  tma_load_4d(st, mk, fb, 0, h, 0, b);
  tma_load_4d(st + kv_bytes, mv, fb, 0, h, 0, b);
  tma_load_4d(st + 2 * kv_bytes, mq, fb, 0, h, 0, b);
}

// Warpgroups per block and blocks per SM, as the registers of a whole
// score row allow: short rows take 2 or 3 blocks of 2 warpgroups; the 128-
// and 208-key rows fit 3 warpgroups in one block (168 registers); the
// 256-key row, 2.
template <int KT>
struct Config {
  static constexpr int nwg = (KT == 8 || KT == 13) ? 3 : 2;
  static constexpr int threads = nwg * 128;
  static constexpr int per_sm = KT <= 2 ? 3 : (KT <= 5 ? 2 : 1);
};

// Persistent: block i takes the (batch, head) pairs i, i + gridDim.x, ...
// Stage layout: K [16 KT rows], V [16 KT rows], Q [qtiles x 64 rows], each
// row 128 bytes, swizzled; every part starts on a 1024-byte boundary.
// Every warpgroup waits for a stage's `full` mbarrier; each then runs its
// query tiles, syncs its own 128 threads, and counts itself done on the
// stage; the last to finish refills the stage with the pair `stages`
// further on.  Warpgroup and warp indices are broadcast from lane 0, so the
// compiler sees them uniform and keeps the wgmma's asynchronous.
template <int KT>
__global__ void __launch_bounds__(Config<KT>::threads, Config<KT>::per_sm)
attn_bf16_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
                 Shape sh) {
  constexpr uint32_t KV_BYTES = 16 * KT * ROW_BYTES;
  constexpr int NWG = Config<KT>::nwg;
  const uint32_t stage_bytes = 2 * KV_BYTES + sh.qtiles * QT * ROW_BYTES;
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ int done[MAX_STAGES];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  if (threadIdx.x == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0, pr = blockIdx.x; s < sh.stages && pr < sh.pairs; ++s, pr += gridDim.x)
      load_head(&mq, &mk, &mv, base + s * stage_bytes, smem_u32(&full[s]), KV_BYTES,
                stage_bytes, pr, sh.heads);
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, ((int)threadIdx.x / 32) & 3, 0);
  int n = 0;
  for (int pr = blockIdx.x; pr < sh.pairs; pr += gridDim.x, ++n) {
    const int s = n % sh.stages, use = n / sh.stages;
    mbar_wait(smem_u32(&full[s]), use & 1);
    const uint32_t st = base + s * stage_bytes;
    const int b = pr / sh.heads, h = pr % sh.heads;
    __nv_bfloat16* out_bh = out + b * sh.osb + h * sh.osh;
    // tile tq of the block's n-th pair belongs to warpgroup (n + tq) % NWG
    for (int tq = ((wg - n) % NWG + NWG) % NWG; tq < sh.qtiles; tq += NWG)
      attend_tile<KT>(st + 2 * KV_BYTES + tq * QT * ROW_BYTES, st, st + KV_BYTES, out_bh, sh,
                      tq * QT, warp);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((threadIdx.x & 127) == 0 && atomicAdd(&done[s], 1) == NWG - 1) {
      done[s] = 0;
      const int next = pr + sh.stages * gridDim.x;
      if (next < sh.pairs)
        load_head(&mq, &mk, &mv, st, smem_u32(&full[s]), KV_BYTES, stage_bytes, next,
                  sh.heads);
    }
  }
}

// ---- the bf16 long path: L > 256, head_dim 64, on wgmma fed by TMA

constexpr int LT = 64;                        // keys per key tile, rows per query tile
constexpr int LNWG = 2;                       // warpgroups per block
constexpr int TILE_BYTES = LT * ROW_BYTES;    // one 64-row tile of Q, K or V: 8 KB

struct LongShape {
  // chunk: key tiles the buffers hold; resident: chunk covers every key
  // tile a row sees.  Passed, not derived in the kernel: a derived flag
  // holds a register, and at the 128-register cap that read 5% slower.
  int heads, L, l_valid, causal, qtiles, chunk, resident;
  float scale;
  long long osb, osl, osh;  // output element strides
};

// The scaled scores of one 64-key tile starting at key k0, keys a row may
// not see set to -inf.  Thread (lane 4g + t) holds rows ra = q0 + 16 warp
// + g (s[4c], s[4c + 1]) and rb = ra + 8 (s[4c + 2], s[4c + 3]) at keys
// k0 + 8c + 2t + {0, 1}, c = 0..7.  Masks only where the tile reaches past
// kfull, the keys every row of the warp sees.
__device__ __forceinline__ void scale_mask64(float* s, int k0, int kfull, int lv, bool causal,
                                             int ra, int rb, int t, float scale) {
  if (k0 + LT <= kfull) {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = __fmul_rn(s[e], scale);
    return;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + c * 8 + 2 * t + e;
      const bool ka = col < lv && (!causal || col <= ra);
      const bool kb = col < lv && (!causal || col <= rb);
      s[4 * c + e] = ka ? __fmul_rn(s[4 * c + e], scale) : -INFINITY;
      s[4 * c + 2 + e] = kb ? __fmul_rn(s[4 * c + 2 + e], scale) : -INFINITY;
    }
}

// S = Q . K_j^T for one 64-key tile: one wgmma m64n64k16 per 16-deep step
__device__ __forceinline__ void scores64(float* s, uint64_t dq, uint64_t dk) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_bf16_ss_n64(s, dq + 2 * kk, dk + 2 * kk, kk);
  wg_commit();
  wg_wait_all();
  reg_fence<32>(s);
}

// (m, sum) of two partial softmax states, m the larger max; a state with
// m = -inf (no key seen yet) has sum 0 and adds nothing
__device__ __forceinline__ void merge_state(float& m, float& sum, float m2, float sum2) {
  const float mn = fmaxf(m, m2);
  const float ms = mn == -INFINITY ? 0.f : mn;
  sum = sum * expf(m - ms) + sum2 * expf(m2 - ms);
  m = mn;
}

// Start the loads of key tiles [c0, c0 + n) of pair (b, h) into the
// block's K (and V) slots, completing on `bar` (one thread).
__device__ __forceinline__ void load_kv(const CUtensorMap* mk, const CUtensorMap* mv,
                                        uint32_t kbuf, uint32_t vbuf, uint32_t bar, int c0,
                                        int n, bool with_v, int b, int h) {
  mbar_expect_tx(bar, (uint32_t)n * TILE_BYTES * (with_v ? 2u : 1u));
  for (int i = 0; i < n; ++i) {
    tma_load_4d(kbuf + i * TILE_BYTES, mk, bar, 0, h, (c0 + i) * LT, b);
    if (with_v) tma_load_4d(vbuf + i * TILE_BYTES, mv, bar, 0, h, (c0 + i) * LT, b);
  }
}

// One block per (batch, head) pair, LNWG warpgroups.  Shared memory, all
// dynamic (no static part, so no alignment pad: at L 325 two blocks fit an
// SM): a Q tile per warpgroup, then `chunk` K tiles and `chunk` V tiles,
// each 8 KB on a 1024-byte boundary, 128-byte swizzled as TMA writes them
// (64-row tiles laid end to end are one swizzled [rows, 64] operand), then
// the mbarriers.  Resident: the head's key tiles all fit (chunk = the key
// tiles any row sees), so K and V arrive once and every query tile reads
// them.  Else the keys come
// in chunks of `chunk` tiles, reloaded for each sweep of each round of
// LNWG query tiles, the block synchronised around each load.  Warpgroup
// w takes query tiles w, w + LNWG, ...; for its tile it sweeps the key
// tiles twice, recomputing S = Q . K_j^T each time (same instructions,
// same bits):
//   A: row max and row sum, online per thread over its 16 keys of a tile
//      (the sum rescaled when the max moves), merged over the row's four
//      threads at the end;
//   B: p = quot(exp(s - max), sum) rounded to bf16 in the registers that
//      held the scores (a 16-key piece of the accumulator is a 16-deep A
//      operand), then O += P . V_j (wgmma, V an MN-major B).
// Key tiles past what the query tile sees (l_valid, the diagonal) are not
// visited: the loop bounds are uniform in the warpgroup, and no wgmma sits
// under a branch.  Key tiles run in order, so runs repeat their bits.
__global__ void __launch_bounds__(LNWG * 128, 2)
attn_long_bf16_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ out,
                      LongShape sh) {
  // no static shared memory precedes it, so the dynamic part starts the
  // block's window, on a 1024-byte boundary (checked; declaring the
  // alignment would pad the static part of every kernel of this file)
  extern __shared__ unsigned char lsm_raw[];
  const uint32_t base = smem_u32(lsm_raw);
  if (base & 1023u) __trap();
  const uint32_t kbuf = base + LNWG * TILE_BYTES;
  const uint32_t vbuf = kbuf + sh.chunk * TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(lsm_raw + (LNWG + 2 * sh.chunk) * TILE_BYTES);
  uint64_t& kv_bar = bars[0];
  uint64_t* q_bar = bars + 1;

  const int b = blockIdx.x / sh.heads, h = blockIdx.x % sh.heads;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, ((int)threadIdx.x / 32) & 3, 0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool elected = (threadIdx.x & 127) == 0;
  const uint32_t qbuf = base + wg * TILE_BYTES;
  const uint32_t qb = smem_u32(&q_bar[wg]), kvb = smem_u32(&kv_bar);
  const int L = sh.L, lv = min(sh.l_valid, L);
  const bool causal = sh.causal != 0;
  const int kt_all = (lv + LT - 1) / LT;  // key tiles any row sees

  if (threadIdx.x == 0) {
    mbar_init(kvb, 1);
    for (int i = 0; i < LNWG; ++i) mbar_init(smem_u32(&q_bar[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (sh.resident) load_kv(&mk, &mv, kbuf, vbuf, kvb, 0, kt_all, true, b, h);
  }
  __syncthreads();
  uint32_t kv_phase = 0;
  if (sh.resident) {
    mbar_wait(kvb, 0);
    kv_phase = 1;
  }
  __nv_bfloat16* out_bh = out + b * sh.osb + h * sh.osh;
  const int rounds = (sh.qtiles + LNWG - 1) / LNWG;

  for (int r = 0; r < rounds; ++r) {
    const int tq = r * LNWG + wg;
    const bool has = tq < sh.qtiles;
    const int q0 = tq * LT;
    if (r > 0) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // Q read by all
    if (has && elected) {
      mbar_expect_tx(qb, TILE_BYTES);
      tma_load_4d(qbuf, &mq, qb, 0, h, q0, b);
    }
    // key tiles this query tile sees, and the most any tile of the round sees
    const int my_nt = !has ? 0 : causal ? (min(lv, q0 + LT) + LT - 1) / LT : kt_all;
    const int last_q0 = (min((r + 1) * LNWG, sh.qtiles) - 1) * LT;
    const int round_nt = causal ? (min(lv, last_q0 + LT) + LT - 1) / LT : kt_all;
    // this warp's rows: a warp whose 16 rows all lie past L sees no key
    const int r_lo = q0 + warp * 16;
    const int ra = r_lo + g, rb = ra + 8;
    const bool live = has && r_lo < L;
    const int kmax = !live ? 0 : causal ? min(lv, r_lo + 16) : lv;  // keys any row sees
    const int kfull = !live ? 0 : causal ? min(lv, r_lo + 1) : lv;  // keys every row sees
    if (has) mbar_wait(qb, r & 1);
    const uint64_t dq = desc_sw128(qbuf);

    // ---- sweep A: row max and row sum
    float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f;
    for (int c0 = 0; c0 < round_nt; c0 += sh.chunk) {
      if (!sh.resident) {
        __syncthreads();  // every warpgroup is done with the last chunk
        if (threadIdx.x == 0)
          load_kv(&mk, &mv, kbuf, vbuf, kvb, c0, min(sh.chunk, round_nt - c0), false, b, h);
        mbar_wait(kvb, kv_phase & 1);
        ++kv_phase;
      }
      const int jend = min(c0 + sh.chunk, my_nt);
      for (int j = c0; j < jend; ++j) {
        float s[32];
        scores64(s, dq, desc_sw128(kbuf + (j - c0) * TILE_BYTES));
        if (j * LT >= kmax) continue;
        scale_mask64(s, j * LT, kfull, lv, causal, ra, rb, t, sh.scale);
        float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ta = fmaxf(ta, fmaxf(s[4 * c], s[4 * c + 1]));
          tb = fmaxf(tb, fmaxf(s[4 * c + 2], s[4 * c + 3]));
        }
        const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
        const float za = na == -INFINITY ? 0.f : na, zb = nb == -INFINITY ? 0.f : nb;
        float ea = 0.f, eb = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          ea += expf(s[4 * c] - za) + expf(s[4 * c + 1] - za);
          eb += expf(s[4 * c + 2] - zb) + expf(s[4 * c + 3] - zb);
        }
        sa = sa * expf(ma - za) + ea;
        sb = sb * expf(mb - zb) + eb;
        ma = na;
        mb = nb;
      }
    }
    if (live) {  // the row's four threads; every row sees key 0, so its max is finite
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        merge_state(ma, sa, __shfl_xor_sync(0xffffffffu, ma, off),
                    __shfl_xor_sync(0xffffffffu, sa, off));
        merge_state(mb, sb, __shfl_xor_sync(0xffffffffu, mb, off),
                    __shfl_xor_sync(0xffffffffu, sb, off));
      }
    }
    const float ia = __frcp_rn(sa), ib = __frcp_rn(sb);

    // ---- sweep B: p = e / sum in bf16, O += P . V_j.  O is never written
    // by other instructions (the first product overwrites it), or ptxas
    // serializes the wgmma (C7514).
    float o[32];
    for (int c0 = 0; c0 < round_nt; c0 += sh.chunk) {
      if (!sh.resident) {
        __syncthreads();
        if (threadIdx.x == 0)
          load_kv(&mk, &mv, kbuf, vbuf, kvb, c0, min(sh.chunk, round_nt - c0), true, b, h);
        mbar_wait(kvb, kv_phase & 1);
        ++kv_phase;
      }
      const int jend = min(c0 + sh.chunk, my_nt);
      for (int j = c0; j < jend; ++j) {
        float s[32];
        scores64(s, dq, desc_sw128(kbuf + (j - c0) * TILE_BYTES));
        uint32_t p[4][4];
        if (j * LT < kmax) {
          scale_mask64(s, j * LT, kfull, lv, causal, ra, rb, t, sh.scale);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float* sj = s + 8 * jj;
            p[jj][0] = pack_bf16(quot(expf(sj[0] - ma), sa, ia), quot(expf(sj[1] - ma), sa, ia));
            p[jj][1] = pack_bf16(quot(expf(sj[2] - mb), sb, ib), quot(expf(sj[3] - mb), sb, ib));
            p[jj][2] = pack_bf16(quot(expf(sj[4] - ma), sa, ia), quot(expf(sj[5] - ma), sa, ia));
            p[jj][3] = pack_bf16(quot(expf(sj[6] - mb), sb, ib), quot(expf(sj[7] - mb), sb, ib));
          }
        } else {  // every key masked for this warp: p is exactly 0
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) p[jj][0] = p[jj][1] = p[jj][2] = p[jj][3] = 0u;
        }
        const uint32_t v_addr = vbuf + (j - c0) * TILE_BYTES;
        reg_fence<16>(&p[0][0]);
        wg_fence();
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          wgmma_bf16_rs_n64_tb(o, p[jj], desc_sw128(v_addr + jj * 16 * ROW_BYTES),
                               (j | jj) != 0);
        wg_commit();
        wg_wait_all();
        reg_fence<32>(o);
      }
    }

    // ---- store the rows that exist: chunk c holds columns 8c + 2t, + 1
    if (live) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        if (ra < L)
          *reinterpret_cast<uint32_t*>(out_bh + ra * sh.osl + c * 8 + 2 * t) =
              pack_bf16(o[4 * c], o[4 * c + 1]);
        if (rb < L)
          *reinterpret_cast<uint32_t*>(out_bh + rb * sh.osl + c * 8 + 2 * t) =
              pack_bf16(o[4 * c + 2], o[4 * c + 3]);
      }
    }
  }
}

// ---- the f32 path at head_dim 64, any L: three TF32 passes on wgmma fed by TMA

constexpr int F_ROW = 128;          // bytes of a 32-wide f32 atom row: the swizzle span
constexpr int F_HALF = LT * F_ROW;  // a [64 rows][32] f32 atom column: 8 KB
constexpr int F_TILE = 2 * F_HALF;  // a [64 rows][64] f32 tile as two atom columns: 16 KB
constexpr int FWG = 4;              // warpgroups a block: the 4 query tiles of L 197 at once
constexpr int F_SMEM = 1024 + (2 * FWG + 6) * F_TILE + 64;  // pad, Q, split tile, landing, bars

struct F32Shape {
  int heads, L, l_valid, causal, qtiles;
  float scale;
  long long osb, osl, osh;  // output element strides
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero (cvt.rna.tf32.f32), in f32 bits with the low 13 bits clear
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mbar_wait that traps after 10 s (a load that never lands): the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait_trap(uint32_t bar, uint32_t parity) {
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

// shared-memory writes of the generic proxy made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
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

// A [64 rows][64] f32 tile as TMA lands it (two swizzled atom columns) ->
// the tf32 hi and lo of its transpose, [64][64 rows] K-major over the rows
// (two atom columns of 32 rows, F_HALF apart), the rows permuted inside
// each 8: column 8c + j holds row 8c + 2j (j < 4) or 8c + 2j - 7 (j >= 4),
// the order in which a wgmma accumulator hands a thread its keys (2t and
// 2t + 1 where a k8 A fragment takes t and t + 4).  A sum over the rows
// does not see the order.  Lanes take consecutive output rows: reads of
// one source row hit 32 banks, writes fill 4 wavefronts.
__device__ __forceinline__ void split_t64(const unsigned char* raw, unsigned char* hi,
                                          unsigned char* lo, int tid, int nthr) {
  for (int i = tid; i < 16 * LT; i += nthr) {
    const int d = i & 63, q4 = i >> 6;           // output row d, float4 column q4
    const int r0 = 8 * (q4 >> 1) + (q4 & 1);     // source rows r0, + 2, + 4, + 6
    const unsigned char* col = raw + (d >> 5) * F_HALF + (d & 3) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 2 * e;
      v[e] = *reinterpret_cast<const float*>(col + r * F_ROW + ((((d & 31) >> 2) ^ (r & 7)) << 4));
    }
    const float4 h = make_float4(tf32_rna(v[0]), tf32_rna(v[1]), tf32_rna(v[2]), tf32_rna(v[3]));
    const float4 l = make_float4(tf32_rna(v[0] - h.x), tf32_rna(v[1] - h.y),
                                 tf32_rna(v[2] - h.z), tf32_rna(v[3] - h.w));
    const int off = (q4 >> 3) * F_HALF + d * F_ROW + (((q4 & 7) ^ (d & 7)) << 4);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// Rows [row0, row0 + 64) of (b, h) of an f32 [B, L, H, 64] view into a tile
// at dst (two boxes of 32 columns), completing on bar (one thread)
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const CUtensorMap* m, uint32_t bar,
                                              int row0, int b, int h) {
  tma_load_4d(dst, m, bar, 0, h, row0, b);
  tma_load_4d(dst + F_HALF, m, bar, 32, h, row0, b);
}

// One key tile of one 64-row query tile, by its warpgroup, online:
//   S = Q . K^T: wgmma m64n64k8 .tf32, Q and K K-major from shared memory,
//     q_lo.k_hi and q_hi.k_lo over the eight k8 steps, then q_hi.k_hi;
//   scale, mask, the new row max over the row's four threads, O and the
//     row sums rescaled by exp(old - new), e = exp(s - max) in the score
//     registers, the sums taken per thread;
//   O += E . V in F_PV_GROUPS groups of keys: e split into tf32 hi and lo
//     (keys 2t, 2t + 1 of each 8 as the A fragment's t, t + 4), wgmma with
//     A from registers and V^T (keys permuted to match) K-major from
//     shared memory: e_lo.v_hi, e_hi.v_lo, then e_hi.v_hi; each group
//     waited before the next one's fragments take its registers.
// A warp whose 16 rows all lie past L feeds e = 0 and skips the softmax.
// The shared-memory addresses pass through an empty asm first, so the
// descriptors are formed where they are used, not held across the key
// loop in registers.
constexpr int F_PV_GROUPS = 2;  // one group spills at the 128-register cap of four warpgroups
__device__ __forceinline__ void attend_f32_tile(float* o, float& ma, float& mb, float& la,
                                                float& lb, uint32_t qhi, uint32_t khi, uint32_t vthi,
                                                int k0, int kfull, int lv, bool causal, bool live,
                                                int ra, int rb, int t, float scale) {
  asm volatile("" : "+r"(qhi), "+r"(khi), "+r"(vthi));
  const uint32_t qlo = qhi + F_TILE, klo = khi + F_TILE, vtlo = vthi + F_TILE;
  float s[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n64(s, desc_sw128(qlo + kstep(kk, F_HALF)), desc_sw128(khi + kstep(kk, F_HALF)),
                      kk);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n64(s, desc_sw128(qhi + kstep(kk, F_HALF)), desc_sw128(klo + kstep(kk, F_HALF)),
                      1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_tf32_ss_n64(s, desc_sw128(qhi + kstep(kk, F_HALF)), desc_sw128(khi + kstep(kk, F_HALF)),
                      1);
  wg_commit();
  wg_wait_all();
  acc_fence<32>(s);

  if (live) {
    scale_mask64(s, k0, kfull, lv, causal, ra, rb, t, scale);
    float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      ta = fmaxf(ta, fmaxf(s[4 * c], s[4 * c + 1]));
      tb = fmaxf(tb, fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, off));
      tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, off));
    }
    // finite: the first key tile holds key 0, which every row sees
    const float na = fmaxf(ma, ta), nb = fmaxf(mb, tb);
    const float ca = __expf(ma - na), cb = __expf(mb - nb);
    ma = na;
    mb = nb;
    float ea = 0.f, eb = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c] = __expf(s[4 * c] - na);
      s[4 * c + 1] = __expf(s[4 * c + 1] - na);
      s[4 * c + 2] = __expf(s[4 * c + 2] - nb);
      s[4 * c + 3] = __expf(s[4 * c + 3] - nb);
      ea += s[4 * c] + s[4 * c + 1];
      eb += s[4 * c + 2] + s[4 * c + 3];
    }
    la = la * ca + ea;
    lb = lb * cb + eb;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      o[4 * c] *= ca;
      o[4 * c + 1] *= ca;
      o[4 * c + 2] *= cb;
      o[4 * c + 3] *= cb;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
  }

  constexpr int NC = 8 / F_PV_GROUPS;  // k8 chunks of keys a group
#pragma unroll
  for (int grp = 0; grp < F_PV_GROUPS; ++grp) {
    uint32_t ph[NC][4], pl[NC][4];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float* e = s + 4 * (grp * NC + i);
      const float v[4] = {e[0], e[2], e[1], e[3]};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float hv = tf32_rna(v[x]);
        ph[i][x] = __float_as_uint(hv);
        pl[i][x] = __float_as_uint(tf32_rna(v[x] - hv));
      }
    }
    acc_fence<32>(o);
    reg_fence<4 * NC>(&ph[0][0]);
    reg_fence<4 * NC>(&pl[0][0]);
    wg_fence();
#pragma unroll
    for (int i = 0; i < NC; ++i)
      wgmma_tf32_rs_n64(o, pl[i], desc_sw128(vthi + kstep(grp * NC + i, F_HALF)), 1);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      wgmma_tf32_rs_n64(o, ph[i], desc_sw128(vtlo + kstep(grp * NC + i, F_HALF)), 1);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      wgmma_tf32_rs_n64(o, ph[i], desc_sw128(vthi + kstep(grp * NC + i, F_HALF)), 1);
    wg_commit();
    wg_wait_all();
    acc_fence<32>(o);
  }
}

// One block per (batch, head) pair, FWG warpgroups.  Shared memory (after a
// pad to a 1024-byte boundary): per warpgroup its Q tile's tf32 hi and lo
// (16 KB each), then one split key tile (K hi, K lo, V^T hi, V^T lo), then
// the landing buffer of one raw K and V tile (32 KB), then the mbarriers.
// Warpgroup w takes query tiles w, w + FWG, ... one round at a time (L <=
// 256: one round); per round it loads its Q tile by TMA and splits it in
// place.  Per key tile of the round (those its last query tile sees): the
// block waits for the landing buffer, splits K into hi and lo and V into
// the hi and lo of its transpose (all threads), and the landing buffer is
// refilled with the next key tile at once, so the load runs under the
// products; each warpgroup then runs attend_f32_tile on its query tile.
// The split is paid once per key tile per round, whatever the number of
// query tiles that read it.  At the end of a round each row's output is
// o / sum (IEEE division), stored where the row exists.  Key tiles run in
// order, so runs repeat their bits.
__global__ void __launch_bounds__(FWG * 128, 1)
attn_f32_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, float* __restrict__ out,
                      F32Shape sh) {
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* sm = fsm_raw + ((1024u - (smem_u32(fsm_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t split = base + 2 * FWG * F_TILE;  // K hi, K lo, V^T hi, V^T lo
  const uint32_t land = split + 4 * F_TILE;        // raw K, raw V
  unsigned char* split_p = sm + 2 * FWG * F_TILE;
  unsigned char* land_p = split_p + 4 * F_TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(land_p + 2 * F_TILE);  // [0] landing, [1 + w] Q

  const int b = blockIdx.x / sh.heads, h = blockIdx.x % sh.heads;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, (tid / 32) & 3, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int L = sh.L, lv = min(sh.l_valid, L);
  const bool causal = sh.causal != 0;
  const int rounds = (sh.qtiles + FWG - 1) / FWG;
  const uint32_t land_bar = smem_u32(&bars[0]), q_bar = smem_u32(&bars[1 + wg]);
  const uint32_t qhi = base + wg * 2 * F_TILE;
  float4* qhi_p = reinterpret_cast<float4*>(sm + wg * 2 * F_TILE);

  // the key tiles round r streams: those its last query tile sees
  auto round_tiles = [&](int r) {
    const int last_q0 = (min((r + 1) * FWG, sh.qtiles) - 1) * LT;
    return ((causal ? min(lv, last_q0 + LT) : lv) + LT - 1) / LT;
  };
  // thread 0's cursor: the next (round, key tile) to land
  int ld_r = 0, ld_j = 0;
  auto land_next = [&]() {
    if (ld_r >= rounds) return;
    mbar_expect_tx(land_bar, 2 * F_TILE);
    load_tile_f32(land, &mk, land_bar, ld_j * LT, b, h);
    load_tile_f32(land + F_TILE, &mv, land_bar, ld_j * LT, b, h);
    if (++ld_j == round_tiles(ld_r)) {
      ld_j = 0;
      ++ld_r;
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= FWG; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    land_next();
  }
  __syncthreads();

  float* out_bh = out + b * sh.osb + h * sh.osh;
  int item = 0;  // key tiles landed so far: the landing buffer's phase
  for (int r = 0; r < rounds; ++r) {
    const int tq = r * FWG + wg;
    const bool has = tq < sh.qtiles;  // uniform in the warpgroup
    const int q0 = tq * LT;
    if (has) {
      if (r > 0) asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // Q read by all
      if ((tid & 127) == 0) {
        mbar_expect_tx(q_bar, F_TILE);
        load_tile_f32(qhi, &mq, q_bar, q0, b, h);
      }
      mbar_wait_trap(q_bar, r & 1);
      split_flat(qhi_p, qhi_p, qhi_p + F_TILE / 16, F_TILE / 16, tid & 127, 128);
      fence_async_smem();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    // this warp's rows: a warp whose 16 rows all lie past L sees no key
    const int r_lo = q0 + warp * 16;
    const int ra = r_lo + g, rb = ra + 8;
    const bool live = has && r_lo < L;
    const int kfull = !live ? 0 : causal ? min(lv, r_lo + 1) : lv;  // keys every row sees
    const int my_nt = !has ? 0 : ((causal ? min(lv, q0 + LT) : lv) + LT - 1) / LT;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
    const int nkt = round_tiles(r);
    for (int j = 0; j < nkt; ++j, ++item) {
      __syncthreads();  // every warpgroup is done with the last split tile
      mbar_wait_trap(land_bar, item & 1);
      split_flat(reinterpret_cast<const float4*>(land_p), reinterpret_cast<float4*>(split_p),
                 reinterpret_cast<float4*>(split_p + F_TILE), F_TILE / 16, tid, FWG * 128);
      split_t64(land_p + F_TILE, split_p + 2 * F_TILE, split_p + 3 * F_TILE, tid, FWG * 128);
      fence_async_smem();
      __syncthreads();  // the split tile is whole; the landing buffer is free
      if (tid == 0) land_next();
      if (j < my_nt)
        attend_f32_tile(o, ma, mb, la, lb, qhi, split, split + 2 * F_TILE, j * LT, kfull, lv,
                        causal, live, ra, rb, t, sh.scale);
    }
    if (live) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        la += __shfl_xor_sync(0xffffffffu, la, off);
        lb += __shfl_xor_sync(0xffffffffu, lb, off);
      }
      // chunk c holds columns 8c + 2t, + 1
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        if (ra < L)
          *reinterpret_cast<float2*>(out_bh + ra * sh.osl + c * 8 + 2 * t) =
              make_float2(__fdiv_rn(o[4 * c], la), __fdiv_rn(o[4 * c + 1], la));
        if (rb < L)
          *reinterpret_cast<float2*>(out_bh + rb * sh.osl + c * 8 + 2 * t) =
              make_float2(__fdiv_rn(o[4 * c + 2], lb), __fdiv_rn(o[4 * c + 3], lb));
      }
    }
  }
}

// attn_f32_kernel's shared memory: K, V, the block's Q rows and their
// score rows (ops/attention.py::attention_route counts the same bytes)
constexpr long long f32_short_smem(int L, int hd) {
  return 4LL * (L * (hd + 1) + L * hd + FQT * (hd + 1) + FQT * L);
}

__global__ void __launch_bounds__(FTHREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, Strides sq,
                Strides sk, Strides sv, Strides so, int heads, int L, int hd,
                int l_valid, int causal, float scale, int qtiles) {
  extern __shared__ float fsm[];
  const int ldk = hd + 1;
  float* Ks = fsm;              // [L][hd + 1]
  float* Vs = Ks + L * ldk;     // [L][hd]
  float* Qs = Vs + L * hd;      // [FQT][hd + 1]
  float* Ss = Qs + FQT * ldk;   // [FQT][L]

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * FQT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* qb = q + b * sq.b + h * sq.h;

  for (int i = tid; i < L * hd; i += FTHREADS) {
    const int r = i / hd, c = i % hd;
    Ks[r * ldk + c] = kb[r * sk.l + c];
    Vs[r * hd + c] = vb[r * sv.l + c];
  }
  for (int i = tid; i < FQT * hd; i += FTHREADS) {
    const int r = i / hd, c = i % hd;
    Qs[r * ldk + c] = (q0 + r < L) ? qb[(q0 + r) * sq.l + c] : 0.f;
  }
  __syncthreads();

  const int lv = min(l_valid, L);
  for (int i = tid; i < FQT * L; i += FTHREADS) {
    const int r = i / L, c = i % L;
    float acc = 0.f;
    for (int d = 0; d < hd; ++d) acc = fmaf(Qs[r * ldk + d], Ks[c * ldk + d], acc);
    const bool keep = c < lv && (!causal || c <= q0 + r);
    Ss[i] = keep ? acc * scale : -INFINITY;
  }
  __syncthreads();

  for (int r = warp; r < FQT; r += FTHREADS / 32) {
    float* row = Ss + r * L;
    float m = -INFINITY;
    for (int c = lane; c < L; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int c = lane; c < L; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int c = lane; c < L; c += 32) row[c] = row[c] / sum;
  }
  __syncthreads();

  for (int i = tid; i < FQT * hd; i += FTHREADS) {
    const int r = i / hd, c = i % hd;
    if (q0 + r >= L) continue;
    float acc = 0.f;
    for (int j = 0; j < L; ++j) acc = fmaf(Ss[r * L + j], Vs[j * hd + c], acc);
    out[b * so.b + (q0 + r) * so.l + h * so.h + c] = acc;
  }
}

// ---- the SIMT long path: bf16 at head_dim != 64 at any L, f32 at head_dim != 64 past
// L 256 or whose rows do not fit attn_f32_kernel; head_dim <= 32 * LMAXC

constexpr int LQ = 4;                // query rows per warp
constexpr int LWARPS = 8;
constexpr int LTHREADS = 32 * LWARPS;
constexpr int LROWS = LQ * LWARPS;   // query rows per block
constexpr int LKT = 32;              // keys per tile, one per lane
constexpr int LMAXC = 8;             // output columns per lane: head_dim <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to T's precision and back: p as the p . v product sees it
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The scaled, masked scores of this warp's LQ rows against key k0 + lane
// of the staged tile.  Every sweep computes them by the same instructions,
// so the three sweeps see the same bits.
__device__ __forceinline__ void long_scores(float (&s)[LQ], const float* Qw, const float* Ks,
                                            int hd, int ldk, int lane, int key, int row0, int lv,
                                            bool causal, float scale) {
#pragma unroll
  for (int r = 0; r < LQ; ++r) s[r] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float kd = Ks[lane * ldk + d];
#pragma unroll
    for (int r = 0; r < LQ; ++r) s[r] = fmaf(Qw[r * hd + d], kd, s[r]);
  }
#pragma unroll
  for (int r = 0; r < LQ; ++r) {
    const bool keep = key < lv && (!causal || key <= row0 + r);
    s[r] = keep ? __fmul_rn(s[r], scale) : -INFINITY;
  }
}

template <typename T>
__global__ void __launch_bounds__(LTHREADS, 2)
attn_long_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, Strides sq, Strides sk, Strides sv, Strides so, int heads,
                 int L, int hd, int l_valid, int causal, float scale, int qtiles) {
  extern __shared__ float lsm[];
  const int ldk = hd + 1;           // odd stride: lanes read distinct banks
  float* Qs = lsm;                  // [LROWS][hd]
  float* Ks = Qs + LROWS * hd;      // [LKT][hd + 1]
  float* Vs = Ks + LKT * ldk;       // [LKT][hd]

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * LROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int lv = min(l_valid, L);
  const bool causal_b = causal != 0;
  const int row0 = q0 + warp * LQ;
  const float* Qw = Qs + warp * LQ * hd;
  // keys any row of the block sees: the tile count is uniform in the block
  const int kend = causal_b ? min(lv, q0 + LROWS) : lv;
  const int ntiles = (kend + LKT - 1) / LKT;

  for (int i = tid; i < LROWS * hd; i += LTHREADS) {
    const int r = i / hd, c = i % hd;
    Qs[i] = (q0 + r < L) ? to_f32(qb[(long long)(q0 + r) * sq.l + c]) : 0.f;
  }
  auto stage = [&](int k0, bool with_v) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < LKT * hd; i += LTHREADS) {
      const int r = i / hd, c = i % hd, key = k0 + r;
      Ks[r * ldk + c] = key < L ? to_f32(kb[(long long)key * sk.l + c]) : 0.f;
      if (with_v) Vs[r * hd + c] = key < L ? to_f32(vb[(long long)key * sv.l + c]) : 0.f;
    }
    __syncthreads();
  };

  float m[LQ], sum[LQ], s[LQ];
#pragma unroll
  for (int r = 0; r < LQ; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.f;
  }
  // sweep 1: the row max (every row sees key 0, so it is finite)
  for (int t = 0; t < ntiles; ++t) {
    stage(t * LKT, false);
    long_scores(s, Qw, Ks, hd, ldk, lane, t * LKT + lane, row0, lv, causal_b, scale);
#pragma unroll
    for (int r = 0; r < LQ; ++r) m[r] = fmaxf(m[r], s[r]);
  }
#pragma unroll
  for (int r = 0; r < LQ; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
  // sweep 2: the row sum
  for (int t = 0; t < ntiles; ++t) {
    stage(t * LKT, false);
    long_scores(s, Qw, Ks, hd, ldk, lane, t * LKT + lane, row0, lv, causal_b, scale);
#pragma unroll
    for (int r = 0; r < LQ; ++r) sum[r] += expf(s[r] - m[r]);
  }
#pragma unroll
  for (int r = 0; r < LQ; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
  // sweep 3: p = e / sum, rounded to T, then p . v in f32, keys in order
  float acc[LQ][LMAXC];
#pragma unroll
  for (int r = 0; r < LQ; ++r)
#pragma unroll
    for (int c = 0; c < LMAXC; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    stage(t * LKT, true);
    long_scores(s, Qw, Ks, hd, ldk, lane, t * LKT + lane, row0, lv, causal_b, scale);
    float p[LQ];
#pragma unroll
    for (int r = 0; r < LQ; ++r)
      p[r] = round_to(__fdiv_rn(expf(s[r] - m[r]), sum[r]), static_cast<T*>(nullptr));
    for (int j = 0; j < LKT; ++j) {
      const float* vr = Vs + j * hd;
#pragma unroll
      for (int r = 0; r < LQ; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < LMAXC; ++c)
          if (lane + 32 * c < hd) acc[r][c] = fmaf(pj, vr[lane + 32 * c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < LQ; ++r) {
    if (row0 + r >= L) continue;
    T* orow = out + b * so.b + (long long)(row0 + r) * so.l + h * so.h;
#pragma unroll
    for (int c = 0; c < LMAXC; ++c)
      if (lane + 32 * c < hd) from_f32(orow + lane + 32 * c, acc[r][c]);
  }
}

template <typename T>
int launch_long(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk,
                Strides sv, Strides so, int batch, int heads, int L, int hd, int l_valid,
                int causal, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > 32 * LMAXC) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (LROWS * hd + LKT * (hd + 1) + LKT * hd);
  cudaError_t err = cudaFuncSetAttribute(attn_long_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int qtiles = (L + LROWS - 1) / LROWS;
  const long long blocks = (long long)batch * heads * qtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  attn_long_kernel<T><<<(unsigned)blocks, LTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, sv, so, heads, L, hd, l_valid, causal, scale, qtiles);
  return (int)cudaGetLastError();
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

// A 4-D map over a strided [B, L, H, 64] view, bf16 or (f32) f32: dims (d,
// H, L, B), innermost first, byte strides of H, L and B (a size-1
// dimension gets the stride it would have in a contiguous layout), box of
// one 128-byte swizzle row (64 bf16 or 32 f32) x 1 x rows x 1 with the
// 128-byte swizzle; rows past L read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, Strides st, int batch, int L, int heads,
              int rows, bool f32 = false) {
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
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), 1u, (cuuint32_t)rows, 1u};
  const cuuint32_t elem[4] = {1u, 1u, 1u, 1u};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KT>
int launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                Strides sk, Strides sv, Strides so, int batch, int heads, int L,
                int l_valid, int causal, float scale, cudaStream_t stream) {
  Shape sh{};
  sh.heads = heads;
  sh.L = L;
  sh.l_valid = l_valid;
  sh.causal = causal;
  sh.pairs = batch * heads;
  sh.qtiles = (L + QT - 1) / QT;
  sh.scale = scale;
  sh.osb = so.b;
  sh.osl = so.l;
  sh.osh = so.h;
  const int stage_bytes = (2 * 16 * KT + sh.qtiles * QT) * ROW_BYTES;
  constexpr int per_sm = Config<KT>::per_sm;
  const int room = (SMEM_MAX - per_sm * (1024 + 1024)) / per_sm;  // alignment, statics, reserve
  sh.stages = room / stage_bytes < MAX_STAGES ? room / stage_bytes : MAX_STAGES;
  if (sh.stages < 1) return (int)cudaErrorInvalidValue;
  const int smem = sh.stages * stage_bytes + 1024;  // + the 1024-byte alignment

  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, sq, batch, L, heads, sh.qtiles * QT) ||
      !make_map(&mk, k, sk, batch, L, heads, 16 * KT) ||
      !make_map(&mv, v, sv, batch, L, heads, 16 * KT))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bf16_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = sh.pairs < per_sm * sms ? sh.pairs : per_sm * sms;
  attn_bf16_kernel<KT><<<grid, Config<KT>::threads, smem, stream>>>(mq, mk, mv,
                                                             static_cast<__nv_bfloat16*>(out), sh);
  return (int)cudaGetLastError();
}

// The bf16 long path: one block per (batch, head); the key tiles any row
// sees stay resident when they fit beside the warpgroups' Q tiles (up to
// 13 tiles, L 832), else they stream in chunks of that size.
int launch_long_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                     Strides sk, Strides sv, Strides so, int batch, int heads, int L,
                     int l_valid, int causal, float scale, cudaStream_t stream) {
  LongShape sh{};
  sh.heads = heads;
  sh.L = L;
  sh.l_valid = l_valid;
  sh.causal = causal;
  sh.qtiles = (L + LT - 1) / LT;
  sh.scale = scale;
  sh.osb = so.b;
  sh.osl = so.l;
  sh.osh = so.h;
  const int lv = l_valid < L ? l_valid : L;
  const int ktiles = (lv + LT - 1) / LT;
  // the mbarriers and the Q tiles, then K and V
  const int cap = (SMEM_MAX - 64 - LNWG * TILE_BYTES) / (2 * TILE_BYTES);
  sh.resident = ktiles <= cap;
  sh.chunk = sh.resident ? ktiles : cap;
  const int smem = (LNWG + 2 * sh.chunk) * TILE_BYTES + 64;
  const long long pairs = (long long)batch * heads;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, sq, batch, L, heads, LT) || !make_map(&mk, k, sk, batch, L, heads, LT) ||
      !make_map(&mv, v, sv, batch, L, heads, LT))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_long_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_long_bf16_kernel<<<(unsigned)pairs, LNWG * 128, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), sh);
  return (int)cudaGetLastError();
}

// The f32 path at head_dim 64, any L: one block of FWG warpgroups per
// (batch, head) pair.
int launch_f32_wgmma(const void* q, const void* k, const void* v, void* out, Strides sq,
                     Strides sk, Strides sv, Strides so, int batch, int heads, int L,
                     int l_valid, int causal, float scale, cudaStream_t stream) {
  const F32Shape sh{heads, L, l_valid, causal, (L + LT - 1) / LT, scale, so.b, so.l, so.h};
  const long long pairs = (long long)batch * heads;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, sq, batch, L, heads, LT, true) ||
      !make_map(&mk, k, sk, batch, L, heads, LT, true) ||
      !make_map(&mv, v, sv, batch, L, heads, LT, true))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_f32_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (err != cudaSuccess) return (int)err;
  attn_f32_wgmma_kernel<<<(unsigned)pairs, FWG * 128, F_SMEM, stream>>>(
      mq, mk, mv, static_cast<float*>(out), sh);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [batch, L, heads, hd] with element strides (b, l, h) each and
// the last dimension contiguous; bf16 or f32 (is_bf16), 1 <= l_valid.
// hd == 64 with every stride and base 16-byte aligned: bf16 the wgmma
// path (L <= 256) or the wgmma long path, f32 the three-pass TF32 kernel
// at any L.  Another hd: f32 at L <= 256 any hd whose rows fit in shared
// memory (SIMT, whole rows); else, f32 and bf16 at any L, the SIMT long
// path, hd <= 256.
// Launches on `stream` and returns the CUDA error code
// (cudaErrorInvalidValue for a shape no path takes).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out,
                             int is_bf16, long long qsb, long long qsl, long long qsh,
                             long long ksb, long long ksl, long long ksh, long long vsb,
                             long long vsl, long long vsh, long long osb, long long osl,
                             long long osh, int batch, int heads, int L, int hd, int l_valid,
                             int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || L < 1 || l_valid < 1) return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh}, so{osb, osl, osh};
  if (!is_bf16 && hd == HD)
    return launch_f32_wgmma(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal, scale,
                            stream);
  if (L > SHORT_MAX_L) {
    if (is_bf16 && hd == HD)
      return launch_long_bf16(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                              scale, stream);
    if (is_bf16)
      return launch_long<__nv_bfloat16>(q, k, v, out, sq, sk, sv, so, batch, heads, L, hd,
                                        l_valid, causal, scale, stream);
    return launch_long<float>(q, k, v, out, sq, sk, sv, so, batch, heads, L, hd, l_valid, causal,
                              scale, stream);
  }
  if (is_bf16 && hd != HD)  // the SIMT long kernel at any L
    return launch_long<__nv_bfloat16>(q, k, v, out, sq, sk, sv, so, batch, heads, L, hd, l_valid,
                                      causal, scale, stream);
  if (is_bf16) {
    const int kt = (L + 15) / 16;
    if (kt <= 1)
      return launch_bf16<1>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                            scale, stream);
    if (kt <= 2)
      return launch_bf16<2>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                            scale, stream);
    if (kt <= 5)
      return launch_bf16<5>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                            scale, stream);
    if (kt <= 8)
      return launch_bf16<8>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                            scale, stream);
    if (kt <= 13)
      return launch_bf16<13>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                             scale, stream);
    return launch_bf16<16>(q, k, v, out, sq, sk, sv, so, batch, heads, L, l_valid, causal,
                           scale, stream);
  }
  if (hd < 1) return (int)cudaErrorInvalidValue;
  const long long smem = f32_short_smem(L, hd);
  if (smem > SMEM_MAX)  // the rows do not fit: the key-tiled kernel
    return launch_long<float>(q, k, v, out, sq, sk, sv, so, batch, heads, L, hd, l_valid, causal,
                              scale, stream);
  cudaError_t err = cudaFuncSetAttribute(attn_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qtiles = (L + FQT - 1) / FQT;
  const long long blocks = (long long)batch * heads * qtiles;
  attn_f32_kernel<<<(unsigned)blocks, FTHREADS, (size_t)smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, sv, so, heads, L, hd, l_valid, causal, scale, qtiles);
  return (int)cudaGetLastError();
}
