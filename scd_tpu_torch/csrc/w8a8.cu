// W8A8 dense layer: int8 x @ int8 w with int32 accumulation, then
// acc * s_x * s_w + b, an optional GELU-family activation, and the cast to
// the output type, all in one kernel.
//
// Replaces three TPU kernels of scd_tpu/ops/pallas_kernels.py:
// - dense_w8a8_fusedq_pallas (kernel _w8a8_fusedq_kernel, epilogue
//   _w8a8_act): bf16 x is quantized per row inside the kernel.  Entry point
//   w8a8_fusedq.
// - dense_w8a8_pallas (kernel _w8a8_kernel) and dense_w8a8_pallas_3d
//   (kernel _w8a8_kernel3): x arrives quantized, with its row scales.  Entry
//   point w8a8_prequant.  On the TPU the rank-3 form exists because
//   flattening [B, L, D] at L = 197 costs a relayout copy; here a
//   contiguous [B, L, D] tensor is already the [B*L, D] matrix, so one
//   kernel serves both.
//
// Semantics (models/vit.py::Int8Dense in the JAX package):
//   s_x = max(max_k |x[r, k]|, 1e-12) / 127       (IEEE division)
//   xq  = rint(clamp(x / s_x, -127, 127))          (IEEE division, half to even)
//   y   = ((float(acc) * s_x) * s_w[c]) + b[c]     (each step rounded: no FMA)
//   out = cast(act(y))                             (act at f32, round to nearest)
// The row's absmax spans the whole of D, whatever the column tile.
//
// What bounds it on an H100: operations.  At the image towers' qkv layer
// (N = 26,624 rows of a batch of 128 images at L = 208, D = 768,
// F = 2304) the product is 2*N*D*F = 94.2 G int8 operations (47.6 us at
// the card's 1,979 TOP/s), while the bytes it must move (bf16 x once, int8
// w once, bf16 out once) are ~165 MB (49.1 us at 3.35 TB/s): the two are
// close, and the fused quantization is what keeps the bytes at the bf16
// layer's.
//
// At the unpadded tower's qkv layer through w8a8_prequant (N = 25,216
// rows, L = 197) the product is 89.3 G operations (45.1 us) and the bytes
// 137 MB (int8 x, int8 w, bf16 out: 41.0 us), so operations bound it too.
//
// Design.  Both kernels run on Hopper's TMA, mbarriers and int8 wgmma.
//
// w8a8_prequant (x arrives quantized).  Persistent blocks, one per SM,
// walk the output tiles of 128 rows x 256 columns in row-major tile order,
// so the blocks in flight share a few row panels of xq and all of wq in
// L2.  A block has two consumer warpgroups and a producer warpgroup
// (setmaxnreg 232 / 40):
// - one producer thread streams (A, B) stage pairs with TMA into a ring of
//   four 48 KB stages: xq [128 rows x 128 bytes of D] and wq [256 columns x
//   128 bytes], 2-D maps, K-major, 128-byte swizzle, zeros past N, F and D
//   (a zero tail of D adds 0 to the int32 sums, so any D % 16 == 0 works,
//   D > PANEL_MAX_D included);
// - warpgroup w multiplies rows 64 w .. 64 w + 63 of the tile: four wgmma
//   m64n256k32 s8 x s8 -> s32 per stage, A and B from shared memory,
//   keeping one stage's products in flight while it frees the stage
//   before; the two warpgroups wait on nothing but the ring, so one's
//   epilogue can overlap the other's products;
// - each consumer thread loads its share of the tile's s_x, s_w and bias
//   when the tile starts, while the products run; once they are done the
//   values go to shared memory (one buffer per warpgroup and tile parity,
//   a named barrier per warpgroup), and the epilogue is w8a8_fusedq's
//   without the activation: ((float(acc) * s_x) * s_w) + b, each step
//   rounded, no FMA, then the cast.  The int32 sums are exact in any
//   order, so the output is bit-equal to the plain version's;
// - the output goes out through each warp's staging rows in shared memory,
//   128 bytes of its 16 rows at a time, as 16-byte stores of whole rows:
//   stores straight from the accumulator layout (four threads a row, 4 or
//   8 bytes each, eight rows an instruction) reach ~1.1 TB/s on an H100,
//   which made the qkv layer's 116 MB bf16 output take twice the products'
//   time.
//
// w8a8_fusedq (x quantized in the kernel).  A block owns a panel
// of 128 rows and a run of 64-column tiles (`tiles` x 2, chosen by the
// wrapper so that the blocks cover the card several times).  It has two
// consumer warpgroups and two producer warps:
// - the consumers take the absmax of each row over all of D, then quantize
//   the rows once into an int8 panel [128, D rounded up to 128] in shared
//   memory, written straight into the layout that the wgmma descriptor
//   names: 128-row x 128-byte atoms, 16-byte chunk index XOR (row mod 8);
//   each warp holds two rows of x in registers while the next two load,
//   so x is read once; x / s_x is the IEEE quotient, from one correctly
//   rounded reciprocal a row and an FMA correction (Markstein's theorem);
//   a `fence.proxy.async.shared::cta`
//   makes those generic-proxy writes visible to the tensor cores;
// - meanwhile each producer warp streams the weight tiles [64 columns x
//   128 bytes of D] of its warpgroup with TMA (a 2-D map over wq [F, D],
//   128-byte swizzle, zeros past F and D) into that warpgroup's ring of up
//   to 6 stages, with full / empty mbarriers;
// - warpgroup w takes every other column tile (w, w + 2, ...) for all 128
//   rows: two wgmma m64n64k32 s8 x s8 -> s32 per 32-deep step, A (the
//   panel) and B (the weight tile) from shared memory, both K-major,
//   keeping one slice's products in flight while it frees the stage of
//   the slice before.  The two warpgroups run apart, so one's epilogue
//   overlaps the other's products;
// - the epilogue: ((float(acc) * s_x) * s_w) + b,
//   the activation, the cast, each step rounded, no FMA (the tile's s_w
//   and bias are loaded first, all in flight).  The int32 sums are exact
//   in any order, so the output is bit-equal to the plain version's
//   before the activation.
// Schedule: one block per SM (a 96 KB panel at D = 768 and two 48 KB
// rings); F is split between blocks that each quantize the same panel
// (re-reading x, mostly from L2, since those blocks are launched side by
// side), which keeps ~5 waves at the ViT shapes instead of the 1.6 waves
// of one block per panel.  D <= PANEL_MAX_D (a 192 KB panel and 2-stage
// rings at D = 1536); for a wider D Int8Dense quantizes with the plain
// chain and calls w8a8_prequant, as the JAX package does for a shape its
// fused kernel does not take.  D must be a multiple of 16 (whole 16-byte
// vectors, and TMA's stride rule), which the wrapper checks.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int PANEL_MAX_D = 1536;  // a 192 KB panel + 2-stage rings in 227 KB

enum { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_TANH = 2, ACT_GELU = 3 };

// v / sx rounded to nearest (the IEEE quotient), from inv = RN(1 / sx):
// q = RN(v inv) is within an ulp of v / sx, the residual v - sx q is exact
// (FMA), and RN(q + r inv) is the correctly rounded quotient (Markstein).
// Quotients small enough to lose that in the subnormal range round to 0.
__device__ __forceinline__ unsigned quant1(float v, float sx, float inv) {
  const float q0 = __fmul_rn(v, inv);
  float q = fmaf(fmaf(-sx, q0, v), inv, q0);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (unsigned)(__float2int_rn(q) & 0xff);
}

// 8 bf16 values -> 8 int8 values, element 0 in the lowest byte.
__device__ __forceinline__ uint2 quant8(uint4 raw, float sx, float inv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    const unsigned pair = quant1(f.x, sx, inv) | (quant1(f.y, sx, inv) << 8);
    w[j >> 1] |= pair << (16 * (j & 1));
  }
  return make_uint2(w[0], w[1]);
}

// The activations in the order of operations of their plain versions
// (ops/w8a8.py::act_plain, PyTorch's own sigmoid and gelu).
template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == ACT_QUICK_GELU) {
    const float t = __fmul_rn(1.702f, y);
    const float s = __frcp_rn(__fadd_rn(1.0f, expf(-t)));  // = IEEE 1 / x
    return __fmul_rn(y, s);
  } else if (ACT == ACT_GELU_TANH) {
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float cube = __fmul_rn(__fmul_rn(y, y), y);
    const float inner =
        __fmul_rn(kBeta, __fadd_rn(y, __fmul_rn(kKappa, cube)));
    return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.0f, tanhf(inner)));
  } else if (ACT == ACT_GELU) {
    const float e = erff(__fmul_rn(y, 0.7071067811865476f));
    return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, e));
  }
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  } else {
    p[0] = __float2bfloat16_rn(a);
  }
}

// ---- TMA, mbarriers and int8 wgmma (both kernels)

constexpr int FQ_THREADS = 2 * 128 + 2 * 32;  // two consumer warpgroups, two producer warps
constexpr int FN = 64;                        // columns of a warpgroup's tile
constexpr int SLICE = 128;                    // bytes of D per weight stage
constexpr int STAGE_BYTES = FN * SLICE;       // 8 KB
constexpr int MAX_STAGES = 6;                 // per warpgroup
constexpr int SMEM_MAX = 232448;          // the SM's 227 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory operand descriptor of 128-byte rows with the 128-byte
// swizzle: start >> 4, LBO 1 (unused), 8-row groups 1024 bytes apart,
// layout type 1.  A 32-deep k step advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_s8_ss_n64(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}


// m64n256k32: the 128 int32 accumulators of a thread
#define ACC128 \
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
      "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
      "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
      "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),  \
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
      "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),  \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),  \
      "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),  \
      "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),  \
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),  \
      "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),  \
      "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),  \
      "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),  \
      "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),  \
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

#define REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

__device__ __forceinline__ void wgmma_s8_ss_n256(int* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" REGS128 "}, %128, %129, p;\n}\n"
      : ACC128
      : "l"(da), "l"(db), "r"(acc));
}

// The epilogue of one 64 x 64 accumulator (rows r0 + 16 w + g and + 8 of
// warp w, columns n0 ..): chunk c (8 columns) is acc[4c .. 4c + 3]:
// (g, 8c + 2t), (g, 8c + 2t + 1), (g + 8, 8c + 2t), (g + 8, 8c + 2t + 1).
// csw / cb hold the s_w and bias of the thread's 16 columns.
template <int ACT, typename OutT>
__device__ __forceinline__ void epilogue_wg(const int (&acc)[32], const float (&csw)[FN / 8][2],
                                            const float (&cb)[FN / 8][2], const float* sx_rows,
                                            int m0, int n0, int r0, int g, int t,
                                            OutT* __restrict__ out, int n, int f) {
  const bool f_even = (f & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lr = r0 + g + half * 8;
    const int grow = m0 + lr;
    if (grow >= n) continue;
    const float sx = sx_rows[lr];
    OutT* orow = out + (size_t)grow * f;
#pragma unroll
    for (int c = 0; c < FN / 8; ++c) {
      const int col = n0 + c * 8 + t * 2;
      if (col >= f) continue;
      const bool second = col + 1 < f;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = __int2float_rn(acc[4 * c + half * 2 + e]);
        v = __fmul_rn(__fmul_rn(v, sx), csw[c][e]);
        v = __fadd_rn(v, cb[c][e]);
        y[e] = activate<ACT>(v);
      }
      if (second && !f_even) {
        store2(orow + col, y[0], 0.0f, false);
        store2(orow + col + 1, y[1], 0.0f, false);
      } else {
        store2(orow + col, y[0], y[1], second);
      }
    }
  }
}

// Block (x, y): rows [128 y, 128 y + 128), 64-column tiles
// [2 tiles x, 2 tiles (x + 1)).  Warpgroup w takes every other tile (w,
// w + 2, ...) for all 128 rows, fed by producer warp w through its own
// ring, so the two warpgroups drift apart and one's epilogue overlaps the
// other's products.  Dynamic shared memory, from a 1024-byte boundary: the
// panel (D / 128 atoms of 128 rows x 128 bytes), then the two rings.
template <int ACT, typename OutT>
__global__ void __launch_bounds__(FQ_THREADS, 1)
w8a8_fusedq_kernel(const __grid_constant__ CUtensorMap mw, const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ sw, const float* __restrict__ bias,
                   OutT* __restrict__ out, int n, int d, int f, int tiles, int stages) {
  __shared__ __align__(8) uint64_t full[2][MAX_STAGES], empty[2][MAX_STAGES];
  __shared__ float sx_s[BM];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t panel = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* panel_ptr = smem_raw + (panel - smem_u32(smem_raw));
  const int slices = (d + SLICE - 1) / SLICE;
  const uint32_t rings = panel + slices * BM * SLICE;

  // broadcast from lane 0: the compiler sees the index uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int tile_lo = blockIdx.x * 2 * tiles;
  const int tile_hi = min(tile_lo + 2 * tiles, (f + FN - 1) / FN);

  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < stages; ++s) {
        mbar_init(smem_u32(&full[w][s]), 1);
        mbar_init(smem_u32(&empty[w][s]), 128);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // producer warp w: one lane streams warpgroup w's tiles
    const int w = warp - 8;
    if (lane == 0) {
      const uint32_t ring = rings + w * stages * STAGE_BYTES;
      int it = 0;
      for (int tile = tile_lo + w; tile < tile_hi; tile += 2)
        for (int kb = 0; kb < slices; ++kb, ++it) {
          const int s = it % stages, use = it / stages;
          if (use > 0) mbar_wait(smem_u32(&empty[w][s]), (use - 1) & 1);
          const uint32_t fb = smem_u32(&full[w][s]);
          mbar_expect_tx(fb, STAGE_BYTES);
          tma_load_2d(ring + s * STAGE_BYTES, &mw, fb, kb * SLICE, tile * FN);
        }
    }
    return;
  }

  // ---- row scales and the quantized panel.  Each consumer warp takes
  // its rows (warp + 8 k) two at a time and holds them in registers
  // (D <= PANEL_MAX_D: at most 6 16-byte chunks a lane), so x is read once;
  // the next two rows' loads are in flight while these are quantized.
  // 8 bf16 -> 8 int8 per chunk, into the swizzled atoms, zeros past n, d.
  constexpr int MAXJ = PANEL_MAX_D / 8 / 32;
  const int cpr = d / 8;                     // 16-byte chunks of a row of x
  const int cpad = slices * (SLICE / 8);     // with the zero tail
  auto load_rows = [&](uint4 (&v)[2][MAXJ], int r0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int grow = m0 + r0 + 8 * i;
      const uint4* rowp = reinterpret_cast<const uint4*>(x + (size_t)grow * d);
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int c = lane + 32 * j;
        v[i][j] = (r0 < BM && grow < n && c < cpr) ? __ldg(rowp + c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  uint4 cur[2][MAXJ], nxt[2][MAXJ];
  load_rows(cur, warp);
#pragma unroll 1
  for (int pass = 0; pass < BM / 16; ++pass) {
    const int r0 = warp + 16 * pass;
    load_rows(nxt, r0 + 16);  // zeros past the panel's last pass
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float amax = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&cur[i][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f2 = __bfloat1622float2(h[e]);
          amax = fmaxf(amax, fmaxf(fabsf(f2.x), fabsf(f2.y)));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const int row = r0 + 8 * i;
      const float sx = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
      const float inv = __frcp_rn(sx);
      if (lane == 0) sx_s[row] = sx;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int c = lane + 32 * j;
        if (c >= cpad) continue;
        const int kb = c / (SLICE / 8), cb = (c % (SLICE / 8)) * 8;
        const int off = kb * BM * SLICE + row * SLICE + ((((cb >> 4) ^ (row & 7)) << 4) | (cb & 15));
        *reinterpret_cast<uint2*>(panel_ptr + off) = quant8(cur[i][j], sx, inv);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) cur[i][j] = nxt[i][j];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();

  // ---- the products: warpgroup wg, its tiles, both 64-row halves
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;
  const uint32_t ring = rings + wg * stages * STAGE_BYTES;
  int it = 0;
  for (int tile = tile_lo + wg; tile < tile_hi; tile += 2) {
    int acc0[32], acc1[32];
    int prev = 0;
    wg_fence();
    for (int kb = 0; kb < slices; ++kb, ++it) {
      const int s = it % stages;
      mbar_wait(smem_u32(&full[wg][s]), (it / stages) & 1);
      const uint64_t da = desc_sw128(panel + kb * BM * SLICE);
      const uint64_t db = desc_sw128(ring + s * STAGE_BYTES);
#pragma unroll
      for (int ks = 0; ks < SLICE / 32; ++ks)
        wgmma_s8_ss_n64(acc0, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
#pragma unroll
      for (int ks = 0; ks < SLICE / 32; ++ks)  // rows 64 .. 127: 8 KB further
        wgmma_s8_ss_n64(acc1, da + (8192 >> 4) + 2 * ks, db + 2 * ks, (kb | ks) != 0);
      wg_commit();
      if (kb > 0) {  // the slice before has been read: free its stage
        wg_wait<1>();
        mbar_arrive(smem_u32(&empty[wg][prev]));
      }
      prev = s;
    }
    wg_wait<0>();
    mbar_arrive(smem_u32(&empty[wg][prev]));
    const int n0 = tile * FN;
    float csw[FN / 8][2], cb[FN / 8][2];
#pragma unroll
    for (int c = 0; c < FN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = min(n0 + c * 8 + t * 2 + e, f - 1);
        csw[c][e] = __ldg(sw + col);
        cb[c][e] = __ldg(bias + col);
      }
    epilogue_wg<ACT, OutT>(acc0, csw, cb, sx_s, m0, n0, r0, g, t, out, n, f);
    epilogue_wg<ACT, OutT>(acc1, csw, cb, sx_s, m0, n0, 64 + r0, g, t, out, n, f);
  }
}

// ---- w8a8_prequant

constexpr int PQ_THREADS = 3 * 128;                   // two consumer warpgroups, one producer
constexpr int PQ_BN = 256;                            // columns of a tile (the wgmma's N)
constexpr int PQ_A_BYTES = BM * SLICE;                // 16 KB: 128 rows of xq
constexpr int PQ_STAGE = PQ_A_BYTES + PQ_BN * SLICE;  // + 32 KB: 256 columns of wq
constexpr int PQ_STAGES = 4;
constexpr int PQ_SMEM = PQ_STAGES * PQ_STAGE + 1024;  // + the 1024-byte alignment pad
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;

// A warp's staged output: 16 rows of 128 bytes (64 bf16 or 32 f32
// columns) a round, rows PITCH bytes apart, which keeps the fragment
// writes free of bank conflicts (bf16 pairs: row g starts 4 g banks on;
// f32 pairs: 8 g).
template <typename OutT>
struct PqOut {
  static constexpr int COLS = 128 / (int)sizeof(OutT);       // columns of a round
  static constexpr int PITCH = sizeof(OutT) == 2 ? 144 : 160;
  static constexpr int VEC = 16 / (int)sizeof(OutT);         // columns of a 16-byte chunk
};
constexpr int PQ_STAGED = 16 * 160;  // a warp's staging bytes, for either type

// The epilogue of one warp's 16 x 256 share of its warpgroup's
// accumulator: the thread holds rows g (h = 0) and g + 8 (h = 1) of the
// warp's 16 and, in chunk c (8 columns), acc[4c + 2h + e] at column
// 8c + 2t + e.  Round by round (128 bytes of each row), the thread
// dequantizes its values into the warp's staging rows, then each lane
// stores 16-byte chunks of whole rows (lane -> row lane / 8 + 4 i, chunk
// lane % 8), so a store instruction writes four full 128-byte lines.
// `vec`: rows of out are 16-byte aligned (F * sizeof(OutT) % 16 == 0),
// else the chunks go out element by element.  sxs: the warp's 16 row
// scales; sws, bs: the tile's s_w and bias.
template <typename OutT>
__device__ __forceinline__ void epilogue_pq(const int (&acc)[PQ_BN / 2], const float* sxs,
                                            const float* sws, const float* bs,
                                            unsigned char* staged, int grow0, int n0, int lane,
                                            OutT* __restrict__ out, int n, int f, bool vec) {
  using P = PqOut<OutT>;
  const int g = lane >> 2, t = lane & 3;
  const float sx[2] = {sxs[g], sxs[g + 8]};
  const int ch = lane & 7;
#pragma unroll
  for (int r = 0; r < PQ_BN / P::COLS; ++r) {
#pragma unroll
    for (int cc = 0; cc < P::COLS / 8; ++cc) {
      const int c = r * (P::COLS / 8) + cc;
      const int lc = 8 * c + 2 * t;
      const float2 w2 = *reinterpret_cast<const float2*>(sws + lc);
      const float2 b2 = *reinterpret_cast<const float2*>(bs + lc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * h]), sx[h]), w2.x);
        float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * c + 2 * h + 1]), sx[h]), w2.y);
        y0 = __fadd_rn(y0, b2.x);
        y1 = __fadd_rn(y1, b2.y);
        store2(reinterpret_cast<OutT*>(staged + (g + 8 * h) * P::PITCH) + 8 * cc + 2 * t, y0,
               y1, true);
      }
    }
    __syncwarp();
    const int col = n0 + r * P::COLS + ch * P::VEC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (lane >> 3) + 4 * i;
      const uint4 v = *reinterpret_cast<const uint4*>(staged + row * P::PITCH + 16 * ch);
      if (grow0 + row < n && col < f) {
        OutT* dst = out + (size_t)(grow0 + row) * f + col;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const OutT* e = reinterpret_cast<const OutT*>(&v);
#pragma unroll
          for (int j = 0; j < P::VEC; ++j)
            if (col + j < f) dst[j] = e[j];
        }
      }
    }
    __syncwarp();  // the rows are read before the next round rewrites them
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of tn column
// tiles a row panel, tile -> (rows 128 (tile / tn), columns 256 (tile %
// tn)).  Dynamic shared memory, from a 1024-byte boundary: the ring.
// Thread (warpgroup wg, warp q of it, lane 4g + t) holds rows
// 64 wg + 16 q + g and + 8 of the tile.
template <typename OutT>
__global__ void __launch_bounds__(PQ_THREADS, 1)
w8a8_prequant_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, OutT* __restrict__ out, int n, int f,
                     int slices, int tn, int tiles, bool vec) {
  __shared__ __align__(8) uint64_t full[PQ_STAGES], empty[PQ_STAGES];
  // the tile's scales and bias: [warpgroup][tile parity]
  __shared__ __align__(16) float sx_s[2][2][64];
  __shared__ __align__(16) float sw_s[2][2][PQ_BN];
  __shared__ __align__(16) float b_s[2][2][PQ_BN];
  __shared__ __align__(16) unsigned char out_s[8][PQ_STAGED];  // a warp's staged output
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // broadcast from lane 0: the compiler sees the index uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PQ_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread streams every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tn) * BM, n0 = (tile % tn) * PQ_BN;
        for (int kb = 0; kb < slices; ++kb, ++it) {
          const int s = it % PQ_STAGES, use = it / PQ_STAGES;
          if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
          const uint32_t st = base + s * PQ_STAGE, fb = smem_u32(&full[s]);
          mbar_expect_tx(fb, PQ_STAGE);
          tma_load_2d(st, &ma, fb, kb * SLICE, m0);
          tma_load_2d(st + PQ_A_BYTES, &mb, fb, kb * SLICE, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2, q = warp & 3;
  const int lt = threadIdx.x & 127;  // thread of the warpgroup
  int it = 0, par = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, par ^= 1) {
    const int m0 = (tile / tn) * BM, n0 = (tile % tn) * PQ_BN;
    // this warpgroup's share of the scales and bias, in flight while the
    // products run: row 64 wg + lt (lt < 64), columns lt and lt + 128
    const int srow = m0 + 64 * wg + lt;
    const int c0 = n0 + lt, c1 = c0 + 128;
    const float r_sx = (lt < 64 && srow < n) ? __ldg(sx + srow) : 0.f;
    const float r_sw0 = c0 < f ? __ldg(sw + c0) : 0.f, r_b0 = c0 < f ? __ldg(bias + c0) : 0.f;
    const float r_sw1 = c1 < f ? __ldg(sw + c1) : 0.f, r_b1 = c1 < f ? __ldg(bias + c1) : 0.f;

    int acc[PQ_BN / 2];
    int prev = 0;
    wg_fence();
    for (int kb = 0; kb < slices; ++kb, ++it) {
      const int s = it % PQ_STAGES;
      mbar_wait(smem_u32(&full[s]), (it / PQ_STAGES) & 1);
      const uint32_t st = base + s * PQ_STAGE;
      const uint64_t da = desc_sw128(st + wg * (64 * SLICE));  // this warpgroup's 64 rows
      const uint64_t db = desc_sw128(st + PQ_A_BYTES);
#pragma unroll
      for (int ks = 0; ks < SLICE / 32; ++ks)
        wgmma_s8_ss_n256(acc, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
      wg_commit();
      if (kb > 0) {  // the stage before has been read: free it
        wg_wait<1>();
        mbar_arrive(smem_u32(&empty[prev]));
      }
      prev = s;
    }
    wg_wait<0>();
    mbar_arrive(smem_u32(&empty[prev]));

    if (lt < 64) sx_s[wg][par][lt] = r_sx;
    sw_s[wg][par][lt] = r_sw0;
    sw_s[wg][par][lt + 128] = r_sw1;
    b_s[wg][par][lt] = r_b0;
    b_s[wg][par][lt + 128] = r_b1;
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
    epilogue_pq<OutT>(acc, &sx_s[wg][par][16 * q], sw_s[wg][par], b_s[wg][par], out_s[warp],
                      m0 + 64 * wg + 16 * q, n0, lane, out, n, f, vec);
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

// A 2-D map over an int8 [rows, d] matrix: boxes of 128 bytes of D x
// box_rows rows, 128-byte swizzle, zeros past the edges.
bool make_map_s8(CUtensorMap* map, const int8_t* ptr, int rows, int d, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)SLICE, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int ACT, typename OutT>
cudaError_t launch_fusedq_t(const void* x, const int8_t* wq, const float* sw, const float* bias,
                            void* out, int n, int d, int f, int tiles, cudaStream_t stream) {
  const int slices = (d + SLICE - 1) / SLICE;
  const int panel_bytes = slices * BM * SLICE;
  const int static_bytes = 4 * MAX_STAGES * (int)sizeof(uint64_t) + BM * (int)sizeof(float);
  int stages = (SMEM_MAX - static_bytes - 1024 - panel_bytes) / (2 * STAGE_BYTES);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 1) return cudaErrorInvalidValue;
  const int smem = 1024 + panel_bytes + 2 * stages * STAGE_BYTES;

  CUtensorMap mw;
  if (!make_map_s8(&mw, wq, f, d, FN)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(w8a8_fusedq_kernel<ACT, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nt = (f + BN - 1) / BN;
  const dim3 grid((nt + tiles - 1) / tiles, (n + BM - 1) / BM);
  w8a8_fusedq_kernel<ACT, OutT><<<grid, FQ_THREADS, smem, stream>>>(
      mw, reinterpret_cast<const __nv_bfloat16*>(x), sw, bias, reinterpret_cast<OutT*>(out), n,
      d, f, tiles, stages);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_prequant(const int8_t* xq, const float* sx,
                            const int8_t* wq, const float* sw,
                            const float* bias, void* out, int n, int d,
                            int f, cudaStream_t stream) {
  CUtensorMap ma, mb;
  if (!make_map_s8(&ma, xq, n, d, BM) || !make_map_s8(&mb, wq, f, d, PQ_BN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  static int smem_set_on = -1;  // the shared-memory limit, set once per device
  if (smem_set_on != dev) {
    err = cudaFuncSetAttribute(w8a8_prequant_kernel<OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, PQ_SMEM);
    if (err != cudaSuccess) return err;
    smem_set_on = dev;
  }
  const int tn = (f + PQ_BN - 1) / PQ_BN;
  const long long tiles = (long long)((n + BM - 1) / BM) * tn;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  w8a8_prequant_kernel<OutT><<<grid, PQ_THREADS, PQ_SMEM, stream>>>(
      ma, mb, sx, sw, bias, reinterpret_cast<OutT*>(out), n, f, (d + SLICE - 1) / SLICE, tn,
      (int)tiles, (f * sizeof(OutT)) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_fusedq(const void* x, const int8_t* wq, const float* sw,
                          const float* bias, void* out, int out_bf16, int n,
                          int d, int f, int tiles, cudaStream_t stream) {
  if (out_bf16)
    return launch_fusedq_t<ACT, __nv_bfloat16>(x, wq, sw, bias, out, n, d, f,
                                               tiles, stream);
  return launch_fusedq_t<ACT, float>(x, wq, sw, bias, out, n, d, f, tiles,
                                     stream);
}

bool bad_shape(int n, int d, int f) {
  return n < 0 || d < 16 || f < 1 || d % 16 != 0 || (n + BM - 1) / BM > 65535;
}

}  // namespace

// x bf16 [n, d] row-major; wq int8 [f, d] row-major (the weight matrix
// transposed); sw, bias f32 [f]; out [n, f], bf16 when out_bf16 else f32.
// act: 0 none, 1 quick_gelu, 2 gelu_tanh, 3 gelu (exact erf).  tiles
// (>= 1): the column tiles (of 128) each block runs against its quantized
// panel.  d must be a multiple of 16 and at most PANEL_MAX_D, and every
// pointer 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int w8a8_fusedq(const void* x, const int8_t* wq, const float* sw,
                           const float* bias, void* out, int out_bf16,
                           int act, int n, int d, int f, int tiles,
                           cudaStream_t stream) {
  if (bad_shape(n, d, f) || tiles < 1 || d > PANEL_MAX_D)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  switch (act) {
    case ACT_NONE:
      return (int)launch_fusedq<ACT_NONE>(x, wq, sw, bias, out, out_bf16, n,
                                          d, f, tiles, stream);
    case ACT_QUICK_GELU:
      return (int)launch_fusedq<ACT_QUICK_GELU>(x, wq, sw, bias, out,
                                                out_bf16, n, d, f, tiles,
                                                stream);
    case ACT_GELU_TANH:
      return (int)launch_fusedq<ACT_GELU_TANH>(x, wq, sw, bias, out,
                                               out_bf16, n, d, f, tiles,
                                               stream);
    case ACT_GELU:
      return (int)launch_fusedq<ACT_GELU>(x, wq, sw, bias, out, out_bf16, n,
                                          d, f, tiles, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// xq int8 [n, d] row-major with row scales sx f32 [n]; the rest as
// w8a8_fusedq, without an activation and at any d % 16 == 0.
extern "C" int w8a8_prequant(const int8_t* xq, const float* sx,
                             const int8_t* wq, const float* sw,
                             const float* bias, void* out, int out_bf16,
                             int n, int d, int f, cudaStream_t stream) {
  if (n < 0 || d < 16 || f < 1 || d % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (out_bf16)
    return (int)launch_prequant<__nv_bfloat16>(xq, sx, wq, sw, bias, out, n,
                                               d, f, stream);
  return (int)launch_prequant<float>(xq, sx, wq, sw, bias, out, n, d, f,
                                     stream);
}
