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
// Design.  w8a8_prequant (mma.sync, the first design's GEMM core): a
// block of 256 threads owns 128 x 128 output tiles and walks D in 64-deep
// slices streamed by cp.async into a second buffer; each of its 8 warps
// computes 64 x 32 of a tile with mma.sync m16n8k32 s8 x s8 -> s32 from
// padded shared rows.
//
// w8a8_fusedq (Hopper: TMA, mbarriers, int8 wgmma).  A block owns a panel
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
// - the epilogue is the first design's: ((float(acc) * s_x) * s_w) + b,
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
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;  // 80-byte rows: fragment loads hit 32 banks
constexpr int PANEL_MAX_D = 1536;  // a 192 KB panel + 2-stage rings in 227 KB

enum { ACT_NONE = 0, ACT_QUICK_GELU = 1, ACT_GELU_TANH = 2, ACT_GELU = 3 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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

// Shared by both kernels: the dequant / activation / cast epilogue of one
// 128 x 128 tile at (m0, n0).
template <int ACT, typename OutT>
__device__ __forceinline__ void epilogue(const int (&acc)[4][4][4],
                                         const float* sx_rows, int m0, int n0,
                                         int wm, int wn, int g, int t,
                                         const float* __restrict__ sw,
                                         const float* __restrict__ bias,
                                         OutT* __restrict__ out, int n,
                                         int f) {
  const bool f_even = (f & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * 64 + mi * 16 + g + half * 8;
      const int grow = m0 + lr;
      if (grow >= n) continue;
      const float sx = sx_rows[lr];
      OutT* orow = out + (size_t)grow * f;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        if (col >= f) continue;
        const bool second = col + 1 < f;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = (e == 0 || second) ? col + e : col;
          float v = __int2float_rn(acc[mi][ni][half * 2 + e]);
          v = __fmul_rn(__fmul_rn(v, sx), __ldg(sw + cc));
          v = __fadd_rn(v, __ldg(bias + cc));
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
}

// w8a8_prequant: xq int8 [n, d] with row scales sx_in [n]; wq int8
// [f, d]; sw, bias f32 [f]; out [n, f].
template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w8a8_prequant_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ sx_in,
                     const int8_t* __restrict__ wq,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias, OutT* __restrict__ out,
                     int n, int d, int f) {
  __shared__ __align__(16) int8_t As[2][BM][LDS];
  __shared__ __align__(16) int8_t Bs[2][BN][LDS];
  __shared__ float sx_s[BM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = warp >> 2; // warp's 64-row half of the tile
  const int wn = warp & 3;  // warp's 32-column quarter of the tile
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kt_count = (d + BK - 1) / BK;

  // int8 slices through cp.async: 128 rows x 64 bytes = 512 chunks per
  // operand, 2 per thread; chunk c is row c / 4, depth (c % 4) * 16.
  auto load_async = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      const int row = c >> 2, kc = (c & 3) * 16;
      const int gk = k0 + kc;
      const int gcol = n0 + row;
      const bool okb = gcol < f && gk < d;
      cp_async16(&Bs[buf][row][kc], okb ? wq + (size_t)gcol * d + gk : wq,
                 okb);
      const int grow = m0 + row;
      const bool oka = grow < n && gk < d;
      cp_async16(&As[buf][row][kc], oka ? xq + (size_t)grow * d + gk : xq,
                 oka);
    }
    cp_async_commit();
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  load_async(0, 0);
  cp_async_wait_all();
  __syncthreads();

  for (int kt = 0; kt < kt_count; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < kt_count;
    if (more) load_async(buf ^ 1, (kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = &As[buf][wm * 64 + mi * 16 + g][ks + t * 4];
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &Bs[buf][wn * 32 + ni * 8 + g][ks + t * 4];
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (more) cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: the row scales of this block's rows, then dequantize, bias,
  // cast, masked store
  for (int r = tid; r < BM; r += THREADS)
    sx_s[r] = m0 + r < n ? sx_in[m0 + r] : 1.0f;
  __syncthreads();
  epilogue<ACT_NONE, OutT>(acc, sx_s, m0, n0, wm, wn, g, t, sw, bias, out,
                           n, f);
}

// ---- w8a8_fusedq: TMA, mbarriers and int8 wgmma

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

  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap mw;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)f};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)SLICE, (cuuint32_t)FN};
  const cuuint32_t elem[2] = {1u, 1u};
  if (encode(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wq), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
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
  const dim3 grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  w8a8_prequant_kernel<OutT><<<grid, THREADS, 0, stream>>>(
      xq, sx, wq, sw, bias, reinterpret_cast<OutT*>(out), n, d, f);
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
// w8a8_fusedq, without an activation.
extern "C" int w8a8_prequant(const int8_t* xq, const float* sx,
                             const int8_t* wq, const float* sw,
                             const float* bias, void* out, int out_bf16,
                             int n, int d, int f, cudaStream_t stream) {
  if (bad_shape(n, d, f)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (out_bf16)
    return (int)launch_prequant<__nv_bfloat16>(xq, sx, wq, sw, bias, out, n,
                                               d, f, stream);
  return (int)launch_prequant<float>(xq, sx, wq, sw, bias, out, n, d, f,
                                     stream);
}
