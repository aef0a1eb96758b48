// One k-means EM iteration: nearest center (E-step), the row-masked
// per-cluster sums and counts (M-step) and the inertia.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::fused_em_step_pallas
// (kernel body _fused_em_kernel).  Same contract: distance via
// |c|^2 - 2 x.c (|x|^2 added after the argmin), first-min ties (the lowest
// center index), min distance max(|x|^2 + min, 0), a 0/1 row mask that
// drops rows from sums, counts and inertia (labels of masked rows are still
// the plain argmin), x read either as f32 or as bf16.  The products are
// the TPU kernel's split on the tensor cores: c = c_hi + c_lo in bf16, and
// x = x_hi + x_lo for f32 x; the cross term is x.c_lo + x.c_hi for bf16 x
// (its lo part is zero) and x_lo.c_hi + x_hi.c_lo + x_hi.c_hi for f32 x
// (lo.lo dropped).  |c|^2 is taken of the same split, c' = c_hi + c_lo
// (exact in f32), so that |c'|^2 - 2 x.c' is the expansion of one center:
// c' differs from c by ~2^-18 of it, and with |c|^2 of c itself that
// residual entered every row's distance to c with one sign where the rows
// lie near it (at K = 1 it biased the inertia by 2e-4 of itself, over the
// contract's 1e-4).  The M-step is the one-hot matrix (exact in bf16)
// times x_hi (+ x_lo), accumulated in f32.
//
// What bounds it on an H100: bytes.  At the pipeline shape (N = 97,536,
// D = 768, K = 100, bf16 x) x is 150 MB, 0.045 ms at 3.35 TB/s; the
// cross term is two bf16 passes of 15 GFLOP, 0.030 ms at 989 TFLOP/s.
// This design reads x twice (E-step, then M-step), ~0.09 ms of HBM time.
//
// Design (Hopper: TMA, mbarriers, wgmma), four kernels on one stream:
// 1. Split pre-pass: the centers into bf16 hi and lo [Kp, Dx] (K padded
//    to a multiple of 128, D to a multiple of 8, zeros past both) with
//    |c_hi + c_lo|^2 (1e30 in the padded columns, as the TPU kernel pads).
//    f32 x, or bf16 x whose rows TMA cannot address (D not a multiple of
//    8, or a base not 16-byte aligned), is written once to bf16 [N, Dx]
//    (hi, and lo for f32).  bf16 x at D % 8 == 0 is read where it lies.
// 2. E-step: a block of two consumer warpgroups and a producer warpgroup
//    (setmaxnreg 232 / 40) owns a tile of 128 rows (64 a warpgroup) and
//    walks the center tiles of 128; blocks are persistent over the row
//    tiles.  One producer thread streams 32-deep stages (x hi [, lo] of
//    the 128 rows, hi and lo of the 128 centers; 64-byte swizzle, zeros
//    past N, D and Kp) into a 192 KB ring (eight stages for bf16 x, six
//    for f32).  Per 16-deep step each warpgroup issues wgmma m64n128k16
//    (A and B K-major from shared memory), always in the same pass order,
//    into a stage accumulator, which is added to the running sum with f32
//    adds once the stage's products are done: the tensor cores' own
//    accumulation is not rounded to nearest, and over a whole row of D 768
//    it biased |x|^2 + |c|^2 - 2 x.c by 5e-4 of a small distance.  While
//    one warpgroup adds, the other's products keep the tensor cores busy.
//    |x|^2 comes from the staged x (two threads a row, 32 bytes each per
//    stage, in a fixed order, chunks rotated by row so that a warp's loads
//    spread over the banks).  The argmin is taken from the accumulator
//    registers: a running (min, index) per thread over its columns in
//    ascending order (strict <, so ties keep the lower index, also across
//    center tiles), then the four threads of a row by shuffles,
//    lexicographic.  Per row: the label, and (label, weight) into a scratch
//    array padded to 64 rows for the M-step; the inertia is summed per
//    thread in tile order, then over the block in a fixed tree, one
//    partial per block.
// 3. M-step: the TPU kernel's one-hot product.  A work unit is a run of
//    64-row stages x 128 centers x 128 columns of x; a block of two
//    consumer warpgroups (64 centers each) and a producer warpgroup owns
//    one unit.  The producer streams the run's x stages (two 64 x 64 boxes,
//    128-byte swizzle, hi [and lo]) and the stage's (label, weight) pairs
//    (a bulk copy) into a ring of six.  Per 16-row step each warpgroup
//    builds the one-hot A fragment in registers (weight where the row's
//    label is the center, else 0) and issues wgmma m64n128k16 with x as an
//    MN-major B (the transpose bit), and a m64n8k16 against a tile of ones
//    in shared memory for the counts.  As in the E-step, each stage's
//    products go to a stage accumulator that is added to the run's sums
//    with f32 adds (at K 1,000 with 10 live slots a run holds ~4,000 rows
//    of one cluster; accumulated on the tensor cores, the sums drifted
//    past the contract's 1e-4 relative).  The unit writes its [128, 128] partial sums once.  Units
//    are about one per SM: the runs are sized so.
// 4. Finalize: sums, counts and inertia summed over the runs' partials
//    (and the E-step blocks' inertia) in index order.
// No float atomics: every sum is taken in an order fixed by the shapes and
// the card's SM count, so two runs on one card give identical bits.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                      // centers of a center tile (E-step wgmma N)
constexpr int BM = 128;                      // rows of an E-step tile (64 a warpgroup)
constexpr int BK = 32;                       // D per E-step stage
constexpr int E_ROW = BK * 2;                // 64 bytes an operand row: the swizzle span
constexpr int RM = 64;                       // rows of an M-step stage
constexpr int DN = 128;                      // columns of an M-step unit (wgmma N)
constexpr int M_BOX = RM * 128;              // 8 KB: 64 rows x 64 bf16 columns
constexpr int M_STAGES = 6;
constexpr int THREADS = 3 * 128;             // two consumer warpgroups, one producer
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int IDX_NONE = 0x7fffffff;

template <bool SPLIT>
struct ELayout {
  static constexpr int X_BYTES = BM * E_ROW;  // 8 KB: hi or lo of the rows
  static constexpr int C_BYTES = NT * E_ROW;  // 8 KB: hi or lo of the centers
  static constexpr int C_OFF = (SPLIT ? 2 : 1) * X_BYTES;
  static constexpr int STAGE = C_OFF + 2 * C_BYTES;  // 24 / 32 KB
  static constexpr int STAGES = SPLIT ? 6 : 8;       // a 192 KB ring
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

template <bool SPLIT>
struct MLayout {
  static constexpr int X_BYTES = (SPLIT ? 2 : 1) * 2 * M_BOX;  // 16 / 32 KB
  static constexpr int LW_BYTES = RM * 8;                      // (label, weight) pairs
  static constexpr int STAGE = X_BYTES + 1024;                 // keeps stages 1024-aligned
  static constexpr int ONES = M_STAGES * STAGE;                // 1 KB of bf16 ones
  static constexpr int SMEM = ONES + 1024 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarriers, TMA and bulk copies

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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register accesses across wgmma
template <int N, typename T>
__device__ __forceinline__ void reg_fence(T* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(*reinterpret_cast<uint32_t*>(&r[i]))::"memory");
}

// K-major rows of 64 bytes with the 64-byte swizzle (what TMA writes):
// start >> 4, LBO 1 (unused), 8-row groups 512 bytes apart, layout type 2.
// A 16-deep step advances the start by 32 bytes (2 units) inside the atom.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * E_ROW >> 4) << 32) | ((uint64_t)2 << 62);
}

// MN-major B of 64-column boxes of 128-byte rows with the 128-byte swizzle
// (what TMA writes): 8-row groups along K 1024 bytes apart (SBO), the next
// 64 columns along N one box further (LBO), layout type 1.  A 16-row step
// along K advances the start by 16 rows (2,048 bytes).
__device__ __forceinline__ uint64_t desc_mn128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(M_BOX >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// K-major B without swizzle (core matrices of 8 rows x 16 bytes, 128 bytes
// apart along K, 8-row groups 256 bytes apart): the tile of ones, where any
// layout reads ones.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

#define ACC64                                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),  \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),   \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),   \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),   \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),   \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),   \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define REGS64                                                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D (64 x 128, f32) += A (64 x 16) . B (16 x 128), both bf16 K-major in
// shared memory; `acc` 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 128) += A (64 x 16, bf16 registers) . B (16 x 128, bf16 MN-major
// in shared memory).
__device__ __forceinline__ void wgmma_rs_n128_tb(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D (64 x 8) += A (64 x 16, registers) . B (16 x 8, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ---- 1. the split pre-pass

// c [k, d] f32 -> hi, lo [kp, dx] bf16 (zeros past k and d) and
// |hi + lo|^2 [kp] (1e30 past k): one warp per padded center, lanes
// strided over the row, then a fixed shuffle tree.
__global__ void split_centers_kernel(const float* __restrict__ c, int k, int d, int kp, int dx,
                                     __nv_bfloat16* __restrict__ hi,
                                     __nv_bfloat16* __restrict__ lo, float* __restrict__ csq) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= kp) return;
  float s = 0.f;
  for (int col = lane; col < dx; col += 32) {
    const float v = (row < k && col < d) ? c[(size_t)row * d + col] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    const __nv_bfloat16 l = __float2bfloat16_rn(v - __bfloat162float(h));  // v - h is exact
    hi[(size_t)row * dx + col] = h;
    lo[(size_t)row * dx + col] = l;
    const float vs = __bfloat162float(h) + __bfloat162float(l);  // exact: the center as split
    s = fmaf(vs, vs, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) csq[row] = row < k ? s : 1e30f;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x [n, d] -> hi [, lo] [n, dx] bf16 (zeros past d); lo is null for bf16 x.
// A thread writes 8 columns of a row (16 bytes of hi, 16 of lo); where
// d % 8 == 0 and x is 16-byte aligned it also reads them as vectors.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
    v[2 * e] = __bfloat162float(h.x);
    v[2 * e + 1] = __bfloat162float(h.y);
  }
}

template <typename T>
__global__ void split_rows_kernel(const T* __restrict__ x, int n, int d, int dx, bool vec,
                                  __nv_bfloat16* __restrict__ hi, __nv_bfloat16* __restrict__ lo) {
  const int groups = dx / 8;
  const long long total = (long long)n * groups;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / groups;
    const int c0 = (int)(i - r * groups) * 8;
    float v[8];
    if (vec) {
      load8(x + r * d + c0, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c0 + e < d ? to_f32(x[r * d + c0 + e]) : 0.f;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = v[2 * e], b = v[2 * e + 1];
      const float ha = __bfloat162float(__float2bfloat16_rn(a));
      const float hb = __bfloat162float(__float2bfloat16_rn(b));
      h[e] = pack_bf16(ha, hb);  // exact: ha, hb are bf16 values
      l[e] = pack_bf16(a - ha, b - hb);  // a - ha is exact in f32
    }
    *reinterpret_cast<uint4*>(hi + r * dx + c0) = make_uint4(h[0], h[1], h[2], h[3]);
    if (lo != nullptr)
      *reinterpret_cast<uint4*>(lo + r * dx + c0) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ---- 2. the E-step

// Thread (warpgroup wg, warp q of it, lane 4g + t) multiplies rows
// [64 wg, 64 wg + 64) of the tile and holds rows 64 wg + 16 q + g (h = 0)
// and + 8 (h = 1); accumulator chunk c (8 columns) is acc[4c .. 4c + 3]:
// (h 0, column 8c + 2t), (h 0, + 1), (h 1, 8c + 2t), (h 1, + 1).  The
// thread sums |x|^2 of half of row h = t & 1 (chunks of half t >> 1), and
// threads t = 0, 1 write rows h = 0, 1.
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
estep_kernel(const __grid_constant__ CUtensorMap xh, const __grid_constant__ CUtensorMap xl,
             const __grid_constant__ CUtensorMap ch, const __grid_constant__ CUtensorMap cl,
             const float* __restrict__ csq, const float* __restrict__ row_w, int n, int npad,
             int ctiles, int ksteps, int* __restrict__ labels, int2* __restrict__ lw,
             float* __restrict__ ine_part) {
  using L = ELayout<SPLIT>;
  __shared__ __align__(8) uint64_t full[L::STAGES], empty[L::STAGES];
  __shared__ float warp_ine[8];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // broadcast from lane 0: the compiler sees the index uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int tiles = (n + BM - 1) / BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread streams every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int per_tile = ctiles * ksteps;
      const int loads = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * per_tile;
      for (int j = 0; j < loads; ++j) {
        const int s = j % L::STAGES, use = j / L::STAGES;
        if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
        const int tile = blockIdx.x + (j / per_tile) * gridDim.x;
        const int ct = (j % per_tile) / ksteps, kb = j % ksteps;
        const uint32_t st = base + s * L::STAGE, fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, L::STAGE);
        tma_load_2d(st, &xh, fb, kb * BK, tile * BM);
        if (SPLIT) tma_load_2d(st + L::X_BYTES, &xl, fb, kb * BK, tile * BM);
        tma_load_2d(st + L::C_OFF, &ch, fb, kb * BK, ct * NT);
        tma_load_2d(st + L::C_OFF + L::C_BYTES, &cl, fb, kb * BK, ct * NT);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int my_row = wg * 64 + q * 16 + g + (t & 1) * 8;  // in the tile
  float ine = 0.f;  // this thread's rows, in tile order
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float rmin[2] = {INFINITY, INFINITY};
    int rarg[2] = {IDX_NONE, IDX_NONE};
    float xsq = 0.f;
    for (int ct = 0; ct < ctiles; ++ct) {
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < ksteps; ++kb, ++it) {
        const int s = it % L::STAGES;
        mbar_wait(smem_u32(&full[s]), (it / L::STAGES) & 1);
        const uint32_t st = base + s * L::STAGE;
        const uint64_t dxh = desc_sw64(st + wg * (64 * E_ROW));
        const uint64_t dxl = desc_sw64(st + L::X_BYTES + wg * (64 * E_ROW));
        const uint64_t dch = desc_sw64(st + L::C_OFF);
        const uint64_t dcl = desc_sw64(st + L::C_OFF + L::C_BYTES);
        float part[NT / 2];  // this stage's products
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if (SPLIT) {  // always x_lo.c_hi, x_hi.c_lo, x_hi.c_hi
            wgmma_ss_n128(part, dxl + 2 * kk, dch + 2 * kk, kk);
            wgmma_ss_n128(part, dxh + 2 * kk, dcl + 2 * kk, 1);
          } else {  // always x.c_lo, x.c_hi
            wgmma_ss_n128(part, dxh + 2 * kk, dcl + 2 * kk, kk);
          }
          wgmma_ss_n128(part, dxh + 2 * kk, dch + 2 * kk, 1);
        }
        wg_commit();
        if (ct == 0) {  // |x|^2 of my half row from the staged x, while the products run
          // chunks 2 (t >> 1) and + 1, started by row so that the 8 lanes
          // of one t read 8 different bank groups
          const unsigned char* xr = smem_raw + (st - raw) + my_row * E_ROW;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = (2 * (t >> 1) + cc + (my_row >> 1)) & 3;
            const uint4 hv = *reinterpret_cast<const uint4*>(xr + 16 * c);
            const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
            uint32_t lwv[4] = {0u, 0u, 0u, 0u};
            if (SPLIT) {
              const uint4 lv = *reinterpret_cast<const uint4*>(xr + L::X_BYTES + 16 * c);
              lwv[0] = lv.x;
              lwv[1] = lv.y;
              lwv[2] = lv.z;
              lwv[3] = lv.w;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 hp = *reinterpret_cast<const __nv_bfloat162*>(&hw[e]);
              const __nv_bfloat162 lp = *reinterpret_cast<const __nv_bfloat162*>(&lwv[e]);
              const float v0 = __bfloat162float(hp.x) + __bfloat162float(lp.x);
              const float v1 = __bfloat162float(hp.y) + __bfloat162float(lp.y);
              xsq = fmaf(v0, v0, xsq);
              xsq = fmaf(v1, v1, xsq);
            }
          }
        }
        // the stage's products are read only once they are done: the other
        // warpgroup's products keep the tensor cores busy meanwhile
        wg_wait<0>();
        reg_fence<NT / 2>(part);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] += part[i];
        mbar_arrive(smem_u32(&empty[s]));
      }

      // fold this center tile: my columns ascend, strict < keeps the first
      const float* cs = csq + ct * NT;
#pragma unroll
      for (int c = 0; c < NT / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * c + 2 * t + e;
          const float cq = __ldg(cs + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = fmaf(-2.f, acc[4 * c + 2 * h + e], cq);
            if (v < rmin[h]) {
              rmin[h] = v;
              rarg[h] = ct * NT + col;
            }
          }
        }
    }

    // the four threads of a row: lexicographic (distance, index)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, rmin[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, rarg[h], off);
        if (ob < rmin[h] || (ob == rmin[h] && oa < rarg[h])) {
          rmin[h] = ob;
          rarg[h] = oa;
        }
      }
    xsq += __shfl_xor_sync(0xffffffffu, xsq, 2);  // the other half of the row
    const int row = tile * BM + my_row;
    if (t < 2 && row < n) {
      const float best = t == 0 ? rmin[0] : rmin[1];
      const int barg = t == 0 ? rarg[0] : rarg[1];
      const int lab = barg == IDX_NONE ? 0 : barg;
      const float w = row_w ? row_w[row] : 1.f;
      labels[row] = lab;
      lw[row] = make_int2(lab, __float_as_int(w));
      ine += fmaxf(best + xsq, 0.f) * w;
    } else if (t < 2 && row < npad) {
      lw[row] = make_int2(0, 0);  // weight 0: the M-step's padding rows add nothing
    }
  }

  // the block's inertia: each warp by a fixed tree, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ine += __shfl_xor_sync(0xffffffffu, ine, off);
  if (lane == 0) warp_ine[warp] = ine;
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += warp_ine[w];
    ine_part[blockIdx.x] = s;
  }
}

// ---- 3. the M-step

// Unit b: center group mg = b % mgroups (128 centers), column chunk dc =
// (b / mgroups) % dchunks (128 columns), run = b / (mgroups * dchunks)
// (stages [run * run_stages, ...) of 64 rows).  Warpgroup wg holds centers
// 128 mg + 64 wg + [0, 64): thread (warp q, lane 4g + t) the rows 16 q + g
// (m_a) and + 8 (m_b) of that m64 tile, accumulator chunk c as in the
// E-step.  A fragment of a 16-row step kk: a[0] = (m_a, rows 2t, 2t + 1),
// a[1] = (m_b, same rows), a[2] = (m_a, rows 2t + 8, + 9), a[3] = (m_b, ...).
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
mstep_kernel(const __grid_constant__ CUtensorMap xh, const __grid_constant__ CUtensorMap xl,
             const int2* __restrict__ lw, int mgroups, int dchunks, int run_stages,
             int total_stages, int kp, int dm, float* __restrict__ part_sums,
             float* __restrict__ part_counts) {
  using L = MLayout<SPLIT>;
  __shared__ __align__(8) uint64_t full[M_STAGES], empty[M_STAGES];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int mg = blockIdx.x % mgroups;
  const int dc = (blockIdx.x / mgroups) % dchunks;
  const int run = blockIdx.x / (mgroups * dchunks);
  const int s0 = run * run_stages;
  const int ns = min(total_stages, s0 + run_stages) - s0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < M_STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < 256) {  // the tile of ones that the counts multiply
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + L::ONES);
    ones[threadIdx.x] = 0x3F803F80u;  // two bf16 1.0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    if (threadIdx.x == 256) {
      for (int j = 0; j < ns; ++j) {
        const int s = j % M_STAGES, use = j / M_STAGES;
        if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
        const int row0 = (s0 + j) * RM;
        const uint32_t st = base + s * L::STAGE, fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, L::X_BYTES + L::LW_BYTES);
        tma_load_2d(st, &xh, fb, dc * DN, row0);
        tma_load_2d(st + M_BOX, &xh, fb, dc * DN + 64, row0);
        if (SPLIT) {
          tma_load_2d(st + 2 * M_BOX, &xl, fb, dc * DN, row0);
          tma_load_2d(st + 3 * M_BOX, &xl, fb, dc * DN + 64, row0);
        }
        bulk_load(st + L::X_BYTES, lw + row0, L::LW_BYTES, fb);
      }
    }
    return;
  }

  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m_a = mg * 128 + wg * 64 + q * 16 + g, m_b = m_a + 8;
  const uint64_t dones = desc_plain(base + L::ONES);
  float acc[DN / 2], part[DN / 2];
  float cnt[4];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < ns; ++j) {
    const int s = j % M_STAGES;
    mbar_wait(smem_u32(&full[s]), (j / M_STAGES) & 1);
    const uint32_t st = base + s * L::STAGE;
    const int2* lws = reinterpret_cast<const int2*>(smem_raw + (st - raw) + L::X_BYTES);
    uint32_t a[RM / 16][4];
#pragma unroll
    for (int kk = 0; kk < RM / 16; ++kk) {
      const int r = kk * 16 + 2 * t;
      const int2 v0 = lws[r], v1 = lws[r + 1], v2 = lws[r + 8], v3 = lws[r + 9];
      const float w0 = __int_as_float(v0.y), w1 = __int_as_float(v1.y);
      const float w2 = __int_as_float(v2.y), w3 = __int_as_float(v3.y);
      a[kk][0] = pack_bf16(v0.x == m_a ? w0 : 0.f, v1.x == m_a ? w1 : 0.f);
      a[kk][1] = pack_bf16(v0.x == m_b ? w0 : 0.f, v1.x == m_b ? w1 : 0.f);
      a[kk][2] = pack_bf16(v2.x == m_a ? w2 : 0.f, v3.x == m_a ? w3 : 0.f);
      a[kk][3] = pack_bf16(v2.x == m_b ? w2 : 0.f, v3.x == m_b ? w3 : 0.f);
    }
    reg_fence<4 * (RM / 16)>(&a[0][0]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RM / 16; ++kk) {
      wgmma_rs_n128_tb(part, a[kk], desc_mn128(st + kk * 16 * 128), kk != 0);
      if (SPLIT) wgmma_rs_n128_tb(part, a[kk], desc_mn128(st + 2 * M_BOX + kk * 16 * 128), 1);
      wgmma_rs_n8(cnt, a[kk], dones, (j | kk) != 0);  // integers: exact
    }
    wg_commit();
    wg_wait<0>();  // the A registers are rewritten for the next stage
    reg_fence<DN / 2>(part);
    reg_fence<4>(cnt);
    mbar_arrive(smem_u32(&empty[s]));
    // the stage's sums join the run's with f32 adds: the tensor cores'
    // accumulation truncates, and over a run's thousands of rows of one
    // cluster that drifted past the contract's 1e-4 relative
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) acc[i] += part[i];
  }

  // the unit's partial sums, written once
  float* pa = part_sums + ((size_t)run * kp + m_a) * dm + dc * DN;
  float* pb = pa + (size_t)8 * dm;
#pragma unroll
  for (int c = 0; c < DN / 8; ++c) {
    *reinterpret_cast<float2*>(pa + 8 * c + 2 * t) = make_float2(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<float2*>(pb + 8 * c + 2 * t) = make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
  if (dc == 0 && t == 0) {  // every column of the ones product is the count
    part_counts[(size_t)run * kp + m_a] = cnt[0];
    part_counts[(size_t)run * kp + m_b] = cnt[2];
  }
}

// ---- 4. finalize: the runs' partials (and the E-step blocks' inertia) in
// index order
__global__ void finalize_kernel(const float* __restrict__ part_sums,
                                const float* __restrict__ part_counts,
                                const float* __restrict__ ine_part, int runs, int eblocks, int k,
                                int d, int kp, int dm, float* __restrict__ sums,
                                float* __restrict__ counts, float* __restrict__ inertia) {
  const size_t kd = (size_t)k * d;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kd) {
    const size_t c = i / d, col = i - c * d;
    float s = 0.f;
    for (int r = 0; r < runs; ++r) s += part_sums[((size_t)r * kp + c) * dm + col];
    sums[i] = s;
  } else if (i < kd + k) {
    const size_t c = i - kd;
    float s = 0.f;
    for (int r = 0; r < runs; ++r) s += part_counts[(size_t)r * kp + c];
    counts[c] = s;
  } else if (i == kd + k) {
    float s = 0.f;
    for (int b = 0; b < eblocks; ++b) s += ine_part[b];
    *inertia = s;
  }
}

// ---- host side

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

// A 2-D map over a bf16 [rows, cols] matrix (row stride cols): box
// box_cols x box_rows, zeros past the edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool SPLIT>
cudaError_t launch_steps(const void* xh, const void* xl, const void* chi, const void* clo,
                         const float* csq, const float* row_w, int n, int dx, int kp, int npad,
                         int eblocks, int runs, int run_stages, int dchunks, int* labels, int2* lw,
                         float* ine_part, float* part_sums, float* part_counts, int phases,
                         cudaStream_t stream) {
  // the lo maps are unused for bf16 x: a copy of the hi map stands in
  CUtensorMap ex[2], ec[2], mx[2];
  if (!make_map(&ex[0], xh, n, dx, BK, BM, CU_TENSOR_MAP_SWIZZLE_64B) ||
      (SPLIT && !make_map(&ex[1], xl, n, dx, BK, BM, CU_TENSOR_MAP_SWIZZLE_64B)) ||
      !make_map(&ec[0], chi, kp, dx, BK, NT, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&ec[1], clo, kp, dx, BK, NT, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&mx[0], xh, n, dx, 64, RM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (SPLIT && !make_map(&mx[1], xl, n, dx, 64, RM, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  if (!SPLIT) {
    ex[1] = ex[0];
    mx[1] = mx[0];
  }
  // the shared-memory limit is set once per kernel and device
  static int smem_set_on = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem_set_on != dev) {
    err = cudaFuncSetAttribute(estep_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ELayout<SPLIT>::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mstep_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MLayout<SPLIT>::SMEM);
    if (err != cudaSuccess) return err;
    smem_set_on = dev;
  }
  if (phases & 2) {
    estep_kernel<SPLIT><<<eblocks, THREADS, ELayout<SPLIT>::SMEM, stream>>>(
        ex[0], ex[1], ec[0], ec[1], csq, row_w, n, npad, kp / NT, (dx + BK - 1) / BK,
        labels, lw, ine_part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & 4) {
    const int mgroups = kp / 128;
    mstep_kernel<SPLIT><<<runs * mgroups * dchunks, THREADS, MLayout<SPLIT>::SMEM, stream>>>(
        mx[0], mx[1], lw, mgroups, dchunks, run_stages, npad / RM, kp, dchunks * DN, part_sums,
        part_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// One EM iteration.  x [n, d] (f32, or bf16 when x_bf16), c [k, d] f32,
// row_w [n] f32 or null (every row weight 1).  Outputs labels [n] int32,
// sums [k, d], counts [k], inertia [1].  The plan (ops/em.py::em_plan)
// gives kp (k rounded up to 128), dx (the bf16 row length, d rounded up to
// 8 when x is rewritten, else d), eblocks (E-step blocks), runs and
// run_stages (M-step runs of 64-row stages) and dchunks (128-column
// chunks), and the scratch: chi, clo [kp, dx] bf16, csq [kp], xhi / xlo
// [n, dx] bf16 (null: x is read where it lies; xlo null for bf16 x), lw
// [round_up(n, 64)] (label, weight) pairs, part_sums [runs, kp, 128
// dchunks], part_counts [runs, kp], ine_part [eblocks]; TMA needs every
// pointer 16-byte aligned.  `phases` selects the kernels (1 split, 2
// E-step, 4 M-step, 8 finalize; 15 for a whole iteration, the others for
// timing the parts).  Returns cudaGetLastError() after the launches.
extern "C" int fused_em_step(const void* x, int x_bf16, const float* c, const float* row_w, int n,
                             int d, int k, int kp, int dx, int eblocks, int runs, int run_stages,
                             int dchunks, int* labels, float* sums, float* counts, float* inertia,
                             void* chi, void* clo, float* csq, void* xhi, void* xlo, void* lw,
                             float* part_sums, float* part_counts, float* ine_part, int phases,
                             cudaStream_t stream) {
  const bool split = x_bf16 == 0;
  const bool rewrite = xhi != nullptr;
  if (k < 1 || d < 1 || n < 0 || kp < k || kp % 128 != 0 || dx < d || dx % 8 != 0 ||
      (!rewrite && (!x_bf16 || dx != d)) || (split && xlo == nullptr) ||
      dchunks * DN < dx || (n > 0 && (eblocks < 1 || runs < 1 || runs * run_stages * RM < n)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (n > 0 && (phases & 1)) {
    split_centers_kernel<<<(kp * 32 + 255) / 256, 256, 0, stream>>>(
        c, k, d, kp, dx, static_cast<__nv_bfloat16*>(chi), static_cast<__nv_bfloat16*>(clo), csq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (rewrite) {
      const long long want = ((long long)n * (dx / 8) + 255) / 256;
      const unsigned blocks = (unsigned)(want < 8192 ? want : 8192);
      __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(xhi);
      __nv_bfloat16* lo = split ? static_cast<__nv_bfloat16*>(xlo) : nullptr;
      const bool vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
      if (x_bf16)
        split_rows_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x), n, d, dx, vec, hi, lo);
      else
        split_rows_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(x), n, d,
                                                             dx, vec, hi, lo);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  if (n > 0 && (phases & 6)) {
    const void* xh = rewrite ? xhi : x;
    const int npad = (n + RM - 1) / RM * RM;
    int2* pairs = static_cast<int2*>(lw);
    err = split ? launch_steps<true>(xh, xlo, chi, clo, csq, row_w, n, dx, kp, npad, eblocks,
                                     runs, run_stages, dchunks, labels, pairs, ine_part,
                                     part_sums, part_counts, phases, stream)
                : launch_steps<false>(xh, nullptr, chi, clo, csq, row_w, n, dx, kp, npad, eblocks,
                                      runs, run_stages, dchunks, labels, pairs, ine_part,
                                      part_sums, part_counts, phases, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 8) {
    const size_t total = (size_t)k * d + k + 1;
    finalize_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        part_sums, part_counts, ine_part, n > 0 ? runs : 0, n > 0 ? eblocks : 0, k, d, kp,
        dchunks * DN, sums, counts, inertia);
  }
  return (int)cudaGetLastError();
}
