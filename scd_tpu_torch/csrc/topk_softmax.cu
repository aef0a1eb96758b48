// Fused vocabulary scoring: scale * F @ W -> online (max, sum-exp) and a
// running top-k per row, without ever storing the [N, V] logits.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::topk_softmax_pallas
// (kernel body _topk_softmax_kernel, _topk_local).  Same contract: logits are
// scale * F @ W in f32, V padding is masked, ties go to the lowest vocabulary
// index, and the caller turns (m, s, vals) into softmax values with
// exp(v - m) / s.
//
// What bounds it on an H100: tensor-core operations.  The TPU kernel takes
// the product on its matrix unit at Precision.HIGHEST, and the JAX
// package's own non-kernel path at Precision.HIGH (three bf16 passes); the
// JAX package refuses single-pass bf16 logits because they flip near-tie
// rankings.  Here f32 operands are split as x = hi + lo, hi = bf16(x),
// lo = bf16(x - hi), and F @ W = lo.hi + hi.lo + hi.hi (lo.lo, ~2^-16 of
// the product, is dropped): ~1e-5 on a logit at scale 100.  At the pipeline
// shape (N = 97,536, D = 512, V = 68,000) that is 3 x 6.8 TFLOP of bf16
// products, 20.6 ms at 989 TFLOP/s; the bytes (F, W and the outputs,
// ~340 MB) take 0.1 ms, and the epilogue ~6.6 G expf and compares, ~2 ms
// of SFU and FMA issue.
//
// Design (Hopper: TMA, mbarriers, wgmma).
// - Split first: two pre-pass kernels write hi and lo of F as [N, Dp] and
//   of W transposed to K-major [V, Dp] (Dp = D rounded up to 32, zeros past
//   D), so every operand row is 64-byte aligned for TMA (~0.5 GB moved,
//   ~0.3 ms).
// - A block of two consumer warpgroups and a producer warpgroup owns a row
//   block of 128 rows (64 a warpgroup) and walks all of V in 256-column
//   tiles; blocks are persistent over the row blocks.  One producer thread
//   streams 32-deep stages (hi and lo of the 128 F rows and of the 256 W
//   columns, 48 KB; 2-D tensor maps, 64-byte swizzle, zeros past N and V)
//   into a ring of three stages with full / empty mbarriers.  Per 16-deep
//   step each consumer warpgroup issues three wgmma m64n256k16 (A and B
//   from shared memory, both K-major) into one f32 accumulator, always
//   lo.hi, hi.lo, hi.hi: two equal columns give equal bits.  setmaxnreg
//   gives the consumers 232 registers and the producer 40.
//   L2 traffic: each tile re-reads its F rows and W columns (768 KB for
//   100.7 MFLOP, 131 operations a byte); W, 139 MB as hi + lo, streams
//   past every row block, mostly from L2, since the blocks walk V together.
// - Epilogue from the accumulator registers: a thread holds 2 rows x 64
//   columns of the tile.  Scale, mask columns >= V (last tile only), take
//   the tile's row max (four partial maxima), rescale the running sum once,
//   add exp(x - m) (four partial sums).  The top-k needs no code per
//   element: each x is written to the thread's next free slot in shared
//   memory, and the slot is kept (the count moves) when x beats the last
//   entry of the thread's register top-KMAX list (KMAX 1, 2, 4, 8 or 16 by
//   k).  A short loop then folds the kept candidates into the list (a
//   thread's columns ascend, so a strict > keeps the lowest index first
//   among equals); after the first tiles a thread keeps ~8 / tile of them.
//   (Inserting in place, by branch or by predicated network, repeats the
//   list's code at all 128 elements; timed, that epilogue cost 2-3x the
//   products.)  After the last tile the four threads of a row merge (max,
//   sum) and their lists by shuffles, in (value desc, index asc) order,
//   and one writes.
// The next tile's first stages load while this tile's epilogue runs; the
// two consumer warpgroups share each stage, so the tensor cores idle
// during the epilogue.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                        // rows of a row block (64 a warpgroup)
constexpr int BN = 256;                        // columns of a tile (the wgmma N)
constexpr int BK = 32;                         // D per stage
constexpr int ROW = BK * 2;                    // 64 bytes an operand row: the swizzle span
constexpr int THREADS = 3 * 128;               // two consumer warpgroups, one producer
constexpr int CONSUMER_REGS = 232;             // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int PRODUCER_REGS = 40;              //   <= the SM's 65,536 (240 / 32, the whole
                                               //   file, never returned from the increase)
constexpr int A_BYTES = BM * ROW;              // 8 KB: hi or lo of the F rows
constexpr int B_BYTES = BN * ROW;              // 16 KB: hi or lo of the W columns
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;  // 48 KB
constexpr int STAGES = 3;                      // a 144 KB ring
constexpr int SLOTS = 64;                      // candidate slots: a thread's columns of a row
constexpr int CAND_BYTES = SLOTS * 256 * 5;    // f32 value + column byte, per consumer thread
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + CAND_BYTES + 1024;  // + 1024-byte alignment
constexpr int IDX_NONE = 0x7fffffff;

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

// ---- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory operand descriptor of K-major rows of 64 bytes with the
// 64-byte swizzle (what TMA writes): start address >> 4, LBO 1 (unused),
// 8-row groups 512 bytes apart (SBO), layout type 2 (64B swizzle).  A
// 16-deep step advances the start by 32 bytes (2 units) inside the atom.
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * ROW >> 4) << 32) | ((uint64_t)2 << 62);
}

// D (64 x 256, f32) += A (64 x 16, K-major) . B (16 x 256, K-major), both
// bf16 in shared memory; `acc` 0 overwrites D.
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

// ---- the split pre-pass

// F [n, d] f32 -> hi, lo [n, dp] bf16 (zeros past d)
__global__ void split_rows_kernel(const float* __restrict__ F, __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ lo, int n, int d, int dp) {
  const long long total = (long long)n * dp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dp;
    const int c = (int)(i - r * dp);
    const float x = c < d ? F[r * d + c] : 0.f;
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));  // x - hi is exact in f32
  }
}

// W [d, v] f32 -> hi, lo [v, dp] bf16, transposed through a 32 x 32 tile of
// shared memory so that reads and writes both go along rows (zeros past d)
__global__ void split_cols_kernel(const float* __restrict__ W, __nv_bfloat16* __restrict__ hi,
                                  __nv_bfloat16* __restrict__ lo, int d, int v, int dp) {
  __shared__ float tile[32][33];
  const int v0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int dd = d0 + j, vv = v0 + tx;
    tile[j][tx] = (dd < d && vv < v) ? W[(long long)dd * v + vv] : 0.f;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int vv = v0 + j, dd = d0 + tx;
    if (vv < v) {
      const float x = tile[tx][j];
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      hi[(long long)vv * dp + dd] = h;
      lo[(long long)vv * dp + dd] = __float2bfloat16_rn(x - __bfloat162float(h));
    }
  }
}

// ---- the products and the epilogue

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

template <int KMAX>
struct TopK {
  float v[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = -INFINITY;
      i[j] = IDX_NONE;
    }
  }

  // Insert a candidate known to beat v[KMAX - 1] whose index exceeds every
  // index held (a thread's columns ascend): a strict > keeps the earlier,
  // lower index first among equals.  Unrolled: the list stays in registers.
  __device__ __forceinline__ void insert(float cv, int ci) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (cv > v[j]) {
        const float tv = v[j];
        const int ti = i[j];
        v[j] = cv;
        i[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }

  // Insert a candidate if it beats v[KMAX - 1] (indices ascending, as in
  // insert).
  __device__ __forceinline__ void offer(float cv, int ci) {
    if (cv > v[KMAX - 1]) insert(cv, ci);
  }

  // Insert any candidate, in (value desc, index asc) order.
  __device__ __forceinline__ void push(float cv, int ci) {
    if (!better(cv, ci, v[KMAX - 1], i[KMAX - 1])) return;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (better(cv, ci, v[j], i[j])) {
        const float tv = v[j];
        const int ti = i[j];
        v[j] = cv;
        i[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }
};

// Load j of this block (its row blocks b, b + gridDim.x, ..., each with
// every 256-column tile of V, each tile in ksteps stages of BK along Dp)
// into the stage at `st`, completing on `fb` (one thread).
__device__ __forceinline__ void load_stage(const CUtensorMap* fhi, const CUtensorMap* flo,
                                           const CUtensorMap* whi, const CUtensorMap* wlo,
                                           uint32_t st, uint32_t fb, int j, int col_tiles,
                                           int ksteps) {
  const int per_rb = col_tiles * ksteps;
  const int rb = blockIdx.x + (j / per_rb) * gridDim.x;
  const int ct = (j % per_rb) / ksteps, kb = j % ksteps;
  mbar_expect_tx(fb, STAGE_BYTES);
  tma_load_2d(st, fhi, fb, kb * BK, rb * BM);
  tma_load_2d(st + A_BYTES, flo, fb, kb * BK, rb * BM);
  tma_load_2d(st + 2 * A_BYTES, whi, fb, kb * BK, ct * BN);
  tma_load_2d(st + 2 * A_BYTES + B_BYTES, wlo, fb, kb * BK, ct * BN);
}

// Block: two consumer warpgroups and a producer warpgroup.  ptxas allocates
// 168 registers a thread for 384 threads; setmaxnreg then moves them: the
// producer keeps 40 and the consumers take 232, so the accumulator (128)
// and the lists stay in registers.  One producer thread issues every load,
// each once both consumer warpgroups have freed its stage; no consumer
// thread branches alone while its wgmma are in flight (ptxas serializes
// wgmma around such a branch).
// Persistent: block b takes row blocks b, b + gridDim.x, ...; for each, every
// 256-column tile of V, for each tile ksteps stages of BK along Dp.  Stage
// layout (from a 1024-byte boundary): F hi [128 rows], F lo, W hi [256
// rows], W lo, each row 64 bytes, swizzled.  Warpgroup w multiplies F rows
// [64 w, 64 w + 64).  Thread (warp q of its warpgroup, lane 4g + t) holds
// rows 64 w + 16 q + g (h = 0) and + 8 (h = 1); accumulator chunk c (8
// columns) is acc[4c .. 4c + 3]: (h 0, col 8c + 2t), (h 0, + 1), (h 1, 8c +
// 2t), (h 1, + 1).
template <int KMAX>
__global__ void __launch_bounds__(THREADS, 1)
topk_wgmma_kernel(const __grid_constant__ CUtensorMap fhi, const __grid_constant__ CUtensorMap flo,
                  const __grid_constant__ CUtensorMap whi, const __grid_constant__ CUtensorMap wlo,
                  int n, int v, int ksteps, int k, float scale, float* __restrict__ m_out,
                  float* __restrict__ s_out, float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // broadcast from lane 0: the compiler sees the index uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int row_blocks = (n + BM - 1) / BM;
  const int col_tiles = (v + BN - 1) / BN;

  const int loads = ((row_blocks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) *
                    col_tiles * ksteps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread streams every stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      for (int j = 0; j < loads; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
        load_stage(&fhi, &flo, &whi, &wlo, base + s * STAGE_BYTES, smem_u32(&full[s]), j,
                   col_tiles, ksteps);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // candidate slots, [SLOTS][256 threads]: conflict-free at any slot
  unsigned char* cand = smem_raw + (base - smem_u32(smem_raw)) + STAGES * STAGE_BYTES;
  float* cand_v = reinterpret_cast<float*>(cand);
  uint8_t* cand_c = cand + SLOTS * 256 * 4;
  const int tid = threadIdx.x;
  const int wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t a_off = wg * (A_BYTES / 2);  // this warpgroup's 64 rows
  int it = 0;
  for (int rb = blockIdx.x; rb < row_blocks; rb += gridDim.x) {
    float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.f, 0.f};
    TopK<KMAX> top[2];
    top[0].init();
    top[1].init();
    for (int ct = 0; ct < col_tiles; ++ct) {
      float acc[128];
      int prev = 0;
      wg_fence();
      for (int kb = 0; kb < ksteps; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
        const uint32_t st = base + s * STAGE_BYTES;
        const uint64_t dfh = desc_sw(st + a_off);
        const uint64_t dfl = desc_sw(st + A_BYTES + a_off);
        const uint64_t dwh = desc_sw(st + 2 * A_BYTES);
        const uint64_t dwl = desc_sw(st + 2 * A_BYTES + B_BYTES);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {  // always lo.hi, hi.lo, hi.hi
          wgmma_bf16_ss_n256(acc, dfl + 2 * kk, dwh + 2 * kk, (kb | kk) != 0);
          wgmma_bf16_ss_n256(acc, dfh + 2 * kk, dwl + 2 * kk, 1);
          wgmma_bf16_ss_n256(acc, dfh + 2 * kk, dwh + 2 * kk, 1);
        }
        wg_commit();
        if (kb > 0) {  // the stage before has been read: free it
          wg_wait<1>();
          mbar_arrive(smem_u32(&empty[prev]));
        }
        prev = s;
      }
      wg_wait<0>();
      mbar_arrive(smem_u32(&empty[prev]));

      // ---- epilogue: columns [col0, col0 + 256), the last tile masked
      const int col0 = ct * BN;
      const int lim = min(BN, v - col0) - 2 * t;  // chunk-relative: 8c + e < lim
      // four partial maxima and sums a row: four chains in flight, not one
      float tmax[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 4; ++q) tmax[h][q] = -INFINITY;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = 8 * c + e < lim;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tmax[h][c & 3] = fmaxf(tmax[h][c & 3],
                                   live ? __fmul_rn(acc[4 * c + 2 * h + e], scale) : -INFINITY);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // while every column so far is masked, the sums stay 0 (no branch
        // of one thread alone: see the kernel's comment)
        const float m_new = fmaxf(fmaxf(run_m[h], fmaxf(fmaxf(tmax[h][0], tmax[h][1]),
                                                        fmaxf(tmax[h][2], tmax[h][3]))),
                                  -FLT_MAX);
        float sum[4] = {run_s[h] * __expf(run_m[h] - m_new), 0.f, 0.f, 0.f};
        const float thr = top[h].v[KMAX - 1];
        // every element goes to the next free slot, and a candidate (x >
        // thr) keeps its slot: no branch, and no insertion code per element
        int cnt = 0;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x =
                8 * c + e < lim ? __fmul_rn(acc[4 * c + 2 * h + e], scale) : -INFINITY;
            sum[c & 3] += __expf(x - m_new);
            cand_v[cnt * 256 + tid] = x;
            cand_c[cnt * 256 + tid] = (uint8_t)(8 * c + 2 * t + e);
            cnt += x > thr;
          }
        run_m[h] = m_new;
        run_s[h] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
        for (int j = 0; j < cnt; ++j)  // few after the first tiles
          top[h].offer(cand_v[j * 256 + tid], col0 + cand_c[j * 256 + tid]);
      }
    }

    // ---- merge the four threads of each row (lanes 4g .. 4g + 3)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, run_m[h], off);
        const float os = __shfl_xor_sync(0xffffffffu, run_s[h], off);
        const float m = fmaxf(run_m[h], om);
        float s = 0.f;
        if (run_m[h] > -INFINITY) s += run_s[h] * expf(run_m[h] - m);
        if (om > -INFINITY) s += os * expf(om - m);
        run_m[h] = m;
        run_s[h] = s;
        float ov[KMAX];
        int oi[KMAX];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          ov[j] = __shfl_xor_sync(0xffffffffu, top[h].v[j], off);
          oi[j] = __shfl_xor_sync(0xffffffffu, top[h].i[j], off);
        }
#pragma unroll
        for (int j = 0; j < KMAX; ++j) top[h].push(ov[j], oi[j]);
      }
      const int row = rb * BM + wg * 64 + (warp & 3) * 16 + g + 8 * h;
      if (t == 0 && row < n) {
        m_out[row] = run_m[h];
        s_out[row] = run_s[h];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            vals[(size_t)row * k + j] = top[h].v[j];
            idx[(size_t)row * k + j] = top[h].i[j];
          }
        }
      }
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

// A 2-D map over a bf16 [rows, dp] matrix: box BK x box_rows, 64-byte
// swizzle, zeros past the last row.
bool make_map(CUtensorMap* map, const __nv_bfloat16* ptr, int rows, int dp, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)dp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)dp * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int padded_d(int d) { return (d + BK - 1) / BK * BK; }

template <int KMAX>
cudaError_t launch(const CUtensorMap* maps, int n, int v, int ksteps, int k, float scale,
                   float* m_out, float* s_out, float* vals, int* idx, int grid,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(topk_wgmma_kernel<KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  topk_wgmma_kernel<KMAX><<<grid, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], n, v, ksteps, k, scale, m_out, s_out, vals, idx);
  return cudaGetLastError();
}

}  // namespace

// Bytes of the scratch `work` that topk_softmax_f32 needs: hi and lo of F
// [n, dp] and of W^T [v, dp] in bf16, dp = d rounded up to BK (32).
extern "C" long long topk_softmax_work_bytes(int n, int d, int v) {
  return 4LL * ((long long)n + v) * padded_d(d);
}

// F [n, d] f32 row-major, W [d, v] f32 row-major, 1 <= k <= 16, v >= k;
// `work`: topk_softmax_work_bytes(n, d, v) bytes of device memory, 16-byte
// aligned, used as scratch.  Outputs: m [n], s [n] (online max and sum of
// exp(logit - m)), vals [n, k] (raw scaled logits, descending), idx [n, k]
// (int32).  Returns cudaGetLastError() after the launches.
extern "C" int topk_softmax_f32(const float* F, const float* W, int n, int d, int v, int k,
                                float scale, float* m_out, float* s_out, float* vals, int* idx,
                                void* work, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || v < k || d < 1 || work == nullptr) return (int)cudaErrorInvalidValue;
  const int dp = padded_d(d);
  __nv_bfloat16* fh = static_cast<__nv_bfloat16*>(work);
  __nv_bfloat16* fl = fh + (size_t)n * dp;
  __nv_bfloat16* wh = fl + (size_t)n * dp;
  __nv_bfloat16* wl = wh + (size_t)v * dp;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)n * dp;
  const long long want = (total + 255) / 256;
  split_rows_kernel<<<(unsigned)(want < 16LL * sms ? want : 16LL * sms), 256, 0, stream>>>(
      F, fh, fl, n, d, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_cols_kernel<<<dim3((v + 31) / 32, dp / 32), dim3(32, 8), 0, stream>>>(W, wh, wl, d, v, dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[4];
  if (!make_map(&maps[0], fh, n, dp, BM) || !make_map(&maps[1], fl, n, dp, BM) ||
      !make_map(&maps[2], wh, v, dp, BN) || !make_map(&maps[3], wl, v, dp, BN))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (n + BM - 1) / BM;
  const int grid = row_blocks < sms ? row_blocks : sms;
  const int ksteps = dp / BK;
  if (k <= 1) err = launch<1>(maps, n, v, ksteps, k, scale, m_out, s_out, vals, idx, grid, stream);
  else if (k <= 2)
    err = launch<2>(maps, n, v, ksteps, k, scale, m_out, s_out, vals, idx, grid, stream);
  else if (k <= 4)
    err = launch<4>(maps, n, v, ksteps, k, scale, m_out, s_out, vals, idx, grid, stream);
  else if (k <= 8)
    err = launch<8>(maps, n, v, ksteps, k, scale, m_out, s_out, vals, idx, grid, stream);
  else
    err = launch<16>(maps, n, v, ksteps, k, scale, m_out, s_out, vals, idx, grid, stream);
  return (int)err;
}
