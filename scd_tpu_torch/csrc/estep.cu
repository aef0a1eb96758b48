// Nearest-center assignment: for every row of x, the first center index
// attaining min ||x - c||^2, and that squared distance.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::estep_assign_pallas
// (kernel body _estep_kernel).  Same contract: x and c in f32, the partial
// distance |c|^2 - 2 x.c, the label is the first index attaining the min
// (ties to the lowest index, across center tiles too), and mindist =
// max(min + |x|^2, 0).  Any N, any K >= 1, any D >= 1: centers past K never
// win.  Two runs give identical bits.
//
// The products are split into bf16 on the tensor cores: x = x_hi + x_lo and
// c = c_hi + c_lo, and the cross term is x_lo.c_hi + x_hi.c_lo + x_hi.c_hi
// (lo.lo dropped, ~2^-16 of |x||c|).  That is the split of the JAX
// package's XLA route (scd_tpu/ops/distance.py, Precision.HIGH, the
// function its k-means runners call); the TPU kernel asks for HIGHEST, full
// f32 products, which this departs from, as csrc/fused_em.cu does.  |c|^2
// is taken of the split, c' = c_hi + c_lo (exact in f32), so that
// |c'|^2 - 2 x.c' is the expansion of one center, and each 32-deep stage's
// products go into a fresh accumulator added to the running sum in f32
// (the tensor cores' own accumulation does not round to nearest): the two
// biases that fused_em.cu's E-step removed.  |x|^2 is summed from the f32
// values of x in a fixed order.
//
// What bounds it on an H100: bytes.  At the k-means runners' shape
// (N = 130,048, D = 768, K = 100) x is 400 MB, 0.120 ms at 3.35 TB/s; the
// three bf16 passes over K padded to 128 are 76.7 GFLOP, 0.078 ms at
// 989 TFLOP/s.
//
// Design (Hopper: TMA, mbarriers, wgmma with A from registers):
// 1. Pre-pass: the centers into bf16 hi and lo [Kp, Dx] (K padded to a
//    multiple of 128, D to a multiple of 8, zeros past both) with
//    |c_hi + c_lo|^2 (1e30 in the padded columns).  Rows that TMA cannot
//    read where they lie (D % 4 != 0, or a base not 16-byte aligned) are
//    copied once into an aligned f32 buffer [N, D rounded up to 4]; x is
//    otherwise read where it lies.
// 2. A block of two consumer warpgroups and a producer warpgroup
//    (setmaxnreg 232 / 40) owns a tile of 128 rows (64 a warpgroup) and
//    walks the center tiles of 128; blocks are persistent over the row
//    tiles.  One producer thread streams 32-deep stages into a ring of six
//    32 KB stages: f32 x of the 128 rows (128 bytes a row, 128-byte
//    swizzle) and hi and lo of the 128 centers (64-byte swizzle), zeros
//    past N, D and Kp.  Per stage each consumer thread loads its A-fragment
//    values of x from the stage (two rows, eight f32 columns of each),
//    adds their squares to |x|^2 (first center tile), splits them into
//    bf16 hi and lo in registers, and per 16-deep step issues wgmma
//    m64n128k16 with A from registers and c K-major from shared memory:
//    x_lo.c_hi, x_hi.c_lo, x_hi.c_hi, always in that order.  No copy of
//    x in bf16 is written to device memory.  While one warpgroup splits and
//    adds, the other's products keep the tensor cores busy.
// 3. The argmin is taken from the accumulator registers: a running (min,
//    index) per thread over its columns in ascending order (strict <, so
//    ties keep the lower index, also across center tiles), then the four
//    threads of a row by shuffles, lexicographic on (distance, index).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;                       // centers of a center tile (wgmma N)
constexpr int BM = 128;                       // rows of a tile (64 a warpgroup)
constexpr int BK = 32;                        // D per stage
constexpr int X_ROW = BK * 4;                 // 128 bytes of f32 x a row: the swizzle span
constexpr int C_ROW = BK * 2;                 // 64 bytes of bf16 centers a row
constexpr int X_BYTES = BM * X_ROW;           // 16 KB
constexpr int C_BYTES = NT * C_ROW;           // 8 KB: hi or lo of the centers
constexpr int STAGE = X_BYTES + 2 * C_BYTES;  // 32 KB
constexpr int STAGES = 6;                     // a 192 KB ring
constexpr int SMEM = STAGES * STAGE + 1024;   // + the 1024-byte alignment pad
constexpr int THREADS = 3 * 128;              // two consumer warpgroups, one producer
constexpr int CONSUMER_REGS = 232;
constexpr int PRODUCER_REGS = 40;
constexpr int IDX_NONE = 0x7fffffff;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
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
         ((uint64_t)(8 * C_ROW >> 4) << 32) | ((uint64_t)2 << 62);
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) . B (16 x 128, bf16
// K-major in shared memory); `acc` 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ---- 1. the pre-pass

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

// x [n, d] -> xp [n, dp] f32, zeros past d: rows that TMA can address.
__global__ void pad_rows_kernel(const float* __restrict__ x, int n, int d, int dp,
                                float* __restrict__ xp) {
  const long long total = (long long)n * dp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / dp;
    const int col = (int)(i - r * dp);
    xp[i] = col < d ? x[r * d + col] : 0.f;
  }
}

// ---- 2. the assignment

// Thread (warpgroup wg, warp q of it, lane 4g + t) multiplies rows
// [64 wg, 64 wg + 64) of the tile and holds rows ra = 64 wg + 16 q + g
// (h = 0) and ra + 8 (h = 1).  Its A fragment of a 16-deep step kk is
// a[j] = (row ra + 8 (j & 1), columns 16 kk + 8 (j >> 1) + 2t, + 1); its
// accumulator chunk c (8 centers) is acc[4c .. 4c + 3]: (h 0, center
// 8c + 2t), (h 0, + 1), (h 1, 8c + 2t), (h 1, + 1).  The four threads of
// a row hold, between them, every column of it, and every center.
__global__ void __launch_bounds__(THREADS, 1)
estep_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mch,
             const __grid_constant__ CUtensorMap mcl, const float* __restrict__ csq, int n,
             int ctiles, int ksteps, int* __restrict__ labels, float* __restrict__ mindist) {
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // broadcast from lane 0: the compiler sees the index uniform
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int tiles = (n + BM - 1) / BM;

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
      const int per_tile = ctiles * ksteps;
      const int loads = ((tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * per_tile;
      for (int j = 0; j < loads; ++j) {
        const int s = j % STAGES, use = j / STAGES;
        if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
        const int tile = blockIdx.x + (j / per_tile) * gridDim.x;
        const int ct = (j % per_tile) / ksteps, kb = j % ksteps;
        const uint32_t st = base + s * STAGE, fb = smem_u32(&full[s]);
        mbar_expect_tx(fb, STAGE);
        tma_load_2d(st, &mx, fb, kb * BK, tile * BM);
        tma_load_2d(st + X_BYTES, &mch, fb, kb * BK, ct * NT);
        tma_load_2d(st + X_BYTES + C_BYTES, &mcl, fb, kb * BK, ct * NT);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2, q = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int ra = wg * 64 + q * 16 + g;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float rmin[2] = {INFINITY, INFINITY};
    int rarg[2] = {IDX_NONE, IDX_NONE};
    float xsq[2] = {0.f, 0.f};
    for (int ct = 0; ct < ctiles; ++ct) {
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < ksteps; ++kb, ++it) {
        const int s = it % STAGES;
        mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
        const uint32_t st = base + s * STAGE;
        const unsigned char* xs = smem_raw + (st - raw);
        // the A fragments of both 16-deep steps, split into hi and lo;
        // 16-byte chunk index XOR (row mod 8): the 128-byte swizzle
        uint32_t ah[BK / 16][4], al[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ra + 8 * (j & 1);
            const int chunk = 4 * kk + 2 * (j >> 1) + (t >> 1);
            const float2 v =
                *reinterpret_cast<const float2*>(xs + r * X_ROW + ((chunk ^ (r & 7)) << 4) + 8 * (t & 1));
            if (ct == 0) {
              xsq[j & 1] = fmaf(v.x, v.x, xsq[j & 1]);
              xsq[j & 1] = fmaf(v.y, v.y, xsq[j & 1]);
            }
            const float hx = __bfloat162float(__float2bfloat16_rn(v.x));
            const float hy = __bfloat162float(__float2bfloat16_rn(v.y));
            ah[kk][j] = pack_bf16(hx, hy);            // exact: hx, hy are bf16 values
            al[kk][j] = pack_bf16(v.x - hx, v.y - hy);  // v - h is exact in f32
          }
        reg_fence<4 * (BK / 16)>(&ah[0][0]);
        reg_fence<4 * (BK / 16)>(&al[0][0]);
        const uint64_t dch = desc_sw64(st + X_BYTES);
        const uint64_t dcl = desc_sw64(st + X_BYTES + C_BYTES);
        float part[NT / 2];  // this stage's products
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {  // always x_lo.c_hi, x_hi.c_lo, x_hi.c_hi
          wgmma_rs_n128(part, al[kk], dch + 2 * kk, kk);
          wgmma_rs_n128(part, ah[kk], dcl + 2 * kk, 1);
          wgmma_rs_n128(part, ah[kk], dch + 2 * kk, 1);
        }
        wg_commit();
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

    // the four threads of a row: lexicographic (distance, index); |x|^2
    // of each row from its four quarters, in a fixed tree
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, rmin[h], off);
        const int oa = __shfl_xor_sync(0xffffffffu, rarg[h], off);
        if (ob < rmin[h] || (ob == rmin[h] && oa < rarg[h])) {
          rmin[h] = ob;
          rarg[h] = oa;
        }
      }
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 1);
      xsq[h] += __shfl_xor_sync(0xffffffffu, xsq[h], 2);
    }
    const int row = tile * BM + ra + 8 * t;  // t = 0: row ra, t = 1: ra + 8
    if (t < 2 && row < n) {
      const float best = t == 0 ? rmin[0] : rmin[1];
      const int barg = t == 0 ? rarg[0] : rarg[1];
      labels[row] = barg == IDX_NONE ? 0 : barg;
      mindist[row] = fmaxf(best + (t == 0 ? xsq[0] : xsq[1]), 0.f);
    }
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

// A 2-D map over a [rows, cols] matrix (row stride cols): boxes of BK
// columns x 128 rows, zeros past the edges.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int elem_bytes,
              int rows, int cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)BK, 128u};
  const cuuint32_t elem[2] = {1u, 1u};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x [n, d] f32 and c [k, d] f32, both contiguous; n >= 1, k >= 1, d >= 1.
// Outputs labels [n] int32 and mindist [n] f32.  Scratch from the wrapper
// (ops/distance.py): chi, clo [kp, dx] bf16 and csq [kp] f32, with kp = k
// rounded up to 128 and dx = d rounded up to 8; xpad [n, dp] f32 with
// dp = d rounded up to 4 where x is not 16-byte aligned or d % 4 != 0,
// else null (x is read where it lies).  Launches the pre-pass and the
// assignment on `stream` and returns cudaGetLastError().
extern "C" int estep_assign(const float* x, const float* c, int n, int d, int k, int kp, int dx,
                            int dp, float* xpad, void* chi, void* clo, float* csq, int* labels,
                            float* mindist, cudaStream_t stream) {
  const bool pad = xpad != nullptr;
  if (n < 1 || k < 1 || d < 1 || kp < k || kp % NT != 0 || dx < d || dx % 8 != 0 ||
      (pad && (dp < d || dp % 4 != 0)) ||
      (!pad && (d % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  split_centers_kernel<<<(kp * 32 + 255) / 256, 256, 0, stream>>>(
      c, k, d, kp, dx, static_cast<__nv_bfloat16*>(chi), static_cast<__nv_bfloat16*>(clo), csq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (pad) {
    const long long want = ((long long)n * dp + 255) / 256;
    pad_rows_kernel<<<(unsigned)(want < 8192 ? want : 8192), 256, 0, stream>>>(x, n, d, dp, xpad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap mx, mch, mcl;
  if (!make_map(&mx, pad ? xpad : x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n, pad ? dp : d,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mch, chi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kp, dx, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&mcl, clo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kp, dx, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  static int smem_set_on = -1;  // the shared-memory limit, set once per device
  if (smem_set_on != dev) {
    err = cudaFuncSetAttribute(estep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set_on = dev;
  }
  const int tiles = (n + BM - 1) / BM;
  estep_kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM, stream>>>(
      mx, mch, mcl, csq, n, kp / NT, (d + BK - 1) / BK, labels, mindist);
  return (int)cudaGetLastError();
}
