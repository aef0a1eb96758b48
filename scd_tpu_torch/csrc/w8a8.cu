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
// Design (simple and right first; wgmma and TMA are later work).  The GEMM
// core: a block of 256 threads owns 128 x 128 output tiles and walks D in
// 64-deep slices (32-deep in w8a8_fusedq where only those fit two blocks
// on an SM).  Each of its 8 warps computes 64 x 32 of a tile with mma.sync
// m16n8k32 s8 x s8 -> s32 from shared memory, 16 products per 32-deep
// step.  Weights arrive pre-transposed to [F, D] (prepared once at load),
// so both operands are K-contiguous and every fragment is one 32-bit
// shared load; padded smem rows make those loads conflict-free.  The
// weight slice streams in with cp.async into a second buffer while the
// current slice is multiplied.  Rows beyond N, columns beyond F and depth
// beyond D are zero-filled (a zero contributes nothing) and masked at the
// store.  D must be a multiple of 16 (whole 16-byte vectors), which the
// wrapper checks.
//
// w8a8_prequant streams both operands in 64-deep slices with cp.async.
// w8a8_fusedq: the block first takes the absmax of its 128 rows over all
// of D (each warp reduces 16 rows), then quantizes the rows once into an
// int8 panel [128, D] in shared memory and runs several column tiles
// against it, streaming only the weights.  x is read in bf16 and never
// written back quantized.  The panel needs D <= PANEL_MAX_D (a 100 KB
// panel at D = 768, the widest int8 layer of the towers); for a wider D
// Int8Dense quantizes with the plain chain and calls w8a8_prequant, as the
// JAX package does for a shape its fused kernel does not take.

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
constexpr int PANEL_MAX_D = 1536;  // panel + weight buffers within 227 KB

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

__device__ __forceinline__ unsigned quant1(float v, float sx) {
  float q = __fdiv_rn(v, sx);
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (unsigned)(__float2int_rn(q) & 0xff);
}

// 8 bf16 values -> 8 int8 values, element 0 in the lowest byte.
__device__ __forceinline__ uint2 quant8(uint4 raw, float sx) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    const unsigned pair = quant1(f.x, sx) | (quant1(f.y, sx) << 8);
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
    const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t)));
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

// The kernel of w8a8_fusedq (d <= PANEL_MAX_D): block (x, y) owns
// rows [128 y, 128 y + 128) and column tiles [tiles x, tiles (x + 1)),
// and streams the weights in KB-deep slices (32 or 64).  Dynamic shared
// memory: the int8 panel [128][dp + 16] (dp = d rounded up to KB, the tail
// zero), the weight double buffer, the row scales.
template <int ACT, typename OutT, int KB>
__global__ void __launch_bounds__(THREADS, 2)
w8a8_panel_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ wq,
                  const float* __restrict__ sw,
                  const float* __restrict__ bias, OutT* __restrict__ out,
                  int n, int d, int f, int tiles) {
  constexpr int PLDS = KB + 16;  // 48- or 80-byte rows: no conflicts
  extern __shared__ __align__(16) int8_t smem[];
  const int dp = (d + KB - 1) / KB * KB;
  const int lda = dp + 16;  // (dp + 16) / 4 words = 4 mod 8: no conflicts
  int8_t* panel = smem;
  int8_t(*Bs)[BN][PLDS] =
      reinterpret_cast<int8_t(*)[BN][PLDS]>(smem + (size_t)BM * lda);
  float* sx_s = reinterpret_cast<float*>(smem + (size_t)BM * lda +
                                         2 * BN * PLDS);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int tile_lo = blockIdx.x * tiles;
  const int tile_hi = min(tile_lo + tiles, (f + BN - 1) / BN);
  const int kt_count = dp / KB;

  // row scales over the full depth
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int grow = m0 + r;
    float amax = 0.0f;
    if (grow < n) {
      const uint4* rowp = reinterpret_cast<const uint4*>(x + (size_t)grow * d);
      for (int c = lane; c < d / 8; c += 32) {
        const uint4 raw = __ldg(rowp + c);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 v = __bfloat1622float2(h[j]);
          amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sx_s[r] = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  }
  __syncthreads();

  // quantize the rows once: 8 bf16 -> 8 int8 per chunk
  const int chunks = dp / 8;
  for (int c = tid; c < BM * chunks; c += THREADS) {
    const int row = c / chunks, kc = (c - row * chunks) * 8;
    const int grow = m0 + row;
    const uint4 raw = (grow < n && kc < d)
                          ? __ldg(reinterpret_cast<const uint4*>(
                                x + (size_t)grow * d + kc))
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint2*>(panel + (size_t)row * lda + kc) =
        quant8(raw, sx_s[row]);
  }

  // a 128 x KB weight slice: 8 * KB 16-byte chunks, 1 or 2 per thread
  auto load_b = [&](int buf, int n0, int k0) {
#pragma unroll
    for (int c = tid; c < BN * KB / 16; c += THREADS) {
      const int row = c / (KB / 16), kc = (c % (KB / 16)) * 16;
      const int gk = k0 + kc;
      const int gcol = n0 + row;
      const bool ok = gcol < f && gk < d;
      cp_async16(&Bs[buf][row][kc], ok ? wq + (size_t)gcol * d + gk : wq,
                 ok);
    }
    cp_async_commit();
  };

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int n0 = tile * BN;
    int acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    load_b(0, n0, 0);
    cp_async_wait_all();
    __syncthreads();  // also publishes the panel before the first tile
    for (int kt = 0; kt < kt_count; ++kt) {
      const int buf = kt & 1;
      const bool more = kt + 1 < kt_count;
      if (more) load_b(buf ^ 1, n0, (kt + 1) * KB);
#pragma unroll
      for (int ks = 0; ks < KB; ks += 32) {
        unsigned a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int8_t* p = panel + (size_t)(wm * 64 + mi * 16 + g) * lda +
                            kt * KB + ks + t * 4;
          a[mi][0] = *reinterpret_cast<const unsigned*>(p);
          a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * lda);
          a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
          a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * lda + 16);
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
    epilogue<ACT, OutT>(acc, sx_s, m0, n0, wm, wn, g, t, sw, bias, out, n,
                        f);
  }
}

size_t panel_smem(int d, int kb) {
  const int dp = (d + kb - 1) / kb * kb;
  return (size_t)BM * (dp + 16) + 2 * BN * (kb + 16) + BM * sizeof(float);
}

template <int ACT, typename OutT, int KB>
cudaError_t launch_panel_kb(const void* x, const int8_t* wq, const float* sw,
                            const float* bias, void* out, int n, int d,
                            int f, int tiles, cudaStream_t stream) {
  const size_t smem = panel_smem(d, KB);
  cudaError_t err = cudaFuncSetAttribute(
      w8a8_panel_kernel<ACT, OutT, KB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nt = (f + BN - 1) / BN;
  const dim3 grid((nt + tiles - 1) / tiles, (n + BM - 1) / BM);
  w8a8_panel_kernel<ACT, OutT, KB><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), wq, sw, bias,
      reinterpret_cast<OutT*>(out), n, d, f, tiles);
  return cudaGetLastError();
}

// 64-deep weight slices unless only 32-deep ones let two blocks share an
// SM (the second block hides mma.sync latency; deeper slices halve the
// barriers).
template <int ACT, typename OutT>
cudaError_t launch_panel(const void* x, const int8_t* wq, const float* sw,
                         const float* bias, void* out, int n, int d, int f,
                         int tiles, cudaStream_t stream) {
  int dev = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  auto two_fit = [&](int kb) {
    return 2 * (panel_smem(d, kb) + reserved) <= (size_t)per_sm;
  };
  if (!two_fit(64) && two_fit(32))
    return launch_panel_kb<ACT, OutT, 32>(x, wq, sw, bias, out, n, d, f,
                                          tiles, stream);
  return launch_panel_kb<ACT, OutT, 64>(x, wq, sw, bias, out, n, d, f, tiles,
                                        stream);
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
    return launch_panel<ACT, __nv_bfloat16>(x, wq, sw, bias, out, n, d, f,
                                            tiles, stream);
  return launch_panel<ACT, float>(x, wq, sw, bias, out, n, d, f, tiles,
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
