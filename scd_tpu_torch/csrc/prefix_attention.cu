// Prefix attention: suffix queries that attend a per-template prefix K/V
// shared by the whole batch, then their own suffix keys under a causal mask.
//
// Replaces no TPU kernel.  The JAX package computes this attention with
// plain XLA (scd_tpu/models/vit.py::_prefix_attention, the prefix-KV
// vocabulary build's text tower); the port's towers never run attention
// through a library call (SDPA), so it is a hand-written kernel here too.
// Per (batch b, head h), with keys in the order [prefix, suffix]:
//   s[i, c] = (q_i . key_c) in f32 from products of the input type, times
//     `scale`; key_c = pk[c] for c < P (the same for every b), k[b, c - P]
//     after; prefix keys c >= p_valid (pad tokens of the prefix row) and
//     suffix keys c - P > i (the causal mask) are -inf;
//   p = exp(s - rowmax) / rowsum in f32 (IEEE division), rounded to v's
//     type;
//   out[i] = sum_c p[i, c] value_c accumulated in f32, stored in v's type.
// The suffix diagonal is always seen, so no row is empty.  pk / pv are read
// with a batch stride of 0: the [B, P, H, d] expansion never exists.
//
// What bounds it on an H100: bytes.  On the vocabulary build's path (B
// 8,192 names, S 16 suffix tokens, P 16 prefix tokens, H 8, d 64, bf16)
// q, k, v (strided views of the packed qkv) and the output are 537 MB,
// 0.160 ms at 3.35 TB/s (0.080 ms at S 8); the products (q . k and p . v
// over <= 32 keys) are 8.6 GFLOP, 0.009 ms at the bf16 tensor-core rate.
//
// Two kernels, chosen by the host (ops/attention.py::prefix_route):
//
// prefix_mma_kernel: bf16 at head_dim 64 (every shipped text tower), on
// the tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Why mma.sync and not wgmma: a wgmma takes 64 query rows against one B
// operand, but every (name, head) has only S <= 16 query rows and its
// own suffix keys, so a 64-row tile would be three quarters padding or
// would need four names to share keys they do not share; the 16-row
// tile of mma.sync fits S <= 16 exactly, one warp per (name, head).  The
// products are 0.009 ms of a 0.08-0.16 ms bound, so the tensor-core rate
// wgmma adds would buy nothing; what the design must do is move the
// bytes once and keep the issue slots free.
// - A block owns a group of heads (the largest divisor of H that is <= 8:
//   the text tower's 8), one warp each, and walks over names (a
//   persistent grid, one block an SM at ~190 registers a thread; held to
//   128 for two blocks an SM, it spilled and ran 30-35% slower on an H100):
//   the prefix K / V of its heads ([P, group, 64] bf16, 32 KB at P 16) is
//   staged in shared memory once per block, not re-read from L2 by each
//   (name, head) as the SIMT kernel does (268 MB a launch, as many bytes
//   as the DRAM bound moves).
// - Each name's q, k, v rows of the group (S x group x 128 bytes each;
//   one contiguous 3 KB row of the packed qkv a token at H 8) land by
//   cp.async 16-byte copies in a ring of stages (up to four, as many as
//   fit beside the prefix), commit groups keeping the next names' loads
//   in flight while the tensor cores work on this one.  Staged rows are
//   144 bytes apart (128 + 16), so ldmatrix's eight row reads hit eight
//   bank groups.  Rows past S and prefix rows past P are never staged:
//   ldmatrix reads them from 16 zero bytes, so the query tile's pad rows
//   and the pad keys are zeros.
// - S = Q . K^T: Q's 16 x 64 A fragments by ldmatrix; each 8-key n-tile
//   (prefix tiles up to p_valid rounded up to 8, one or two suffix tiles)
//   by ldmatrix of the staged key rows, 4 k-steps over head_dim.  Lane l
//   holds rows l/4 and l/4 + 8, key columns 2(l%4) and 2(l%4)+1 of each
//   n-tile: the masks (prefix key >= p_valid; suffix key j > row) and
//   the softmax run in these fragments, the row max and sum over a quad
//   of lanes (two shuffles); n-tiles that no key of the input reaches
//   (past p_valid, the second suffix tile at S <= 8) are skipped.
//   p = exp(s - max) / sum, the quotient correctly rounded from one
//   reciprocal a row and an FMA correction (as csrc/attention.cu), is
//   rounded to bf16 before p . v, as the contract asks: the normalisation
//   is not deferred to the output, which would round another value.
// - O = P . V: the score fragments, rounded, are the A fragments of the
//   second product (no trip through shared memory); V's B fragments by
//   ldmatrix.trans; 16-key k-steps x 8 n-tiles of head_dim.
// - The output (bf16) goes into the name's staged q rows of its head,
//   then the block writes each token's [group x 64] row with 16-byte
//   coalesced stores.
// It takes any 16-byte-aligned base, batch, row and head strides; the
// host refuses other views (no fallback to the SIMT kernel).
//
// prefix_attn_kernel (SIMT, no tensor cores): f32 inputs and head_dims
// other than 64; no shipped config launches it on the card.  One block
// of four warps per (b, h) pair stages its n = P + S keys' K and V and
// its S query rows in shared memory as f32 (16-byte vector loads where
// the views allow them, division-free), zero-padding head_dim to a
// multiple of 4.  Each warp owns R consecutive query rows (R = S / 4
// rounded up to 1, 2 or 4) and each lane one key (c = lane: n <= 32):
// S = Q . K^T over float4 chunks of head_dim, the row max and sum by
// warp shuffles, O = P . V with each p shuffled from its owning lane.
// Limits (both): S <= 16, P + S <= 32; the SIMT kernel head_dim <= 128.
// Anything else is refused before a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_S = 16;
constexpr int MAX_KEYS = 32;
constexpr int MAX_HD = 128;

struct Strides {
  long long b, l, h;  // batch (0 for the prefix), row, head; elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One group of head rows to stage: rows [0, rows) of a view, into
// dst[r * ld + c] as f32.
template <typename T>
struct Group {
  const T* src;
  long long stride;  // elements between rows
  float* dst;
  int ld, rows;
};

// 16 bytes of the input type -> VE floats at dst (16-byte aligned)
__device__ __forceinline__ void put16(float* dst, uint4 raw, float) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
__device__ __forceinline__ void put16(float* dst, uint4 raw, __nv_bfloat16) {
  // a bf16 is the high half of its f32
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(__uint_as_float(w[2 * i] << 16), __uint_as_float(w[2 * i] & 0xffff0000u),
                    __uint_as_float(w[2 * i + 1] << 16),
                    __uint_as_float(w[2 * i + 1] & 0xffff0000u));
}

// Stage the five groups.  Each thread owns one column chunk (16 bytes, or
// one element where the views do not allow 16-byte loads) and every
// `step`-th row: no division in the loops, and the first row of every
// group is loaded before any is stored, so a block waits about one memory
// latency where every group fits one pass (the path's: rows <= 16).
template <typename T>
__device__ void stage(const Group<T> (&g)[5], int hd, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  const int per_row = vec ? hd / VE : hd;
  const int step = THREADS / per_row;
  const int r0 = threadIdx.x / per_row, c = (threadIdx.x % per_row) * (vec ? VE : 1);
  if (r0 >= step) return;
  if (vec) {
    uint4 raw[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (r0 < g[i].rows) raw[i] = *reinterpret_cast<const uint4*>(g[i].src + r0 * g[i].stride + c);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (r0 < g[i].rows) put16(g[i].dst + r0 * g[i].ld + c, raw[i], T());
      for (int r = r0 + step; r < g[i].rows; r += step)
        put16(g[i].dst + r * g[i].ld + c,
              *reinterpret_cast<const uint4*>(g[i].src + r * g[i].stride + c), T());
    }
  } else {
    T raw[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      if (r0 < g[i].rows) raw[i] = g[i].src[r0 * g[i].stride + c];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      if (r0 < g[i].rows) g[i].dst[r0 * g[i].ld + c] = to_f32(raw[i]);
      for (int r = r0 + step; r < g[i].rows; r += step)
        g[i].dst[r * g[i].ld + c] = to_f32(g[i].src[r * g[i].stride + c]);
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
prefix_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ pk, const T* __restrict__ pv, T* __restrict__ out,
                   Strides sq, Strides sk, Strides sv, Strides sp, Strides spv, Strides so,
                   int heads, int S, int P, int hd, int p_valid, float scale, int vec) {
  extern __shared__ float smem[];
  const int n = P + S;
  const int hd4 = (hd + 3) & ~3;
  const int ldk = hd4 + 4;  // 16-byte rows, conflict-free float4 reads
  float* Ks = smem;             // [n][ldk]
  float* Qs = Ks + n * ldk;     // [S][ldk]
  float* Vs = Qs + S * ldk;     // [n][hd]

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // ---- stage K = [pk; k_b], V = [pv; v_b], Q_b as f32; zero the pad columns
  const Group<T> groups[5] = {{pk + h * sp.h, sp.l, Ks, ldk, P},
                              {k + b * sk.b + h * sk.h, sk.l, Ks + P * ldk, ldk, S},
                              {q + b * sq.b + h * sq.h, sq.l, Qs, ldk, S},
                              {pv + h * spv.h, spv.l, Vs, hd, P},
                              {v + b * sv.b + h * sv.h, sv.l, Vs + P * hd, hd, S}};
  stage(groups, hd, vec);
  if (hd4 > hd) {
    for (int i = threadIdx.x; i < (n + S) * (hd4 - hd); i += THREADS) {
      const int r = i / (hd4 - hd), c = hd + i % (hd4 - hd);
      Ks[r * ldk + c] = 0.f;  // rows n.. are Qs's (contiguous after Ks)
    }
  }
  __syncthreads();

  const int lv = min(max(p_valid, 0), P);
  const int row0 = warp * R;
  if (row0 >= S) return;  // warp-uniform: no shuffle below is left waiting

  // ---- S = Q . K^T: R rows of this warp x the key of this lane
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  const float* krow = Ks + min(lane, n - 1) * ldk;
  for (int c4 = 0; c4 < hd4; c4 += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(krow + c4);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = min(row0 + i, S - 1);
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * ldk + c4);
      float a = acc[i];
      a = fmaf(qv.x, kv.x, a);
      a = fmaf(qv.y, kv.y, a);
      a = fmaf(qv.z, kv.z, a);
      a = fmaf(qv.w, kv.w, a);
      acc[i] = a;
    }
  }

  // ---- scale, mask, softmax in f32; p rounded to v's type
  const int c = lane;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    const bool keep = c < P ? c < lv : (c < n && c - P <= r);
    float x = keep ? acc[i] * scale : -INFINITY;
    float m = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    x = expf(x - m);  // masked: exp(-inf) = 0
    float sum = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    acc[i] = r < S ? to_f32(from_f32<T>(__fdiv_rn(x, sum))) : 0.f;
  }

  // ---- O = P . V: lane owns columns lane + 32 j (j < dc); p from its
  // owning lane
  constexpr int DC = MAX_HD / 32;
  const int dc = (hd + 31) / 32;  // warp-uniform
  float o[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) o[i][j] = 0.f;
  for (int key = 0; key < n; ++key) {
    const float* vrow = Vs + key * hd;
    float vv[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = lane + 32 * j;
      vv[j] = (j < dc && col < hd) ? vrow[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float p = __shfl_sync(0xffffffffu, acc[i], key);
#pragma unroll
      for (int j = 0; j < DC; ++j)
        if (j < dc) o[i][j] = fmaf(p, vv[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    if (r >= S) continue;
    T* orow = out + b * so.b + r * so.l + h * so.h;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int col = lane + 32 * j;
      if (col < hd) orow[col] = from_f32<T>(o[i][j]);
    }
  }
}

template <typename T, int R>
int launch(const void* q, const void* k, const void* v, const void* pk, const void* pv,
           void* out, Strides sq, Strides sk, Strides sv, Strides sp, Strides spv, Strides so,
           int batch, int heads, int S, int P, int hd, int p_valid, float scale, int vec,
           cudaStream_t stream) {
  const int n = P + S, ldk = ((hd + 3) & ~3) + 4;
  const size_t smem = sizeof(float) * ((size_t)(n + S) * ldk + (size_t)n * hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prefix_attn_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)batch * heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  prefix_attn_kernel<T, R><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(pk), static_cast<const T*>(pv), static_cast<T*>(out), sq, sk, sv,
      sp, spv, so, heads, S, P, hd, p_valid, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_r(const void* q, const void* k, const void* v, const void* pk, const void* pv,
             void* out, Strides sq, Strides sk, Strides sv, Strides sp, Strides spv,
             Strides so, int batch, int heads, int S, int P, int hd, int p_valid, float scale,
             int vec, cudaStream_t stream) {
  const int r = (S + WARPS - 1) / WARPS;
  if (r <= 1)
    return launch<T, 1>(q, k, v, pk, pv, out, sq, sk, sv, sp, spv, so, batch, heads, S, P, hd,
                        p_valid, scale, vec, stream);
  if (r <= 2)
    return launch<T, 2>(q, k, v, pk, pv, out, sq, sk, sv, sp, spv, so, batch, heads, S, P, hd,
                        p_valid, scale, vec, stream);
  return launch<T, 4>(q, k, v, pk, pv, out, sq, sk, sv, sp, spv, so, batch, heads, S, P, hd,
                      p_valid, scale, vec, stream);
}

// ------------------------------------------------ the mma.sync kernel

constexpr int MMA_HD = 64;         // head_dim it takes
constexpr int MMA_ROW = 144;       // bytes between staged head rows
constexpr int MMA_GROUP = 8;       // most heads (warps) a block
constexpr int MMA_MAX_STAGES = 4;  // most names a block holds in shared memory
constexpr int MMA_CHUNKS = 4;      // 16-byte copies a thread, tensor and name: <= S / 4

struct View {
  const __nv_bfloat16* p;
  long long b, l, h;  // batch (0 for the prefix), row, head strides; elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// e / sum, correctly rounded (as IEEE division), from inv = RN(1 / sum)
// and one FMA correction (Markstein), as csrc/attention.cu divides.  Not
// div.rn: a masked key's e = 0 sends div.rn to its slow path, which on an
// H100 nearly tripled the kernel's time at the build's S 8 (PERF.md).
__device__ __forceinline__ float quot(float e, float sum, float inv) {
  const float q = __fmul_rn(e, inv);
  return fmaf(fmaf(-sum, q, e), inv, q);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory, in bytes: 16 zero bytes; the group's prefix K rows
// [group][P] and V rows, MMA_ROW apart; then NST stages, each the name's
// Q, K, V rows [group][S] of the group's heads.
template <int NST>
__global__ void __launch_bounds__(32 * MMA_GROUP, 1)
prefix_mma_kernel(View q, View k, View v, View pk, View pv, __nv_bfloat16* __restrict__ out,
                  long long osb, long long osl, long long osh, int batch, int group, int S,
                  int P, int p_valid, float scale) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* smem = mma_smem;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.y * group;  // the group's first head
  const int nb = gridDim.x, b0 = blockIdx.x;
  const int count = (batch - b0 + nb - 1) / nb;  // names of this block: b0 + it * nb

  const uint32_t zero = smem_u32(smem);
  const uint32_t pk_s = zero + 16, pv_s = pk_s + group * P * MMA_ROW;
  const uint32_t tensor_bytes = group * S * MMA_ROW;
  const uint32_t stage0 = pv_s + group * P * MMA_ROW;
  if (tid == 0) *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);

  // ---- each thread's 16-byte copies of a name (the same for every
  // name but for the batch offset): chunk cc of token rows r = rs + j *
  // step, row r = (token i, head hh) with i = r / group
  const int cc = tid & 7, rs = tid >> 3, step = 4 * group, rows = group * S;
  long long oq[MMA_CHUNKS], ok[MMA_CHUNKS], ov[MMA_CHUNKS];
  uint32_t dst[MMA_CHUNKS];
#pragma unroll
  for (int j = 0; j < MMA_CHUNKS; ++j) {
    const int r = rs + j * step, i = r / group, hh = r - i * group, h = h0 + hh;
    oq[j] = i * q.l + h * q.h + cc * 8;
    ok[j] = i * k.l + h * k.h + cc * 8;
    ov[j] = i * v.l + h * v.h + cc * 8;
    dst[j] = (hh * S + i) * MMA_ROW + cc * 16;
  }
  auto load_name = [&](int b, int st) {
    const uint32_t base = stage0 + st * 3 * tensor_bytes;
    const __nv_bfloat16 *qb = q.p + b * q.b, *kb = k.p + b * k.b, *vb = v.p + b * v.b;
#pragma unroll
    for (int j = 0; j < MMA_CHUNKS; ++j) {
      if (rs + j * step < rows) {
        cp_async16(base + dst[j], qb + oq[j]);
        cp_async16(base + tensor_bytes + dst[j], kb + ok[j]);
        cp_async16(base + 2 * tensor_bytes + dst[j], vb + ov[j]);
      }
    }
  };

  // ---- the prefix of the group's heads, once; with the first names
  for (int r = rs; r < group * P; r += step) {
    const int p = r / group, hh = r - p * group, h = h0 + hh;
    const uint32_t d = (hh * P + p) * MMA_ROW + cc * 16;
    cp_async16(pk_s + d, pk.p + p * pk.l + h * pk.h + cc * 8);
    cp_async16(pv_s + d, pv.p + p * pv.l + h * pv.h + cc * 8);
  }
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < count) load_name(b0 + s * nb, s);
    cp_commit();
  }

  // ---- this warp's head: fragment coordinates
  const int hh = warp;
  const int g = lane >> 2, t = lane & 3;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of a 16-row tile
  const int a_col = (lane >> 4) * 16;                    // and its byte column
  const int b_row = lane & 7, b_col = (lane >> 3) * 16;  // of four 8-row matrices
  const int lv = p_valid;
  const int ntp = (lv + 7) >> 3;  // prefix n-tiles of Q . K^T (8 keys each)
  const int kp = (lv + 15) >> 4;  // prefix k-steps of P . V (16 keys each)
  const int ns = S > 8 ? 2 : 1;   // suffix n-tiles
  const uint32_t pk_h = pk_s + hh * P * MMA_ROW, pv_h = pv_s + hh * P * MMA_ROW;

  // ---- the output: each thread's 16-byte chunks of the name's [S,
  // group x 64] row block, chunk c = tid + j * 32 group
  long long oo[MMA_CHUNKS];
  uint32_t os[MMA_CHUNKS];
#pragma unroll
  for (int j = 0; j < MMA_CHUNKS; ++j) {
    const int c = tid + j * 32 * group, i = c / (8 * group), rem = c - i * 8 * group;
    const int ho = rem >> 3, co = rem & 7;
    oo[j] = i * osl + (h0 + ho) * osh + co * 8;
    os[j] = (ho * S + i) * MMA_ROW + co * 16;
  }

  for (int it = 0; it < count; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();  // name `it` landed; the stage of name it - 1 is free
    {
      const int nx = it + NST - 1;
      if (nx < count) load_name(b0 + nx * nb, nx % NST);
      cp_commit();
    }
    const int st = it % NST;
    const uint32_t q_h = stage0 + st * 3 * tensor_bytes + hh * S * MMA_ROW;
    const uint32_t k_h = q_h + tensor_bytes, v_h = q_h + 2 * tensor_bytes;

    // ---- S = Q . K^T
    uint32_t qf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(qf[kk], a_row < S ? q_h + a_row * MMA_ROW + kk * 32 + a_col : zero);
    float sp[4][4], ss[2][4];  // prefix n-tiles (<= 32 keys), suffix n-tiles
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[nt][e] = 0.f;
      if (nt < ntp) {
        const int key = nt * 8 + b_row;
        uint32_t kf[4];
        ldsm_x4(kf, key < P ? pk_h + key * MMA_ROW + b_col : zero);
        mma16816(sp[nt], qf[0], kf[0], kf[1]);
        mma16816(sp[nt], qf[1], kf[2], kf[3]);
        ldsm_x4(kf, key < P ? pk_h + key * MMA_ROW + 64 + b_col : zero);
        mma16816(sp[nt], qf[2], kf[0], kf[1]);
        mma16816(sp[nt], qf[3], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ss[nt][e] = 0.f;
      if (nt < ns) {
        const int key = nt * 8 + b_row;
        uint32_t kf[4];
        ldsm_x4(kf, key < S ? k_h + key * MMA_ROW + b_col : zero);
        mma16816(ss[nt], qf[0], kf[0], kf[1]);
        mma16816(ss[nt], qf[1], kf[2], kf[3]);
        ldsm_x4(kf, key < S ? k_h + key * MMA_ROW + 64 + b_col : zero);
        mma16816(ss[nt], qf[2], kf[0], kf[1]);
        mma16816(ss[nt], qf[3], kf[2], kf[3]);
      }
    }

    // ---- scale, mask, softmax in f32 on rows g (e < 2) and g + 8, over
    // the n-tiles computed (a tile never computed keeps p = 0)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (nt < ntp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = nt * 8 + 2 * t + (e & 1) < lv;
          sp[nt][e] = keep ? sp[nt][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sp[nt][e]);
        }
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (nt < ns) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = nt * 8 + 2 * t + (e & 1) <= g + 8 * (e >> 1);
          ss[nt][e] = keep ? ss[nt][e] * scale : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], ss[nt][e]);
        }
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (nt < ntp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[nt][e] = expf(sp[nt][e] - mx[e >> 1]);  // masked: exp(-inf) = 0
          sum[e >> 1] += sp[nt][e];
        }
      }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      if (nt < ns) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ss[nt][e] = expf(ss[nt][e] - mx[e >> 1]);
          sum[e >> 1] += ss[nt][e];
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }

    // ---- p rounded to bf16 in the A fragments of P . V: k-step ks takes
    // n-tiles 2 ks (columns 0-7) and 2 ks + 1 (8-15)
    const float inv[2] = {__frcp_rn(sum[0]), __frcp_rn(sum[1])};
    uint32_t ap[2][4], as[4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* c = sp[2 * ks + (x >> 1)];
        const int e = (x & 1) * 2, r = e >> 1;
        ap[ks][x] = pack_bf16(quot(c[e], sum[r], inv[r]), quot(c[e + 1], sum[r], inv[r]));
      }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* c = ss[x >> 1];
      const int e = (x & 1) * 2, r = e >> 1;
      as[x] = pack_bf16(quot(c[e], sum[r], inv[r]), quot(c[e + 1], sum[r], inv[r]));
    }

    // ---- O = P . V over head_dim's 8 n-tiles, two a V load
    float o[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t vf[4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks < kp) {
          const int key = ks * 16 + a_row;
          ldsm_x4_trans(vf, key < P ? pv_h + key * MMA_ROW + np * 32 + a_col : zero);
          mma16816(o[2 * np], ap[ks], vf[0], vf[1]);
          mma16816(o[2 * np + 1], ap[ks], vf[2], vf[3]);
        }
      }
      ldsm_x4_trans(vf, a_row < S ? v_h + a_row * MMA_ROW + np * 32 + a_col : zero);
      mma16816(o[2 * np], as, vf[0], vf[1]);
      mma16816(o[2 * np + 1], as, vf[2], vf[3]);
    }

    // ---- O (bf16) into this head's staged q rows, then the block's
    // coalesced stores of the name's rows
    __syncwarp();
    unsigned char* q_g = smem + (q_h - zero);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = g + 8 * r;
        if (row < S)
          *reinterpret_cast<uint32_t*>(q_g + row * MMA_ROW + nt * 16 + t * 4) =
              pack_bf16(o[nt][2 * r], o[nt][2 * r + 1]);
      }
    __syncthreads();
    const unsigned char* st_g = smem + (stage0 - zero) + st * 3 * tensor_bytes;
    __nv_bfloat16* ob = out + (long long)(b0 + it * nb) * osb;
#pragma unroll
    for (int j = 0; j < MMA_CHUNKS; ++j)
      if (tid + j * 32 * group < rows * 8)
        *reinterpret_cast<uint4*>(ob + oo[j]) = *reinterpret_cast<const uint4*>(st_g + os[j]);
  }
  cp_wait<0>();  // no copy outlives the block
}

template <int NST>
int mma_launch(const View& q, const View& k, const View& v, const View& pk, const View& pv,
               __nv_bfloat16* out, long long osb, long long osl, long long osh, int batch,
               int group, int groups, int S, int P, int p_valid, float scale, size_t smem,
               int sms, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(prefix_mma_kernel<NST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefix_mma_kernel<NST>, 32 * group,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int nb = (int)std::min<long long>(batch, std::max(1LL, (long long)sms * per_sm / groups));
  prefix_mma_kernel<NST><<<dim3(nb, groups), 32 * group, smem, stream>>>(
      q, k, v, pk, pv, out, osb, osl, osh, batch, group, S, P, p_valid, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: [B, S, H, d] views (strides in elements: batch, row, head; the
// last dimension contiguous); pk, pv: [P, H, d] views (row, head); out:
// [B, S, H, d].  `vec` = 1 when every base, stride and head_dim allows
// 16-byte loads.  Returns a cudaError_t (0 on a launch that was taken).
extern "C" int prefix_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pk, const void* pv, void* out, int is_bf16,
                                    long long qsb, long long qsl, long long qsh, long long ksb,
                                    long long ksl, long long ksh, long long vsb, long long vsl,
                                    long long vsh, long long psl, long long psh,
                                    long long pvsl, long long pvsh, long long osb,
                                    long long osl, long long osh, int batch, int heads, int S,
                                    int P, int hd, int p_valid, float scale, int vec,
                                    cudaStream_t stream) {
  if (batch < 1 || heads < 1 || S < 1 || S > MAX_S || P < 0 || P + S > MAX_KEYS || hd < 1 ||
      hd > MAX_HD)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh}, sp{0, psl, psh},
      spv{0, pvsl, pvsh}, so{osb, osl, osh};
  if (is_bf16)
    return launch_r<__nv_bfloat16>(q, k, v, pk, pv, out, sq, sk, sv, sp, spv, so, batch, heads,
                                   S, P, hd, p_valid, scale, vec, stream);
  return launch_r<float>(q, k, v, pk, pv, out, sq, sk, sv, sp, spv, so, batch, heads, S, P, hd,
                         p_valid, scale, vec, stream);
}

// The mma.sync kernel: bf16 [B, S, H, 64] views q, k, v and [P, H, 64]
// pk, pv (strides in elements, the last dimension contiguous; every base
// and stride a 16-byte multiple); out contiguous [B, S, H, 64].  Returns a
// cudaError_t (0 on a launch that was taken).
extern "C" int prefix_attention_mma_fwd(const void* q, const void* k, const void* v,
                                        const void* pk, const void* pv, void* out,
                                        long long qsb, long long qsl, long long qsh,
                                        long long ksb, long long ksl, long long ksh,
                                        long long vsb, long long vsl, long long vsh,
                                        long long psl, long long psh, long long pvsl,
                                        long long pvsh, long long osb, long long osl,
                                        long long osh, int batch, int heads, int S, int P,
                                        int hd, int p_valid, float scale, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || S < 1 || S > MAX_S || P < 0 || P + S > MAX_KEYS ||
      hd != MMA_HD || p_valid < 0 || p_valid > P)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {q, k, v, pk, pv, out};
  const long long strides[13] = {qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, psl, psh, pvsl, pvsh};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorMisalignedAddress;  // 8 bf16 = 16 bytes
  int group = std::min(heads, MMA_GROUP);
  while (heads % group) --group;  // the largest divisor of H <= 8
  const size_t fixed = 16 + 2 * (size_t)group * P * MMA_ROW;
  const size_t stage = 3 * (size_t)group * S * MMA_ROW;
  int dev = 0, sms = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  int nst = MMA_MAX_STAGES;
  while (nst > 2 && fixed + nst * stage > (size_t)limit) --nst;
  const size_t smem = fixed + nst * stage;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidConfiguration;
  const View vq{static_cast<const __nv_bfloat16*>(q), qsb, qsl, qsh},
      vk{static_cast<const __nv_bfloat16*>(k), ksb, ksl, ksh},
      vv{static_cast<const __nv_bfloat16*>(v), vsb, vsl, vsh},
      vpk{static_cast<const __nv_bfloat16*>(pk), 0, psl, psh},
      vpv{static_cast<const __nv_bfloat16*>(pv), 0, pvsl, pvsh};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const int groups = heads / group;
  if (nst == 4)
    return mma_launch<4>(vq, vk, vv, vpk, vpv, o, osb, osl, osh, batch, group, groups, S, P,
                         p_valid, scale, smem, sms, stream);
  if (nst == 3)
    return mma_launch<3>(vq, vk, vv, vpk, vpv, o, osb, osl, osh, batch, group, groups, S, P,
                         p_valid, scale, smem, sms, stream);
  return mma_launch<2>(vq, vk, vv, vpk, vpv, o, osb, osl, osh, batch, group, groups, S, P,
                       p_valid, scale, smem, sms, stream);
}
