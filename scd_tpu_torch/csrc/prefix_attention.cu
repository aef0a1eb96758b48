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
// 0.160 ms at 3.35 TB/s; the products (q . k and p . v over <= 32 keys)
// are 8.6 GFLOP, 0.009 ms at the bf16 tensor-core rate and 0.13 ms on the
// f32 SIMT units.
//
// Design (simple first, no tensor cores): one block of four warps per
// (b, h) pair.  The block stages its n = P + S keys' K and V and its S
// query rows in shared memory as f32 (16-byte vector loads where the views
// allow them; each thread one column chunk of every step-th row, with no
// division in the loops and the first row of each group loaded before any
// is stored; on an H100 issuing the loads earlier alone gained nothing, the
// division-free mapping did), zero-padding head_dim to a multiple of 4.
// Each warp owns R consecutive query rows (R = S / 4 rounded up to 1, 2
// or 4) and each lane one key (c = lane: n <= 32): S = Q . K^T runs over
// float4 chunks of head_dim with the query rows read as broadcasts; the row max and sum are warp shuffles; O = P . V takes
// each p from its owning lane by a shuffle, and the lanes own consecutive
// output columns.
// Limits: S <= 16, P + S <= 32, head_dim <= 128 (the path: S 8 or 16, P
// <= 16, head_dim 64); anything else is refused before a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
