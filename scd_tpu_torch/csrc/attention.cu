// Masked softmax attention for short sequences, on [B, L, H, d] views with
// any batch, sequence and head strides (the last dimension contiguous).
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
// Design.  L <= 256, so no online softmax is needed (the Pallas kernels make
// the same choice): one block owns a (batch, head) pair and a tile of 64
// queries, holds that head's whole K and V in shared memory, and keeps each
// query's full score row in registers.  bf16 inputs take the tensor cores:
// four warps, each with 16 query rows, run mma.sync m16n8k16 bf16 for
// q . k^T (scores accumulate in f32 registers), apply scale and masks, take
// the row max and sum across the four lanes that share a row, round p to
// bf16 in the registers that already hold the scores (the accumulator
// layout of two 8-column tiles is the A-operand layout of a 16-deep one),
// and run a second mma.sync for p . v.  The number of 16-key tiles is a
// template argument (1, 2, 5, 8, 13 or 16: the text buckets 16 / 32 / 80,
// 128, the padded image sequence 208, and 256), so the score registers are
// addressed statically; keys past L are zero in shared memory and masked.
// Shared-memory rows are padded to 72 elements, so the fragment loads hit
// 32 distinct banks.  K, V and the Q tile are staged with cp.async, every
// 16-byte copy of a thread in flight at once (the first design's loop of
// dependent loads and stores took 6x SDPA's time); K and V are re-read by
// each query tile of a head, from L2 after the first.  A warp whose rows
// all lie past L exits after the staging, and key tiles that every row of
// a warp masks (causal, or past l_valid) skip both products: their p is
// exactly 0, so the result is the same bit for bit.  f32 inputs (no
// tensor-core path keeps f32 products exact) take a plain SIMT kernel
// with the same contract: 32 queries per block, scores staged in shared
// memory, fmaf dot products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;        // head dimension of the bf16 path
constexpr int QT = 64;        // query rows per block, bf16 path (4 warps x 16)
constexpr int LDS = HD + 8;   // shared row stride in elements (144 bytes)
constexpr int FQT = 32;       // query rows per block, f32 path
constexpr int FTHREADS = 256;

struct Strides {
  long long b, l, h;  // element strides of batch, sequence and head
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Start copying rows [row0, row0 + nrows) of one head into shared memory
// (row stride LDS), 16 bytes per cp.async, all in flight at once; rows at
// or past L are zero.  The caller waits (cp_async_wait_all) and syncs.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long stride_l, int row0, int nrows, int L) {
  for (int i = threadIdx.x; i < nrows * (HD / 8); i += blockDim.x) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (row0 + r < L)
      cp_async16(dst + r * LDS + c, src + (row0 + r) * stride_l + c);
    else
      *reinterpret_cast<uint4*>(dst + r * LDS + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int KT>
__global__ void __launch_bounds__(128)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 Strides sq, Strides sk, Strides sv, Strides so, int heads, int L,
                 int l_valid, int causal, float scale, int qtiles) {
  constexpr int LK = 16 * KT;  // keys held
  constexpr int NT = 2 * KT;   // 8-key score tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + LK * LDS;
  __nv_bfloat16* Qs = Vs + LK * LDS;

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * QT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  stage_rows(Ks, k + b * sk.b + h * sk.h, sk.l, 0, LK, L);
  stage_rows(Vs, v + b * sv.b + h * sv.h, sv.l, 0, LK, L);
  stage_rows(Qs, q + b * sq.b + h * sq.h, sq.l, q0, QT, L);
  cp_async_wait_all();
  __syncthreads();
  if (q0 + warp * 16 >= L) return;  // no row of this warp exists

  // keys any row of this warp may see; key tiles past it skip both
  // products (their p is exactly 0)
  const int lv = min(l_valid, L);
  const int kmax = causal ? min(lv, q0 + warp * 16 + 16) : lv;

  // ---- this warp's 16 query rows as A fragments
  const __nv_bfloat16* Qw = Qs + warp * 16 * LDS;
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    qa[kk][0] = ld32(Qw + g * LDS + kk * 16 + 2 * t);
    qa[kk][1] = ld32(Qw + (g + 8) * LDS + kk * 16 + 2 * t);
    qa[kk][2] = ld32(Qw + g * LDS + kk * 16 + 8 + 2 * t);
    qa[kk][3] = ld32(Qw + (g + 8) * LDS + kk * 16 + 8 + 2 * t);
  }

  // ---- scores: s[j] is the 16 x 8 tile of keys 8j .. 8j + 7
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (j * 8 < kmax) {
      const __nv_bfloat16* Kr = Ks + (j * 8 + g) * LDS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(Kr + kk * 16), ld32(Kr + kk * 16 + 8));
    }
  }

  // ---- scale, masks, row max (rows ra = g, rb = g + 8 of the warp's 16)
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = j * 8 + 2 * t + e;
      const bool ka = col < lv && (!causal || col <= ra);
      const bool kb = col < lv && (!causal || col <= rb);
      s[j][e] = ka ? s[j][e] * scale : -INFINITY;
      s[j][2 + e] = kb ? s[j][2 + e] * scale : -INFINITY;
      ma = fmaxf(ma, s[j][e]);
      mb = fmaxf(mb, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }

  // ---- exp and row sums (every row has key 0 unmasked, so max is finite)
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j * 8 >= kmax) {  // every key masked: p is exactly 0
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - ma);
      s[j][2 + e] = expf(s[j][2 + e] - mb);
      sa += s[j][e];
      sb += s[j][2 + e];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }

  // ---- out = p . v, p rounded to bf16 (IEEE division first, as the TPU
  // kernel's p / sum)
  float o[HD / 8][4];
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk * 16 >= kmax) continue;  // p is exactly 0 for these keys
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0] / sa, s[2 * kk][1] / sa);
    pa[1] = pack_bf16(s[2 * kk][2] / sb, s[2 * kk][3] / sb);
    pa[2] = pack_bf16(s[2 * kk + 1][0] / sa, s[2 * kk + 1][1] / sa);
    pa[3] = pack_bf16(s[2 * kk + 1][2] / sb, s[2 * kk + 1][3] / sb);
    const __nv_bfloat16* Vr = Vs + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      const __nv_bfloat16* vp = Vr + jd * 8;
      mma_bf16(o[jd], pa, pack_pair(vp[0], vp[LDS]), pack_pair(vp[8 * LDS], vp[9 * LDS]));
    }
  }

  // ---- store the rows that exist
  __nv_bfloat16* ob = out + b * so.b + h * so.h + 2 * t;
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd) {
    if (ra < L)
      *reinterpret_cast<uint32_t*>(ob + ra * so.l + jd * 8) = pack_bf16(o[jd][0], o[jd][1]);
    if (rb < L)
      *reinterpret_cast<uint32_t*>(ob + rb * so.l + jd * 8) = pack_bf16(o[jd][2], o[jd][3]);
  }
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

template <int KT>
int launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq,
                Strides sk, Strides sv, Strides so, int batch, int heads, int L,
                int l_valid, int causal, float scale, cudaStream_t stream) {
  const int qtiles = (L + QT - 1) / QT;
  const int smem = (2 * 16 * KT + QT) * LDS * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)batch * heads * qtiles;
  attn_bf16_kernel<KT><<<(unsigned)blocks, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, sv, so,
      heads, L, l_valid, causal, scale, qtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [batch, L, heads, hd] with element strides (b, l, h) each and
// the last dimension contiguous; bf16 (is_bf16, hd == 64, L <= 256, every
// stride and base 16-byte aligned) or f32.  1 <= l_valid.  Launches on
// `stream` and returns the CUDA error code (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out,
                             int is_bf16, long long qsb, long long qsl, long long qsh,
                             long long ksb, long long ksl, long long ksh, long long vsb,
                             long long vsl, long long vsh, long long osb, long long osl,
                             long long osh, int batch, int heads, int L, int hd, int l_valid,
                             int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || L < 1 || L > 256 || l_valid < 1)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh}, so{osb, osl, osh};
  if (is_bf16) {
    if (hd != HD) return (int)cudaErrorInvalidValue;
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
  const long long smem = 4LL * (L * (hd + 1) + L * hd + FQT * (hd + 1) + FQT * L);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // the SM's 227 KB
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
