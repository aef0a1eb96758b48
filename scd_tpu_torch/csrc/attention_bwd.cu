// The gradient of masked softmax attention (non-causal, L <= 256), on
// [B, L, H, d] views with any batch, sequence and head strides (the last
// dimension contiguous).
//
// Replaces no TPU kernel: the JAX package differentiates its attention with
// XLA autodiff and has no Pallas backward.  The port's forward is the
// hand-written csrc/attention.cu, whose output autograd cannot see through,
// so ops/attention.py::AttentionFunction takes its gradient here.  It is the
// exact gradient of the forward's arithmetic, with the forward's rounding of
// p to v's type taken as the identity, as autodiff of a cast takes it (and,
// as autodiff does, the cotangent of that rounded p rounded to v's type):
//   s = scale * (q . k^T) in f32, keys >= l_valid at -inf;
//   p = exp(s - rowmax) / rowsum in f32 (IEEE division);
//   dV = T(p)^T . dO;
//   dP = T(dO . V^T);
//   D = rowsum(p * dP);  dS = p * (dP - D);
//   dQ = scale * dS . K;  dK = scale * dS^T . Q,
// all accumulated in f32 and stored once in T (bf16 or f32).  Keys at or past
// l_valid get dK = dV = 0.
//
// Two kernels, both on one stream, neither with atomics: every output
// element is summed by one thread in a fixed order, so a repeat gives the
// same bits.
//   1. attn_bwd_dq_kernel, one block per (batch, head, 32-query tile): the
//      tile's score and dP rows against every key tile (K and V staged by
//      32-key tiles), the row max, sum, p and D, dS, then dQ = dS . K with K
//      staged again; it writes each row's max, sum and D to a scratch the
//      caller allocates.
//   2. attn_bwd_dkv_kernel, one block per (batch, head, 32-key tile): for
//      each 32-query tile, the same scores and dP recomputed by the same
//      instructions (so p and dS carry the same bits as in kernel 1), p and
//      dS from the row statistics, then dV += T(p)^T . dO and dK += dS^T . Q.
// Products are SIMT fmaf in f32 from inputs converted on load.
//
// What bounds it on an H100: at the training shape (B 256, L 197, H 12,
// d 64, bf16) the bytes (q, k, v, o and dO read, dq, dk, dv written) are
// 0.19 ms at 3.35 TB/s and the products (s twice, dP twice, dV, dK, dQ:
// 7 x 2 B H L^2 d = 1.1e11 FLOP as a tensor-core kernel would do them)
// 0.11 ms at 989 TFLOP/s bf16.  This kernel does those products on the SIMT
// units (67 TFLOP/s f32 peak), reading both operands from shared memory, so
// it runs far from either bound; a wgmma design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_L = 256;         // the whole-row forward paths' limit
constexpr int MAX_HD = 128;
constexpr int TR = 32;             // queries (kernel 1) or keys (kernel 2) per block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = TR / WARPS;    // rows of a tile per warp: 4
constexpr int MAXC = MAX_HD / 32;  // output columns per lane

struct Strides {
  long long b, l, h;  // element strides of batch, sequence and head
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to T's precision and back
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + TR) of one (batch, head) of x into dst [TR][ld] as f32,
// zeros past L.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* base, long long sl,
                                           int row0, int L, int hd) {
  for (int i = threadIdx.x; i < TR * hd; i += THREADS) {
    const int r = i / hd, c = i % hd;
    dst[r * ld + c] = row0 + r < L ? to_f32(base[(long long)(row0 + r) * sl + c]) : 0.f;
  }
}

// The dot products of this warp's RPW rows of A ([.][hd], rows arow0..) with
// row `lane` of B ([TR][hd + 1]), fmaf in d order.  Both kernels form every
// score and every dP through this one function, so they agree bit for bit.
__device__ __forceinline__ void row_dots(float (&out)[RPW], const float* A, int arow0,
                                         const float* Bt, int hd, int lane) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) out[r] = 0.f;
  const int ldb = hd + 1;
  for (int d = 0; d < hd; ++d) {
    const float bd = Bt[lane * ldb + d];
#pragma unroll
    for (int r = 0; r < RPW; ++r) out[r] = fmaf(A[(arow0 + r) * hd + d], bd, out[r]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// p of one score from its row's max and sum, as both kernels form it
__device__ __forceinline__ float prob(float s, float m, float sum) {
  return __fdiv_rn(expf(__fsub_rn(s, m)), sum);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                   Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int heads,
                   int L, int hd, int lv, float scale, int qtiles, int lp, long long bhl) {
  extern __shared__ float smem[];
  float* Qs = smem;                // [TR][hd]
  float* dOs = Qs + TR * hd;       // [TR][hd]
  float* Ks = dOs + TR * hd;       // [TR][hd + 1]
  float* Vs = Ks + TR * (hd + 1);  // [TR][hd + 1]
  float* S = Vs + TR * (hd + 1);   // [TR][lp]: scores, then p
  float* G = S + TR * lp;          // [TR][lp]: dP, then dS

  const int tile = blockIdx.x % qtiles;
  const int bh = blockIdx.x / qtiles;
  const int b = bh / heads, h = bh % heads;
  const int q0 = tile * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * RPW;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = dout + b * sdo.b + h * sdo.h;
  const int ntiles = (lv + TR - 1) / TR;  // key tiles with a valid key

  stage_rows(Qs, hd, qb, sq.l, q0, L, hd);
  stage_rows(dOs, hd, ob, sdo.l, q0, L, hd);
  // scores and dP against every key tile with a valid key
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // the last tile's readers are done
    stage_rows(Ks, hd + 1, kb, sk.l, t * TR, L, hd);
    stage_rows(Vs, hd + 1, vb, sv.l, t * TR, L, hd);
    __syncthreads();
    float s[RPW], dp[RPW];
    row_dots(s, Qs, r0, Ks, hd, lane);
    row_dots(dp, dOs, r0, Vs, hd, lane);
    const int key = t * TR + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      S[(r0 + r) * lp + key] = key < lv ? __fmul_rn(s[r], scale) : -INFINITY;
      G[(r0 + r) * lp + key] = round_to(dp[r], q);
    }
  }
  __syncthreads();

  // per row (each warp its own RPW rows): max, sum, p, D, dS
  for (int r = r0; r < r0 + RPW; ++r) {
    float* srow = S + r * lp;
    float* grow = G + r * lp;
    float m = -INFINITY;
    for (int c = lane; c < lv; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);  // key 0 is valid, so finite
    float sum = 0.f;
    for (int c = lane; c < lv; c += 32) sum += expf(__fsub_rn(srow[c], m));
    sum = warp_sum(sum);
    float dsum = 0.f;
    for (int c = lane; c < lv; c += 32) {
      const float p = prob(srow[c], m, sum);
      srow[c] = p;
      dsum = fmaf(p, grow[c], dsum);
    }
    dsum = warp_sum(dsum);
    for (int c = lane; c < lv; c += 32) grow[c] = __fmul_rn(srow[c], __fsub_rn(grow[c], dsum));
    if (lane == 0 && q0 + r < L) {
      const long long row = (long long)bh * L + q0 + r;
      stats[row] = m;
      stats[bhl + row] = sum;
      stats[2 * bhl + row] = dsum;
    }
  }

  // dQ = scale * dS . K over the valid keys, K staged again
  float acc[RPW][MAXC];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) acc[r][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    stage_rows(Ks, hd + 1, kb, sk.l, t * TR, L, hd);
    __syncthreads();
    const int nk = min(TR, lv - t * TR);
    for (int j = 0; j < nk; ++j) {
      const float* krow = Ks + j * (hd + 1);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float ds = G[(r0 + r) * lp + t * TR + j];
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          if (lane + 32 * c < hd) acc[r][c] = fmaf(ds, krow[lane + 32 * c], acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (q0 + r0 + r >= L) continue;
    T* orow = dq + b * sdq.b + (long long)(q0 + r0 + r) * sdq.l + h * sdq.h;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (lane + 32 * c < hd) from_f32(orow + lane + 32 * c, __fmul_rn(acc[r][c], scale));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                    const float* __restrict__ stats, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdk, Strides sdv, int heads, int L, int hd, int lv,
                    float scale, int ktiles, long long bhl) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [TR][hd + 1]
  float* Vs = Ks + TR * (hd + 1);   // [TR][hd + 1]
  float* Qs = Vs + TR * (hd + 1);   // [TR][hd]
  float* dOs = Qs + TR * hd;        // [TR][hd]
  float* Ps = dOs + TR * hd;        // [TR queries][TR + 1 keys]: T(p)
  float* Gs = Ps + TR * (TR + 1);   // [TR][TR + 1]: dS
  float* rm = Gs + TR * (TR + 1);   // [TR] row max, sum and D of the query tile
  float* rs = rm + TR;
  float* rd = rs + TR;

  const int tile = blockIdx.x % ktiles;
  const int bh = blockIdx.x / ktiles;
  const int b = bh / heads, h = bh % heads;
  const int k0 = tile * TR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = warp * RPW;  // this warp's keys in the tile, for the sums
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* ob = dout + b * sdo.b + h * sdo.h;

  float adk[RPW][MAXC], adv[RPW][MAXC];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) adk[r][c] = adv[r][c] = 0.f;

  if (k0 < lv) {  // else every key of the tile is masked: zeros
    stage_rows(Ks, hd + 1, kb, sk.l, k0, L, hd);
    stage_rows(Vs, hd + 1, vb, sv.l, k0, L, hd);
    const int key = k0 + lane;
    const bool keep = key < lv;
    for (int i0 = 0; i0 < L; i0 += TR) {
      __syncthreads();  // the last query tile's readers are done
      stage_rows(Qs, hd, qb, sq.l, i0, L, hd);
      stage_rows(dOs, hd, ob, sdo.l, i0, L, hd);
      for (int i = threadIdx.x; i < TR; i += THREADS) {
        const long long row = (long long)bh * L + i0 + i;
        const bool in = i0 + i < L;
        rm[i] = in ? stats[row] : 0.f;
        rs[i] = in ? stats[bhl + row] : 1.f;
        rd[i] = in ? stats[2 * bhl + row] : 0.f;
      }
      __syncthreads();
      // this warp's RPW queries against key `lane`: p and dS as kernel 1 has them
      float s[RPW], dp[RPW];
      row_dots(s, Qs, warp * RPW, Ks, hd, lane);
      row_dots(dp, dOs, warp * RPW, Vs, hd, lane);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = warp * RPW + r;
        const float p = keep ? prob(__fmul_rn(s[r], scale), rm[i], rs[i]) : 0.f;
        Ps[i * (TR + 1) + lane] = round_to(p, q);
        Gs[i * (TR + 1) + lane] = __fmul_rn(p, __fsub_rn(round_to(dp[r], q), rd[i]));
      }
      __syncthreads();
      const int ni = min(TR, L - i0);
      for (int i = 0; i < ni; ++i) {
        const float* qrow = Qs + i * hd;
        const float* orow = dOs + i * hd;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float p = Ps[i * (TR + 1) + j0 + r];
          const float ds = Gs[i * (TR + 1) + j0 + r];
#pragma unroll
          for (int c = 0; c < MAXC; ++c) {
            if (lane + 32 * c < hd) {
              adv[r][c] = fmaf(p, orow[lane + 32 * c], adv[r][c]);
              adk[r][c] = fmaf(ds, qrow[lane + 32 * c], adk[r][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int key = k0 + j0 + r;
    if (key >= L) continue;
    const bool keep = key < lv;
    T* krow = dk + b * sdk.b + (long long)key * sdk.l + h * sdk.h;
    T* vrow = dv + b * sdv.b + (long long)key * sdv.l + h * sdv.h;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (lane + 32 * c < hd) {
        from_f32(krow + lane + 32 * c, keep ? __fmul_rn(adk[r][c], scale) : 0.f);
        from_f32(vrow + lane + 32 * c, keep ? adv[r][c] : 0.f);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, Strides sq, Strides sk, Strides sv, Strides sdo,
           Strides sdq, Strides sdk, Strides sdv, int batch, int heads, int L, int hd,
           int l_valid, float scale, cudaStream_t stream) {
  const int lp = (L + TR - 1) / TR * TR;
  const int tiles = lp / TR;
  const long long bhl = (long long)batch * heads * L;
  const long long blocks = (long long)batch * heads * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem1 = 4 * (2 * TR * hd + 2 * TR * (hd + 1) + 2 * TR * lp);
  const int smem2 = 4 * (2 * TR * (hd + 1) + 2 * TR * hd + 2 * TR * (TR + 1) + 3 * TR);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  attn_bwd_dq_kernel<T><<<(unsigned)blocks, THREADS, (size_t)smem1, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dq), stats, sq, sk, sv, sdo, sdq, heads, L, hd, l_valid,
      scale, tiles, lp, bhl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<T><<<(unsigned)blocks, THREADS, (size_t)smem2, stream>>>(
      qt, kt, vt, ot, static_cast<T*>(dk), static_cast<T*>(dv), stats, sq, sk, sv, sdo, sdk,
      sdv, heads, L, hd, l_valid, scale, tiles, bhl);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v (the forward's inputs), dout (the gradient of its output) and dq,
// dk, dv (written): [batch, L, heads, hd] views with element strides (b, l, h)
// each and the last dimension contiguous, all bf16 or all f32 (is_bf16).
// stats: 3 * batch * heads * L floats of scratch.  Takes 1 <= L <= 256,
// 1 <= hd <= 128, 1 <= l_valid, causal 0; returns cudaErrorInvalidValue for
// anything else.  Launches both kernels on `stream` and returns the CUDA
// error code.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, float* stats, int is_bf16,
                             long long qsb, long long qsl, long long qsh, long long ksb,
                             long long ksl, long long ksh, long long vsb, long long vsl,
                             long long vsh, long long osb, long long osl, long long osh,
                             long long dqsb, long long dqsl, long long dqsh, long long dksb,
                             long long dksl, long long dksh, long long dvsb, long long dvsl,
                             long long dvsh, int batch, int heads, int L, int hd, int l_valid,
                             int causal, float scale, cudaStream_t stream) {
  if (batch < 1 || heads < 1 || L < 1 || L > MAX_L || hd < 1 || hd > MAX_HD || l_valid < 1 ||
      causal != 0)
    return (int)cudaErrorInvalidValue;
  const int lv = l_valid < L ? l_valid : L;
  const Strides sq{qsb, qsl, qsh}, sk{ksb, ksl, ksh}, sv{vsb, vsl, vsh}, so{osb, osl, osh};
  const Strides sdq{dqsb, dqsl, dqsh}, sdk{dksb, dksl, dksh}, sdv{dvsb, dvsl, dvsh};
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk,
                                 sdv, batch, heads, L, hd, lv, scale, stream);
  return launch<float>(q, k, v, dout, dq, dk, dv, stats, sq, sk, sv, so, sdq, sdk, sdv, batch,
                       heads, L, hd, lv, scale, stream);
}
