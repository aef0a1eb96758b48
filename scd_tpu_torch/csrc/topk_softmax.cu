// Fused vocabulary scoring: scale * F @ W -> online (max, sum-exp) and a
// running top-k per row, without ever storing the [N, V] logits.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::topk_softmax_pallas
// (kernel body _topk_softmax_kernel, _topk_local).  Same contract: logits are
// scale * F @ W in f32, V padding is masked, ties go to the lowest vocabulary
// index, and the caller turns (m, s, vals) into softmax values with
// exp(v - m) / s.
//
// What bounds it on an H100: operations.  At the pipeline shape (N = 97,536
// rows, D = 512, V = 68,000) the product is 2*N*D*V = 6.8 TFLOP, while the
// bytes it must move (F, W, and [N, k] outputs) are ~340 MB: ~0.1 ms of HBM
// time against ~100 ms at the card's 67 TFLOP/s f32 (non-tensor) rate.  The
// JAX package refuses single-pass bf16 logits because they flip near-tie
// rankings, so this first version stays in f32 FMA (no TF32, no tensor
// cores); a 3xTF32 / bf16x3 wgmma version is later work (ROADMAP).
//
// Design.  One block owns BM = 128 rows of F and streams all of W past
// them in BN = 128 column tiles; each tile is a register-tiled SGEMM
// (BK = 16 slices of F and W staged through shared memory, an 8x8 micro
// tile per thread).  The 128 x 128 logit tile is then written to shared
// memory, and two threads per row (neighbouring lanes) fold it into their
// private online (max, sum-exp) and a top-KMAX list kept in registers,
// sorted by value descending, then index ascending.  After the last tile
// the two lanes merge by shuffle and the even lane writes the row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int AS_LD = BM + 4;  // padded: 2-way bank conflicts at most on stores
constexpr int BS_LD = BN;
constexpr int LS_LD = BN + 2;  // 130: the scan of the logit tile is conflict-free
constexpr int SMEM_FLOATS = BK * AS_LD + BK * BS_LD + BM * LS_LD;
constexpr int IDX_NONE = 0x7fffffff;

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

  // Insert (cv, ci) into the sorted list; fully unrolled so the list stays
  // in registers.
  __device__ __forceinline__ void push(float cv, int ci) {
    if (!better(cv, ci, v[KMAX - 1], i[KMAX - 1])) return;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (better(cv, ci, v[j], i[j])) {
        float tv = v[j];
        int ti = i[j];
        v[j] = cv;
        i[j] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }
};

template <int KMAX>
__global__ void __launch_bounds__(THREADS, 2)
topk_softmax_kernel(const float* __restrict__ F, const float* __restrict__ W,
                    int n, int d, int v, int k, float scale,
                    float* __restrict__ m_out, float* __restrict__ s_out,
                    float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                // [BK][AS_LD]  F slice, transposed
  float* Bs = As + BK * AS_LD;     // [BK][BS_LD]  W slice
  float* Ls = Bs + BK * BS_LD;     // [BM][LS_LD]  scaled logit tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group of the micro tile
  const int ty = tid >> 4;   // row group of the micro tile
  const int row0 = blockIdx.x * BM;

  // scan role: two neighbouring lanes per row
  const int srow = tid >> 1;
  const int half = tid & 1;

  float run_m = -INFINITY;
  float run_s = 0.f;
  TopK<KMAX> top;
  top.init();

  for (int v0 = 0; v0 < v; v0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // F slice: consecutive threads walk D (coalesced), stored transposed
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = tid & 15;
        const int r = (tid >> 4) + 16 * j;
        const int gr = row0 + r;
        const int gk = k0 + kk;
        As[kk * AS_LD + r] =
            (gr < n && gk < d) ? F[(size_t)gr * d + gk] : 0.f;
      }
      // W slice: consecutive threads walk V (coalesced)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tid & 127;
        const int kk = (tid >> 7) + 2 * j;
        const int gc = v0 + c;
        const int gk = k0 + kk;
        Bs[kk * BS_LD + c] =
            (gc < v && gk < d) ? W[(size_t)gk * v + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * AS_LD + 64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * BS_LD + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * BS_LD + 64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
      __syncthreads();
    }

    // logit tile -> shared memory
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = (p < 4) ? ty * 4 + p : 64 + ty * 4 + (p - 4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = (q < 4) ? tx * 4 + q : 64 + tx * 4 + (q - 4);
        Ls[r * LS_LD + c] = scale * acc[p][q];
      }
    }
    __syncthreads();

    // fold this lane's 64 columns (c = 2*t + half, increasing) of its row
    const float* lrow = Ls + srow * LS_LD;
    const int ncols = min(BN, v - v0);
    float tmax = -INFINITY;
    for (int t = 0; t < BN / 2; ++t) {
      const int c = 2 * t + half;
      if (c < ncols) tmax = fmaxf(tmax, lrow[c]);
    }
    if (tmax > -INFINITY) {
      const float new_m = fmaxf(run_m, tmax);
      float s = run_s * expf(run_m - new_m);
      for (int t = 0; t < BN / 2; ++t) {
        const int c = 2 * t + half;
        if (c < ncols) {
          const float x = lrow[c];
          s += expf(x - new_m);
          top.push(x, v0 + c);
        }
      }
      run_m = new_m;
      run_s = s;
    }
    // the next tile's k-loop synchronises before Ls is written again
  }

  // merge the two lanes of each row
  const unsigned full = 0xffffffffu;
  const float om = __shfl_xor_sync(full, run_m, 1);
  const float os = __shfl_xor_sync(full, run_s, 1);
  const float m = fmaxf(run_m, om);
  float s = 0.f;
  if (run_m > -INFINITY) s += run_s * expf(run_m - m);
  if (om > -INFINITY) s += os * expf(om - m);
  float ov[KMAX];
  int oi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    ov[j] = __shfl_xor_sync(full, top.v[j], 1);
    oi[j] = __shfl_xor_sync(full, top.i[j], 1);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) top.push(ov[j], oi[j]);

  const int grow = row0 + srow;
  if (half == 0 && grow < n) {
    m_out[grow] = m;
    s_out[grow] = s;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        vals[(size_t)grow * k + j] = top.v[j];
        idx[(size_t)grow * k + j] = top.i[j];
      }
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* F, const float* W, int n, int d, int v, int k,
                   float scale, float* m_out, float* s_out, float* vals,
                   int* idx, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_softmax_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM);
  topk_softmax_kernel<KMAX><<<grid, THREADS, smem, stream>>>(
      F, W, n, d, v, k, scale, m_out, s_out, vals, idx);
  return cudaGetLastError();
}

}  // namespace

// F [n, d] f32 row-major, W [d, v] f32 row-major, 1 <= k <= 16, v >= k.
// Outputs: m [n], s [n] (online max and sum of exp(logit - m)), vals [n, k]
// (raw scaled logits, descending), idx [n, k] (int32).
// Returns cudaGetLastError() after the launch.
extern "C" int topk_softmax_f32(const float* F, const float* W, int n, int d,
                                int v, int k, float scale, float* m_out,
                                float* s_out, float* vals, int* idx,
                                cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 16 || v < k || d < 1) return (int)cudaErrorInvalidValue;
  if (k <= 4)
    return (int)launch<4>(F, W, n, d, v, k, scale, m_out, s_out, vals, idx, stream);
  if (k <= 8)
    return (int)launch<8>(F, W, n, d, v, k, scale, m_out, s_out, vals, idx, stream);
  return (int)launch<16>(F, W, n, d, v, k, scale, m_out, s_out, vals, idx, stream);
}
