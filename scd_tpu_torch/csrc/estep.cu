// Nearest-center assignment: for every row of x, the first center index
// attaining min ||x - c||^2, and that squared distance.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::estep_assign_pallas
// (kernel body _estep_kernel).  Same contract: x and c in f32, the partial
// distance |c|^2 - 2 x.c in full f32 (no TF32; the TPU kernel asks for
// Precision.HIGHEST), the label is the first index attaining the min, and
// mindist = max(min + |x|^2, 0).  Any N and any K: centers past K never win.
//
// What bounds it on an H100: operations.  At the k-means runner's shape
// (N = 130,048, D = 768, K = 100) the cross term is 2*N*K*D = 20 GFLOP,
// 0.30 ms at 67 TFLOP/s f32 (non-tensor), while x is 400 MB, 0.12 ms of HBM
// time.
//
// Design: the E-step of csrc/fused_em.cu without its M-step.  One block of
// 256 threads per tile of BM = 128 rows; the cross term is a register-tiled
// SGEMM (8 x 8 outputs a thread) over center tiles of BN = 128 and depth
// slices of BK = 16, both staged transposed in shared memory, so any K and
// D fit in ~17 KB.  The per-row (min, argmin) folds in registers and across
// the 16 lanes that share a row by shuffle, lexicographically on (distance,
// index), and an earlier center tile keeps a tie.  |x|^2 is summed from the
// same staged slices during the first center tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int LD = BM + 4;  // both staged slices are stored transposed, padded
constexpr int IDX_NONE = 0x7fffffff;

// |c_j|^2 for every center: one warp per center, fixed shuffle order.
__global__ void center_sqnorm_kernel(const float* __restrict__ c, int k, int d,
                                     float* __restrict__ csq) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= k) return;
  float s = 0.f;
  for (int t = lane; t < d; t += 32) {
    const float v = c[(size_t)warp * d + t];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) csq[warp] = s;
}

__global__ void __launch_bounds__(THREADS, 2)
estep_kernel(const float* __restrict__ x, const float* __restrict__ c,
             const float* __restrict__ csq, int n, int d, int k,
             int* __restrict__ labels, float* __restrict__ mindist) {
  __shared__ __align__(16) float As[BK * LD];
  __shared__ __align__(16) float Bs[BK * LD];
  __shared__ float csq_s[BN];
  __shared__ float xsq_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BM;
  float rmin[8];
  int rarg[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    rmin[p] = INFINITY;
    rarg[p] = IDX_NONE;
  }
  float xsq = 0.f;  // |x|^2 of tile row tid (tid < BM), in column order

  for (int j0 = 0; j0 < k; j0 += BN) {
    if (tid < BN) csq_s[tid] = (j0 + tid < k) ? csq[j0 + tid] : 0.f;
    float acc[8][8];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = tid & 15;
        const int r = (tid >> 4) + 16 * j;
        const int gk = k0 + kk;
        const int gr = row0 + r;
        const int gc = j0 + r;
        As[kk * LD + r] = (gr < n && gk < d) ? x[(size_t)gr * d + gk] : 0.f;
        Bs[kk * LD + r] = (gc < k && gk < d) ? c[(size_t)gc * d + gk] : 0.f;
      }
      __syncthreads();
      if (j0 == 0 && tid < BM) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float v = As[kk * LD + tid];
          xsq = fmaf(v, v, xsq);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk * LD + ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk * LD + 64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk * LD + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk * LD + 64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
      }
      __syncthreads();
    }

    // fold this center tile into the running per-row (min, argmin)
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float best = INFINITY;
      int barg = IDX_NONE;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // increasing center index
        const int cl = (q < 4) ? tx * 4 + q : 64 + tx * 4 + (q - 4);
        if (j0 + cl < k) {
          const float dd = csq_s[cl] - 2.f * acc[p][q];
          if (dd < best) {
            best = dd;
            barg = j0 + cl;
          }
        }
      }
      // the 16 lanes sharing this row: lexicographic (distance, index)
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, barg, off);
        if (ob < best || (ob == best && oa < barg)) {
          best = ob;
          barg = oa;
        }
      }
      if (best < rmin[p]) {  // strict: an earlier tile keeps a tie
        rmin[p] = best;
        rarg[p] = barg;
      }
    }
    __syncthreads();  // every lane is done with csq_s before it is rewritten
  }

  if (tid < BM) xsq_s[tid] = xsq;
  __syncthreads();
  if (tx == 0) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = (p < 4) ? ty * 4 + p : 64 + ty * 4 + (p - 4);
      const int gr = row0 + r;
      if (gr < n) {
        labels[gr] = (rarg[p] == IDX_NONE) ? 0 : rarg[p];
        mindist[gr] = fmaxf(rmin[p] + xsq_s[r], 0.f);
      }
    }
  }
}

}  // namespace

// x [n, d] f32, c [k, d] f32, both contiguous; n >= 1, k >= 1, d >= 1.
// Outputs labels [n] int32 and mindist [n] f32; scratch csq [k].  Launches
// two kernels on `stream` and returns cudaGetLastError().
extern "C" int estep_assign_f32(const float* x, const float* c, int n, int d, int k,
                                int* labels, float* mindist, float* csq,
                                cudaStream_t stream) {
  if (n < 1 || k < 1 || d < 1) return (int)cudaErrorInvalidValue;
  center_sqnorm_kernel<<<(k + 7) / 8, 256, 0, stream>>>(c, k, d, csq);
  estep_kernel<<<(n + BM - 1) / BM, THREADS, 0, stream>>>(x, c, csq, n, d, k, labels,
                                                          mindist);
  return (int)cudaGetLastError();
}
