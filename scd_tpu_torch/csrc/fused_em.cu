// One k-means EM iteration in one pass over x: nearest center (E-step),
// the row-masked per-cluster sums and counts (M-step) and the inertia.
//
// Replaces the TPU kernel scd_tpu/ops/pallas_kernels.py::fused_em_step_pallas
// (kernel body _fused_em_kernel).  Same contract: distance via
// |c|^2 - 2 x.c (|x|^2 added after the argmin), first-min ties, min distance
// |x|^2 + min clamped at 0, a 0/1 row mask that drops rows from sums, counts
// and inertia (labels of masked rows are still the plain argmin), and x read
// either as f32 or as bf16 (x_bf16).  All arithmetic is f32 in both modes:
// the TPU kernel's estep_passes = 3 / 2 are bf16 splits of the cross term,
// and an f32 cross term meets the 3-pass label contract, so the knob has no
// counterpart here.
//
// What bounds it on an H100: operations.  At the pipeline shape (N = 97,536,
// D = 768, K = 100) the E-step is 2*N*K*D = 15 GFLOP per iteration, ~0.22 ms
// at 67 TFLOP/s f32 (non-tensor), while x is 300 MB (f32) or 150 MB (bf16),
// ~0.09 / 0.045 ms of HBM time.  The M-step adds N*D additions.
//
// Design.  Blocks are persistent (the caller sizes the grid to ~2 per SM)
// and walk row tiles of BM = 128 rows in a fixed order.  Per tile, the
// E-step is a register-tiled SGEMM over center tiles of BN = 128 and depth
// slices of BK = 16 (K and D are both tiled, so any K fits; shared memory
// is ~38 KB whatever K and D are), with the per-row (min, argmin) folded in
// registers and across the 16 lanes that share a row by shuffle.  The
// M-step sorts the tile's rows by label (stable) into segments of one
// label each, then streams the x tile again, 64 columns at a time, through
// shared memory: each (segment, column) sum is taken in row order and
// added to the block's own [K, D] slab, a warp covering 32 columns of one
// segment.  No two blocks touch one slab, so no atomics are needed, and
// the slab updates of a batch go to distinct addresses, so their loads
// overlap.  |x|^2 is summed from the same staged chunks.  A second kernel
// sums the slabs in block order.  Every sum is therefore taken in an order
// fixed by the grid size and the data, and two runs on the same card give
// identical bits — Lloyd loops that wander from run to run would make
// every parity check flaky.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int LD = BM + 4;  // both staged slices are stored transposed, padded
constexpr int MC = 64;      // M-step: columns of x staged at a time
constexpr int MB = 8;       // M-step: (segment, column) items per thread batch
constexpr int IDX_NONE = 0x7fffffff;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
fused_em_kernel(const T* __restrict__ x, const float* __restrict__ c,
                const float* __restrict__ csq, const float* __restrict__ row_w,
                int n, int d, int k, int* __restrict__ labels,
                float* __restrict__ slab_sums, float* __restrict__ slab_counts,
                float* __restrict__ slab_inertia) {
  // E-step: As/Bs hold the transposed x and center slices.  M-step: the
  // same storage holds a [BM][MC + 1] chunk of the x tile.
  constexpr int STAGE = (2 * BK * LD > BM * (MC + 1)) ? 2 * BK * LD : BM * (MC + 1);
  __shared__ __align__(16) float stage[STAGE];
  float* As = stage;
  float* Bs = stage + BK * LD;
  float* Xs = stage;
  __shared__ float csq_s[BN];
  __shared__ float rmin_s[BM];  // min over centers of |c|^2 - 2 x.c
  __shared__ float xsq_s[BM];   // |x|^2, summed chunk by chunk
  __shared__ int lab_s[BM];     // label, or k for rows that add nothing
  __shared__ float w_s[BM];     // row weight
  __shared__ int perm_s[BM];    // tile rows sorted by (label, row)
  __shared__ int seg_lab[BM];
  __shared__ int seg_start[BM + 1];
  __shared__ int warp_starts[BM / 32];
  __shared__ int nvalid_s;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int b = blockIdx.x;
  float* sums_b = slab_sums + (size_t)b * k * d;
  float* counts_b = slab_counts + (size_t)b * k;

  for (size_t t = tid; t < (size_t)k * d; t += THREADS) sums_b[t] = 0.f;
  for (int t = tid; t < k; t += THREADS) counts_b[t] = 0.f;
  float block_inertia = 0.f;  // thread 0's running sum, in tile order
  __syncthreads();

  const int ntiles = (n + BM - 1) / BM;
  for (int tile = b; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    float rmin[8];
    int rarg[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      rmin[p] = INFINITY;
      rarg[p] = IDX_NONE;
    }

    // ---- E-step: cross = x . c^T tile by tile
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
          As[kk * LD + r] = (gr < n && gk < d) ? load_x(&x[(size_t)gr * d + gk]) : 0.f;
          Bs[kk * LD + r] = (gc < k && gk < d) ? c[(size_t)gc * d + gk] : 0.f;
        }
        __syncthreads();
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

    // ---- per-row results
    if (tx == 0) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int r = (p < 4) ? ty * 4 + p : 64 + ty * 4 + (p - 4);
        const int gr = row0 + r;
        int lab = k;
        float w = 0.f;
        if (gr < n) {
          const int arg = (rarg[p] == IDX_NONE) ? 0 : rarg[p];
          labels[gr] = arg;
          w = row_w ? row_w[gr] : 1.f;
          if (w != 0.f) lab = arg;
        }
        lab_s[r] = lab;
        w_s[r] = w;
        rmin_s[r] = rmin[p];
        xsq_s[r] = 0.f;
      }
    }
    __syncthreads();

    // ---- stable sort of the tile's rows by label (rows that add nothing
    // last), then segments of equal label via warp ballots
    unsigned starts = 0;
    int my_lab = k;
    if (tid < BM) {
      const int me = lab_s[tid];
      int rank = 0;
      for (int r = 0; r < BM; ++r) {
        const int o = lab_s[r];
        rank += (o < me) || (o == me && r < tid);
      }
      perm_s[rank] = tid;
    }
    __syncthreads();
    if (tid < BM) {  // tid is now a sorted position
      my_lab = lab_s[perm_s[tid]];
      const bool valid = my_lab != k;
      const bool start = valid && (tid == 0 || lab_s[perm_s[tid - 1]] != my_lab);
      starts = __ballot_sync(0xffffffffu, start);
      if (lane == 0) warp_starts[tid >> 5] = __popc(starts);
      if (valid && (tid == BM - 1 || lab_s[perm_s[tid + 1]] == k)) nvalid_s = tid + 1;
      if (tid == 0 && !valid) nvalid_s = 0;
    }
    __syncthreads();
    int nseg = 0;
#pragma unroll
    for (int w = 0; w < BM / 32; ++w) nseg += warp_starts[w];
    if (tid < BM && ((starts >> lane) & 1u)) {
      int s = __popc(starts & ((1u << lane) - 1u));
      for (int w = 0; w < (tid >> 5); ++w) s += warp_starts[w];
      seg_lab[s] = my_lab;
      seg_start[s] = tid;
    }
    if (tid == 0) seg_start[nseg] = nvalid_s;
    __syncthreads();

    // ---- counts: one thread per segment; segments have distinct labels
    if (tid < nseg) {
      float cnt = 0.f;
      for (int t = seg_start[tid]; t < seg_start[tid + 1]; ++t) cnt += w_s[perm_s[t]];
      counts_b[seg_lab[tid]] += cnt;
    }

    // ---- M-step, MC columns at a time: stage the x chunk (coalesced),
    // add |x|^2 (one thread per row, in column order), then one (segment,
    // column) item per thread-step; a warp covers 32 consecutive columns of
    // one segment, so the slab updates coalesce
    for (int d0 = 0; d0 < d; d0 += MC) {
#pragma unroll 4
      for (int j = 0; j < BM * MC / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / MC, cc = i % MC;
        const int gr = row0 + r, gc = d0 + cc;
        Xs[r * (MC + 1) + cc] =
            (gr < n && gc < d) ? load_x(&x[(size_t)gr * d + gc]) : 0.f;
      }
      __syncthreads();
      if (tid < BM) {
        float sq = 0.f;
        for (int cc = 0; cc < MC; ++cc) {
          const float v = Xs[tid * (MC + 1) + cc];
          sq = fmaf(v, v, sq);
        }
        xsq_s[tid] += sq;
      }
      const int items = nseg * MC;
      for (int base = 0; base < items; base += THREADS * MB) {
        float part[MB];
        size_t addr[MB];
#pragma unroll
        for (int q = 0; q < MB; ++q) {
          const int i = base + q * THREADS + tid;
          part[q] = 0.f;
          addr[q] = ~(size_t)0;
          if (i < items) {
            const int s = i / MC, cc = i % MC;
            if (d0 + cc < d) {
              for (int t = seg_start[s]; t < seg_start[s + 1]; ++t) {
                const int r = perm_s[t];
                part[q] = fmaf(w_s[r], Xs[r * (MC + 1) + cc], part[q]);
              }
              addr[q] = (size_t)seg_lab[s] * d + d0 + cc;
            }
          }
        }
        // distinct (label, column) pairs: the loads are independent
        float old[MB];
#pragma unroll
        for (int q = 0; q < MB; ++q)
          if (addr[q] != ~(size_t)0) old[q] = sums_b[addr[q]];
#pragma unroll
        for (int q = 0; q < MB; ++q)
          if (addr[q] != ~(size_t)0) sums_b[addr[q]] = old[q] + part[q];
      }
      __syncthreads();  // before the next chunk overwrites Xs
    }

    // ---- inertia of the tile, in a fixed order (warp 0: 4 rows a lane,
    // then a fixed shuffle tree)
    if (tid < 32) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        const int r = lane * (BM / 32) + j;
        s += fmaxf(rmin_s[r] + xsq_s[r], 0.f) * w_s[r];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tid == 0) block_inertia += s;
    }
    __syncthreads();
  }
  if (tid == 0) slab_inertia[b] = block_inertia;
}

// Sum the per-block slabs in block order.
__global__ void em_finalize_kernel(const float* __restrict__ slab_sums,
                                   const float* __restrict__ slab_counts,
                                   const float* __restrict__ slab_inertia,
                                   int grid, int k, int d,
                                   float* __restrict__ sums,
                                   float* __restrict__ counts,
                                   float* __restrict__ inertia) {
  const size_t kd = (size_t)k * d;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kd) {
    float s = 0.f;
    for (int b = 0; b < grid; ++b) s += slab_sums[(size_t)b * kd + i];
    sums[i] = s;
  } else if (i < kd + k) {
    const size_t j = i - kd;
    float s = 0.f;
    for (int b = 0; b < grid; ++b) s += slab_counts[(size_t)b * k + j];
    counts[j] = s;
  } else if (i == kd + k) {
    float s = 0.f;
    for (int b = 0; b < grid; ++b) s += slab_inertia[b];
    *inertia = s;
  }
}

}  // namespace

// x [n, d] (f32, or bf16 when x_bf16), c [k, d] f32, row_w [n] f32 or null
// (all rows weight 1).  Outputs labels [n] int32, sums [k, d], counts [k],
// inertia [1].  Scratch: csq [k], slab_sums [grid, k, d], slab_counts
// [grid, k], slab_inertia [grid]; grid >= 1 blocks.  Launches three kernels
// on `stream` and returns cudaGetLastError().
extern "C" int fused_em_step(const void* x, int x_bf16, const float* c,
                             const float* row_w, int n, int d, int k, int grid,
                             int* labels, float* sums, float* counts,
                             float* inertia, float* csq, float* slab_sums,
                             float* slab_counts, float* slab_inertia,
                             cudaStream_t stream) {
  if (k < 1 || d < 1 || n < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  center_sqnorm_kernel<<<(k + 7) / 8, 256, 0, stream>>>(c, k, d, csq);
  if (x_bf16)
    fused_em_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), c, csq, row_w, n, d, k, labels,
        slab_sums, slab_counts, slab_inertia);
  else
    fused_em_kernel<float><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(x), c, csq, row_w, n, d, k, labels,
        slab_sums, slab_counts, slab_inertia);
  const size_t total = (size_t)k * d + k + 1;
  em_finalize_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      slab_sums, slab_counts, slab_inertia, grid, k, d, sums, counts, inertia);
  return (int)cudaGetLastError();
}
