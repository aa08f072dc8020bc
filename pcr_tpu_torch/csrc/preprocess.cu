// K2 and K3 — the two neighbourhood passes of the fused per-scale
// preprocess (ops/preprocess.outlier_and_normals_sorted): statistical
// outlier statistics, then survivor-kNN moments for the normals.
//
// K2 replaces pcr_tpu/ops/pallas/feature_kernels.py:outlier_stats_pallas,
// K3 replaces pcr_tpu/ops/pallas/feature_kernels.py:survivor_moments_pallas.
//
// Both reduce over one slab: the 2*band sorted rows starting at
// starts[tile] (element offset, computed once by the wrapper) for every
// query of a q_tile-row tile.  The TPU kernels cache the (TQ, 2*band) d2
// tile in VMEM across the 10 bisection steps; on the H100 that tile would
// not fit in shared memory (227 KB per block), so each thread recomputes
// its query's distances in every step (3 subtractions, 3 products, 2 adds
// per slab row).  Bound: issue rate — a query costs ~12 passes over 2*band
// rows and reads nothing but the slab, which the block holds in shared
// memory (24 KB for K2, 32 KB for K3 at band 1024).  Counting passes stop
// as soon as the count reaches k, which changes no result.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using pcr::kBisectSteps;
using pcr::launch_threads;
using pcr::reserve_smem;
using pcr::tile_start;

__global__ void outlier_stats_kernel(const int* __restrict__ starts,
                                     const float* __restrict__ q,
                                     const float* __restrict__ r, int q_tile,
                                     int band, int k1, float log_lo,
                                     float log_hi, float* __restrict__ mean_d,
                                     unsigned char* __restrict__ found,
                                     float* __restrict__ tau_out) {
  extern __shared__ float smem[];
  const int slab = 2 * band;
  float* sx = smem;
  float* sy = smem + slab;
  float* sz = smem + 2 * slab;
  const int start = tile_start(starts, q_tile);
  pcr::stage_slab(r, 3, start, slab, smem);
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

  // log-space count-CDF bisection for the k1-th nearest (self included)
  const float tau = pcr::log_bisect_tau(qx, qy, qz, sx, sy, sz, slab, k1, log_lo, log_hi);
  int cnt = 0;
  float sum_d = 0.0f;
  for (int k = 0; k < slab; ++k) {
    const float d = pcr::sqdist(qx, qy, qz, sx[k], sy[k], sz[k]);
    if (d < pcr::kRealD2Max && d <= tau) {
      ++cnt;
      sum_d = __fadd_rn(sum_d, __fsqrt_rn(fmaxf(d, 0.0f)));
    }
  }
  mean_d[qi] = __fdiv_rn(sum_d, static_cast<float>(max(cnt - 1, 1)));  // self = 0
  found[qi] = cnt >= k1 ? 1 : 0;
  tau_out[qi] = tau;
}

__global__ void survivor_moments_kernel(const int* __restrict__ starts,
                                        const float* __restrict__ q,
                                        const float* __restrict__ r,
                                        const unsigned char* __restrict__ keep,
                                        const float* __restrict__ tau0,
                                        const float* __restrict__ center,
                                        int q_tile, int band, int normal_k,
                                        float* __restrict__ out) {
  extern __shared__ float smem[];
  const int slab = 2 * band;
  float* sx = smem;
  float* sy = smem + slab;
  float* sz = smem + 2 * slab;
  float* sk = smem + 3 * slab;
  const int start = tile_start(starts, q_tile);
  pcr::stage_slab(r, 3, start, slab, smem);
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    sk[j] = keep[start + j] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

  // linear bisection on [0, 4*tau_out + 1e-6] for the normal_k-th survivor
  float lo = 0.0f;
  float hi = __fadd_rn(__fmul_rn(4.0f, tau0[qi]), 1e-6f);
  for (int s = 0; s < kBisectSteps; ++s) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int k = 0; k < slab && c < normal_k; ++k) {
      const float d = pcr::sqdist(qx, qy, qz, sx[k], sy[k], sz[k]);
      c += (sk[k] != 0.0f) & (d < pcr::kRealD2Max) & (d <= mid);
    }
    if (c >= normal_k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  const float tau = hi;

  // moments [x y z | xx xy xz yy yz zz | count] centred on the slab centroid
  const int tile = (blockIdx.x * blockDim.x) / q_tile;
  const float cx = center[3 * tile], cy = center[3 * tile + 1],
              cz = center[3 * tile + 2];
  float acc[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) acc[f] = 0.0f;
  for (int k = 0; k < slab; ++k) {
    const float d = pcr::sqdist(qx, qy, qz, sx[k], sy[k], sz[k]);
    if (sk[k] != 0.0f && d < pcr::kRealD2Max && d <= tau) {
      const float bx = __fsub_rn(sx[k], cx);
      const float by = __fsub_rn(sy[k], cy);
      const float bz = __fsub_rn(sz[k], cz);
      acc[0] = __fadd_rn(acc[0], bx);
      acc[1] = __fadd_rn(acc[1], by);
      acc[2] = __fadd_rn(acc[2], bz);
      acc[3] = __fadd_rn(acc[3], __fmul_rn(bx, bx));
      acc[4] = __fadd_rn(acc[4], __fmul_rn(bx, by));
      acc[5] = __fadd_rn(acc[5], __fmul_rn(bx, bz));
      acc[6] = __fadd_rn(acc[6], __fmul_rn(by, by));
      acc[7] = __fadd_rn(acc[7], __fmul_rn(by, bz));
      acc[8] = __fadd_rn(acc[8], __fmul_rn(bz, bz));
      acc[9] = __fadd_rn(acc[9], 1.0f);
    }
  }
#pragma unroll
  for (int f = 0; f < 10; ++f) out[10 * static_cast<size_t>(qi) + f] = acc[f];
}

}  // namespace

// The wrapper guarantees q_tile < 128 or q_tile % 128 == 0, and
// n_pad % q_tile == 0; starts[t] + 2*band never exceeds the ref rows.
extern "C" int pcr_outlier_stats(const int* starts, const float* q,
                                 const float* r, int n_pad, int q_tile,
                                 int band, int k1, float log_lo, float log_hi,
                                 float* mean_d, unsigned char* found,
                                 float* tau_out, cudaStream_t stream) {
  const int threads = launch_threads(q_tile);
  const size_t smem = sizeof(float) * 3 * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(outlier_stats_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  outlier_stats_kernel<<<n_pad / threads, threads, smem, stream>>>(
      starts, q, r, q_tile, band, k1, log_lo, log_hi, mean_d, found, tau_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcr_survivor_moments(const int* starts, const float* q,
                                    const float* r, const unsigned char* keep,
                                    const float* tau0, const float* center,
                                    int n_pad, int q_tile, int band,
                                    int normal_k, float* out,
                                    cudaStream_t stream) {
  const int threads = launch_threads(q_tile);
  const size_t smem = sizeof(float) * 4 * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(survivor_moments_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  survivor_moments_kernel<<<n_pad / threads, threads, smem, stream>>>(
      starts, q, r, keep, tau0, center, q_tile, band, normal_k, out);
  return static_cast<int>(cudaGetLastError());
}
