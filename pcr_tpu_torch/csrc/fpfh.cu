// K4, K5 and K6 — the three banded passes of the stage-1 features
// (ops/fpfh_sorted.fgr_features_sorted): Hybrid(2v, 20) neighbourhood
// moments for the normals, SPFH histograms over Hybrid(10v, 200)
// neighbourhoods, and the 1/d2-weighted FPFH sum of the neighbours' SPFH.
//
// K4 replaces pcr_tpu/ops/pallas/feature_kernels.py:moments_pallas,
// K5 replaces pcr_tpu/ops/pallas/feature_kernels.py:spfh_pallas,
// K6 replaces pcr_tpu/ops/pallas/feature_kernels.py:fpfh_pallas.
//
// Every query of a q_tile-row tile reduces over the same slab: the 2*band
// sorted rows from starts[tile] (element offset, computed once by the
// wrapper, which also proves that each query's own row lies in its slab).
//
// Bound on the H100: the FP32 issue rate.  A query costs ~11 sweeps of its
// 4096-row slab (10 bisection steps and the consumer pass), ~10 x 24576 x
// 4096 distance evaluations of 8 FP32 operations each per pass over an NCLT
// scan, while the bytes are a few MB (each slab row is read from L2 once per
// block).  The TPU kernels keep the (TQ, 2*band) d2 tile in VMEM across the
// bisection; that tile cannot live in a block's 227 KB of shared memory, so
// here one thread owns one query and recomputes its distances in every step
// from the slab, which its block holds in shared memory (K4 and K6: the
// coordinates, 48 KB at band 2048; K5: coordinates and normals, 96 KB).
// Counting passes stop once the count reaches k.  K5 evaluates the Darboux
// features only for the <= 200 kept pairs of a query, not for the whole
// slab, and keeps its 33 bin counts in shared memory; K6 keeps its 33 sums in
// registers and reads the kept rows' SPFH from L2 (the 4096 x 33 SPFH slab,
// 540 KB, does not fit in shared memory).
//
// d2 and every Darboux operation are rounded one by one (`__f*_rn`, no FMA
// contraction), in the order of the plain PyTorch versions, and the file is
// compiled without --use_fast_math (an approximate rsqrt flipped histogram
// bins on the TPU): the kernels' bins and tau equal the plain versions'.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using pcr::launch_threads;
using pcr::reserve_smem;
using pcr::tile_start;

constexpr int kBins = 11;
constexpr int kFeat = 33;
constexpr float kTiny = 1e-12f;

__global__ void moments_kernel(const int* __restrict__ starts,
                               const float* __restrict__ q,
                               const float* __restrict__ r,
                               const float* __restrict__ center, int q_tile,
                               int band, int normal_k, float log_lo,
                               float log_hi, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int slab = 2 * band;
  const float* sx = smem;
  const float* sy = smem + slab;
  const float* sz = smem + 2 * slab;
  const int start = tile_start(starts, q_tile);
  pcr::stage_slab(r, 3, start, slab, smem);
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

  // Hybrid(2v, normal_k): the normal_k-th nearest, self included
  const float tau = pcr::log_bisect_tau(qx, qy, qz, sx, sy, sz, slab, normal_k,
                                        log_lo, log_hi);

  // moments [x y z | xx xy xz yy yz zz | count] centred on the slab centroid
  const int tile = (blockIdx.x * blockDim.x) / q_tile;
  const float cx = center[3 * tile], cy = center[3 * tile + 1],
              cz = center[3 * tile + 2];
  float acc[10];
#pragma unroll
  for (int f = 0; f < 10; ++f) acc[f] = 0.0f;
  for (int k = 0; k < slab; ++k) {
    const float d = pcr::sqdist(qx, qy, qz, sx[k], sy[k], sz[k]);
    if (d < pcr::kRealD2Max && d <= tau) {
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

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// a * b - c * d, each product rounded (one component of a cross product)
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ int bin_of(float f, float lo, float scale) {
  const int b = static_cast<int>(floorf(__fmul_rn(__fsub_rn(f, lo), scale)));
  return min(max(b, 0), kBins - 1);
}

// Open3D's ComputePairFeatures with the source/target swap, for the query
// (q, n1) and the slab row (b, n2) at squared distance d2 — the arithmetic of
// ops/kernels/feature_kernels._pair_features_tile, operation for operation.
__device__ __forceinline__ void pair_features(float qx, float qy, float qz,
                                              float n1x, float n1y, float n1z,
                                              float bx, float by, float bz,
                                              float n2x, float n2y, float n2z,
                                              float d2, float* f1, float* f2,
                                              float* f3) {
  const float dist = fmaxf(__fsqrt_rn(d2), kTiny);
  const float dnx = __fdiv_rn(__fsub_rn(bx, qx), dist);
  const float dny = __fdiv_rn(__fsub_rn(by, qy), dist);
  const float dnz = __fdiv_rn(__fsub_rn(bz, qz), dist);
  const float a1 = dot3(n1x, n1y, n1z, dnx, dny, dnz);
  const float a2 = dot3(n2x, n2y, n2z, dnx, dny, dnz);
  const bool swap = fabsf(a2) > fabsf(a1);
  const float ux = swap ? n2x : n1x, uy = swap ? n2y : n1y, uz = swap ? n2z : n1z;
  const float tx = swap ? n1x : n2x, ty = swap ? n1y : n2y, tz = swap ? n1z : n2z;
  const float ex = swap ? -dnx : dnx, ey = swap ? -dny : dny, ez = swap ? -dnz : dnz;
  *f2 = dot3(ux, uy, uz, ex, ey, ez);
  float vx = cross1(ey, uz, ez, uy);
  float vy = cross1(ez, ux, ex, uz);
  float vz = cross1(ex, uy, ey, ux);
  const float vn = fmaxf(__fsqrt_rn(dot3(vx, vy, vz, vx, vy, vz)), kTiny);
  vx = __fdiv_rn(vx, vn);
  vy = __fdiv_rn(vy, vn);
  vz = __fdiv_rn(vz, vn);
  const float wx = cross1(uy, vz, uz, vy);
  const float wy = cross1(uz, vx, ux, vz);
  const float wz = cross1(ux, vy, uy, vx);
  *f1 = dot3(vx, vy, vz, tx, ty, tz);
  *f3 = atan2f(dot3(wx, wy, wz, tx, ty, tz), dot3(ux, uy, uz, tx, ty, tz));
}

__global__ void spfh_kernel(const int* __restrict__ starts,
                            const float* __restrict__ q,
                            const float* __restrict__ nq,
                            const float* __restrict__ r,
                            const float* __restrict__ nr, int q_tile, int band,
                            int k, float log_lo, float log_hi, float radius2,
                            float lo3, float scale12, float scale3,
                            float* __restrict__ spfh_out,
                            float* __restrict__ tau_out) {
  extern __shared__ float smem[];
  const int slab = 2 * band;
  const float* sx = smem;
  const float* sy = smem + slab;
  const float* sz = smem + 2 * slab;
  const float* snx = smem + 3 * slab;
  const float* sny = smem + 4 * slab;
  const float* snz = smem + 5 * slab;
  // bin b of this thread at hist[b * blockDim.x + threadIdx.x] (no conflicts)
  int* hist = reinterpret_cast<int*>(smem + 6 * slab);
  const int start = tile_start(starts, q_tile);
  pcr::stage_slab(r, 3, start, slab, smem);
  pcr::stage_slab(nr, 3, start, slab, smem + 3 * slab);
  for (int b = 0; b < kFeat; ++b) hist[b * blockDim.x + threadIdx.x] = 0;
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float n1x = nq[3 * qi], n1y = nq[3 * qi + 1], n1z = nq[3 * qi + 2];

  // Hybrid(10v, max_nn excl. self): the (max_nn+1)-th nearest, self included,
  // capped at the radius
  const float tau = fminf(
      pcr::log_bisect_tau(qx, qy, qz, sx, sy, sz, slab, k, log_lo, log_hi), radius2);
  const int self_col = qi - start;
  int cnt = 0;
  for (int j = 0; j < slab; ++j) {
    const float d = pcr::sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
    if (d < pcr::kRealD2Max && d <= tau && d > 0.0f && j != self_col) {
      float f1, f2, f3;
      pair_features(qx, qy, qz, n1x, n1y, n1z, sx[j], sy[j], sz[j], snx[j],
                    sny[j], snz[j], d, &f1, &f2, &f3);
      ++hist[bin_of(f1, -1.0f, scale12) * blockDim.x + threadIdx.x];
      ++hist[(kBins + bin_of(f2, -1.0f, scale12)) * blockDim.x + threadIdx.x];
      ++hist[(2 * kBins + bin_of(f3, lo3, scale3)) * blockDim.x + threadIdx.x];
      ++cnt;
    }
  }
  const float incr = cnt > 0 ? __fdiv_rn(100.0f, static_cast<float>(cnt)) : 0.0f;
  for (int b = 0; b < kFeat; ++b) {
    spfh_out[kFeat * static_cast<size_t>(qi) + b] =
        __fmul_rn(static_cast<float>(hist[b * blockDim.x + threadIdx.x]), incr);
  }
  tau_out[qi] = tau;
}

__global__ void fpfh_kernel(const int* __restrict__ starts,
                            const float* __restrict__ q,
                            const float* __restrict__ r,
                            const float* __restrict__ tau_in,
                            const float* __restrict__ spfh, int q_tile,
                            int band, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int slab = 2 * band;
  const float* sx = smem;
  const float* sy = smem + slab;
  const float* sz = smem + 2 * slab;
  const int start = tile_start(starts, q_tile);
  pcr::stage_slab(r, 3, start, slab, smem);
  __syncthreads();
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const float tau = tau_in[qi];
  const int self_col = qi - start;
  float acc[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.0f;
  for (int j = 0; j < slab; ++j) {
    const float d = pcr::sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
    if (d < pcr::kRealD2Max && d <= tau && d > 0.0f && j != self_col) {
      const float w = __frcp_rn(fmaxf(d, kTiny));
      const float* row = spfh + kFeat * static_cast<size_t>(start + j);
#pragma unroll
      for (int f = 0; f < kFeat; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, row[f]));
    }
  }
#pragma unroll
  for (int f = 0; f < kFeat; ++f) out[kFeat * static_cast<size_t>(qi) + f] = acc[f];
}

}  // namespace

// The wrappers guarantee q_tile < 128 or q_tile % 128 == 0, n_pad % q_tile
// == 0 and starts[t] + 2*band <= the ref rows of r, nr and spfh.
extern "C" int pcr_moments(const int* starts, const float* q, const float* r,
                           const float* center, int n_pad, int q_tile, int band,
                           int normal_k, float log_lo, float log_hi, float* out,
                           cudaStream_t stream) {
  const int threads = launch_threads(q_tile);
  const size_t smem = sizeof(float) * 3 * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(moments_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_kernel<<<n_pad / threads, threads, smem, stream>>>(
      starts, q, r, center, q_tile, band, normal_k, log_lo, log_hi, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcr_spfh(const int* starts, const float* q, const float* nq,
                        const float* r, const float* nr, int n_pad, int q_tile,
                        int band, int k, float log_lo, float log_hi,
                        float radius2, float lo3, float scale12, float scale3,
                        float* spfh_out, float* tau_out, cudaStream_t stream) {
  const int threads = launch_threads(q_tile);
  const size_t smem = sizeof(float) * 6 * 2 * static_cast<size_t>(band) +
                      sizeof(int) * kFeat * static_cast<size_t>(threads);
  cudaError_t err = reserve_smem(spfh_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  spfh_kernel<<<n_pad / threads, threads, smem, stream>>>(
      starts, q, nq, r, nr, q_tile, band, k, log_lo, log_hi, radius2, lo3,
      scale12, scale3, spfh_out, tau_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcr_fpfh(const int* starts, const float* q, const float* r,
                        const float* tau, const float* spfh, int n_pad,
                        int q_tile, int band, float* out, cudaStream_t stream) {
  const int threads = launch_threads(q_tile);
  const size_t smem = sizeof(float) * 3 * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(fpfh_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fpfh_kernel<<<n_pad / threads, threads, smem, stream>>>(
      starts, q, r, tau, spfh, q_tile, band, out);
  return static_cast<int>(cudaGetLastError());
}
