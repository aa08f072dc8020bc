// Shared helpers for the hand-written Hopper kernels of pcr_tpu_torch.
#pragma once

#include <cuda_runtime.h>

namespace pcr {

// Any query-candidate pair with d2 above this involves a PAD_COORD sentinel.
constexpr float kRealD2Max = 1.0e10f;
// Threads per block of the slab kernels (one thread per query).
constexpr int kMaxThreads = 128;
constexpr int kBisectSteps = 10;

// Squared distance as ((dx*dx + dy*dy) + dz*dz) with every operation rounded
// on its own (no FMA contraction), so it is bit-identical to the plain
// PyTorch versions, which evaluate the same expression one op at a time.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Slab start (element offset) of the q_tile-row tile this block lies in.
// q_tile is a multiple of blockDim.x, so a block never straddles tiles.
__device__ __forceinline__ int tile_start(const int* starts, int q_tile) {
  return starts[(blockIdx.x * blockDim.x) / q_tile];
}

// Stage `cols` float columns of the slab rows [start, start + slab) into
// shared memory, column c at dst + c * slab.  src is row-major with `cols`
// floats a row.
__device__ __forceinline__ void stage_slab(const float* __restrict__ src, int cols,
                                           int start, int slab, float* dst) {
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const float* row = src + static_cast<size_t>(cols) * (start + j);
    for (int c = 0; c < cols; ++c) dst[c * slab + j] = row[c];
  }
}

// Log-space count-CDF bisection on [exp(log_lo), exp(log_hi)]: the least
// bisection threshold with at least k real slab rows at d2 <= threshold.
// Each counting pass stops once the count reaches k, which changes no result.
__device__ __forceinline__ float log_bisect_tau(float qx, float qy, float qz,
                                                const float* sx, const float* sy,
                                                const float* sz, int slab, int k,
                                                float log_lo, float log_hi) {
  float llo = log_lo, lhi = log_hi;
  for (int s = 0; s < kBisectSteps; ++s) {
    const float lmid = __fmul_rn(0.5f, __fadd_rn(llo, lhi));
    const float t = expf(lmid);
    int c = 0;
    for (int j = 0; j < slab && c < k; ++j) {
      const float d = sqdist(qx, qy, qz, sx[j], sy[j], sz[j]);
      c += (d < kRealD2Max) & (d <= t);
    }
    if (c >= k) {
      lhi = lmid;
    } else {
      llo = lmid;
    }
  }
  return expf(lhi);
}

inline int launch_threads(int q_tile) {
  return q_tile < kMaxThreads ? q_tile : kMaxThreads;
}

// Dynamic shared memory above the 48 KB default must be reserved first.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace pcr
