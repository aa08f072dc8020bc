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

// The helpers below serve K2 and K3 (csrc/preprocess.cu), where a team of
// TEAM lanes shares one query and several bisection levels are counted in
// one pass over the slab.

// The lanes of the calling thread's team: TEAM consecutive lanes of its warp.
template <int TEAM>
__device__ __forceinline__ unsigned team_mask() {
  static_assert(TEAM >= 2 && TEAM <= 32 && (TEAM & (TEAM - 1)) == 0,
                "a team is 2, 4, 8, 16 or 32 lanes");
  if constexpr (TEAM == 32) {
    return 0xffffffffu;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << TEAM) - 1u) << (lane & ~static_cast<unsigned>(TEAM - 1));
  }
}

// Sum of v over the team by a butterfly of shuffles in a fixed order.  IEEE
// addition commutes, so every lane ends with the same bits, run after run.
template <int TEAM>
__device__ __forceinline__ float team_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = TEAM / 2; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(mask, v, off));
  }
  return v;
}

// The 2^R - 1 thresholds of the next R bisection levels below (lo, hi), in
// heap order (node n's children are 2n+1 and 2n+2): each is the midpoint
// 0.5f * (lo + hi) that the serial walk computes at that node, with the same
// two roundings.
template <int R>
__device__ __forceinline__ void subtree_mids(float lo, float hi,
                                             float (&mid)[(1 << R) - 1]) {
  constexpr int M = (1 << R) - 1;
  float nlo[M], nhi[M];
  nlo[0] = lo;
  nhi[0] = hi;
#pragma unroll
  for (int n = 0; n < M; ++n) {
    mid[n] = __fmul_rn(0.5f, __fadd_rn(nlo[n], nhi[n]));
    if (2 * n + 2 < M) {
      nlo[2 * n + 1] = nlo[n];
      nhi[2 * n + 1] = mid[n];
      nlo[2 * n + 2] = mid[n];
      nhi[2 * n + 2] = nhi[n];
    }
  }
}

// Walk R levels down that subtree from its root: where a node's count
// reaches k, hi moves down to its midpoint, else lo moves up: the serial
// walk's decisions from the same counts, hence the same (lo, hi).
template <int R>
__device__ __forceinline__ void walk_levels(const int (&cnt)[(1 << R) - 1],
                                            const float (&mid)[(1 << R) - 1], int k,
                                            float& lo, float& hi) {
  int n = 0;
#pragma unroll
  for (int l = 0; l < R; ++l) {
    int c = 0;
    float m = 0.0f;
#pragma unroll
    for (int i = (1 << l) - 1; i < (2 << l) - 1; ++i) {   // the nodes of level l
      if (n == i) {
        c = cnt[i];
        m = mid[i];
      }
    }
    if (c >= k) {
      hi = m;
      n = 2 * n + 1;
    } else {
      lo = m;
      n = 2 * n + 2;
    }
  }
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
