// Shared helpers for the hand-written Hopper kernels of pcr_tpu_torch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pcr {

// Any query-candidate pair with d2 above this involves a PAD_COORD sentinel.
constexpr float kRealD2Max = 1.0e10f;
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

// The helpers below serve K2 and K3 (csrc/preprocess.cu) and K4-K6
// (csrc/fpfh.cu), where a team of TEAM lanes shares one query and, in K2-K5,
// several bisection levels are counted in one pass over the slab.

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

// A block of WARPS warps in teams of TEAM lanes; a team takes QPT queries of
// its block's tile in turn.
template <int TEAM, int WARPS, int QPT>
struct Geometry {
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kTeams = kThreads / TEAM;
  static constexpr int kQueries = kTeams * QPT;   // queries a block
};

// Blocks of one tile's queries: ceil(q_tile / queries a block) of them a tile.
template <int TEAM, int WARPS, int QPT>
int blocks_for(int n_pad, int q_tile) {
  using G = Geometry<TEAM, WARPS, QPT>;
  return (n_pad / q_tile) * ((q_tile + G::kQueries - 1) / G::kQueries);
}

// Whether a log bisection up to log_hi needs the d2 < kRealD2Max test: every
// threshold is at most ~expf(log_hi), and below kRealD2Max (with a margin far
// above expf's error) no threshold admits a sentinel pair.
inline bool needs_sentinel_check(float log_hi) {
  return !(log_hi < logf(kRealD2Max) - 1e-3f);
}

// Stage the slab rows [start, start + slab) as float4 (x, y, z, w); w is
// the survivor flag where KEEP, else 0.
template <bool KEEP>
__device__ __forceinline__ void stage_rows(const float* __restrict__ r,
                                           const unsigned char* __restrict__ keep,
                                           int start, int slab, float4* s4) {
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const float* row = r + 3 * static_cast<size_t>(start + j);
    float w = 0.0f;
    if constexpr (KEEP) w = keep[start + j] ? 1.0f : 0.0f;
    s4[j] = make_float4(row[0], row[1], row[2], w);
  }
}

// d2 of the query to slab row p, or NaN where the row does not count: a
// non-survivor (KEEP and p.w == 0) or, where CHECK, a sentinel pair.
template <bool CHECK, bool KEEP>
__device__ __forceinline__ float counted_d2(float qx, float qy, float qz, float4 p) {
  const float d = sqdist(qx, qy, qz, p.x, p.y, p.z);
  bool ok = true;
  if constexpr (KEEP) ok = p.w != 0.0f;
  if constexpr (CHECK) ok = ok && d < kRealD2Max;
  return ok ? d : __int_as_float(0x7fffffff);
}

// The rows a team reduces over: the whole staged slab (row i is slab row i) ...
struct SlabRows {
  const float4* s4;
  __device__ __forceinline__ int index(int i) const { return i; }
  __device__ __forceinline__ float4 row(int i) const { return s4[i]; }
};

// ... or the slab rows that the team listed (row i is slab row list[i]).
struct ListedRows {
  const float4* s4;
  const unsigned short* list;
  __device__ __forceinline__ int index(int i) const { return list[i]; }
  __device__ __forceinline__ float4 row(int i) const { return s4[list[i]]; }
};

// Compact the slab rows at d2 <= top into list, in ascending order, at most
// CAP of them (ballot and popcount prefix over the team).  Returns how many
// there are; above CAP the sweep stops early and the list is not complete.
template <int TEAM, int CAP, bool CHECK>
__device__ __forceinline__ int list_rows_within(const float4* s4, int slab, int lane,
                                                unsigned mask, float qx, float qy, float qz,
                                                float top, unsigned short* list) {
  const int shift = (threadIdx.x & 31) - lane;       // the team's first lane in its warp
  const unsigned below = (1u << lane) - 1u;          // the team's lanes before this one
  int n = 0;
  for (int j0 = 0; j0 < slab && n <= CAP; j0 += TEAM) {
    const int j = j0 + lane;
    const bool in = j < slab && counted_d2<CHECK, false>(qx, qy, qz, s4[j]) <= top;
    const unsigned votes = __ballot_sync(mask, in) >> shift;
    const int pos = n + __popc(votes & below);
    if (in && pos < CAP) list[pos] = static_cast<unsigned short>(j);
    n += __popc(votes);
  }
  __syncwarp(mask);
  return n;
}

// One pass: count the team's n rows at d2 <= each threshold of the next
// R levels below (lo, hi) (exp of the midpoint where LOG), then walk them.
template <int TEAM, int R, bool LOG, bool CHECK, bool KEEP, typename ROWS>
__device__ __forceinline__ void count_levels(const ROWS& rows, int n, int lane,
                                             unsigned mask, float qx, float qy, float qz,
                                             int k, float& lo, float& hi) {
  constexpr int M = (1 << R) - 1;
  float mid[M], t[M];
  int cnt[M];
  subtree_mids<R>(lo, hi, mid);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    t[m] = LOG ? expf(mid[m]) : mid[m];
    cnt[m] = 0;
  }
#pragma unroll 4
  for (int j = lane; j < n; j += TEAM) {
    const float d = counted_d2<CHECK, KEEP>(qx, qy, qz, rows.row(j));
#pragma unroll
    for (int m = 0; m < M; ++m) cnt[m] += d <= t[m];
  }
#pragma unroll
  for (int m = 0; m < M; ++m) cnt[m] = __reduce_add_sync(mask, cnt[m]);
  walk_levels<R>(cnt, mid, k, lo, hi);
}

// The whole 10-step bisection for the k-th nearest counted row, LEVELS levels
// a pass (the last pass takes what is left).
template <int TEAM, int LEVELS, bool LOG, bool CHECK, bool KEEP, int DONE = 0, typename ROWS>
__device__ __forceinline__ void bisect(const ROWS& rows, int n, int lane, unsigned mask,
                                       float qx, float qy, float qz, int k, float& lo,
                                       float& hi) {
  constexpr int R = LEVELS < kBisectSteps - DONE ? LEVELS : kBisectSteps - DONE;
  count_levels<TEAM, R, LOG, CHECK, KEEP>(rows, n, lane, mask, qx, qy, qz, k, lo, hi);
  if constexpr (DONE + R < kBisectSteps) {
    bisect<TEAM, LEVELS, LOG, CHECK, KEEP, DONE + R>(rows, n, lane, mask, qx, qy, qz, k, lo,
                                                      hi);
  }
}

// The moments [x y z | xx xy xz yy yz zz | count] of the counted rows at
// d2 <= tau, centred on (cx, cy, cz); lane 0 writes the 10 floats to out.
template <int TEAM, bool CHECK, bool KEEP, typename ROWS>
__device__ __forceinline__ void team_moments(const ROWS& rows, int n, int lane,
                                             unsigned mask, float qx, float qy, float qz,
                                             float tau, float cx, float cy, float cz,
                                             float* __restrict__ out) {
  float acc[9];
#pragma unroll
  for (int f = 0; f < 9; ++f) acc[f] = 0.0f;
  int cnt = 0;
  for (int j = lane; j < n; j += TEAM) {
    const float4 p = rows.row(j);
    const float d = counted_d2<CHECK, KEEP>(qx, qy, qz, p);
    if (d <= tau) {
      const float bx = __fsub_rn(p.x, cx);
      const float by = __fsub_rn(p.y, cy);
      const float bz = __fsub_rn(p.z, cz);
      acc[0] = __fadd_rn(acc[0], bx);
      acc[1] = __fadd_rn(acc[1], by);
      acc[2] = __fadd_rn(acc[2], bz);
      acc[3] = __fadd_rn(acc[3], __fmul_rn(bx, bx));
      acc[4] = __fadd_rn(acc[4], __fmul_rn(bx, by));
      acc[5] = __fadd_rn(acc[5], __fmul_rn(bx, bz));
      acc[6] = __fadd_rn(acc[6], __fmul_rn(by, by));
      acc[7] = __fadd_rn(acc[7], __fmul_rn(by, bz));
      acc[8] = __fadd_rn(acc[8], __fmul_rn(bz, bz));
      ++cnt;
    }
  }
  cnt = __reduce_add_sync(mask, cnt);
#pragma unroll
  for (int f = 0; f < 9; ++f) acc[f] = team_sum<TEAM>(acc[f], mask);
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < 9; ++f) out[f] = acc[f];
    out[9] = static_cast<float>(cnt);
  }
}

// Dynamic shared memory above the 48 KB default must be reserved first.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace pcr
