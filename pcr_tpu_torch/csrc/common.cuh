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

// The slab start of one query tile of the band sweep (ops/band_nn.slab_starts'
// rule), taken by a block: csrc/band_nn.cu's slab_starts and csrc/gicp.cu's
// gicp_move.  Each thread folds the axis coordinates of its rows of the tile
// into a SlabExtent; slab_start merges the block's and thread 0 writes the
// tile's start, so both kernels take the same starts bit for bit.

constexpr float kSlabSentinel = 1.0e6f;   // a masked or padding row (ops/kernels/common.SENTINEL)
constexpr float kSlabBig = 3.0e38f;       // ops/kernels/common.BIG

// The tile's smallest coordinate over every row, its largest over the real
// rows (those below kSlabSentinel / 2), and whether it has a real row.
struct SlabExtent {
  float mn = INFINITY;
  float mx = -kSlabBig;
  int real = 0;
};

__device__ __forceinline__ void slab_extent(SlabExtent& e, float a) {
  e.mn = fminf(e.mn, a);
  if (a < kSlabSentinel / 2) {
    e.mx = fmaxf(e.mx, a);
    e.real = 1;
  }
}

// torch.searchsorted on the ascending a[0, n): the first i with a[i] >= v,
// or with RIGHT the first i with a[i] > v.
template <bool RIGHT>
__device__ long long search_sorted(const float* __restrict__ a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = a[mid];
    if (RIGHT ? x <= v : x < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Refs level with a tile (sorted rows [lo, hi)) inside the slab at start.
__device__ __forceinline__ long long level_rows(long long lo, long long hi, long long start,
                                                long long band) {
  const long long end = hi < start + 2 * band ? hi : start + 2 * band;
  const long long begin = lo > start ? lo : start;
  return end > begin ? end - begin : 0;
}

// The block's extents merged (warp shuffles, then warp order), and thread 0
// writes *start: pcr_tpu's slab at the first ref within max_dist of the
// tile's lowest row, rounded down to band and capped at max_blk bands,
// unless it misses refs level with the tile (ra in [mn, mx]) and the slab
// centred on them holds them all.  Every thread of the block calls it.
template <int THREADS>
__device__ void slab_start(SlabExtent e, const float* __restrict__ ra, int nr, int band,
                           int max_blk, float max_dist, int* start) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");
  __shared__ SlabExtent warps[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    e.mn = fminf(e.mn, __shfl_xor_sync(0xffffffffu, e.mn, off));
    e.mx = fmaxf(e.mx, __shfl_xor_sync(0xffffffffu, e.mx, off));
    e.real |= __shfl_xor_sync(0xffffffffu, e.real, off);
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = e;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < THREADS / 32; ++w) {
    e.mn = fminf(e.mn, warps[w].mn);
    e.mx = fmaxf(e.mx, warps[w].mx);
    e.real |= warps[w].real;
  }
  const long long b = band, top = max_blk;
  const long long ss = search_sorted<false>(ra, nr, __fsub_rn(e.mn, max_dist));
  const long long lo = search_sorted<false>(ra, nr, e.mn);
  const long long hi = search_sorted<true>(ra, nr, e.mx);
  const long long ours = clamp64(ss / b, 0, top) * b;
  const long long centred = clamp64((lo + hi) / 2 - b, 0, top * b);
  const long long level = hi - lo;
  const bool centre = level_rows(lo, hi, ours, b) < level &&
                      level_rows(lo, hi, centred, b) == level && e.real;
  *start = static_cast<int>(centre ? centred : ours);
}

// The pose update of K8 and K10 (csrc/loops.cu, csrc/gicp.cu).

// xi = H^-1 g for the SPD 6x6 H by Cholesky H = L L^T (torch.linalg.cholesky
// then cholesky_solve, as utils/linalg.solve6_cholesky).
__device__ inline void cholesky_solve6(const float (&H)[6][6], const float (&g)[6],
                                       float (&x)[6]) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// out = a K + b K^2 + I for K = skew(w), K^2 as the 3x3 product (utils/se3.py).
__device__ __forceinline__ void rodrigues(const float (&K)[3][3], const float (&K2)[3][3],
                                          float a, float b, float (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = (i == j ? 1.0f : 0.0f) + a * K[i][j] + b * K2[i][j];
  }
}

// T <- se3_exp(xi) T for the twist xi = (omega, v), with utils/se3.py's
// small-angle branches; T is a pose's top three rows (R | t), row-major.
__device__ inline void se3_exp_compose(const float (&xi)[6], float* T) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(fmaxf(theta2, 1e-32f));
  const bool taylor = theta2 < 1e-12f;
  const float sn = sinf(theta), cs = cosf(theta);
  const float a = taylor ? 1.0f - theta2 / 6.0f : sn / theta;
  const float b = taylor ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2;
  const float c = taylor ? 1.0f / 6.0f - theta2 / 120.0f : (theta - sn) / (theta2 * theta);
  const float K[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float K2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      K2[i][j] = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
    }
  }
  float R[3][3], V[3][3];
  rodrigues(K, K2, a, b, R);
  rodrigues(K, K2, b, c, V);
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) te[i] = V[i][0] * xi[3] + V[i][1] * xi[4] + V[i][2] * xi[5];

  // T <- [R te; 0 1] T
  float old[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) old[e] = T[e];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = R[i][0] * old[j] + R[i][1] * old[4 + j] + R[i][2] * old[8 + j];
      T[4 * i + j] = j == 3 ? s + te[i] : s;
    }
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
