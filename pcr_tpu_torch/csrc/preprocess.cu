// K2 and K3 — the two neighbourhood passes of the fused per-scale
// preprocess (ops/preprocess.outlier_and_normals_sorted): statistical
// outlier statistics, then survivor-kNN moments for the normals.
//
// K2 replaces pcr_tpu/ops/pallas/feature_kernels.py:outlier_stats_pallas,
// K3 replaces pcr_tpu/ops/pallas/feature_kernels.py:survivor_moments_pallas.
//
// Both reduce over one slab: the 2*band sorted rows starting at
// starts[tile] (element offset, computed once by the wrapper) for every
// query of a q_tile-row tile, and both find their threshold by a 10-step
// bisection of a count (K2 in log space for the k1-th nearest row, K3
// linearly for the normal_k-th nearest survivor), then sum over the rows at
// d2 <= tau.  The TPU kernels keep the (TQ, 2*band) d2 tile in VMEM through
// the 10 steps; that tile does not fit in an SM's shared memory, so d2 is
// recomputed from the slab in every pass.  Bound: issue rate (about 15
// instructions a (query, row) pair a pass, against a few bytes a query).
//
// Design for the H100 (the team, staging, counting and moments helpers are
// in common.cuh, which K4 and K5 of fpfh.cu share):
//  * A team of kTeam lanes shares one query and splits its slab (lane l
//    takes rows l, l + kTeam, ...), so a block of kWarps warps works on
//    kWarps * 32 / kTeam queries of one tile at once and the finest stage-2
//    scale puts tens of warps on every SM (one thread a query gave ~5).
//    Counts combine with __reduce_add_sync (exact in any order, so tau is
//    the plain version's bit for bit); float sums with a butterfly of
//    shuffles in a fixed order, so they are deterministic.
//  * Several bisection levels a pass: the thresholds of a bisection form a
//    fixed binary tree below (lo, hi), so one pass counts the slab against
//    the 2^kLevels - 1 thresholds of the next kLevels levels and then walks
//    those levels from the counts (pcr::subtree_mids, pcr::walk_levels):
//    ceil(10 / kLevels) passes instead of 10.  Each threshold is computed by
//    the serial walk's own f32 operations (0.5f * (lo + hi), then expf for
//    K2) and each step takes the serial walk's >= k decision, so the result
//    is the serial walk's tau.
//  * The block stages its slab once as float4 rows (x, y, z, w), packed while
//    staging; K3 puts the survivor flag in w (1.0f or 0.0f).  One 16-byte
//    shared load a row a pass.  A row that does not count gets d2 = NaN,
//    which fails every <= test.  The d2 < kRealD2Max sentinel test is
//    dropped where no threshold can reach kRealD2Max: for K2 checked on the
//    host from the top bound, for K3 per query from its top 4*tau + 1e-6
//    (the branch is uniform over the team).  No pass stops early once a
//    count reaches k: a team runs to its slowest lane, and the low
//    thresholds never reach k.
//  * Not used: cp.async / TMA staging (the slab is read once a block and
//    used by every query of the block in every pass: staging is a few
//    percent of the work, and the other resident blocks overlap it), and
//    tensor cores (d2 must be the plain version's rounded f32
//    ((dx*dx + dy*dy) + dz*dz) for tau to stay bit-equal; a TF32 or bf16
//    product reorders d2 at LiDAR coordinates).
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using pcr::bisect;
using pcr::blocks_for;
using pcr::counted_d2;
using pcr::Geometry;
using pcr::kRealD2Max;
using pcr::reserve_smem;
using pcr::SlabRows;
using pcr::stage_rows;

// Chosen on the H100 by tools/tune_preprocess.py (PERF.md).
constexpr int kTeam = 32;            // lanes a query
constexpr int kWarps = 8;            // warps a block
constexpr int kQueriesPerTeam = 1;   // queries a team takes in turn
constexpr int kLevels = 2;           // bisection levels a pass

template <int TEAM, int WARPS, int QPT, int LEVELS, bool CHECK>
__global__ void __launch_bounds__(32 * WARPS)
    outlier_stats_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                         const float* __restrict__ r, int q_tile, int band, int k1,
                         float log_lo, float log_hi, float* __restrict__ mean_d,
                         unsigned char* __restrict__ found, float* __restrict__ tau_out) {
  using G = Geometry<TEAM, WARPS, QPT>;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + G::kQueries - 1) / G::kQueries;
  const int tile = blockIdx.x / per_tile;
  stage_rows<false>(r, nullptr, starts[tile], slab, s4);
  __syncthreads();
  const int team = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const unsigned mask = pcr::team_mask<TEAM>();
  for (int u = 0; u < QPT; ++u) {
    const int local = (blockIdx.x % per_tile) * G::kQueries + u * G::kTeams + team;
    if (local >= q_tile) break;                      // the same for the whole team
    const int qi = tile * q_tile + local;
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];

    // log-space count-CDF bisection for the k1-th nearest (self included)
    float llo = log_lo, lhi = log_hi;
    bisect<TEAM, LEVELS, true, CHECK, false>(SlabRows{s4}, slab, lane, mask, qx, qy, qz, k1,
                                             llo, lhi);
    const float tau = expf(lhi);
    int cnt = 0;
    float sum_d = 0.0f;
    for (int j = lane; j < slab; j += TEAM) {
      const float d = counted_d2<CHECK, false>(qx, qy, qz, s4[j]);
      if (d <= tau) {
        ++cnt;
        sum_d = __fadd_rn(sum_d, __fsqrt_rn(fmaxf(d, 0.0f)));
      }
    }
    cnt = __reduce_add_sync(mask, cnt);
    sum_d = pcr::team_sum<TEAM>(sum_d, mask);
    if (lane == 0) {
      mean_d[qi] = __fdiv_rn(sum_d, static_cast<float>(max(cnt - 1, 1)));  // self = 0
      found[qi] = cnt >= k1 ? 1 : 0;
      tau_out[qi] = tau;
    }
  }
}

// K3 for one query: the linear bisection on [0, hi] for the normal_k-th
// survivor, then the moments of the survivors at d2 <= tau.
template <int TEAM, int LEVELS, bool CHECK>
__device__ __forceinline__ void survivor_query(const float4* s4, int slab, int lane,
                                               unsigned mask, float qx, float qy, float qz,
                                               float hi, float cx, float cy, float cz,
                                               int normal_k, float* __restrict__ out) {
  float lo = 0.0f;
  const SlabRows rows{s4};
  bisect<TEAM, LEVELS, false, CHECK, true>(rows, slab, lane, mask, qx, qy, qz, normal_k, lo,
                                           hi);
  pcr::team_moments<TEAM, CHECK, true>(rows, slab, lane, mask, qx, qy, qz, hi, cx, cy, cz,
                                       out);
}

template <int TEAM, int WARPS, int QPT, int LEVELS>
__global__ void __launch_bounds__(32 * WARPS)
    survivor_moments_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                            const float* __restrict__ r,
                            const unsigned char* __restrict__ keep,
                            const float* __restrict__ tau0, const float* __restrict__ center,
                            int q_tile, int band, int normal_k, float* __restrict__ out) {
  using G = Geometry<TEAM, WARPS, QPT>;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + G::kQueries - 1) / G::kQueries;
  const int tile = blockIdx.x / per_tile;
  stage_rows<true>(r, keep, starts[tile], slab, s4);
  __syncthreads();
  const int team = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const unsigned mask = pcr::team_mask<TEAM>();
  const float cx = center[3 * tile], cy = center[3 * tile + 1], cz = center[3 * tile + 2];
  for (int u = 0; u < QPT; ++u) {
    const int local = (blockIdx.x % per_tile) * G::kQueries + u * G::kTeams + team;
    if (local >= q_tile) break;                      // the same for the whole team
    const int qi = tile * q_tile + local;
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    const float hi = __fadd_rn(__fmul_rn(4.0f, tau0[qi]), 1e-6f);
    float* o = out + 10 * static_cast<size_t>(qi);
    // below kRealD2Max no threshold admits a sentinel pair (NaN: checked)
    if (hi < kRealD2Max) {
      survivor_query<TEAM, LEVELS, false>(s4, slab, lane, mask, qx, qy, qz, hi, cx, cy, cz,
                                          normal_k, o);
    } else {
      survivor_query<TEAM, LEVELS, true>(s4, slab, lane, mask, qx, qy, qz, hi, cx, cy, cz,
                                         normal_k, o);
    }
  }
}

template <int TEAM, int WARPS, int QPT, int LEVELS>
int launch_outlier_stats(const int* starts, const float* q, const float* r, int n_pad,
                         int q_tile, int band, int k1, float log_lo, float log_hi,
                         float* mean_d, unsigned char* found, float* tau_out,
                         cudaStream_t stream) {
  const bool check = pcr::needs_sentinel_check(log_hi);
  auto kernel = check ? &outlier_stats_kernel<TEAM, WARPS, QPT, LEVELS, true>
                      : &outlier_stats_kernel<TEAM, WARPS, QPT, LEVELS, false>;
  const size_t smem = sizeof(float4) * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for<TEAM, WARPS, QPT>(n_pad, q_tile), 32 * WARPS, smem, stream>>>(
      starts, q, r, q_tile, band, k1, log_lo, log_hi, mean_d, found, tau_out);
  return static_cast<int>(cudaGetLastError());
}

template <int TEAM, int WARPS, int QPT, int LEVELS>
int launch_survivor_moments(const int* starts, const float* q, const float* r,
                            const unsigned char* keep, const float* tau0,
                            const float* center, int n_pad, int q_tile, int band,
                            int normal_k, float* out, cudaStream_t stream) {
  auto kernel = &survivor_moments_kernel<TEAM, WARPS, QPT, LEVELS>;
  const size_t smem = sizeof(float4) * 2 * static_cast<size_t>(band);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for<TEAM, WARPS, QPT>(n_pad, q_tile), 32 * WARPS, smem, stream>>>(
      starts, q, r, keep, tau0, center, q_tile, band, normal_k, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper guarantees n_pad % q_tile == 0; starts[t] + 2*band never
// exceeds the ref rows.
extern "C" int pcr_outlier_stats(const int* starts, const float* q,
                                 const float* r, int n_pad, int q_tile,
                                 int band, int k1, float log_lo, float log_hi,
                                 float* mean_d, unsigned char* found,
                                 float* tau_out, cudaStream_t stream) {
  return launch_outlier_stats<kTeam, kWarps, kQueriesPerTeam, kLevels>(
      starts, q, r, n_pad, q_tile, band, k1, log_lo, log_hi, mean_d, found, tau_out, stream);
}

extern "C" int pcr_survivor_moments(const int* starts, const float* q,
                                    const float* r, const unsigned char* keep,
                                    const float* tau0, const float* center,
                                    int n_pad, int q_tile, int band,
                                    int normal_k, float* out,
                                    cudaStream_t stream) {
  return launch_survivor_moments<kTeam, kWarps, kQueriesPerTeam, kLevels>(
      starts, q, r, keep, tau0, center, n_pad, q_tile, band, normal_k, out, stream);
}
