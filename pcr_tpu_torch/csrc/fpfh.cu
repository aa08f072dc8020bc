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
// Bound on the H100: the issue rate.  K4 and K5 find their threshold by a
// 10-step log-space bisection of a count over the slab (4096 rows at band
// 2048, ~100 M (query, row) pairs over an NCLT scan), against a few MB of
// bytes.  The TPU kernels keep the (TQ, 2*band) d2 tile in VMEM across the
// bisection; that tile cannot live in a block's 227 KB of shared memory.
//
// Design of K4 and K5 for the H100 (the team, staging, counting and moments
// helpers are K2's and K3's, shared through common.cuh):
//  * A team of kTeam lanes shares one query and splits its rows; a block of
//    kWarps warps works on kWarps * 32 / kTeam queries of one tile at once.
//    Counts combine with __reduce_add_sync (exact in any order, so tau is
//    the plain version's bit for bit); K4's nine float sums with a butterfly
//    of shuffles in a fixed order, so they are deterministic.
//  * The block stages its slab once as float4 rows, 64 KB at band 2048 (one
//    16-byte shared load a row).  The d2 < kRealD2Max sentinel test is
//    dropped: K4's top threshold is (2v)^2 and K5's (10v)^2, checked on the
//    host.
//  * One sweep of the slab, then lists.  No threshold of the bisection and
//    no tau lies above the top bound, and of a scan's 4096 slab rows a few
//    (K4, within 2v) or a few hundred (K5, within 10v) lie within it.  So
//    the team sweeps the slab once, compacting the rows within the top bound
//    into a list of 16-bit slab rows in shared memory (__ballot_sync and a
//    __popc prefix; kMomentsList and kSpfhList rows at most), and the ten
//    bisection levels, K4's moments and K5's consumer read the listed rows,
//    recomputing d2 from the slab.  The counts are those of the whole slab,
//    so tau, K4's counts and K5's kept pairs do not change.  A query with
//    more rows within the top bound than its list holds (a crowded
//    neighbourhood; a query past the cloud, which has every sentinel row of
//    its slab at d2 = 0) runs the same code over the whole slab instead.
//    Those past the cloud fill the last tiles, which the blocks take first.
//  * kLevels bisection levels a pass: one pass counts the rows against the
//    2^kLevels - 1 thresholds of the next kLevels levels of the bisection
//    tree, each computed by the serial walk's own f32 operations, and walks
//    them from the counts: ceil(10 / kLevels) passes instead of 10.
//  * K5's consumer is dense.  A kept pair (d2 <= tau, d2 > 0, not the
//    query's own column) costs a few hundred instructions (two square roots,
//    six divisions, atan2f), and only ~200 of a slab's 4096 rows are kept.
//    The team goes through its rows once more, kTeam at a time; the kept
//    rows of each step are compacted (ballot and popcount prefix) behind
//    those waiting in a small list in shared memory, and whenever kTeam wait
//    every lane takes one: pair_features, then one atomicAdd into each of
//    three bins of the team's int[33] in shared memory (integer counts:
//    exact in any order).  With kCompact false each lane evaluates its own
//    kept rows in place while the other lanes of its warp wait: as fast over
//    a list, which is mostly kept rows, but slower over a slab (PERF.md).
//  * The neighbours' normals are read from global memory for the kept rows
//    only (the normals of a scan are 295 KB and stay in L2); staging them
//    beside the slab (kStageNormals) costs resident blocks and is slower.
//  * Not used: cp.async / TMA staging (the slab is read once a block; taking
//    2 or 4 queries a team in turn, which halves or quarters the staging a
//    query, makes K4 slower and K5 at most a tenth faster, PERF.md), and
//    tensor cores (d2 must be the plain version's rounded f32
//    ((dx*dx + dy*dy) + dz*dz) for tau and the kept set to stay bit-equal; a
//    TF32 or bf16 product reorders d2 at LiDAR coordinates).
//
// K6 reduces over K5's kept pairs (about 200 of a query's 4096 slab rows):
// out[q] = sum of w * spfh[row], w = 1 / max(d2, 1e-12).  Bound on the H100:
// the slab sweep that finds the kept rows (~100 M pairs a scan, as K5's
// listing sweep) and the latency of the kept rows' SPFH reads from L2 (the
// 4096 x 33 SPFH slab, 540 KB, does not fit in shared memory; a scan's SPFH,
// 3.2 MB, stays in L2).  Design: a team of kTeam lanes a query over the
// float4 slab; lane f sums feature f (lane 0 also feature 32), so a kept
// row's SPFH is one coalesced 132-byte read of the team instead of 33
// scattered reads of one thread, and the 33 sums need one register a lane.
// The kept rows of each step are walked from the step's ballot with __ffs
// (a list of kept rows in shared memory consumed several at a time, or a
// prefetch of the next kept row, was no faster at band 2048, PERF.md);
// blocks of 32 warps share each staged slab among 32 queries, and at band
// 4096 (128 KB a slab, one block an SM) keep 32 warps on each SM.  Each
// feature is summed in ascending row order with the same rounded operations
// as the former one-thread-a-query walk, so the sums did not change by a bit.
//
// d2 and every Darboux operation are rounded one by one (`__f*_rn`, no FMA
// contraction), in the order of the plain PyTorch versions, and the file is
// compiled without --use_fast_math (an approximate rsqrt flipped histogram
// bins on the TPU): the kernels' bins and tau equal the plain versions'.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using pcr::bisect;
using pcr::blocks_for;
using pcr::counted_d2;
using pcr::Geometry;
using pcr::ListedRows;
using pcr::reserve_smem;
using pcr::SlabRows;
using pcr::stage_rows;

// Chosen on the H100 by tools/tune_features.py (PERF.md).
constexpr int kTeam = 32;             // lanes a query
constexpr int kWarps = 16;            // warps a block
constexpr int kQueriesPerTeam = 1;    // queries a team takes in turn
constexpr int kLevels = 2;            // bisection levels a pass
constexpr int kMomentsList = 256;     // K4: candidate rows a team can list (0: none)
constexpr int kSpfhList = 1024;       // K5: the same
constexpr bool kCompact = true;       // K5: kept pairs compacted over the team
constexpr bool kStageNormals = false; // K5: neighbour normals in shared memory
constexpr int kFpfhWarps = 32;        // K6: warps (queries at a time) a block

constexpr int kBins = 11;
constexpr int kFeat = 33;
constexpr float kTiny = 1e-12f;

// The tile of this block.  The last tiles hold the rows past the cloud, whose
// queries see every sentinel row of their slab at d2 = 0: where those are
// more than a team can list, they take the slab path, several times the work
// of a listed query.  Blocks start in launch order, so the tiles are taken
// from the last to the first and those blocks do not form the launch's tail.
__device__ __forceinline__ int heavy_first_tile(int per_tile) {
  return (gridDim.x - 1 - blockIdx.x) / per_tile;
}

// K4 for one query over ``rows``: the bisection for the normal_k-th nearest
// (self included), then the moments of the rows at d2 <= tau.
template <int TEAM, int LEVELS, bool CHECK, typename ROWS>
__device__ __forceinline__ void moments_query(const ROWS& rows, int n, int lane,
                                              unsigned mask, float qx, float qy, float qz,
                                              int normal_k, float log_lo, float log_hi,
                                              float cx, float cy, float cz,
                                              float* __restrict__ out) {
  float llo = log_lo, lhi = log_hi;
  bisect<TEAM, LEVELS, true, CHECK, false>(rows, n, lane, mask, qx, qy, qz, normal_k, llo,
                                           lhi);
  pcr::team_moments<TEAM, CHECK, false>(rows, n, lane, mask, qx, qy, qz, expf(lhi), cx, cy,
                                        cz, out);
}

template <int TEAM, int WARPS, int QPT, int LEVELS, int LIST, bool CHECK>
__global__ void __launch_bounds__(32 * WARPS)
    moments_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                   const float* __restrict__ r, const float* __restrict__ center,
                   int q_tile, int band, int normal_k, float log_lo, float log_hi,
                   float* __restrict__ out) {
  using G = Geometry<TEAM, WARPS, QPT>;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + G::kQueries - 1) / G::kQueries;
  const int tile = heavy_first_tile(per_tile);
  stage_rows<false>(r, nullptr, starts[tile], slab, s4);
  __syncthreads();
  const int team = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  const unsigned mask = pcr::team_mask<TEAM>();
  unsigned short* list = reinterpret_cast<unsigned short*>(s4 + slab) + LIST * team;
  // the moments are centred on the slab centroid
  const float cx = center[3 * tile], cy = center[3 * tile + 1], cz = center[3 * tile + 2];
  for (int u = 0; u < QPT; ++u) {
    const int local = (blockIdx.x % per_tile) * G::kQueries + u * G::kTeams + team;
    if (local >= q_tile) break;                      // the same for the whole team
    const int qi = tile * q_tile + local;
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    float* o = out + 10 * static_cast<size_t>(qi);
    // Hybrid(2v, normal_k): no threshold lies above (2v)^2, the top bound
    int n = LIST + 1;
    if constexpr (LIST > 0) {
      n = pcr::list_rows_within<TEAM, LIST, CHECK>(s4, slab, lane, mask, qx, qy, qz,
                                                   expf(log_hi), list);
    }
    if (n <= LIST) {                                 // the same for the whole team
      moments_query<TEAM, LEVELS, CHECK>(ListedRows{s4, list}, n, lane, mask, qx, qy, qz,
                                         normal_k, log_lo, log_hi, cx, cy, cz, o);
    } else {
      moments_query<TEAM, LEVELS, CHECK>(SlabRows{s4}, slab, lane, mask, qx, qy, qz, normal_k,
                                         log_lo, log_hi, cx, cy, cz, o);
    }
    __syncwarp(mask);                                // the list is read before the next query
  }
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

// One kept pair of K5: the Darboux features of the query (q, n1) and the slab
// row p with normal n2 at squared distance d2, counted into the team's bins.
__device__ __forceinline__ void bin_pair(float qx, float qy, float qz, float n1x, float n1y,
                                         float n1z, float4 p, const float* __restrict__ n2,
                                         float d2, float lo3, float scale12, float scale3,
                                         int* hist) {
  float f1, f2, f3;
  pair_features(qx, qy, qz, n1x, n1y, n1z, p.x, p.y, p.z, n2[0], n2[1], n2[2], d2, &f1, &f2,
                &f3);
  atomicAdd(hist + bin_of(f1, -1.0f, scale12), 1);
  atomicAdd(hist + kBins + bin_of(f2, -1.0f, scale12), 1);
  atomicAdd(hist + 2 * kBins + bin_of(f3, lo3, scale3), 1);
}

// Shared memory of a K5 block: the slab as float4 rows, the slab's normals
// (3 floats a row) where STAGE_N, then for every team kFeat bin counts, a
// list of 2 * TEAM kept rows and a list of LIST candidate rows.
template <int TEAM, int WARPS, int QPT, int LIST, bool STAGE_N>
size_t spfh_smem(int band) {
  const size_t slab = 2 * static_cast<size_t>(band);
  return sizeof(float4) * slab + (STAGE_N ? sizeof(float) * 3 * slab : 0) +
         Geometry<TEAM, WARPS, QPT>::kTeams *
             (sizeof(int) * (kFeat + 2 * TEAM) + sizeof(unsigned short) * LIST);
}

// K5 for one query over ``rows``: the bisection for the k-th nearest (self
// included) capped at the radius, then the Darboux features of the kept pairs
// (d2 <= tau, d2 > 0, not the query's own slab column) counted into hist.
// Returns tau; *total is the number of kept pairs.
template <int TEAM, int LEVELS, bool CHECK, bool COMPACT, typename ROWS>
__device__ __forceinline__ float spfh_query(const ROWS& rows, int n, int lane, unsigned mask,
                                            float qx, float qy, float qz, float n1x, float n1y,
                                            float n1z, int self_col, int k, float log_lo,
                                            float log_hi, float radius2, float lo3,
                                            float scale12, float scale3,
                                            const float* __restrict__ normals, int* hist,
                                            int* kept_rows, int* total) {
  float llo = log_lo, lhi = log_hi;
  bisect<TEAM, LEVELS, true, CHECK, false>(rows, n, lane, mask, qx, qy, qz, k, llo, lhi);
  const float tau = fminf(expf(lhi), radius2);
  __syncwarp(mask);                                  // the bins are zero for every lane

  const int shift = (threadIdx.x & 31) - lane;       // the team's first lane in its warp
  const unsigned below = (1u << lane) - 1u;          // the team's lanes before this one
  int all = 0, pending = 0;                          // kept pairs; those still in kept_rows
  for (int i0 = 0; i0 < n; i0 += TEAM) {
    const int i = i0 + lane;
    int j = -1;
    float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float d = 0.0f;
    if (i < n) {
      j = rows.index(i);
      p = rows.s4[j];
      d = counted_d2<CHECK, false>(qx, qy, qz, p);
    }
    const bool kept = d <= tau && d > 0.0f && j != self_col;
    const unsigned votes = __ballot_sync(mask, kept) >> shift;
    all += __popc(votes);
    if constexpr (COMPACT) {
      if (kept) kept_rows[pending + __popc(votes & below)] = j;
      pending += __popc(votes);
      __syncwarp(mask);
      if (pending >= TEAM) {                         // the same for the whole team
        pending -= TEAM;
        const int jj = kept_rows[pending + lane];
        const float4 pj = rows.s4[jj];
        bin_pair(qx, qy, qz, n1x, n1y, n1z, pj, normals + 3 * jj,
                 pcr::sqdist(qx, qy, qz, pj.x, pj.y, pj.z), lo3, scale12, scale3, hist);
        __syncwarp(mask);                            // read before the list grows again
      }
    } else {
      if (kept) {
        bin_pair(qx, qy, qz, n1x, n1y, n1z, p, normals + 3 * j, d, lo3, scale12, scale3, hist);
      }
    }
  }
  if (COMPACT && lane < pending) {
    const int jj = kept_rows[lane];
    const float4 pj = rows.s4[jj];
    bin_pair(qx, qy, qz, n1x, n1y, n1z, pj, normals + 3 * jj,
             pcr::sqdist(qx, qy, qz, pj.x, pj.y, pj.z), lo3, scale12, scale3, hist);
  }
  __syncwarp(mask);
  *total = all;
  return tau;
}

template <int TEAM, int WARPS, int QPT, int LEVELS, int LIST, bool CHECK, bool COMPACT,
          bool STAGE_N>
__global__ void __launch_bounds__(32 * WARPS)
    spfh_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                const float* __restrict__ nq, const float* __restrict__ r,
                const float* __restrict__ nr, int q_tile, int band, int k, float log_lo,
                float log_hi, float radius2, float lo3, float scale12, float scale3,
                float* __restrict__ spfh_out, float* __restrict__ tau_out) {
  using G = Geometry<TEAM, WARPS, QPT>;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + G::kQueries - 1) / G::kQueries;
  const int tile = heavy_first_tile(per_tile);
  const int start = starts[tile];
  const int team = threadIdx.x / TEAM, lane = threadIdx.x % TEAM;
  float* sn = reinterpret_cast<float*>(s4 + slab);
  int* bins = reinterpret_cast<int*>(sn + (STAGE_N ? 3 * slab : 0));
  int* hist = bins + kFeat * team;                              // this team's bin counts,
  int* kept_rows = bins + kFeat * G::kTeams + 2 * TEAM * team;  // its kept rows in waiting
  unsigned short* list =                                        // and its candidate rows
      reinterpret_cast<unsigned short*>(bins + (kFeat + 2 * TEAM) * G::kTeams) + LIST * team;
  stage_rows<false>(r, nullptr, start, slab, s4);
  if constexpr (STAGE_N) {
    const float* src = nr + 3 * static_cast<size_t>(start);
    for (int j = threadIdx.x; j < 3 * slab; j += blockDim.x) sn[j] = src[j];
  }
  __syncthreads();
  // slab row j's normal: from the staged slab, else from global memory
  const float* normals = STAGE_N ? sn : nr + 3 * static_cast<size_t>(start);
  const unsigned mask = pcr::team_mask<TEAM>();
  for (int u = 0; u < QPT; ++u) {
    const int local = (blockIdx.x % per_tile) * G::kQueries + u * G::kTeams + team;
    if (local >= q_tile) break;                      // the same for the whole team
    const int qi = tile * q_tile + local;
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    const float n1x = nq[3 * qi], n1y = nq[3 * qi + 1], n1z = nq[3 * qi + 2];
    for (int b = lane; b < kFeat; b += TEAM) hist[b] = 0;

    // Hybrid(10v, max_nn excl. self): no threshold lies above (10v)^2, the top
    // bound of the bisection for the (max_nn+1)-th nearest
    int n = LIST + 1;
    if constexpr (LIST > 0) {
      n = pcr::list_rows_within<TEAM, LIST, CHECK>(s4, slab, lane, mask, qx, qy, qz,
                                                   expf(log_hi), list);
    }
    int total;
    float tau;
    if (n <= LIST) {                                 // the same for the whole team
      tau = spfh_query<TEAM, LEVELS, CHECK, COMPACT>(
          ListedRows{s4, list}, n, lane, mask, qx, qy, qz, n1x, n1y, n1z, qi - start, k,
          log_lo, log_hi, radius2, lo3, scale12, scale3, normals, hist, kept_rows, &total);
    } else {
      tau = spfh_query<TEAM, LEVELS, CHECK, COMPACT>(
          SlabRows{s4}, slab, lane, mask, qx, qy, qz, n1x, n1y, n1z, qi - start, k, log_lo,
          log_hi, radius2, lo3, scale12, scale3, normals, hist, kept_rows, &total);
    }
    const float incr = total > 0 ? __fdiv_rn(100.0f, static_cast<float>(total)) : 0.0f;
    for (int b = lane; b < kFeat; b += TEAM) {
      spfh_out[kFeat * static_cast<size_t>(qi) + b] =
          __fmul_rn(static_cast<float>(hist[b]), incr);
    }
    if (lane == 0) tau_out[qi] = tau;
    __syncwarp(mask);                                // all read before the next query
  }
}

// K6 for one query: the team sweeps the slab kTeam rows a step and adds, in
// ascending row order, w * spfh[row] for each kept row (real, d2 <= tau,
// d2 > 0, not the query's own column), w = 1 / max(d2, 1e-12).  Each step's
// kept rows are taken from its ballot with __ffs, the weight shuffled from
// the lane that computed it.  Lane f holds feature f, lane 0 feature 32 as
// well; a kept row's SPFH is one coalesced 132-byte read of the team.  Every
// feature is summed in ascending row order with the same rounded operations
// as the one-thread-a-query walk, so the sums are that walk's bit for bit.
__device__ __forceinline__ void fpfh_query(const float4* s4, int slab, int lane, float qx,
                                           float qy, float qz, float tau, int self_col,
                                           const float* __restrict__ spfh, float& acc,
                                           float& acc32) {
  for (int j0 = 0; j0 < slab; j0 += kTeam) {
    const int j = j0 + lane;
    float d = 0.0f;
    if (j < slab) {
      const float4 p = s4[j];
      d = pcr::sqdist(qx, qy, qz, p.x, p.y, p.z);
    }
    const bool kept =
        j < slab && d < pcr::kRealD2Max && d <= tau && d > 0.0f && j != self_col;
    const float w = __frcp_rn(fmaxf(d, kTiny));
    unsigned votes = __ballot_sync(0xffffffffu, kept);
    while (votes) {                                  // the same for the whole team
      const int b = __ffs(votes) - 1;
      votes &= votes - 1u;
      const float wb = __shfl_sync(0xffffffffu, w, b);
      const float* row = spfh + kFeat * static_cast<size_t>(j0 + b);
      acc = __fadd_rn(acc, __fmul_rn(wb, row[lane]));
      if (lane == 0) acc32 = __fadd_rn(acc32, __fmul_rn(wb, row[kTeam]));
    }
  }
}

// Shared memory of a K6 block: the slab as float4 rows.
size_t fpfh_smem(int band) { return sizeof(float4) * 2 * static_cast<size_t>(band); }

template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
    fpfh_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                const float* __restrict__ r, const float* __restrict__ tau_in,
                const float* __restrict__ spfh, int q_tile, int band,
                float* __restrict__ out) {
  using G = Geometry<kTeam, WARPS, 1>;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + G::kQueries - 1) / G::kQueries;
  const int tile = blockIdx.x / per_tile;
  const int start = starts[tile];
  stage_rows<false>(r, nullptr, start, slab, s4);
  __syncthreads();
  const int team = threadIdx.x / kTeam, lane = threadIdx.x % kTeam;
  const int local = (blockIdx.x % per_tile) * G::kQueries + team;
  if (local >= q_tile) return;                       // the same for the whole team
  const int qi = tile * q_tile + local;
  float acc = 0.0f, acc32 = 0.0f;
  fpfh_query(s4, slab, lane, q[3 * qi], q[3 * qi + 1], q[3 * qi + 2], tau_in[qi], qi - start,
             spfh + kFeat * static_cast<size_t>(start), acc, acc32);
  float* o = out + kFeat * static_cast<size_t>(qi);
  o[lane] = acc;
  if (lane == 0) o[kTeam] = acc32;
}

// A candidate list names slab rows in 16 bits.
constexpr int kMaxListedSlab = 1 << 16;

// Shared memory of a K4 block: the slab as float4 rows, then every team's
// list of LIST candidate rows.
template <int TEAM, int WARPS, int QPT, int LIST>
size_t moments_smem(int band) {
  return sizeof(float4) * 2 * static_cast<size_t>(band) +
         sizeof(unsigned short) * LIST * Geometry<TEAM, WARPS, QPT>::kTeams;
}

template <int TEAM, int WARPS, int QPT, int LEVELS, int LIST>
int launch_moments(const int* starts, const float* q, const float* r, const float* center,
                   int n_pad, int q_tile, int band, int normal_k, float log_lo, float log_hi,
                   float* out, cudaStream_t stream) {
  if (LIST > 0 && 2 * band > kMaxListedSlab) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pcr::needs_sentinel_check(log_hi)
                    ? &moments_kernel<TEAM, WARPS, QPT, LEVELS, LIST, true>
                    : &moments_kernel<TEAM, WARPS, QPT, LEVELS, LIST, false>;
  const size_t smem = moments_smem<TEAM, WARPS, QPT, LIST>(band);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for<TEAM, WARPS, QPT>(n_pad, q_tile), 32 * WARPS, smem, stream>>>(
      starts, q, r, center, q_tile, band, normal_k, log_lo, log_hi, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TEAM, int WARPS, int QPT, int LEVELS, int LIST, bool COMPACT, bool STAGE_N>
int launch_spfh(const int* starts, const float* q, const float* nq, const float* r,
                const float* nr, int n_pad, int q_tile, int band, int k, float log_lo,
                float log_hi, float radius2, float lo3, float scale12, float scale3,
                float* spfh_out, float* tau_out, cudaStream_t stream) {
  if (LIST > 0 && 2 * band > kMaxListedSlab) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pcr::needs_sentinel_check(log_hi)
                    ? &spfh_kernel<TEAM, WARPS, QPT, LEVELS, LIST, true, COMPACT, STAGE_N>
                    : &spfh_kernel<TEAM, WARPS, QPT, LEVELS, LIST, false, COMPACT, STAGE_N>;
  const size_t smem = spfh_smem<TEAM, WARPS, QPT, LIST, STAGE_N>(band);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for<TEAM, WARPS, QPT>(n_pad, q_tile), 32 * WARPS, smem, stream>>>(
      starts, q, nq, r, nr, q_tile, band, k, log_lo, log_hi, radius2, lo3, scale12, scale3,
      spfh_out, tau_out);
  return static_cast<int>(cudaGetLastError());
}

template <int WARPS>
int launch_fpfh(const int* starts, const float* q, const float* r, const float* tau,
                const float* spfh, int n_pad, int q_tile, int band, float* out,
                cudaStream_t stream) {
  auto kernel = &fpfh_kernel<WARPS>;
  const size_t smem = fpfh_smem(band);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks_for<kTeam, WARPS, 1>(n_pad, q_tile), 32 * WARPS, smem, stream>>>(
      starts, q, r, tau, spfh, q_tile, band, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers guarantee n_pad % q_tile == 0 and starts[t] + 2*band <= the
// ref rows of r, nr and spfh, and that the kernel's shared memory fits the card.
extern "C" int pcr_moments(const int* starts, const float* q, const float* r,
                           const float* center, int n_pad, int q_tile, int band,
                           int normal_k, float log_lo, float log_hi, float* out,
                           cudaStream_t stream) {
  return launch_moments<kTeam, kWarps, kQueriesPerTeam, kLevels, kMomentsList>(
      starts, q, r, center, n_pad, q_tile, band, normal_k, log_lo, log_hi, out, stream);
}

extern "C" int pcr_spfh(const int* starts, const float* q, const float* nq,
                        const float* r, const float* nr, int n_pad, int q_tile,
                        int band, int k, float log_lo, float log_hi,
                        float radius2, float lo3, float scale12, float scale3,
                        float* spfh_out, float* tau_out, cudaStream_t stream) {
  return launch_spfh<kTeam, kWarps, kQueriesPerTeam, kLevels, kSpfhList, kCompact,
                     kStageNormals>(
      starts, q, nq, r, nr, n_pad, q_tile, band, k, log_lo, log_hi, radius2, lo3, scale12,
      scale3, spfh_out, tau_out, stream);
}

extern "C" int pcr_fpfh(const int* starts, const float* q, const float* r,
                        const float* tau, const float* spfh, int n_pad,
                        int q_tile, int band, float* out, cudaStream_t stream) {
  return launch_fpfh<kFpfhWarps>(starts, q, r, tau, spfh, n_pad, q_tile, band, out, stream);
}

// Shared memory a block of each kernel asks for at this band, which the
// wrappers hold against the card's limit before they launch.
extern "C" int pcr_moments_smem(int band) {
  return static_cast<int>(moments_smem<kTeam, kWarps, kQueriesPerTeam, kMomentsList>(band));
}

extern "C" int pcr_spfh_smem(int band) {
  return static_cast<int>(
      spfh_smem<kTeam, kWarps, kQueriesPerTeam, kSpfhList, kStageNormals>(band));
}

extern "C" int pcr_fpfh_smem(int band) {
  return static_cast<int>(fpfh_smem(band));
}
