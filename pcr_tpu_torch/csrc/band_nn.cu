// K1 — banded 1-NN for the GICP correspondence search and gate evaluation.
//
// Replaces pcr_tpu/ops/pallas/nn_kernels.py:nn1_band_pallas.  Every query
// tile of q_tile sorted queries scans ONE contiguous slab of 2*band rows of
// the sorted reference, starting at starts[tile] (element offset, computed
// once by the wrapper).  Output: exact d2 of the winner and its ABSOLUTE
// sorted row, the first minimum on ties (as torch.min).
//
// The slab starts come from slab_starts below, one block a query tile
// (ops/band_nn.slab_starts' rule, common.cuh's slab_start: the tile's
// extent along the sweep axis, three binary searches in the sorted axis
// coordinates and the centred-slab choice); K10's gicp_move (csrc/gicp.cu)
// takes its starts with the same device code.
//
// Bound on the H100: issue rate and latency.  Each (query, slab row) pair
// is ~11 instructions (d2 rounded op by op, a compare, two selects) against
// a few MB of bytes; the main path launches it with 10240-32768 queries, too
// few for one thread a query to fill 132 SMs with warps (80 blocks of 4
// warps at 10240), and a row kept as three float arrays in shared memory
// costs three shared loads a pair.
//
// Design:
//  * The block stages the slab as float4 rows, kChunk rows at a time (one
//    chunk holds the slab of every band up to kChunk / 2): one 16-byte
//    shared load a row.
//  * kSplit lanes share each query and split its slab rows by residue:
//    part s takes rows s, s + kSplit, s + 2*kSplit, ... in ascending order.
//    The kSplit lanes of a part read kSplit consecutive rows (no bank
//    conflict; the other groups of the warp read the same rows, broadcast).
//    This multiplies the threads of a launch by kSplit.
//  * Each thread takes kQueries queries of its group, so that one shared
//    load serves kQueries pairs.
//  * Each part keeps its first minimum (strict <, ascending rows); the
//    partial minima are merged by a butterfly of shuffles, lexicographically
//    on (d2, row).  The winner is the least (d2, row) of the slab: its first
//    minimum, so d2 and row equal the one-thread-a-query walk's bit for bit.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using pcr::reserve_smem;

// Chosen on the H100 by tools/tune_band_nn.py (PERF.md).
constexpr int kSplit = 16;     // lanes a query
constexpr int kQueries = 2;    // queries a thread
constexpr int kWarps = 8;      // warps a block
constexpr int kChunk = 4096;   // slab rows staged at a time

// The row of the lesser (d2, row): the first minimum of the union of the
// two parts' rows, given each part's first minimum.
__device__ __forceinline__ void merge_min(float od, int oj, float& d, int& j) {
  if (od < d || (od == d && oj < j)) {
    d = od;
    j = oj;
  }
}

template <int SPLIT, int QPT, int WARPS, int CHUNK>
__global__ void __launch_bounds__(32 * WARPS)
    nn1_band_kernel(const int* __restrict__ starts, const float* __restrict__ q,
                    const float* __restrict__ r, int q_tile, int band,
                    float* __restrict__ out_d, int* __restrict__ out_row) {
  static_assert(SPLIT >= 1 && SPLIT <= 32 && (SPLIT & (SPLIT - 1)) == 0,
                "a query's lanes are 1, 2, 4, 8, 16 or 32 of a warp");
  static_assert(CHUNK % SPLIT == 0, "a chunk keeps every part's rows in step");
  constexpr int kThreads = 32 * WARPS;
  constexpr int kBlockQueries = kThreads / SPLIT * QPT;
  extern __shared__ float4 s4[];
  const int slab = 2 * band;
  const int per_tile = (q_tile + kBlockQueries - 1) / kBlockQueries;
  const int tile = blockIdx.x / per_tile;
  const int start = starts[tile];
  const int part = threadIdx.x % SPLIT;
  const int local0 = (blockIdx.x % per_tile) * kBlockQueries + threadIdx.x / SPLIT * QPT;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int best_j[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    // a query past the tile repeats the tile's last one and is not written
    const int qi = tile * q_tile + min(local0 + u, q_tile - 1);
    qx[u] = q[3 * qi];
    qy[u] = q[3 * qi + 1];
    qz[u] = q[3 * qi + 2];
    best[u] = 3.0e38f;
    best_j[u] = part;    // (3e38, the part's first row): merged, slab row 0
  }
  for (int c0 = 0; c0 < slab; c0 += CHUNK) {
    const int m = min(CHUNK, slab - c0);
    if (c0 > 0) __syncthreads();                     // the last chunk is read
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const float* row = r + 3 * static_cast<size_t>(start + c0 + j);
      s4[j] = make_float4(row[0], row[1], row[2], 0.0f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = part; j < m; j += SPLIT) {
      const float4 p = s4[j];
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        const float d = pcr::sqdist(qx[u], qy[u], qz[u], p.x, p.y, p.z);
        if (d < best[u]) {  // strict: a part keeps its first minimum
          best[u] = d;
          best_j[u] = c0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
#pragma unroll
    for (int off = SPLIT / 2; off > 0; off >>= 1) {
      merge_min(__shfl_xor_sync(0xffffffffu, best[u], off),
                __shfl_xor_sync(0xffffffffu, best_j[u], off), best[u], best_j[u]);
    }
    if (part == 0 && local0 + u < q_tile) {
      const int qi = tile * q_tile + local0 + u;
      out_d[qi] = best[u];
      out_row[qi] = start + best_j[u];
    }
  }
}

template <int SPLIT, int QPT, int WARPS, int CHUNK>
int launch_nn1_band(const int* starts, const float* q, const float* r, int nq_pad, int q_tile,
                    int band, float* out_d, int* out_row, cudaStream_t stream) {
  constexpr int kBlockQueries = 32 * WARPS / SPLIT * QPT;
  auto kernel = &nn1_band_kernel<SPLIT, QPT, WARPS, CHUNK>;
  const int rows = 2 * band < CHUNK ? 2 * band : CHUNK;
  const size_t smem = sizeof(float4) * static_cast<size_t>(rows);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (nq_pad / q_tile) * ((q_tile + kBlockQueries - 1) / kBlockQueries);
  kernel<<<blocks, 32 * WARPS, smem, stream>>>(starts, q, r, q_tile, band, out_d, out_row);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kStartThreads = 256;

__global__ void __launch_bounds__(kStartThreads)
    slab_starts_kernel(const float* __restrict__ q, const float* __restrict__ ra, int nr,
                       const long long* __restrict__ axis_p, int q_tile, int band, int max_blk,
                       float max_dist, int* __restrict__ starts) {
  const int axis = static_cast<int>(*axis_p);
  pcr::SlabExtent ext;
  for (int k = threadIdx.x; k < q_tile; k += kStartThreads) {
    const size_t i = static_cast<size_t>(blockIdx.x) * q_tile + k;
    pcr::slab_extent(ext, q[3 * i + axis]);
  }
  pcr::slab_start<kStartThreads>(ext, ra, nr, band, max_blk, max_dist, starts + blockIdx.x);
}

}  // namespace

// slab_starts: q (n_tiles * q_tile, 3) sorted queries, masked and padding
// rows at SENTINEL; ra (nr,) the ascending axis coordinates of the refs;
// axis an int64 on the device; starts (n_tiles,) written.
extern "C" int pcr_slab_starts(const float* q, const float* ra, int nr, const long long* axis,
                               int n_tiles, int q_tile, int band, int max_blk, float max_dist,
                               int* starts, cudaStream_t stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  slab_starts_kernel<<<n_tiles, kStartThreads, 0, stream>>>(q, ra, nr, axis, q_tile, band,
                                                            max_blk, max_dist, starts);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper guarantees nq_pad % q_tile == 0 and starts[t] + 2*band <= the
// ref rows of r.
extern "C" int pcr_nn1_band(const int* starts, const float* q, const float* r,
                            int nq_pad, int q_tile, int band, float* out_d,
                            int* out_row, cudaStream_t stream) {
  return launch_nn1_band<kSplit, kQueries, kWarps, kChunk>(starts, q, r, nq_pad, q_tile, band,
                                                           out_d, out_row, stream);
}
