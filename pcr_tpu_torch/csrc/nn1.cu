// K7 — brute-force 1-NN of every query over the whole reference cloud, for
// the exact-correspondence GICP and the exact evaluation.
//
// Replaces pcr_tpu/ops/pallas/nn_kernels.py:nn1_pallas (_nn1_kernel).  The
// TPU kernel keeps a (TQ, sub_chunk) running per-lane min of the expanded
// |q|^2 + |r|^2 - 2 q.r in VMEM, finds the winning lane with a one-hot reduce
// and re-scores the winner outside the kernel.  None of that carries over.
//
// On the H100 the bytes are tiny (12 bytes a row, each ref row read once per
// block from L2); the kernel is bound by the instructions it issues per
// (query, ref) pair.  d2 must stay bit-equal to the plain version
// (pcr::sqdist: 3 subtractions, 3 products, 2 sums, each rounded on its own,
// so nothing fuses into an FMA): 8 instructions a pair are the least, and
// keeping (min d2, row) with a compare and two selects a pair made ~12.
// Design:
//   * kQueries queries a thread, in registers: one broadcast 16-byte shared
//     load of a ref row serves all of them;
//   * the index is found lazily.  For each query and each group of kGroup
//     refs the running minimum is folded with fminf (one FMNMX a pair); once a
//     group, a strict compare with the minimum before the group records the
//     group when it improved (a compare and a select a group).  After the
//     sweep each query re-scores its recorded group from global memory and
//     takes the first row whose d2 equals its minimum.  The strict compare
//     keeps the first group that reaches the minimum and the re-score its
//     first row, so the row is the first minimum (torch.min's), and the same
//     rounded formula gives the same d2 in the sweep and the re-score;
//   * the block stages its ref range through shared memory kChunk rows at a
//     time as float4 rows, double-buffered with cp.async (4-byte copies: a
//     row is 12 bytes), so the next chunk's copy overlaps this chunk's sweep;
//     rows past the range are +inf, whose d2 (+inf) never improves a minimum;
//   * a few query blocks cannot fill 132 SMs, so the ref rows are split into
//     `splits` contiguous ranges of whole groups (grid.y): each block writes
//     its range's partial (min, row), and a second kernel keeps, per query,
//     the first split holding the smallest d2.  Ranges ascend, so the result
//     is the first minimum of the whole row.  The wrapper picks the splits so
//     that the blocks fill the card's resident slots (kMinBlocks x SMs:
//     the launch bounds cap the registers so that kMinBlocks blocks fit) in
//     whole waves: the blocks do equal work, so a partial last
//     wave would leave SMs idle.
// Constants chosen on the H100 by tools/tune_nn1.py (PERF.md).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kQueries = 8;    // queries a thread
constexpr int kGroup = 8;      // refs a group (one compare-and-record a group)
constexpr int kChunk = 512;    // ref rows staged at a time (one of two buffers)
constexpr int kMinBlocks = 8;  // __launch_bounds__ blocks a SM (0: the compiler's choice)
constexpr int kUnroll = 8;     // refs a loop body takes (kGroup: the group is one body)

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of ref rows [c0, c0 + CHUNK) into buf; rows at or past hi
// are written +inf at once.
template <int THREADS, int CHUNK>
__device__ __forceinline__ void stage_chunk(float4* buf, const float* __restrict__ r, int c0,
                                            int hi) {
  float* f = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < 3 * CHUNK; e += THREADS) {
    const int j = e / 3;
    float* dst = f + 4 * j + (e - 3 * j);
    if (c0 + j < hi) {
      cp_async4(dst, r + 3 * static_cast<size_t>(c0) + e);
    } else {
      *dst = __int_as_float(0x7f800000);
    }
  }
  cp_async_commit();
}

template <int THREADS, int QPT, int GROUP, int CHUNK, int MINB, int UNROLL>
__global__ void __launch_bounds__(THREADS, MINB > 0 ? MINB : 1)
    nn1_partial_kernel(const float* __restrict__ q, const float* __restrict__ r, int nq,
                       int nr, int per_split, float* __restrict__ part_d,
                       int* __restrict__ part_row) {
  static_assert(CHUNK % GROUP == 0, "a chunk holds whole groups");
  static_assert(GROUP % UNROLL == 0, "a group is whole loop bodies");
  __shared__ float4 sr[2][CHUNK];
  const int lo = blockIdx.y * per_split;
  const int hi = min(nr, lo + per_split);
  const int q0 = blockIdx.x * THREADS * QPT + threadIdx.x;
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int best_g[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    // a query past nq repeats the last one and is not written
    const int qi = min(q0 + u * THREADS, nq - 1);
    qx[u] = q[3 * qi];
    qy[u] = q[3 * qi + 1];
    qz[u] = q[3 * qi + 2];
    best[u] = 3.0e38f;
    best_g[u] = lo;
  }
  const int n_chunks = (hi - lo + CHUNK - 1) / CHUNK;
  stage_chunk<THREADS, CHUNK>(sr[0], r, lo, hi);
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = lo + c * CHUNK;
    if (c + 1 < n_chunks) {
      // the other buffer was last read before the previous iteration's
      // closing barrier
      stage_chunk<THREADS, CHUNK>(sr[(c + 1) & 1], r, c0 + CHUNK, hi);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* buf = sr[c & 1];
    const int m = min(CHUNK, hi - c0);
    for (int g = 0; g < m; g += GROUP) {
      float gm[QPT];
#pragma unroll
      for (int u = 0; u < QPT; ++u) gm[u] = best[u];
      // UNROLL refs a loop body: a body of QPT * UNROLL pairs stays small
      // enough for the instruction cache, however large the group
#pragma unroll 1
      for (int k0 = g; k0 < g + GROUP; k0 += UNROLL) {
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const float4 p = buf[k0 + k];
#pragma unroll
          for (int u = 0; u < QPT; ++u) {
            gm[u] = fminf(gm[u], pcr::sqdist(qx[u], qy[u], qz[u], p.x, p.y, p.z));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        best_g[u] = gm[u] < best[u] ? c0 + g : best_g[u];  // strict: the first group
        best[u] = gm[u];
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int qi = q0 + u * THREADS;
    if (qi >= nq) continue;
    // the first row of the recorded group at the minimum (the group's own
    // start when nothing beat 3e38); unrolled, so the loads overlap
    int row = best_g[u];
#pragma unroll
    for (int k = GROUP - 1; k >= 0; --k) {
      const int j = best_g[u] + k;
      if (j < hi) {
        const float* rp = r + 3 * static_cast<size_t>(j);
        if (pcr::sqdist(qx[u], qy[u], qz[u], rp[0], rp[1], rp[2]) == best[u]) row = j;
      }
    }
    const size_t o = static_cast<size_t>(blockIdx.y) * nq + qi;
    part_d[o] = best[u];
    part_row[o] = row;
  }
}

constexpr int kMergeLoads = 8;  // partials a merge thread loads at once

__global__ void nn1_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_row, int nq,
                                 int splits, float* __restrict__ out_d,
                                 int* __restrict__ out_row) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best = 3.0e38f;
  int best_row = 0;
  // kMergeLoads partials in flight at a time, then kept in split order
  for (int s0 = 0; s0 < splits; s0 += kMergeLoads) {
    float d[kMergeLoads];
    int row[kMergeLoads];
#pragma unroll
    for (int k = 0; k < kMergeLoads; ++k) {
      const size_t o = static_cast<size_t>(min(s0 + k, splits - 1)) * nq + qi;
      d[k] = part_d[o];
      row[k] = part_row[o];
    }
#pragma unroll
    for (int k = 0; k < kMergeLoads; ++k) {
      // strict: an earlier split (lower rows) wins ties; the first split
      // always seeds the minimum (its d2 may be 3e38)
      if ((s0 == 0 && k == 0) || (s0 + k < splits && d[k] < best)) {
        best = d[k];
        best_row = row[k];
      }
    }
  }
  out_d[qi] = best;
  out_row[qi] = best_row;
}

template <int THREADS, int QPT, int GROUP, int CHUNK, int MINB, int UNROLL>
int launch_nn1(const float* q, const float* r, int nq, int nr, int splits, float* part_d,
               int* part_row, float* out_d, int* out_row, cudaStream_t stream) {
  // whole groups a split; the last ranges may then be empty and are dropped
  const int per_split = ((nr + splits - 1) / splits + GROUP - 1) / GROUP * GROUP;
  const int used = (nr + per_split - 1) / per_split;
  const int block_queries = THREADS * QPT;
  const dim3 grid((nq + block_queries - 1) / block_queries, used);
  nn1_partial_kernel<THREADS, QPT, GROUP, CHUNK, MINB, UNROLL>
      <<<grid, THREADS, 0, stream>>>(q, r, nq, nr, per_split, part_d, part_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_merge_kernel<<<(nq + 127) / 128, 128, 0, stream>>>(part_d, part_row, nq, used, out_d,
                                                         out_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (nq, 3) and r (nr, 3) row-major f32; part_d / part_row hold splits * nq
// entries of scratch.  The wrapper guarantees nq >= 1, nr >= 1 and
// 1 <= splits <= nr.
extern "C" int pcr_nn1(const float* q, const float* r, int nq, int nr, int splits,
                       float* part_d, int* part_row, float* out_d, int* out_row,
                       cudaStream_t stream) {
  return launch_nn1<kThreads, kQueries, kGroup, kChunk, kMinBlocks, kUnroll>(
      q, r, nq, nr, splits, part_d, part_row, out_d, out_row, stream);
}
