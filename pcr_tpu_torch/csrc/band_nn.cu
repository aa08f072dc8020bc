// K1 — banded 1-NN for the GICP correspondence search and gate evaluation.
//
// Replaces pcr_tpu/ops/pallas/nn_kernels.py:nn1_band_pallas.  Every query
// tile of q_tile sorted queries scans ONE contiguous slab of 2*band rows of
// the sorted reference, starting at starts[tile] (element offset, computed
// once by the wrapper).  Output: exact d2 of the winner and its ABSOLUTE
// sorted row.
//
// On the H100 the work is ~10 ALU ops per (query, slab row) pair and the
// bytes are tiny (each slab row is read once per block, mostly from L2), so
// it is bound by issue rate and by how many warps are in flight.  Design:
// one thread per query keeps its running (min d2, row) in registers; the
// block stages the slab through shared memory in chunks of blockDim.x rows,
// so band 2048 (48 KB of coordinates) does not set the shared-memory size,
// and small blocks put more of them on the card's 132 SMs.  All threads of a
// block read the same shared word at a time (broadcast, no bank conflicts).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 128;

__global__ void nn1_band_kernel(const int* __restrict__ starts,
                                const float* __restrict__ q,
                                const float* __restrict__ r, int q_tile,
                                int band, float* __restrict__ out_d,
                                int* __restrict__ out_row) {
  __shared__ float sx[kMaxThreads], sy[kMaxThreads], sz[kMaxThreads];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  // q_tile is a multiple of blockDim.x, so a block never straddles tiles.
  const int start = starts[(blockIdx.x * blockDim.x) / q_tile];
  const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
  const int slab = 2 * band;
  float best = 3.0e38f;
  int best_row = start;
  for (int c0 = 0; c0 < slab; c0 += blockDim.x) {
    __syncthreads();
    const int j = c0 + threadIdx.x;
    if (j < slab) {
      const float* rp = r + 3 * static_cast<size_t>(start + j);
      sx[threadIdx.x] = rp[0];
      sy[threadIdx.x] = rp[1];
      sz[threadIdx.x] = rp[2];
    }
    __syncthreads();
    const int m = min(static_cast<int>(blockDim.x), slab - c0);
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const float d = pcr::sqdist(qx, qy, qz, sx[k], sy[k], sz[k]);
      if (d < best) {  // strict: the first minimum wins, as torch.min does
        best = d;
        best_row = start + c0 + k;
      }
    }
  }
  out_d[qi] = best;
  out_row[qi] = best_row;
}

}  // namespace

// The wrapper guarantees q_tile < 128 or q_tile % 128 == 0, and
// nq_pad % q_tile == 0.
extern "C" int pcr_nn1_band(const int* starts, const float* q, const float* r,
                            int nq_pad, int q_tile, int band, float* out_d,
                            int* out_row, cudaStream_t stream) {
  const int threads = q_tile < kMaxThreads ? q_tile : kMaxThreads;
  nn1_band_kernel<<<nq_pad / threads, threads, 0, stream>>>(
      starts, q, r, q_tile, band, out_d, out_row);
  return static_cast<int>(cudaGetLastError());
}
