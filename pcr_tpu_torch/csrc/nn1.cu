// K7 — brute-force 1-NN of every query over the whole reference cloud, for
// the exact-correspondence GICP and the exact evaluation.
//
// Replaces pcr_tpu/ops/pallas/nn_kernels.py:nn1_pallas (_nn1_kernel).  The
// TPU kernel keeps a (TQ, sub_chunk) running per-lane min of the expanded
// |q|^2 + |r|^2 - 2 q.r in VMEM, finds the winning lane with a one-hot reduce
// and re-scores the winner outside the kernel.  None of that carries over.
//
// On the H100 the work is ~12 issued instructions per (query, ref) pair and
// the bytes are tiny (12 bytes a row, each ref row read once per block from
// L2), so it is bound by issue rate and by how many warps are in flight.
// Design, as K1's (band_nn.cu) but over the whole ref:
//   * one thread owns one query and keeps (min d2, row) in registers;
//   * the block streams its ref range through shared memory in chunks of
//     kChunk rows (float4 a row: one broadcast 16-byte load per pair), so Nr
//     does not set the shared-memory size;
//   * d2 is ((dx*dx + dy*dy) + dz*dz) with every operation rounded on its own
//     (pcr::sqdist), bit-equal to the plain version, so no re-score;
//   * a few query blocks cannot fill 132 SMs, so the ref rows are split into
//     `splits` contiguous ranges (grid.y): each block writes its range's
//     partial (min, row), and a second kernel keeps, per query, the first
//     split holding the smallest d2.  Within a range the first minimum wins
//     (strict <), and ranges ascend, so the result is the first minimum of
//     the whole row, as torch.min's.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;

__global__ void nn1_partial_kernel(const float* __restrict__ q,
                                   const float* __restrict__ r, int nq, int nr,
                                   int per_split, float* __restrict__ part_d,
                                   int* __restrict__ part_row) {
  __shared__ float4 sr[kChunk];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const int lo = blockIdx.y * per_split;
  const int hi = min(nr, lo + per_split);
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (qi < nq) {
    const float* qp = q + 3 * static_cast<size_t>(qi);
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float best = 3.0e38f;
  int best_row = lo;
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    const int m = min(kChunk, hi - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float* rp = r + 3 * static_cast<size_t>(c0 + j);
      sr[j] = make_float4(rp[0], rp[1], rp[2], 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < m; ++k) {
      const float4 v = sr[k];
      const float d = pcr::sqdist(qx, qy, qz, v.x, v.y, v.z);
      if (d < best) {  // strict: the first minimum wins
        best = d;
        best_row = c0 + k;
      }
    }
  }
  if (qi < nq) {
    const size_t o = static_cast<size_t>(blockIdx.y) * nq + qi;
    part_d[o] = best;
    part_row[o] = best_row;
  }
}

__global__ void nn1_merge_kernel(const float* __restrict__ part_d,
                                 const int* __restrict__ part_row, int nq,
                                 int splits, float* __restrict__ out_d,
                                 int* __restrict__ out_row) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= nq) return;
  float best = part_d[qi];
  int best_row = part_row[qi];
  for (int s = 1; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * nq + qi;
    const float d = part_d[o];
    if (d < best) {  // strict: an earlier split (lower rows) wins ties
      best = d;
      best_row = part_row[o];
    }
  }
  out_d[qi] = best;
  out_row[qi] = best_row;
}

}  // namespace

// q (nq, 3) and r (nr, 3) row-major f32; part_d / part_row hold splits * nq
// entries of scratch.  The wrapper guarantees nq >= 1, nr >= 1 and
// 1 <= splits <= nr, with per_split = ceil(nr / splits).
extern "C" int pcr_nn1(const float* q, const float* r, int nq, int nr, int splits,
                       float* part_d, int* part_row, float* out_d, int* out_row,
                       cudaStream_t stream) {
  const int per_split = (nr + splits - 1) / splits;
  const dim3 grid((nq + kThreads - 1) / kThreads, splits);
  nn1_partial_kernel<<<grid, kThreads, 0, stream>>>(q, r, nq, nr, per_split, part_d,
                                                   part_row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn1_merge_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_row, nq, splits, out_d, out_row);
  return static_cast<int>(cudaGetLastError());
}
