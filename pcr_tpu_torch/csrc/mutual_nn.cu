// K11 — mutual nearest neighbours of two feature sets (FGR's matching).
//
// Replaces pcr_tpu/ops/knn.py:nn1_mutual, whose jax.lax.scan over query
// tiles (knn.py:348) XLA compiles into one program: for each (q_tile, Nb)
// tile of expanded squared distances it takes the rows' argmin (a -> b) and
// folds the columns' minima into a carried (Nb,) minimum (b -> a).  The port
// ran that scan as a host loop that wrote every (2048, Nb) tile to device
// memory and read it back for where, argmin and min.
//
// What it computes, for a (na, 33) and b (nb, 33) f32 with their masks and
// the squared norms an = sum(a*a), bn = sum(b*b) that the wrapper computes
// as the plain version does:
//   d2(i, j) = max((an_i + bn_j) - 2 * dot(a_i, b_j), 0) where both rows are
//              valid, else BIG (3e38): _chunk_sqdist's expanded formula;
//   ij[i] = the smallest j among the minimal d2(i, .), ji[j] = the smallest
//           i among the minimal d2(., j): the lexicographic minimum of
//           (d2, index), which is what the plain version's first-index
//           argmin inside a tile and strict "<" across tiles give.  A row
//           whose every d2 is BIG (masked, or no valid partner) gets 0.
// The 33-term dot product is summed with fmaf in ascending k, so its
// rounding differs from the plain version's cuBLAS product: on near-ties the
// kernel may pick another index, within the expanded form's rounding.
//
// Bound on the H100: FP32 throughput.  24576^2 pairs x 33 FMAs is 2.0e10 FMAs,
// about 0.6 ms at the 67 TFLOP/s peak; the bytes (6.5 MB of features) are
// nothing.  Design:
//   * a block takes a tile of kTile a-rows and walks a range of b-tiles of
//     kTile rows; both tiles are staged transposed in shared memory
//     (k-major, rows padded to kStride floats), so that a thread reads its
//     rows' and columns' k-th values as float4s;
//   * each thread holds an 8 x 8 micro-tile of dot products in registers
//     (rows 4ty..4ty+3 and 64+4ty..+3, columns 4tx..4tx+3 and 64+4tx..+3,
//     so a quarter warp's float4 loads of b are contiguous): 64 FMAs per
//     four 16-byte shared loads.  No distance is written to memory;
//   * the d2 of the micro-tile updates, in registers, each row's running
//     (min, first column) over the block's b range (columns ascend within a
//     thread, so a strict "<" keeps the first) and each column's (min,
//     first row) over the tile's rows;
//   * the partial minima merge across lanes (shuffles), warps (shared
//     memory) and blocks by the lexicographic order of (d2, index).  Across
//     blocks each row and column keeps a uint64 key (float bits of d2 >= 0
//     above the index) merged with atomicMin: an integer atomic on a total
//     order, so the result does not depend on the blocks' order, run after
//     run.  No float atomic is used;
//   * the b range is split over grid.y so that the blocks fill the card's
//     resident slots a few times over.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDim = 33;             // FPFH features
constexpr int kTile = 128;           // a-rows and b-rows of a block tile
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 pairs each
constexpr int kStride = kTile + 4;   // floats between two k's of a staged tile
constexpr int kWaves = 4;            // resident-block waves the splits aim at
constexpr float kBig = 3.0e38f;      // a masked pair (ops/knn.py's BIG)

__device__ __forceinline__ unsigned long long pack(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(i);
}

// (d, i) <- the lexicographic minimum of (d, i) and (od, oi)
__device__ __forceinline__ void lexmin(float& d, int& i, float od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

// Rows [r0, r0 + kTile) of x (n, kDim) into s[k * kStride + row], 0 past n.
// The tile is contiguous in x, so the loads coalesce.
__device__ __forceinline__ void stage(float* s, const float* __restrict__ x, int r0, int n) {
  const int rows = min(kTile, n - r0);
  const float* src = x + static_cast<size_t>(r0) * kDim;
  for (int e = threadIdx.x; e < kTile * kDim; e += kThreads) {
    const int row = e / kDim;
    const int k = e - row * kDim;
    s[k * kStride + row] = row < rows ? src[e] : 0.f;
  }
}

// The thread's u-th row (or column) of a tile, u in [0, 8): 4t+u, then 64+4t+u-4.
__device__ __forceinline__ int lane_row(int t, int u) {
  return u < 4 ? 4 * t + u : 64 + 4 * t + (u - 4);
}

__global__ void __launch_bounds__(kThreads)
    mutual_kernel(const float* __restrict__ a, const float* __restrict__ an,
                  const unsigned char* __restrict__ am, int na, const float* __restrict__ b,
                  const float* __restrict__ bn, const unsigned char* __restrict__ bm, int nb,
                  int tiles_per_split, unsigned long long* __restrict__ row_key,
                  unsigned long long* __restrict__ col_key) {
  __shared__ __align__(16) float sa[kDim * kStride];
  __shared__ __align__(16) float sb[kDim * kStride];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a0 = blockIdx.x * kTile;
  const int nbt = (nb + kTile - 1) / kTile;
  const int t_lo = blockIdx.y * tiles_per_split;
  const int t_hi = min(nbt, t_lo + tiles_per_split);
  const float inf = __int_as_float(0x7f800000);

  stage(sa, a, a0, na);
  // the thread's rows: squared norm, valid (in range and unmasked), in range
  float rnorm[8], rd[8];
  int rj[8];
  unsigned rvalid = 0, rin = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = a0 + lane_row(ty, u);
    const bool in = row < na;
    rnorm[u] = in ? an[row] : 0.f;
    rin |= static_cast<unsigned>(in) << u;
    rvalid |= static_cast<unsigned>(in && am[row] != 0) << u;
    rd[u] = inf;   // any d2 of a column in range, BIG included, is below it
    rj[u] = 0;
  }
  float* col_d = sb;  // after a tile's products, sb holds the warps' column minima
  int* col_i = reinterpret_cast<int*>(sb + 8 * kTile);

  for (int t = t_lo; t < t_hi; ++t) {
    const int b0 = t * kTile;
    __syncthreads();  // the last tile's column minima were read
    stage(sb, b, b0, nb);
    __syncthreads();
    float acc[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kDim; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(sa + k * kStride + 4 * ty);
      const float4 a_hi = *reinterpret_cast<const float4*>(sa + k * kStride + 64 + 4 * ty);
      const float4 b_lo = *reinterpret_cast<const float4*>(sb + k * kStride + 4 * tx);
      const float4 b_hi = *reinterpret_cast<const float4*>(sb + k * kStride + 64 + 4 * tx);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
    }
    // the thread's columns of this tile
    float cnorm[8], cd[8];
    int ci[8];
    unsigned cvalid = 0, cin = 0;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int col = b0 + lane_row(tx, v);
      const bool in = col < nb;
      cnorm[v] = in ? bn[col] : 0.f;
      cin |= static_cast<unsigned>(in) << v;
      cvalid |= static_cast<unsigned>(in && bm[col] != 0) << v;
      cd[v] = inf;
      ci[v] = 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int row = a0 + lane_row(ty, u);
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float d = fmaxf(__fsub_rn(__fadd_rn(rnorm[u], cnorm[v]), __fmul_rn(2.f, acc[u][v])),
                        0.f);
        d = ((rvalid >> u) & (cvalid >> v) & 1u) ? d : kBig;
        // columns ascend within the thread: strict "<" keeps the first
        const float dr = ((cin >> v) & 1u) ? d : inf;
        if (dr < rd[u]) {
          rd[u] = dr;
          rj[u] = b0 + lane_row(tx, v);
        }
        const float dc = ((rin >> u) & 1u) ? d : inf;
        if (dc < cd[v]) {
          cd[v] = dc;
          ci[v] = row;
        }
      }
    }
    // columns: the two ty of a warp by a shuffle, the eight warps in shared memory
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      lexmin(cd[v], ci[v], __shfl_xor_sync(0xffffffffu, cd[v], 16),
             __shfl_xor_sync(0xffffffffu, ci[v], 16));
    }
    __syncthreads();  // every thread is done reading sb's features
    if (lane < 16) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        col_d[warp * kTile + lane_row(tx, v)] = cd[v];
        col_i[warp * kTile + lane_row(tx, v)] = ci[v];
      }
    }
    __syncthreads();
    if (threadIdx.x < kTile && b0 + static_cast<int>(threadIdx.x) < nb) {
      float d = col_d[threadIdx.x];
      int i = col_i[threadIdx.x];
      for (int w = 1; w < kThreads / 32; ++w) {
        lexmin(d, i, col_d[w * kTile + threadIdx.x], col_i[w * kTile + threadIdx.x]);
      }
      atomicMin(col_key + b0 + threadIdx.x, pack(d, i));
    }
  }
  // rows: the 16 tx of a half warp by shuffles, then one key a row
#pragma unroll
  for (int u = 0; u < 8; ++u) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      lexmin(rd[u], rj[u], __shfl_xor_sync(0xffffffffu, rd[u], off),
             __shfl_xor_sync(0xffffffffu, rj[u], off));
    }
    if (tx == 0 && ((rin >> u) & 1u) && t_lo < t_hi) {
      atomicMin(row_key + a0 + lane_row(ty, u), pack(rd[u], rj[u]));
    }
  }
}

// The index of every merged key: its low 32 bits.
__global__ void index_kernel(const unsigned long long* __restrict__ key, int n,
                             int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int>(key[i] & 0xffffffffull);
}

}  // namespace

// a (na, 33), b (nb, 33) f32 row-major; an (na,), bn (nb,) their squared
// norms; am (na,), bm (nb,) bool masks; row_key (na,), col_key (nb,) uint64
// scratch.  Writes ij (na,) and ji (nb,) int32.  The wrapper guarantees
// na >= 1 and nb >= 1.
extern "C" int pcr_nn1_mutual(const float* a, const float* an, const unsigned char* am, int na,
                              const float* b, const float* bn, const unsigned char* bm, int nb,
                              unsigned long long* row_key, unsigned long long* col_key, int* ij,
                              int* ji, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(row_key, 0xff, sizeof(unsigned long long) * na, stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(col_key, 0xff, sizeof(unsigned long long) * nb, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mutual_kernel, kThreads, 0);
  const int nat = (na + kTile - 1) / kTile;
  const int nbt = (nb + kTile - 1) / kTile;
  const int want = max(1, kWaves * max(per_sm, 1) * sms);
  const int splits = max(1, min(nbt, (want + nat - 1) / nat));
  const int per_split = (nbt + splits - 1) / splits;
  const int used = (nbt + per_split - 1) / per_split;   // no empty range
  mutual_kernel<<<dim3(nat, used), kThreads, 0, stream>>>(a, an, am, na, b, bn, bm, nb,
                                                          per_split, row_key, col_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  index_kernel<<<(na + 255) / 256, 256, 0, stream>>>(row_key, na, ij);
  index_kernel<<<(nb + 255) / 256, 256, 0, stream>>>(col_key, nb, ji);
  return static_cast<int>(cudaGetLastError());
}
