// K10 — the band GICP's Gauss-Newton iteration (models/gicp._gicp_band_sorted)
// as three launches around K1: gicp_move, then K1's sweep, then gicp_rows,
// then gicp_update.
//
// Not a Pallas kernel: K10 is the port's counterpart of the body of the
// jax.lax.while_loop of pcr_tpu/models/gicp.py:_gicp_band_sorted (line 442),
// which pcr_tpu compiles into one XLA program.  The port keeps the loop on
// the host, with one host read of the convergence flag an iteration (the
// per-scale iteration counts, and the lock-step exit of point-sharded
// ranks, stay as they are), and K1 as its own launch.  Its plain versions
// (ops/kernels/gicp_kernels.py) are a chain of ~275 small launches an
// iteration, so on the card the loop was bound by the host's launches.
//
// What bounds the kernels is latency: at 21504 rows an iteration reads about
// 1.4 MB, under half a microsecond at 3.35 TB/s, against a few microseconds
// of launch and of a dependent gather a row.  The design keeps every
// intermediate out of device memory and the launches few:
//   * gicp_move, one block a query tile: moves the tile's sorted source rows
//     by T (read from the device), writes q_sp with masked rows at SENTINEL,
//     and takes the tile's slab start by ops/band_nn.slab_starts' rule with
//     the device code of csrc/band_nn.cu's slab_starts (common.cuh's
//     slab_start), so its starts equal that kernel's on the same q_sp bit
//     for bit;
//   * gicp_rows, one thread a sorted row: the packed target gather, d and
//     d2 = (dx dx + dy dy) + dz dz rounded op by op (as the plain version
//     and K1), valid, u = R n_p, the plane-disk C, M = C^-1 by the adjugate,
//     the robust weight, G = [skew(p) | -I]; each row's 30 sums (H on and
//     below the diagonal, g, n_corr, n_src, sum d2) meet by shuffles and then
//     in warp order, one partial row a block, no float atomics;
//   * gicp_update, one block: merges the partial rows in a fixed order (warp
//     w the columns w, w + 8, ...; lane l the rows l, l + 32, ... in
//     ascending order, then a shuffle tree), then one thread damps H, solves
//     by Cholesky (xi = 0 without a correspondence), composes exp(xi) T, runs
//     Open3D's test against the previous fitness and rmse and writes T and
//     the state [fitness, rmse, n_corr, done] in place.  With a process
//     group the caller sums the rows and all-reduces the one row first.
// Everything is float32 (no fast math); counts are whole numbers held
// exactly in float32; every sum runs in a fixed order, so the same inputs
// give the same bits, run after run.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float kSentinel = pcr::kSlabSentinel;
constexpr int kMoveThreads = 256;
constexpr int kRowsThreads = 256;
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr int kUpdateThreads = 256;
constexpr int kSums = 30;             // H (21), g (6), n_corr, n_src, sum d2
constexpr int kRowFloats = 32;        // a partial row, padded with zeros
constexpr int kNCorr = 27, kNSrc = 28, kSumD2 = 29;
constexpr unsigned kFull = 0xffffffffu;

// Entry (r, c), r >= c, of the 21 sums of H: the lower triangle row by row,
// as torch.tril_indices(6, 6).
__host__ __device__ constexpr int tri(int r, int c) { return r * (r + 1) / 2 + c; }

__global__ void __launch_bounds__(kMoveThreads)
    gicp_move_kernel(const float* __restrict__ T, const float* __restrict__ pts,
                     const unsigned char* __restrict__ mask, const float* __restrict__ ra, int nr,
                     const long long* __restrict__ axis_p, int q_tile, int band, int max_blk,
                     float max_dist, float* __restrict__ q_sp, int* __restrict__ starts) {
  const int tile = blockIdx.x;
  const int axis = static_cast<int>(*axis_p);
  float t[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) t[e] = T[e];
  pcr::SlabExtent ext;
  for (int k = threadIdx.x; k < q_tile; k += kMoveThreads) {
    const size_t i = static_cast<size_t>(tile) * q_tile + k;
    float p[3] = {kSentinel, kSentinel, kSentinel};
    if (mask[i]) {
      const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
#pragma unroll
      for (int r = 0; r < 3; ++r) {   // transform_points: p @ R^T, then + t
        p[r] = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(t[4 * r], x), __fmul_rn(t[4 * r + 1], y)),
                      __fmul_rn(t[4 * r + 2], z)),
            t[4 * r + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) q_sp[3 * i + r] = p[r];
    pcr::slab_extent(ext, axis == 0 ? p[0] : (axis == 1 ? p[1] : p[2]));
  }
  pcr::slab_start<kMoveThreads>(ext, ra, nr, band, max_blk, max_dist, starts + tile);
}

__global__ void __launch_bounds__(kRowsThreads)
    gicp_rows_kernel(const float* __restrict__ q_sp, const float* __restrict__ nrm,
                     const unsigned char* __restrict__ mask, const float* __restrict__ d2k,
                     const int* __restrict__ row, const float4* __restrict__ pack,
                     const float* __restrict__ T, int rows, int nr, float max_d2, int loss,
                     float gm_k, float a, float* __restrict__ partials) {
  __shared__ float warp_sums[kRowsWarps][kSums];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRowsThreads + threadIdx.x;
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  if (i < rows && mask[i]) {
    acc[kNSrc] = 1.0f;
    const float px = q_sp[3 * i], py = q_sp[3 * i + 1], pz = q_sp[3 * i + 2];
    const int j = min(max(row[i], 0), nr - 1);
    const float4 r0 = pack[2 * j], r1 = pack[2 * j + 1];   // [q | m | 0 0]
    const float d[3] = {__fsub_rn(r0.x, px), __fsub_rn(r0.y, py), __fsub_rn(r0.z, pz)};
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                               __fmul_rn(d[2], d[2]));
    if (d2k[i] <= max_d2 && d2 <= max_d2) {
      acc[kNCorr] = 1.0f;
      acc[kSumD2] = d2;
      float t[9];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) t[3 * r + c] = T[4 * r + c];
      }
      const float n0 = nrm[3 * i], n1 = nrm[3 * i + 1], n2 = nrm[3 * i + 2];
      const float m[3] = {r0.w, r1.x, r1.y};
      float u[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) u[r] = t[3 * r] * n0 + t[3 * r + 1] * n1 + t[3 * r + 2] * n2;
      // C = 2 I - a (m m^T + u u^T), then M = C^-1 by the adjugate (gicp._inv3)
      float C[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          C[r][c] = (r == c ? 2.0f : 0.0f) - a * (m[r] * m[c] + u[r] * u[c]);
        }
      }
      const float A11 = C[1][1] * C[2][2] - C[1][2] * C[2][1];
      const float A12 = C[0][2] * C[2][1] - C[0][1] * C[2][2];
      const float A13 = C[0][1] * C[1][2] - C[0][2] * C[1][1];
      const float A21 = C[1][2] * C[2][0] - C[1][0] * C[2][2];
      const float A22 = C[0][0] * C[2][2] - C[0][2] * C[2][0];
      const float A23 = C[0][2] * C[1][0] - C[0][0] * C[1][2];
      const float A31 = C[1][0] * C[2][1] - C[1][1] * C[2][0];
      const float A32 = C[0][1] * C[2][0] - C[0][0] * C[2][1];
      const float A33 = C[0][0] * C[1][1] - C[0][1] * C[1][0];
      const float det = C[0][0] * A11 + C[0][1] * A21 + C[0][2] * A31;
      const float inv_det = 1.0f / (fabsf(det) > 1e-30f ? det : 1e-30f);
      const float M[3][3] = {{A11 * inv_det, A12 * inv_det, A13 * inv_det},
                             {A21 * inv_det, A22 * inv_det, A23 * inv_det},
                             {A31 * inv_det, A32 * inv_det, A33 * inv_det}};
      const float rn = sqrtf(fmaxf(d2, 1e-16f));
      float w = 1.0f;                                            // l2
      if (loss == 1) {
        w = 1.0f / fmaxf(rn, 1e-8f);                             // l1
      } else if (loss == 2) {
        const float s = gm_k + rn * rn;                          // Geman-McClure
        w = gm_k / (s * s);
      }
      const float G[3][6] = {{0.0f, -pz, py, -1.0f, 0.0f, 0.0f},
                             {pz, 0.0f, -px, 0.0f, -1.0f, 0.0f},
                             {-py, px, 0.0f, 0.0f, 0.0f, -1.0f}};
      float MG[3][6], wG[3][6], Md[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          MG[r][c] = M[r][0] * G[0][c] + M[r][1] * G[1][c] + M[r][2] * G[2][c];
          wG[r][c] = G[r][c] * w;
        }
        Md[r] = M[r][0] * d[0] + M[r][1] * d[1] + M[r][2] * d[2];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c) {
          acc[tri(r, c)] = wG[0][r] * MG[0][c] + wG[1][r] * MG[1][c] + wG[2][r] * MG[2][c];
        }
        acc[21 + r] = wG[0][r] * Md[0] + wG[1][r] * Md[1] + wG[2][r] * Md[2];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kRowFloats) {
    float s = 0.0f;
    if (threadIdx.x < kSums) {
#pragma unroll
      for (int v = 0; v < kRowsWarps; ++v) s += warp_sums[v][threadIdx.x];
    }
    partials[static_cast<size_t>(blockIdx.x) * kRowFloats + threadIdx.x] = s;
  }
}

// The n partial rows summed into s[kSums] in a fixed order: warp w takes the
// columns w, w + 8, ...; lane l sums the rows l, l + 32, ... in ascending
// order, and the lanes' sums meet by a shuffle tree.
__device__ void merge_rows(const float* __restrict__ partials, int n, float* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < kSums; c += kUpdateThreads / 32) {
    float v = 0.0f;
    for (int b = lane; b < n; b += 32) v += partials[static_cast<size_t>(b) * kRowFloats + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) s[c] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kUpdateThreads)
    gicp_update_kernel(const float* __restrict__ partials, int n, float* __restrict__ T,
                       float* __restrict__ state, float rel_fit, float rel_rmse) {
  __shared__ float s[kSums];
  merge_rows(partials, n, s);
  if (threadIdx.x != 0) return;
  const float n_corr = s[kNCorr];
  const float fitness = n_corr / fmaxf(s[kNSrc], 1.0f);
  const float rmse = sqrtf(s[kSumD2] / fmaxf(n_corr, 1.0f));
  float H[6][6], g[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int c = 0; c <= r; ++c) H[r][c] = H[c][r] = s[tri(r, c)];
    g[r] = s[21 + r];
  }
  float trace = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) trace += H[i][i];
  const float lam = 1e-6f * (trace / 6.0f + 1.0f);
#pragma unroll
  for (int i = 0; i < 6; ++i) H[i][i] += lam;
  float x[6];
  pcr::cholesky_solve6(H, g, x);
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = n_corr > 0.0f ? -x[i] : 0.0f;
  pcr::se3_exp_compose(xi, T);
  const bool done = (fabsf(fitness - state[0]) < rel_fit && fabsf(rmse - state[1]) < rel_rmse) ||
                    n_corr == 0.0f;
  state[0] = fitness;
  state[1] = rmse;
  state[2] = n_corr;
  state[3] = done ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

// Blocks (partial rows) of gicp_rows over `rows` sorted rows.
int pcr_gicp_rows_blocks(int rows) { return (rows + kRowsThreads - 1) / kRowsThreads; }

// gicp_move: T (4, 4); pts (n_tiles * q_tile, 3), mask (same rows) bytes; ra
// (nr,) the ascending axis coordinates of the refs; axis an int64 on the
// device; q_sp (n_tiles * q_tile, 3) and starts (n_tiles,) written.
int pcr_gicp_move(const float* T, const float* pts, const unsigned char* mask, const float* ra,
                  int nr, const long long* axis, int n_tiles, int q_tile, int band, int max_blk,
                  float max_dist, float* q_sp, int* starts, void* stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  gicp_move_kernel<<<n_tiles, kMoveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      T, pts, mask, ra, nr, axis, q_tile, band, max_blk, max_dist, q_sp, starts);
  return static_cast<int>(cudaGetLastError());
}

// gicp_rows: q_sp, normals (rows, 3), mask (rows,) bytes, K1's d2 and row
// (rows,), the packed target (nr_pad, 8), T (4, 4); loss 0 l2, 1 l1, 2 gm;
// partials (pcr_gicp_rows_blocks(rows), 32) written.
int pcr_gicp_rows(const float* q_sp, const float* normals, const unsigned char* mask,
                  const float* d2, const int* row, const float* pack, const float* T, int rows,
                  int nr, float max_d2, int loss, float gm_k, float a, float* partials,
                  void* stream) {
  const int blocks = pcr_gicp_rows_blocks(rows);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  gicp_rows_kernel<<<blocks, kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_sp, normals, mask, d2, row, reinterpret_cast<const float4*>(pack), T, rows, nr, max_d2,
      loss, gm_k, a, partials);
  return static_cast<int>(cudaGetLastError());
}

// gicp_update: partials (n, 32); T (4, 4) and state (4,) updated in place.
int pcr_gicp_update(const float* partials, int n, float* T, float* state, float rel_fit,
                    float rel_rmse, void* stream) {
  gicp_update_kernel<<<1, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, n, T, state, rel_fit, rel_rmse);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
