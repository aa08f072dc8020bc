// K8 — FGR's graduated non-convexity (GNC), all iteration_number steps of
// every pair in one launch — and K9 — the pose graph's block-Thomas solve,
// the forward and the backward sweep in one launch.
//
// Neither replaces a Pallas kernel.  K8 is the port's counterpart of the
// jax.lax.scan of pcr_tpu/models/fgr.py:fgr_from_correspondences (line 166),
// K9 of the two scans of
// pcr_tpu/models/global_refine/pose_graph.py:_block_thomas_solve (lines 173
// and 180); pcr_tpu compiles each into one XLA program.  The port's plain
// versions (ops/kernels/loop_kernels.py) run them as Python loops of small
// launches, so on the card they are bound by the host.
//
// What bounds the kernels is latency, not bytes or operations: each step
// depends on the one before, so neither loop spreads over the card.
//
// K8, one block a pair, for all steps:
//   * rows of zero weight add exact zeros to every sum, so the block first
//     compacts the rows of nonzero weight, in ascending order, into shared
//     memory where they fit (kGncSmemRows rows) and otherwise into the
//     wrapper's global scratch buffer (read back through L2 every step);
//   * a step needs only 16 sums: G^T G with G = [skew(pt) | -I] is
//     [[|pt|^2 I - pt pt^T, skew(pt)], [-skew(pt), I]], so H follows from
//     sum l, sum l pt and sum l pt pt^T (10 sums), and G^T r = [r x pt; -r]
//     gives g's 6.  Each thread sums a fixed stride of rows; the warps
//     reduce by shuffles, then warp 0 adds the warps' sums in index order;
//   * one thread damps H, solves H xi = -g by Cholesky (the port's
//     solve6_cholesky), takes se3_exp(xi) with the port's small-angle
//     branches (utils/se3.py) and composes T <- exp(xi) T in shared memory;
//     mu lives in every thread's registers, updated alike.
// K9, one warp for the whole sweep:
//   * step j forms S = D_j - U_{j-1}^T C_{j-1} and r = rhs_j - U_{j-1}^T
//     d_{j-1} beside U_j in a 6x13 augmented system in shared memory and
//     eliminates it with partial pivoting (the largest |a| of the column,
//     the first on ties, as LAPACK's getrf behind torch.linalg.solve_ex);
//     seven lanes back-substitute one column each, giving C_j and d_j;
//   * step j+1's blocks (D, U, rhs: 78 floats, three a lane) are loaded into
//     registers while step j is eliminated;
//   * C_j and d_j go to global memory; the backward sweep reads them back,
//     one row a lane, the next row loaded while this one is used.
// Everything is float32 (no fast math); every sum runs in a fixed order, so
// the same inputs give the same bits, run after run.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kGncThreads = 512;
constexpr int kGncWarps = kGncThreads / 32;
constexpr int kGncSums = 16;
constexpr int kGncSmemRows = 6144;   // 6144 rows x 32 bytes = 192 KB of shared memory
constexpr unsigned kFull = 0xffffffffu;

// A compacted row: (px, py, pz, w), (qx, qy, qz, 0).
__device__ __forceinline__ void put_row(float4* rows, int k, const float* p, const float* q,
                                        float w) {
  rows[2 * k] = make_float4(p[0], p[1], p[2], w);
  rows[2 * k + 1] = make_float4(q[0], q[1], q[2], 0.0f);
}

// One GNC step's pose update from the block's 16 sums S (sum l; sum l x, y,
// z; sum l xx, yy, zz, xy, xz, yz; g): H, damping, Cholesky, se3_exp, and
// T <- exp(xi) T on T's top three rows (R | t), row-major in shared memory.
__device__ void gnc_update(const float (&S)[kGncSums], bool enough, float* T) {
  const float sl = S[0], sx = S[1], sy = S[2], sz = S[3];
  const float sxx = S[4], syy = S[5], szz = S[6], sxy = S[7], sxz = S[8], syz = S[9];
  float H[6][6] = {
      {syy + szz, -sxy, -sxz, 0.0f, -sz, sy},
      {-sxy, sxx + szz, -syz, sz, 0.0f, -sx},
      {-sxz, -syz, sxx + syy, -sy, sx, 0.0f},
      {0.0f, sz, -sy, sl, 0.0f, 0.0f},
      {-sz, 0.0f, sx, 0.0f, sl, 0.0f},
      {sy, -sx, 0.0f, 0.0f, 0.0f, sl}};
  float g[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = S[10 + i];
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
  for (int i = 0; i < 6; ++i) xi[i] = enough ? -x[i] : 0.0f;
  pcr::se3_exp_compose(xi, T);
}

__global__ void __launch_bounds__(kGncThreads)
    gnc_kernel(const float* __restrict__ p, const float* __restrict__ q,
               const float* __restrict__ w, const float* __restrict__ delta,
               const unsigned char* __restrict__ enough, int n, int iterations, float mu0,
               float division_factor, int decrease_mu, int smem_rows,
               float4* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ float4 staged[];
  __shared__ float partial[kGncWarps][kGncSums];
  __shared__ float T[12];
  __shared__ int warp_count[kGncWarps];
  const int pair = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pp = p + 3 * static_cast<size_t>(pair) * n;
  const float* qp = q + 3 * static_cast<size_t>(pair) * n;
  const float* wp = w + static_cast<size_t>(pair) * n;

  // the rows of nonzero weight: how many, then where
  int cnt = 0;
  for (int i = tid; i < n; i += kGncThreads) cnt += wp[i] != 0.0f;
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) warp_count[warp] = cnt;
  __syncthreads();
  int kept = 0;
#pragma unroll
  for (int v = 0; v < kGncWarps; ++v) kept += warp_count[v];
  float4* rows = kept <= smem_rows ? staged : scratch + 2 * static_cast<size_t>(pair) * n;
  __syncthreads();
  int base = 0;
  for (int i0 = 0; i0 < n; i0 += kGncThreads) {
    const int i = i0 + tid;
    const float wi = i < n ? wp[i] : 0.0f;
    const bool keep = wi != 0.0f;
    const unsigned votes = __ballot_sync(kFull, keep);
    if (lane == 0) warp_count[warp] = __popc(votes);
    __syncthreads();
    int before = base, chunk = 0;
#pragma unroll
    for (int v = 0; v < kGncWarps; ++v) {
      before += v < warp ? warp_count[v] : 0;
      chunk += warp_count[v];
    }
    if (keep) put_row(rows, before + __popc(votes & ((1u << lane) - 1u)), pp + 3 * i, qp + 3 * i, wi);
    base += chunk;
    __syncthreads();
  }

  const float stop = delta[pair] * delta[pair];
  const bool ok = enough[pair] != 0;
  if (tid < 12) T[tid] = tid % 5 == 0 ? 1.0f : 0.0f;   // identity: entries 0, 5, 10
  __syncthreads();
  float mu = mu0;
  for (int it = 0; it < iterations; ++it) {
    if (decrease_mu && it % 4 == 0 && mu > stop) mu = mu / division_factor;
    float t[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) t[e] = T[e];
    float acc[kGncSums];
#pragma unroll
    for (int k = 0; k < kGncSums; ++k) acc[k] = 0.0f;
    for (int i = tid; i < kept; i += kGncThreads) {
      const float4 a = rows[2 * i], b = rows[2 * i + 1];
      const float x = t[0] * a.x + t[1] * a.y + t[2] * a.z + t[3];
      const float y = t[4] * a.x + t[5] * a.y + t[6] * a.z + t[7];
      const float z = t[8] * a.x + t[9] * a.y + t[10] * a.z + t[11];
      const float rx = b.x - x, ry = b.y - y, rz = b.z - z;
      const float s = mu / (mu + (rx * rx + ry * ry + rz * rz));
      const float l = s * s * a.w;
      const float lx = l * x, ly = l * y, lz = l * z;
      acc[0] += l;
      acc[1] += lx;
      acc[2] += ly;
      acc[3] += lz;
      acc[4] += lx * x;
      acc[5] += ly * y;
      acc[6] += lz * z;
      acc[7] += lx * y;
      acc[8] += lx * z;
      acc[9] += ly * z;
      acc[10] += l * (ry * z - rz * y);
      acc[11] += l * (rz * x - rx * z);
      acc[12] += l * (rx * y - ry * x);
      acc[13] -= l * rx;
      acc[14] -= l * ry;
      acc[15] -= l * rz;
    }
#pragma unroll
    for (int k = 0; k < kGncSums; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kGncSums; ++k) partial[warp][k] = acc[k];
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.0f;
      if (lane < kGncSums) {
#pragma unroll
        for (int v = 0; v < kGncWarps; ++v) s += partial[v][lane];
      }
      float S[kGncSums];
#pragma unroll
      for (int k = 0; k < kGncSums; ++k) S[k] = __shfl_sync(kFull, s, k);
      if (lane == 0) gnc_update(S, ok, T);
    }
    __syncthreads();
  }
  if (tid < 16) out[16 * static_cast<size_t>(pair) + tid] = tid < 12 ? T[tid] : (tid == 15 ? 1.0f : 0.0f);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

constexpr int kStepFloats = 78;   // D_j (36), U_j (36, zero at the last step), rhs_j (6)

// Lane `lane`'s three floats of step j's inputs, entries lane, lane + 32, lane + 64.
__device__ __forceinline__ void load_step(const float* __restrict__ D, const float* __restrict__ U,
                                          const float* __restrict__ rhs, int m, int j, int lane,
                                          float (&v)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int e = lane + 32 * r;
    float x = 0.0f;
    if (e < 36) {
      x = D[36 * static_cast<size_t>(j) + e];
    } else if (e < 72) {
      if (j < m - 1) x = U[36 * static_cast<size_t>(j) + e - 36];
    } else if (e < kStepFloats) {
      x = rhs[6 * static_cast<size_t>(j) + e - 72];
    }
    v[r] = x;
  }
}

__global__ void __launch_bounds__(32)
    block_thomas_kernel(const float* __restrict__ D, const float* __restrict__ U,
                        const float* __restrict__ rhs, int m, float* __restrict__ Cs,
                        float* __restrict__ ds, float* __restrict__ x) {
  __shared__ float in[2][kStepFloats];   // step inputs by parity: step j - 1's U is U_{j-1}
  __shared__ float A[6][13];             // [S | U_j | r]
  __shared__ float C[6][6];              // C_{j-1}
  __shared__ float d[6];                 // d_{j-1}
  const int lane = threadIdx.x;

  float pre[3];
  load_step(D, U, rhs, m, 0, lane, pre);
  for (int j = 0; j < m; ++j) {
    float* cur = in[j & 1];
    const float* prev_u = in[(j + 1) & 1] + 36;   // U_{j-1}, row-major
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (lane + 32 * r < kStepFloats) cur[lane + 32 * r] = pre[r];
    }
    __syncwarp();
    if (j + 1 < m) load_step(D, U, rhs, m, j + 1, lane, pre);   // in flight during step j

    // S = D_j - U_{j-1}^T C_{j-1} and r = rhs_j - U_{j-1}^T d_{j-1}; U_j beside them
    for (int e = lane; e < 42; e += 32) {
      if (e < 36) {
        const int i = e / 6, k = e % 6;
        float s = cur[e];
        if (j > 0) {
          float t = 0.0f;
#pragma unroll
          for (int l = 0; l < 6; ++l) t += prev_u[6 * l + i] * C[l][k];
          s -= t;
        }
        A[i][k] = s;
        A[i][6 + k] = cur[36 + e];
      } else {
        const int i = e - 36;
        float s = cur[72 + i];
        if (j > 0) {
          float t = 0.0f;
#pragma unroll
          for (int l = 0; l < 6; ++l) t += prev_u[6 * l + i] * d[l];
          s -= t;
        }
        A[i][12] = s;
      }
    }
    __syncwarp();

    // elimination with partial pivoting
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      int piv = k;
      float best = fabsf(A[k][k]);
#pragma unroll
      for (int i = k + 1; i < 6; ++i) {
        const float v = fabsf(A[i][k]);
        if (v > best) {
          best = v;
          piv = i;
        }
      }
      __syncwarp();
      if (piv != k && lane >= k && lane < 13) {
        const float t = A[k][lane];
        A[k][lane] = A[piv][lane];
        A[piv][lane] = t;
      }
      __syncwarp();
      const int width = 12 - k;
      const float inv = 1.0f / A[k][k];
      for (int e = lane; e < (5 - k) * width; e += 32) {
        const int i = k + 1 + e / width, c = k + 1 + e % width;
        A[i][c] -= (A[i][k] * inv) * A[k][c];
      }
      __syncwarp();
    }

    // back substitution, one column a lane: C_j (columns 6-11), d_j (12)
    if (lane < 7) {
      const int col = 6 + lane;
      float s[6];
#pragma unroll
      for (int k = 5; k >= 0; --k) {
        float t = A[k][col];
#pragma unroll
        for (int l = k + 1; l < 6; ++l) t -= A[k][l] * s[l];
        s[k] = t / A[k][k];
      }
      if (lane < 6) {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          C[k][lane] = s[k];
          Cs[36 * static_cast<size_t>(j) + 6 * k + lane] = s[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          d[k] = s[k];
          ds[6 * static_cast<size_t>(j) + k] = s[k];
        }
      }
    }
    __syncwarp();
  }

  // backward sweep: x_{m-1} = d_{m-1}; x_j = d_j - C_j x_{j+1}; lane i < 6 holds x[i]
  const unsigned six = 0x3fu;
  if (lane < 6) {
    float xi = ds[6 * static_cast<size_t>(m - 1) + lane];
    x[6 * static_cast<size_t>(m - 1) + lane] = xi;
    float c[6], dn = 0.0f;
    if (m >= 2) {
#pragma unroll
      for (int k = 0; k < 6; ++k) c[k] = Cs[36 * static_cast<size_t>(m - 2) + 6 * lane + k];
      dn = ds[6 * static_cast<size_t>(m - 2) + lane];
    }
    for (int j = m - 2; j >= 0; --j) {
      float cj[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) cj[k] = c[k];
      const float dj = dn;
      if (j > 0) {   // row lane of step j - 1, in flight during step j
#pragma unroll
        for (int k = 0; k < 6; ++k) c[k] = Cs[36 * static_cast<size_t>(j - 1) + 6 * lane + k];
        dn = ds[6 * static_cast<size_t>(j - 1) + lane];
      }
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) t += cj[k] * __shfl_sync(six, xi, k);
      xi = dj - t;
      x[6 * static_cast<size_t>(j) + lane] = xi;
    }
  }
}

}  // namespace

extern "C" {

// K8: p, q (batch, n, 3), w (batch, n), delta (batch,), enough (batch,) bytes;
// scratch (batch, n, 8) floats; out (batch, 4, 4).
int pcr_gnc(const float* p, const float* q, const float* w, const float* delta,
            const unsigned char* enough, int batch, int n, int iterations, float mu0,
            float division_factor, int decrease_mu, float* scratch, float* out, void* stream) {
  const int smem_rows = n < kGncSmemRows ? n : kGncSmemRows;
  const size_t smem = 2 * sizeof(float4) * static_cast<size_t>(smem_rows);
  cudaError_t err = pcr::reserve_smem(gnc_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gnc_kernel<<<batch, kGncThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, q, w, delta, enough, n, iterations, mu0, division_factor, decrease_mu, smem_rows,
      reinterpret_cast<float4*>(scratch), out);
  return static_cast<int>(cudaGetLastError());
}

// K9: D (m, 6, 6), U (m-1, 6, 6), rhs (m, 6); Cs (m, 6, 6) and ds (m, 6)
// scratch for the backward sweep; x (m, 6).
int pcr_block_thomas(const float* D, const float* U, const float* rhs, int m, float* Cs,
                     float* ds, float* x, void* stream) {
  block_thomas_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(D, U, rhs, m, Cs, ds, x);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
