// K12 — the pose graph's edge Jacobians and Gauss-Newton blocks, and their
// assembly into the normal equations in a fixed order.
//
// Replaces pcr_tpu/models/global_refine/pose_graph.py:_edge_jacobians
// (line 100, jax.vmap(jax.jacfwd(...)) of the edge residual) and the
// assembly of the blocks into the dense system or the circuit's bands
// (lines 243-266), which XLA compiles into the LM's lax.while_loop.  The
// port computed them with 12 vmapped torch.func.jvp calls and a few dozen
// batched 6x6 products, ~30 ms of host launches an LM iteration at n = 901,
// and summed them with index_add_ / index_put_(accumulate=True), which on
// the card add with float atomics in an order that may change from run to
// run.
//
// Launch 1, edge_blocks_kernel, one thread an edge: the residual
//   r = log(T_edge^-1 X_j^-1 X_i)   (se3_log of utils/se3.py, (omega, t))
// and its 12 directional derivatives at delta = 0 of
//   r(exp(delta_i) X_i, exp(delta_j) X_j)
// in forward mode, one direction at a time with dual numbers (value,
// tangent): jacfwd's function, so both packages linearise the same thing.
// At delta = 0 the tangent of exp(delta) X is hat(e_k) X exactly.  The
// rest runs through the inverse, the products and se3_log with the primal's
// branches (from_rotation_matrix's largest denominator, so3_log's
// vn < 1e-6, se3_log's theta2 < 1e-12), and torch's tangent rules: a branch
// passes its own tangent, a clamp passes it where the input is not below
// the bound, the norm of a zero vector has tangent 0.  So at zero residual
// (the odometry edges at a chain's start) no NaN or inf appears.  Then, with
// W = l * mask * Info, LJ = W J and
//   H_ii = J_i^T LJ_i, H_jj = J_j^T LJ_j, H_ij = J_i^T LJ_j,
//   b_i = LJ_i^T r, b_j = LJ_j^T r,
// as models/global_refine/pose_graph._edge_blocks forms them.
//
// Launch 2, the assembly, one thread an output element: each node's (or
// node pair's) contributions were sorted once a graph by (target, kind,
// edge), kind being H_ii before H_jj (and, for the dense H, H_ij before
// H_ij^T), b_i before b_j.  A thread adds its target's terms to 0 in that
// order, one rounding a term: the order of the CPU's sequential index_add_
// and of pcr_tpu's .at[].add chain.  So the card's assembly gives the bits of
// the CPU's plain assembly of the same blocks, run after run, and no float
// atomic is used.  The circuit's bands keep _build_tridiag's rule: only
// (i, i+1) couplings enter the super-diagonal.
//
// Bound on the H100: latency.  The work is ~10,700 FP32 operations an edge
// (12 dual passes of ~700 and the 6x6 products), ~0.15 us of the card's
// peak at E = 901, and the bytes ~0.7 MB, ~0.2 us; one thread walks its
// edge's chain of dependent operations.  One thread an edge keeps the
// kernel simple; 12 lanes an edge, one a direction, is the later lever.
#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Dual {
  float v;  // value
  float d;  // tangent
};

__device__ __forceinline__ Dual cst(float v) { return {v, 0.f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.v * b.d + a.d * b.v};
}
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return {s, a.d / (2.f * s)};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), cosf(a.v) * a.d}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -sinf(a.v) * a.d}; }
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}
// torch.clamp(a, min=lo): the tangent passes where a >= lo
__device__ __forceinline__ Dual dclamp_min(Dual a, float lo) {
  return a.v >= lo ? a : Dual{lo, 0.f};
}
// torch.linalg.norm of a 3-vector: tangent 0 at the zero vector
__device__ __forceinline__ Dual dnorm3(Dual x, Dual y, Dual z) {
  const Dual s = (x * x + y * y) + z * z;
  if (s.v == 0.f) return {0.f, 0.f};
  return dsqrt(s);
}

// A rigid transform's top three rows: R (3x3) and t (3).
struct Pose {
  Dual R[3][3];
  Dual t[3];
};

__device__ __forceinline__ Pose compose(const Pose& a, const Pose& b) {
  Pose c;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c.R[r][k] = (a.R[r][0] * b.R[0][k] + a.R[r][1] * b.R[1][k]) + a.R[r][2] * b.R[2][k];
    }
    c.t[r] = ((a.R[r][0] * b.t[0] + a.R[r][1] * b.t[1]) + a.R[r][2] * b.t[2]) + a.t[r];
  }
  return c;
}

// utils/se3.invert: (R^T, -R^T t)
__device__ __forceinline__ Pose invert(const Pose& a) {
  Pose c;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) c.R[r][k] = a.R[k][r];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    c.t[r] = -((c.R[r][0] * a.t[0] + c.R[r][1] * a.t[1]) + c.R[r][2] * a.t[2]);
  }
  return c;
}

__device__ __forceinline__ Pose load_pose(const float* __restrict__ T) {
  Pose p;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.R[r][k] = cst(T[4 * r + k]);
    p.t[r] = cst(T[4 * r + 3]);
  }
  return p;
}

// The tangent of exp(delta) X at delta = 0 along the basis twist e_dir
// (omega first, then t): hat(e_dir) X, exact (one +-1 a row).
__device__ __forceinline__ void perturb(Pose& X, int dir) {
  if (dir < 3) {
    // skew(e_dir) X: rows (a, b) = (y, z), (z, x), (x, y) of dir x, y, z
    const int a = (dir + 1) % 3, b = (dir + 2) % 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      X.R[a][k].d = -X.R[b][k].v;
      X.R[b][k].d = X.R[a][k].v;
    }
    X.t[a].d = -X.t[b].v;
    X.t[b].d = X.t[a].v;
  } else {
    X.t[dir - 3].d = 1.f;
  }
}

// utils/quaternion.from_rotation_matrix followed by utils/se3.so3_log
__device__ void so3_log(const Dual (&m)[3][3], Dual (&omega)[3]) {
  const Dual one = cst(1.f);
  const Dual tr = (m[0][0] + m[1][1]) + m[2][2];
  const float dens[4] = {1.f + tr.v, ((1.f + m[0][0].v) - m[1][1].v) - m[2][2].v,
                         ((1.f - m[0][0].v) + m[1][1].v) - m[2][2].v,
                         ((1.f - m[0][0].v) - m[1][1].v) + m[2][2].v};
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) best = dens[k] > dens[best] ? k : best;  // argmax: the first
  Dual c[4];
  if (best == 0) {
    c[0] = one + tr;
    c[1] = m[2][1] - m[1][2];
    c[2] = m[0][2] - m[2][0];
    c[3] = m[1][0] - m[0][1];
  } else if (best == 1) {
    c[0] = m[2][1] - m[1][2];
    c[1] = ((one + m[0][0]) - m[1][1]) - m[2][2];
    c[2] = m[0][1] + m[1][0];
    c[3] = m[0][2] + m[2][0];
  } else if (best == 2) {
    c[0] = m[0][2] - m[2][0];
    c[1] = m[0][1] + m[1][0];
    c[2] = ((one - m[0][0]) + m[1][1]) - m[2][2];
    c[3] = m[1][2] + m[2][1];
  } else {
    c[0] = m[1][0] - m[0][1];
    c[1] = m[0][2] + m[2][0];
    c[2] = m[1][2] + m[2][1];
    c[3] = ((one - m[0][0]) - m[1][1]) + m[2][2];
  }
  // qnormalize: c / clamp(|c|, 1e-12); |c| >= 2 here
  const Dual nrm = dclamp_min(dsqrt(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + c[3] * c[3]),
                              1e-12f);
  Dual q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = c[k] / nrm;
  if (q[0].v < 0.f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
  }
  const Dual vn = dnorm3(q[1], q[2], q[3]);
  const Dual theta = 2.f * datan2(vn, q[0]);
  const Dual scale = vn.v < 1e-6f ? cst(2.f) / dclamp_min(q[0], 1e-32f)
                                  : theta / dclamp_min(vn, 1e-32f);
#pragma unroll
  for (int k = 0; k < 3; ++k) omega[k] = scale * q[k + 1];
}

// utils/se3.se3_log of M: (omega, V^-1 t)
__device__ void se3_log(const Pose& M, Dual (&r)[6]) {
  Dual omega[3];
  so3_log(M.R, omega);
  const Dual theta2 = (omega[0] * omega[0] + omega[1] * omega[1]) + omega[2] * omega[2];
  const Dual theta = dsqrt(dclamp_min(theta2, 1e-32f));
  Dual cot;
  if (theta2.v < 1e-12f) {
    cot = cst(1.f / 12.f) + theta2 / cst(720.f);
  } else {
    const Dual half = theta / cst(2.f);
    cot = (cst(1.f) - half * dcos(half) / dclamp_min(dsin(half), 1e-32f)) /
          dclamp_min(theta2, 1e-32f);
  }
  const Dual zero = cst(0.f);
  const Dual K[3][3] = {{zero, -omega[2], omega[1]},
                        {omega[2], zero, -omega[0]},
                        {-omega[1], omega[0], zero}};
  Dual V[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const Dual KK = (K[a][0] * K[0][b] + K[a][1] * K[1][b]) + K[a][2] * K[2][b];
      V[a][b] = (cst(a == b ? 1.f : 0.f) - 0.5f * K[a][b]) + cot * KK;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r[a] = omega[a];
    r[3 + a] = (V[a][0] * M.t[0] + V[a][1] * M.t[1]) + V[a][2] * M.t[2];
  }
}

__global__ void edge_blocks_kernel(const float* __restrict__ nodes, const int* __restrict__ src,
                                   const int* __restrict__ dst, const float* __restrict__ edge_T,
                                   const float* __restrict__ info, const float* __restrict__ w,
                                   int n_edges, float* __restrict__ Hii, float* __restrict__ Hjj,
                                   float* __restrict__ Hij, float* __restrict__ bi,
                                   float* __restrict__ bj) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const Pose Xi = load_pose(nodes + 16 * static_cast<size_t>(src[e]));
  const Pose Xj = load_pose(nodes + 16 * static_cast<size_t>(dst[e]));
  const Pose Tinv = invert(load_pose(edge_T + 16 * static_cast<size_t>(e)));
  float J[6][12], r[6];
#pragma unroll 1
  for (int dir = 0; dir < 12; ++dir) {
    Pose Yi = Xi, Yj = Xj;
    perturb(dir < 6 ? Yi : Yj, dir % 6);
    Dual res[6];
    se3_log(compose(compose(Tinv, invert(Yj)), Yi), res);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      J[a][dir] = res[a].d;
      r[a] = res[a].v;
    }
  }
  // W = (l * mask) * Info, LJ = W J (6 x 12)
  const float* I = info + 36 * static_cast<size_t>(e);
  const float we = w[e];
  float LJ[6][12];
#pragma unroll 1
  for (int a = 0; a < 6; ++a) {
    float Wa[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) Wa[b] = we * I[6 * a + b];
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) s += Wa[b] * J[b][c];
      LJ[a][c] = s;
    }
  }
  const size_t o36 = 36 * static_cast<size_t>(e), o6 = 6 * static_cast<size_t>(e);
#pragma unroll 1
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float ii = 0.f, jj = 0.f, ij = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        ii += J[b][a] * LJ[b][c];
        jj += J[b][6 + a] * LJ[b][6 + c];
        ij += J[b][a] * LJ[b][6 + c];
      }
      Hii[o36 + 6 * a + c] = ii;
      Hjj[o36 + 6 * a + c] = jj;
      Hij[o36 + 6 * a + c] = ij;
    }
    float gi = 0.f, gj = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      gi += LJ[b][a] * r[b];
      gj += LJ[b][6 + a] * r[b];
    }
    bi[o6 + a] = gi;
    bj[o6 + a] = gj;
  }
}

constexpr int kBandSlots = 36 + 36 + 6;  // diag, off and b elements of a node

// One thread a (node, slot): diag (slots 0-35), off (36-71), b (72-77).
// node_ent[node_off[p] .. node_off[p+1]) = 2 e + kind, sorted by (kind, e);
// kind 0: p is the edge's source (H_ii, H_ij, b_i), 1: its target (H_jj, b_j).
__global__ void assemble_band_kernel(const float* __restrict__ Hii, const float* __restrict__ Hjj,
                                     const float* __restrict__ Hij, const float* __restrict__ bi,
                                     const float* __restrict__ bj, const int* __restrict__ src,
                                     const int* __restrict__ dst, const int* __restrict__ node_off,
                                     const int* __restrict__ node_ent, int n,
                                     float* __restrict__ diag, float* __restrict__ off,
                                     float* __restrict__ b) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * kBandSlots) return;
  const int p = idx / kBandSlots;
  const int s = idx - p * kBandSlots;
  const int lo = node_off[p], hi = node_off[p + 1];
  float acc = 0.f;
  if (s < 36) {
    for (int k = lo; k < hi; ++k) {
      const int e = node_ent[k] >> 1;
      acc = __fadd_rn(acc, ((node_ent[k] & 1) ? Hjj : Hii)[36 * static_cast<size_t>(e) + s]);
    }
    diag[36 * static_cast<size_t>(p) + s] = acc;
  } else if (s < 72) {
    for (int k = lo; k < hi; ++k) {
      const int e = node_ent[k] >> 1;
      if ((node_ent[k] & 1) == 0 && dst[e] == src[e] + 1) {
        acc = __fadd_rn(acc, Hij[36 * static_cast<size_t>(e) + (s - 36)]);
      }
    }
    off[36 * static_cast<size_t>(p) + (s - 36)] = acc;
  } else {
    for (int k = lo; k < hi; ++k) {
      const int e = node_ent[k] >> 1;
      acc = __fadd_rn(acc, ((node_ent[k] & 1) ? bj : bi)[6 * static_cast<size_t>(e) + (s - 72)]);
    }
    b[6 * static_cast<size_t>(p) + (s - 72)] = acc;
  }
}

// One thread an element of the dense (6n, 6n) H, then one an element of
// b (6n).  block_ent[block_off[t] .. block_off[t+1]) = 4 e + kind for the
// node pair t = p n + q, sorted by (kind, e); kinds H_ii, H_jj, H_ij, H_ij^T.
__global__ void assemble_dense_kernel(const float* __restrict__ Hii, const float* __restrict__ Hjj,
                                      const float* __restrict__ Hij, const float* __restrict__ bi,
                                      const float* __restrict__ bj,
                                      const int* __restrict__ block_off,
                                      const int* __restrict__ block_ent,
                                      const int* __restrict__ node_off,
                                      const int* __restrict__ node_ent, int n,
                                      float* __restrict__ H, float* __restrict__ b) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long side = 6LL * n;
  float acc = 0.f;
  if (idx < side * side) {
    const int row = static_cast<int>(idx / side), col = static_cast<int>(idx - row * side);
    const int p = row / 6, a = row - 6 * p, q = col / 6, c = col - 6 * q;
    const long long t = static_cast<long long>(p) * n + q;
    for (int k = block_off[t]; k < block_off[t + 1]; ++k) {
      const size_t e = static_cast<size_t>(block_ent[k] >> 2);
      const int kind = block_ent[k] & 3;
      const float v = kind == 0   ? Hii[36 * e + 6 * a + c]
                      : kind == 1 ? Hjj[36 * e + 6 * a + c]
                      : kind == 2 ? Hij[36 * e + 6 * a + c]
                                  : Hij[36 * e + 6 * c + a];
      acc = __fadd_rn(acc, v);
    }
    H[idx] = acc;
  } else if (idx < side * side + side) {
    const int i = static_cast<int>(idx - side * side);
    const int p = i / 6, s = i - 6 * p;
    for (int k = node_off[p]; k < node_off[p + 1]; ++k) {
      const size_t e = static_cast<size_t>(node_ent[k] >> 1);
      acc = __fadd_rn(acc, ((node_ent[k] & 1) ? bj : bi)[6 * e + s]);
    }
    b[i] = acc;
  }
}

constexpr int kEdgeThreads = 64;
constexpr int kAssembleThreads = 256;

}  // namespace

// nodes (n, 4, 4), edge_T (E, 4, 4), info (E, 6, 6), w (E,) f32; src, dst
// (E,) int32.  Writes Hii, Hjj, Hij (E, 6, 6) and bi, bj (E, 6).  E >= 1.
extern "C" int pcr_edge_blocks(const float* nodes, const int* src, const int* dst,
                               const float* edge_T, const float* info, const float* w,
                               int n_edges, float* Hii, float* Hjj, float* Hij, float* bi,
                               float* bj, cudaStream_t stream) {
  edge_blocks_kernel<<<(n_edges + kEdgeThreads - 1) / kEdgeThreads, kEdgeThreads, 0, stream>>>(
      nodes, src, dst, edge_T, info, w, n_edges, Hii, Hjj, Hij, bi, bj);
  return static_cast<int>(cudaGetLastError());
}

// The circuit's bands: diag, off (n, 6, 6) and b (n, 6) from the blocks.
extern "C" int pcr_assemble_band(const float* Hii, const float* Hjj, const float* Hij,
                                 const float* bi, const float* bj, const int* src, const int* dst,
                                 const int* node_off, const int* node_ent, int n, float* diag,
                                 float* off, float* b, cudaStream_t stream) {
  const int total = n * kBandSlots;
  assemble_band_kernel<<<(total + kAssembleThreads - 1) / kAssembleThreads, kAssembleThreads, 0,
                         stream>>>(Hii, Hjj, Hij, bi, bj, src, dst, node_off, node_ent, n, diag,
                                   off, b);
  return static_cast<int>(cudaGetLastError());
}

// The dense H (6n, 6n) and b (6n) from the blocks.
extern "C" int pcr_assemble_dense(const float* Hii, const float* Hjj, const float* Hij,
                                  const float* bi, const float* bj, const int* block_off,
                                  const int* block_ent, const int* node_off, const int* node_ent,
                                  int n, float* H, float* b, cudaStream_t stream) {
  const long long total = 36LL * n * n + 6LL * n;
  const long long blocks = (total + kAssembleThreads - 1) / kAssembleThreads;
  assemble_dense_kernel<<<static_cast<unsigned>(blocks), kAssembleThreads, 0, stream>>>(
      Hii, Hjj, Hij, bi, bj, block_off, block_ent, node_off, node_ent, n, H, b);
  return static_cast<int>(cudaGetLastError());
}
