// K13 — exact k nearest neighbours of 3-D points (ops/knn.knn_exact on the
// card: FGR's k = 200 selection features, the unfused pyramid's k = 20 / 30
// normals and outlier statistics, viz's k = 1).
//
// Replaces pcr_tpu/ops/knn.py:knn_exact, whose jax.lax.scan over ref chunks
// with jax.lax.top_k (knn.py:203-225) XLA compiles into one program; it is
// not a Pallas kernel.  The port ran it as a host loop over 512-row query
// tiles that wrote each (512, Nr) expanded-distance block to device memory
// and read it back for where, clamp, torch.topk, the exact re-score and
// torch.sort: ~290 ms a 90112-row scan at k = 200 on the H100.
//
// What it computes, for queries q (nq, 3), refs r (nr, 3) f32, a ref mask
// and k: for every query row (masked ones too) the k refs with the smallest
// key (d2, index), ascending, where d2 = ((dx*dx + dy*dy) + dz*dz) with each
// operation rounded on its own (pcr::sqdist, exact_sqdist's sum, K7's rule),
// over the valid refs other than the query's own row when exclude_self.
// Ties go to the smaller index, whatever order the refs arrive in.  Slots
// past the valid refs take d2 = BIG (3e38) and the smallest indices among
// the masked refs and the query's own row, ascending (BIG's key); slots past
// nr take (BIG, 0).
//
// Bound on the H100: FP32 throughput.  A brute-force selection scores every
// query against every valid ref: 90112 x 83637 pairs at 8 operations is
// 6.0e10, ~0.9 ms at 67 TFLOP/s; the output (nq x k x 12 bytes, 216 MB at
// k = 200) is ~0.07 ms.  This kernel scores only the ref tiles that can hold
// one of a query's k nearest, so it does a small share of that work; what
// bounds it is latency: per tile, a load from L2 and the block's barriers,
// and the candidate buffers' selections.  Design:
//   * the wrapper orders refs and queries along a 30-bit Morton curve over
//     the valid refs' bounding box (morton_kernel, then torch.argsort), masked
//     refs last, so that a block's queries are neighbours and a tile of TILE
//     consecutive valid refs is a compact box; box_kernel writes the sorted
//     rows as float4 (x, y, z, the ref's row) and each tile's box;
//   * a block of kWarps warps takes QPW consecutive queries a warp; the
//     lanes of a warp share its queries (in registers) and split each ref
//     tile, one 16-byte shared load of a ref row serving every query;
//   * each query keeps its candidates in a buffer of C 64-bit keys (d2's
//     bits above the index: d2 >= 0, so the integer order is the (d2, index)
//     order) in shared memory and tau, its k-th key once it has k.  A ref
//     under tau is appended, its slot taken from a warp ballot.  A buffer
//     within a warp step of full is cut to its k smallest by a radix select
//     (8 bits a pass, integer shared atomics on a histogram) and tau falls to
//     the k-th key.  No float atomics;
//   * the block sorts the tiles by the d2 from its middle query to each box's
//     midpoint and visits them in rounds: the first takes the nearest tiles,
//     enough for k candidates; each later one tests up to kThreads tiles at
//     once against every query's tau and visits those that some query needs,
//     in order, testing each again just before it (tau only falls).  A tile
//     is needed when its box's d2 to the query, with pcr::sqdist's
//     roundings, is at most tau: that d2 is at most the d2 of any row in the
//     box (rounding is monotone), so a skipped tile holds no ref that counts.
//     The next tile's rows are loaded into registers while the warps score
//     this one;
//   * at the end each buffer is cut to k and sorted (bitonic, by its warp),
//     so the result does not depend on the order of the tiles, the blocks or
//     the candidates.
// Geometry (kWarps, QPW queries a warp, TILE rows a tile at each C) chosen
// on the H100 by tools/tune_knn.py (PERF.md); C by k alone: the smallest of
// 64 ... 512 holding 2k + 32 keys, so a cut frees at least k + 32 slots.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kQueries = 2;                // queries a warp (tuned)
constexpr int kTileSmall = 128;            // ref rows a tile at buffers up to 256 keys (tuned)
constexpr int kTileLarge = 256;            // ... and at 512 keys (tuned)
constexpr int kMaxK = 256;                 // the largest k (ops/kernels/nn_kernels.KNN_MAX_K)
constexpr int kMortonBits = 10;            // a cell coordinate a Morton axis
constexpr int kMaskedCode = 1 << 30;       // a masked ref's code: after every valid one
constexpr float kBig = 3.0e38f;            // a slot past the valid refs (ops/knn.py's BIG)
constexpr unsigned long long kEmpty = ~0ull;

// Morton code of a point in the box lo_hi = (lo xyz, hi xyz): each axis cut
// into 2^kMortonBits cells (a flat or empty box puts every point in cell 0).
__device__ __forceinline__ unsigned spread3(unsigned x) {
  x &= 0x3ffu;
  x = (x | (x << 16)) & 0x030000ffu;
  x = (x | (x << 8)) & 0x0300f00fu;
  x = (x | (x << 4)) & 0x030c30c3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

__device__ __forceinline__ int morton(const float* __restrict__ p, const float* lo_hi) {
  unsigned code = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ext = lo_hi[3 + a] - lo_hi[a];
    const float inv = ext > 0.f ? static_cast<float>((1 << kMortonBits) - 1) / ext : 0.f;
    // NaN (an empty box) goes to cell 0: fmaxf keeps the number
    const float t = fminf(fmaxf((p[a] - lo_hi[a]) * inv, 0.f),
                          static_cast<float>((1 << kMortonBits) - 1));
    code |= spread3(static_cast<unsigned>(t)) << a;
  }
  return static_cast<int>(code);
}

// The bounding box of the valid refs, one block: lo_hi = (min xyz, max xyz).
__global__ void __launch_bounds__(1024)
    bbox_kernel(const float* __restrict__ r, const unsigned char* __restrict__ mask, int nr,
                float* __restrict__ lo_hi) {
  __shared__ float part[6][32];
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    if (!mask[i]) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = r[3 * static_cast<size_t>(i) + a];
      v[a] = fminf(v[a], x);
      v[3 + a] = fmaxf(v[3 + a], x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(0xffffffffu, v[a], off));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(0xffffffffu, v[3 + a], off));
    }
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) part[a][warp] = v[a];
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float x = part[a][0];
    for (int w = 1; w < warps; ++w) x = a < 3 ? fminf(x, part[a][w]) : fmaxf(x, part[a][w]);
    lo_hi[a] = x;
  }
}

// Each point's Morton code in the refs' box; with a mask, masked points get
// kMaskedCode.
__global__ void morton_kernel(const float* __restrict__ p, int n,
                              const unsigned char* __restrict__ mask,
                              const float* __restrict__ lo_hi, int* __restrict__ code) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  code[i] = mask != nullptr && !mask[i] ? kMaskedCode
                                        : morton(p + 3 * static_cast<size_t>(i), lo_hi);
}

// The sorted valid refs as float4 rows (x, y, z, the ref's row as int bits)
// and the box of each tile of TILE of them, one warp a tile: box[6 t ...] =
// (min xyz, max xyz).  Tiles past the valid refs are left.
template <int TILE>
__global__ void box_kernel(const float* __restrict__ r, const long long* __restrict__ rperm,
                           const int* __restrict__ n_valid, int n_tiles,
                           float4* __restrict__ rows, float* __restrict__ box) {
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int nv = *n_valid;
  if (tile >= n_tiles || tile * TILE >= nv) return;
  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int j = tile * TILE + lane; j < min((tile + 1) * TILE, nv); j += 32) {
    const long long o = rperm[j];
    const float* row = r + 3 * o;
    rows[j] = make_float4(row[0], row[1], row[2], __int_as_float(static_cast<int>(o)));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], row[a]);
      v[3 + a] = fmaxf(v[3 + a], row[a]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(0xffffffffu, v[a], off));
      v[3 + a] = fmaxf(v[3 + a], __shfl_xor_sync(0xffffffffu, v[3 + a], off));
    }
  }
  if (lane < 6) box[6 * static_cast<size_t>(tile) + lane] = v[lane];
}

// d2 from (x, y, z) to the nearest point of the box, with pcr::sqdist's
// roundings: at most the d2 of any point inside the box.
__device__ __forceinline__ float box_d2(const float* __restrict__ b, float x, float y, float z) {
  const float dx = x < b[0] ? __fsub_rn(b[0], x) : (x > b[3] ? __fsub_rn(x, b[3]) : 0.f);
  const float dy = y < b[1] ? __fsub_rn(b[1], y) : (y > b[4] ? __fsub_rn(y, b[4]) : 0.f);
  const float dz = z < b[2] ? __fsub_rn(b[2], z) : (z > b[5] ? __fsub_rn(z, b[5]) : 0.f);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned long long make_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(j);
}

// Sort the n keys of b ascending (n a power of two), by one warp.
__device__ __forceinline__ void warp_sort(unsigned long long* b, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll 4
      for (int t = lane; t < n / 2; t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long x = b[i], y = b[i + stride];
        if ((x > y) == ((i & size) == 0)) {
          b[i] = y;
          b[i + stride] = x;
        }
      }
      __syncwarp();
    }
  }
}

// The same by the whole block.
__device__ void block_sort(unsigned long long* b, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long x = b[i], y = b[i + stride];
        if ((x > y) == ((i & size) == 0)) {
          b[i] = y;
          b[i + stride] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Keep the k smallest of the cnt >= k distinct keys of b in b[0, k), in
// their order, by one warp; returns the k-th key.  A radix select, 8 bits a
// pass from the top, over the warp's 256-bin histogram h: each pass finds
// the bin holding the k-th key among the keys that share the digits found so
// far, and stops once every key of that bin is taken; then the keys below
// the bin's end are compacted.  Integer shared atomics only, aggregated over
// the lanes that share a digit.
__device__ unsigned long long select_k(unsigned long long* b, int cnt, int k, int* h, int lane) {
  const unsigned below = (1u << lane) - 1u;
  unsigned long long prefix = 0;   // the k-th key's digits found so far
  int need = k;                    // keys still to take among those that share them
  int shift = 64;
  while (true) {
    shift -= 8;
    const unsigned long long high = shift == 56 ? 0ull : ~0ull << (shift + 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[8 * lane + e] = 0;
    __syncwarp();
    for (int e0 = 0; e0 < cnt; e0 += 32) {
      const int e = e0 + lane;
      const unsigned long long key = e < cnt ? b[e] : 0ull;
      const bool in = e < cnt && (key & high) == prefix;
      const int digit = in ? static_cast<int>((key >> shift) & 255ull) : 256 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (in && (peers & below) == 0u) atomicAdd(h + digit, __popc(peers));
    }
    __syncwarp();
    int c[8], sum = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c[e] = h[8 * lane + e];
      sum += c[e];
    }
    int incl = sum;   // inclusive scan of the lanes' sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const int excl = incl - sum;
    const int owner = __ffs(__ballot_sync(0xffffffffu, excl < need && need <= incl)) - 1;
    int digit = 0, run = excl, in_bin = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (in_bin == 0 && run + c[e] >= need) {
        digit = 8 * lane + e;
        in_bin = c[e];
      } else if (in_bin == 0) {
        run += c[e];
      }
    }
    digit = __shfl_sync(0xffffffffu, digit, owner);
    in_bin = __shfl_sync(0xffffffffu, in_bin, owner);
    need -= __shfl_sync(0xffffffffu, run, owner);
    prefix |= static_cast<unsigned long long>(digit) << shift;
    __syncwarp();
    if (in_bin == need) break;   // at the last digit a bin holds one key
  }
  const unsigned long long limit = prefix + (1ull << shift);
  unsigned long long kth = 0;
  int out = 0;
  for (int e0 = 0; e0 < cnt; e0 += 32) {
    const int e = e0 + lane;
    const unsigned long long key = e < cnt ? b[e] : 0ull;
    const bool keep = e < cnt && key < limit;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    __syncwarp();
    if (keep) {
      b[out + __popc(m & below)] = key;
      kth = key > kth ? key : kth;
    }
    out += __popc(m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, kth, off);
    kth = o > kth ? o : kth;
  }
  __syncwarp();
  return kth;
}

// The warp's query state: its candidates' count, and tau = the k-th key once
// k candidates are kept (td = +inf before: every finite d2 is appended).
struct Query {
  float x, y, z;
  int row;        // the query's own (unsorted) row, -1 past nq
  int cnt;
  float td;
  int tj;
};

// Cut the buffer to its k smallest keys and lower tau to the k-th.
__device__ __forceinline__ void shrink(unsigned long long* b, Query& s, int k, int* h,
                                       int lane) {
  __syncwarp();
  const unsigned long long key = select_k(b, s.cnt, k, h, lane);
  s.cnt = k;
  s.td = __uint_as_float(static_cast<unsigned>(key >> 32));
  s.tj = static_cast<int>(key & 0xffffffffull);
}

struct SelectArgs {
  const float* q;
  const long long* qperm;   // sorted position -> query row
  int nq;
  const float4* rows;       // the sorted valid refs (x, y, z, row)
  const int* n_valid;       // valid refs (device scalar)
  const unsigned char* rmask;
  int nr;
  const float* box;
  int tile_keys;            // a power of two >= the tiles of nr refs
  int k;
  int exclude_self;
  float* out_d;
  long long* out_i;
};

// Dynamic shared memory of a block: the staged tile, the queries (x, y, z,
// tau), a round's listed tiles (box, tile), the warps' counts and
// histograms, the tiles' order keys and the candidate buffers.
template <int C, int QPW, int TILE>
constexpr size_t select_smem(int tile_keys) {
  return TILE * sizeof(float4) + kWarps * QPW * sizeof(float4) + kThreads * 7 * sizeof(float) +
         kWarps * (2 + 256) * sizeof(int) +
         sizeof(unsigned long long) * (tile_keys + kWarps * QPW * C);
}

template <int C, int QPW, int TILE>
__global__ void __launch_bounds__(kThreads) select_kernel(const SelectArgs a) {
  constexpr int QB = kWarps * QPW;
  constexpr int kRows = (TILE + kThreads - 1) / kThreads;   // staged rows a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);
  float4* qs = rows + TILE;
  float* lbox = reinterpret_cast<float*>(qs + QB);
  int* ltile = reinterpret_cast<int*>(lbox + 6 * kThreads);
  int* wcount = ltile + kThreads;
  int* hists = wcount + 2 * kWarps;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(hists + 256 * kWarps);
  unsigned long long* bufs = keys + a.tile_keys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int nv = *a.n_valid;
  const int nt = (nv + TILE - 1) / TILE;
  unsigned long long* buf = bufs + static_cast<size_t>(warp * QPW) * C;
  int* h = hists + 256 * warp;

  Query s[QPW];
#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    const int sorted = blockIdx.x * QB + warp * QPW + u;
    s[u].row = sorted < a.nq ? static_cast<int>(a.qperm[sorted]) : -1;
    const float* p = a.q + 3 * static_cast<size_t>(max(s[u].row, 0));
    s[u].x = p[0];
    s[u].y = p[1];
    s[u].z = p[2];
    s[u].cnt = 0;
    s[u].td = s[u].row >= 0 ? INFINITY : -1.f;   // a row past nq takes nothing
    s[u].tj = 0x7fffffff;
    if (lane == 0) qs[warp * QPW + u] = make_float4(s[u].x, s[u].y, s[u].z, s[u].td);
  }

  // the tiles in the order of their boxes' midpoints' d2 to the block's
  // middle query (a tile whose box is large for its rows comes late)
  {
    const float* c = a.q + 3 * a.qperm[min(blockIdx.x * QB + QB / 2, a.nq - 1)];
    for (int t = threadIdx.x; t < a.tile_keys; t += kThreads) {
      unsigned long long key = kEmpty;
      if (t < nt) {
        const float* b = a.box + 6 * static_cast<size_t>(t);
        key = make_key(pcr::sqdist(c[0], c[1], c[2], 0.5f * (b[0] + b[3]), 0.5f * (b[1] + b[4]),
                                   0.5f * (b[2] + b[5])),
                       t);
      }
      keys[t] = key;
    }
    __syncthreads();
    block_sort(keys, a.tile_keys);
  }

  float4 pre[kRows];   // the next tile's rows, loaded while the warps score this one
  auto load = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int f = threadIdx.x + i * kThreads;
      const int j = tile * TILE + f;
      // past the valid refs: NaN, whose d2 passes no compare
      pre[i] = f < TILE && j < nv ? a.rows[j] : make_float4(NAN, NAN, NAN, __int_as_float(0));
    }
  };

  // rounds: the first takes the nearest tiles, enough for k candidates; each
  // later one tests up to kThreads tiles against every query's tau at once
  // and visits those that some query needs, in order
  int pos = 0, len = min(nt, (a.k + TILE) / TILE + 1);
  while (pos < nt) {
#pragma unroll
    for (int u = 0; u < QPW; ++u) {   // a query with k candidates takes its tau now
      if (s[u].cnt >= a.k && s[u].td == INFINITY) shrink(buf + u * C, s[u], a.k, h, lane);
      if (lane == 0) qs[warp * QPW + u].w = s[u].td;
    }
    __syncthreads();
    bool need = false;
    int t = 0;
    float b[6];
    if (static_cast<int>(threadIdx.x) < len && pos + static_cast<int>(threadIdx.x) < nt) {
      t = static_cast<int>(keys[pos + threadIdx.x] & 0xffffffffull);
#pragma unroll
      for (int e = 0; e < 6; ++e) b[e] = a.box[6 * static_cast<size_t>(t) + e];
      for (int v = 0; v < QB; ++v) {
        const float4 p = qs[v];
        need |= box_d2(b, p.x, p.y, p.z) <= p.w;
      }
    }
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int first = 0, listed = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      first += w < warp ? wcount[w] : 0;
      listed += wcount[w];
    }
    if (need) {
      const int e = first + __popc(m & below);
      ltile[e] = t;
#pragma unroll
      for (int f = 0; f < 6; ++f) lbox[6 * e + f] = b[f];
    }
    __syncthreads();
    int loaded = -1;   // the list entry whose rows are in pre
    for (int e = 0; e < listed; ++e) {
      bool want = false;   // tau may have fallen since the round's test
#pragma unroll
      for (int u = 0; u < QPW; ++u) want |= box_d2(lbox + 6 * e, s[u].x, s[u].y, s[u].z) <= s[u].td;
      if (!__syncthreads_or(want)) continue;
      if (loaded != e) load(ltile[e]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int f = threadIdx.x + i * kThreads;
        if (f < TILE) rows[f] = pre[i];
      }
      __syncthreads();
      if (e + 1 < listed) {
        load(ltile[e + 1]);
        loaded = e + 1;
      }
      for (int j0 = 0; j0 < TILE; j0 += 32) {
        const float4 p = rows[j0 + lane];
        float d[QPW];
        bool any = false;
#pragma unroll
        for (int u = 0; u < QPW; ++u) {
          d[u] = pcr::sqdist(s[u].x, s[u].y, s[u].z, p.x, p.y, p.z);
          any |= d[u] <= s[u].td;
        }
        if (!__any_sync(0xffffffffu, any)) continue;
        const int j = __float_as_int(p.w);
#pragma unroll
        for (int u = 0; u < QPW; ++u) {
          const bool take = d[u] <= s[u].td && (d[u] < s[u].td || j < s[u].tj) &&
                            !(a.exclude_self && j == s[u].row);
          const unsigned mt = __ballot_sync(0xffffffffu, take);
          if (mt == 0u) continue;
          unsigned long long* bu = buf + u * C;
          if (take) bu[s[u].cnt + __popc(mt & below)] = make_key(d[u], j);
          s[u].cnt += __popc(mt);
          if (s[u].cnt > C - 32) shrink(bu, s[u], a.k, h, lane);
        }
      }
      __syncthreads();
    }
    pos += len;
    len = kThreads;
  }

#pragma unroll
  for (int u = 0; u < QPW; ++u) {
    if (s[u].row < 0) continue;
    unsigned long long* bu = buf + u * C;
    if (s[u].cnt > a.k) shrink(bu, s[u], a.k, h, lane);
    int n = 32;
    while (n < s[u].cnt) n <<= 1;
    for (int e = s[u].cnt + lane; e < n; e += 32) bu[e] = kEmpty;
    __syncwarp();
    warp_sort(bu, n, lane);
    const size_t out = static_cast<size_t>(s[u].row) * a.k;
    for (int e = lane; e < s[u].cnt; e += 32) {
      const unsigned long long key = bu[e];
      a.out_d[out + e] = __uint_as_float(static_cast<unsigned>(key >> 32));
      a.out_i[out + e] = static_cast<long long>(key & 0xffffffffull);
    }
    // fewer valid refs than k: the masked refs and the query's own row, ascending
    int filled = s[u].cnt;
    for (int j0 = 0; j0 < a.nr && filled < a.k; j0 += 32) {
      const int j = j0 + lane;
      const bool f = j < a.nr && (!a.rmask[j] || (a.exclude_self && j == s[u].row));
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int e = filled + __popc(m & below);
      if (f && e < a.k) {
        a.out_d[out + e] = kBig;
        a.out_i[out + e] = j;
      }
      filled += __popc(m);
    }
    for (int e = filled + lane; e < a.k; e += 32) {   // k > nr
      a.out_d[out + e] = kBig;
      a.out_i[out + e] = 0;
    }
  }
}

template <int C, int QPW, int TILE>
cudaError_t launch_select(SelectArgs a, const float* r, const long long* rperm, float4* rows,
                          float* box, cudaStream_t stream) {
  constexpr int QB = kWarps * QPW;
  const int n_tiles = (a.nr + TILE - 1) / TILE;
  a.tile_keys = 1;
  while (a.tile_keys < n_tiles) a.tile_keys <<= 1;
  const size_t smem = select_smem<C, QPW, TILE>(a.tile_keys);
  int device = 0, most = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(most)) return cudaErrorInvalidValue;   // nr too large
  box_kernel<TILE><<<(n_tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      r, rperm, a.n_valid, n_tiles, rows, box);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = pcr::reserve_smem(select_kernel<C, QPW, TILE>, smem);
  if (err != cudaSuccess) return err;
  select_kernel<C, QPW, TILE><<<(a.nq + QB - 1) / QB, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// K13 at one geometry: QPW queries a warp, TILE_SMALL ref rows a tile where
// k takes a buffer of at most 256 keys, TILE_LARGE where it takes 512.
template <int QPW, int TILE_SMALL, int TILE_LARGE>
cudaError_t select_at(const SelectArgs& a, const float* r, const long long* rperm,
                      float4* rows, float* box, cudaStream_t stream) {
  if (a.k < 1 || a.k > kMaxK) return cudaErrorInvalidValue;
  if (2 * a.k + 32 <= 64) {
    return launch_select<64, QPW, TILE_SMALL>(a, r, rperm, rows, box, stream);
  }
  if (2 * a.k + 32 <= 128) {
    return launch_select<128, QPW, TILE_SMALL>(a, r, rperm, rows, box, stream);
  }
  if (2 * a.k + 32 <= 256) {
    return launch_select<256, QPW, TILE_SMALL>(a, r, rperm, rows, box, stream);
  }
  return launch_select<512, QPW, TILE_LARGE>(a, r, rperm, rows, box, stream);
}

}  // namespace

// Morton codes for K13's order.  r (nr, 3) f32 with its bool mask; q (nq, 3)
// f32 or null; lo_hi (6,) f32 scratch.  Writes rcode (nr,) int32 (masked
// refs kMaskedCode) and, if q, qcode (nq,) int32, both in the valid refs'
// bounding box.  The wrapper guarantees nr >= 1.
extern "C" int pcr_knn_morton(const float* r, const unsigned char* rmask, int nr, const float* q,
                              int nq, float* lo_hi, int* rcode, int* qcode,
                              cudaStream_t stream) {
  bbox_kernel<<<1, 1024, 0, stream>>>(r, rmask, nr, lo_hi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  morton_kernel<<<(nr + 255) / 256, 256, 0, stream>>>(r, nr, rmask, lo_hi, rcode);
  err = cudaGetLastError();
  if (err != cudaSuccess || q == nullptr || nq == 0) return static_cast<int>(err);
  morton_kernel<<<(nq + 255) / 256, 256, 0, stream>>>(q, nq, nullptr, lo_hi, qcode);
  return static_cast<int>(cudaGetLastError());
}

// K13 over the sorted orders: q (nq, 3), r (nr, 3) f32; qperm (nq,), rperm
// (nr,) int64 sorted position -> row, the valid refs first; n_valid a
// device int32; rmask (nr,) bool; rows (nr,) float4 and box (ceil(nr / 64)
// x 6) f32 scratch (no geometry tools/tune_knn.py tries takes fewer tile
// rows).  Writes out_d (nq, k) f32 and out_i (nq, k) int64.  Refused (an
// error, nothing launched) where a block's shared memory cannot hold the
// tiles' order keys at this nr.  The wrapper guarantees nq >= 1, nr >= 1
// and 1 <= k <= kMaxK.
extern "C" int pcr_knn_select(const float* q, const long long* qperm, int nq, const float* r,
                              const long long* rperm, const int* n_valid,
                              const unsigned char* rmask, int nr, int k, int exclude_self,
                              float* rows, float* box, float* out_d, long long* out_i,
                              cudaStream_t stream) {
  float4* rows4 = reinterpret_cast<float4*>(rows);
  const SelectArgs a{q, qperm, nq, rows4, n_valid, rmask, nr, box, 0,
                     k, exclude_self, out_d, out_i};
  return static_cast<int>(
      select_at<kQueries, kTileSmall, kTileLarge>(a, r, rperm, rows4, box, stream));
}
