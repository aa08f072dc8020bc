// voxel_counts — the occupied-voxel counts of the multiscale pyramid's
// capacity planner (utils/cloud.plan_scale_caps), every cloud and scale of a
// chunk in one call.
//
// Replaces no TPU kernel: pcr_tpu plans on the host
// (pcr_tpu/utils/cloud.py plan_scale_caps over native.count_voxels), and so
// did the port, one std::sort of ~24k keys a (cloud, scale) after copying
// every cloud from the card (native/pcd_io.cc pcr_count_voxels).  The count
// must equal that function's bit for bit, since the caps it sets decide
// every pyramid's compaction and so every pose:
//   * mn: the cloud's minimum over its valid rows, axis by axis;
//   * c = (long long) floorf((p - mn) / v), in float32 with IEEE division
//     (the build has no fast-math flag) and nothing to contract into an FMA;
//   * key = ((c0 & 0x1FFFFF) << 42) | ((c1 & 0x1FFFFF) << 21) | (c2 & 0x1FFFFF);
//   * the number of distinct keys over the valid rows; 0 for an empty cloud.
// (Where (p - mn) / v leaves the range of a 64-bit integer the two casts
// differ, the host's giving INT64_MIN and the card's saturating; no finite
// cloud of this repository comes near 2^63 voxels.)
//
// Bound on the H100: bytes and latency.  The work is one read of the points
// and masks (13 bytes a row) and one hash insertion a (row, scale); at 32
// NCLT clouds and 5 scales that is ~4 us of bytes at 3.35 TB/s.  Design:
//   * min_kernel: one block a cloud reduces its valid rows' minimum with
//     fminf (order-free, so exact) through shuffles and shared memory;
//   * insert_kernel: one thread a row, grid (row tiles, scales, clouds).
//     Each (cloud, scale) owns an open-addressing table of 2^slots_log2
//     64-bit keys in global scratch, at least twice the cloud's rows, so its
//     load stays under one half; empty slots are all ones, which no key
//     (63 bits) equals.  A key is placed by atomicCAS with linear probing
//     from its fmix64 hash; the thread whose CAS claims an empty slot counts
//     1, __syncthreads_count sums the block's claims and one 64-bit
//     atomicAdd adds them to the (cloud, scale) count.  Integer atomics:
//     the count does not depend on the order of the insertions.
//   * Row tiles run fastest in the grid, so the blocks in flight fill a few
//     tables at a time and a cloud's rows are re-read from L2 for its
//     scales.  The wrapper sizes the chunks so that the tables stay within
//     its scratch budget, and each call clears its tables and counts with
//     two memsets on the stream before the two kernels.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxClouds = 64;     // clouds a call (the wrapper's chunk)
constexpr int kMaxScales = 8;
constexpr int kMinThreads = 512;
constexpr int kInsertThreads = 256;
constexpr unsigned long long kEmpty = ~0ull;
constexpr long long kField = 0x1FFFFF;   // 21 bits a coordinate

// The clouds of one call, passed by value (~1.3 KB of kernel parameters).
struct Chunk {
  const float* points[kMaxClouds];        // (rows, 3) float32
  const unsigned char* mask[kMaxClouds];  // (rows,) bool; nullptr: every row valid
  int rows[kMaxClouds];
  float scale[kMaxScales];
};

__global__ void __launch_bounds__(kMinThreads)
    min_kernel(const Chunk chunk, float* __restrict__ mins) {
  __shared__ float part[3][kMinThreads / 32];
  const int cloud = blockIdx.x, rows = chunk.rows[cloud];
  const float* p = chunk.points[cloud];
  const unsigned char* m = chunk.mask[cloud];
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  for (int i = threadIdx.x; i < rows; i += kMinThreads) {
    if (m == nullptr || m[i]) {
#pragma unroll
      for (int d = 0; d < 3; d++) mn[d] = fminf(mn[d], p[3 * static_cast<size_t>(i) + d]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 0; d < 3; d++) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn[d] = fminf(mn[d], __shfl_xor_sync(0xffffffffu, mn[d], off));
    if (lane == 0) part[d][warp] = mn[d];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float lo = INFINITY;
    for (int w = 0; w < kMinThreads / 32; w++) lo = fminf(lo, part[threadIdx.x][w]);
    mins[3 * cloud + threadIdx.x] = lo;
  }
}

// MurmurHash3's 64-bit finaliser.
__device__ __forceinline__ unsigned long long fmix64(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

__global__ void __launch_bounds__(kInsertThreads)
    insert_kernel(const Chunk chunk, const float* __restrict__ mins, int slots_log2,
                  unsigned long long* __restrict__ tables, unsigned long long* __restrict__ counts) {
  const int cloud = blockIdx.z, s = blockIdx.y;
  const int i = blockIdx.x * kInsertThreads + threadIdx.x;
  const unsigned char* m = chunk.mask[cloud];
  int claimed = 0;
  if (i < chunk.rows[cloud] && (m == nullptr || m[i])) {
    const float* p = chunk.points[cloud] + 3 * static_cast<size_t>(i);
    const float v = chunk.scale[s];
    unsigned long long key = 0;
#pragma unroll
    for (int d = 0; d < 3; d++) {
      const long long c = static_cast<long long>(floorf((p[d] - mins[3 * cloud + d]) / v));
      key = (key << 21) | static_cast<unsigned long long>(c & kField);
    }
    const size_t table = static_cast<size_t>(cloud) * gridDim.y + s;
    unsigned long long* t = tables + (table << slots_log2);
    const unsigned long long last = (1ull << slots_log2) - 1;
    for (unsigned long long slot = fmix64(key) & last;; slot = (slot + 1) & last) {
      const unsigned long long seen = atomicCAS(t + slot, kEmpty, key);
      if (seen == kEmpty) {
        claimed = 1;
        break;
      }
      if (seen == key) break;
    }
  }
  const int n = __syncthreads_count(claimed);
  if (threadIdx.x == 0 && n > 0)
    atomicAdd(counts + static_cast<size_t>(cloud) * gridDim.y + s,
              static_cast<unsigned long long>(n));
}

}  // namespace

// points, masks: host arrays of n_clouds device pointers (a mask may be
// null); rows: host array of each cloud's rows; scales: host array of
// n_scales voxel sizes.  tables: n_clouds * n_scales * 2^slots_log2 keys of
// scratch, 2^slots_log2 >= 2 * every cloud's rows; mins: n_clouds * 3
// floats of scratch; counts: (n_clouds, n_scales) int64, written.
extern "C" int pcr_voxel_counts(const void* const* points, const void* const* masks,
                                const int* rows, int n_clouds, const float* scales,
                                int n_scales, int slots_log2, unsigned long long* tables,
                                float* mins, unsigned long long* counts, cudaStream_t stream) {
  if (n_clouds < 1 || n_clouds > kMaxClouds || n_scales < 1 || n_scales > kMaxScales)
    return static_cast<int>(cudaErrorInvalidValue);
  Chunk chunk = {};
  int max_rows = 0;
  for (int k = 0; k < n_clouds; k++) {
    chunk.points[k] = static_cast<const float*>(points[k]);
    chunk.mask[k] = static_cast<const unsigned char*>(masks[k]);
    chunk.rows[k] = rows[k];
    if (rows[k] > max_rows) max_rows = rows[k];
  }
  for (int s = 0; s < n_scales; s++) chunk.scale[s] = scales[s];
  const size_t n_tables = static_cast<size_t>(n_clouds) * n_scales;
  cudaError_t err = cudaMemsetAsync(counts, 0, n_tables * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_rows == 0) return static_cast<int>(cudaSuccess);
  err = cudaMemsetAsync(tables, 0xFF, (n_tables << slots_log2) * sizeof(unsigned long long),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  min_kernel<<<n_clouds, kMinThreads, 0, stream>>>(chunk, mins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((max_rows + kInsertThreads - 1) / kInsertThreads, n_scales, n_clouds);
  insert_kernel<<<grid, kInsertThreads, 0, stream>>>(chunk, mins, slots_log2, tables, counts);
  return static_cast<int>(cudaGetLastError());
}
