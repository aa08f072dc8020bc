// Shared helpers for the hand-written Hopper kernels of pcr_tpu_torch.
#pragma once

#include <cuda_runtime.h>

namespace pcr {

// Any query-candidate pair with d2 above this involves a PAD_COORD sentinel.
constexpr float kRealD2Max = 1.0e10f;

// Squared distance as ((dx*dx + dy*dy) + dz*dz) with every operation rounded
// on its own (no FMA contraction), so it is bit-identical to the plain
// PyTorch versions, which evaluate the same expression one op at a time.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

}  // namespace pcr
