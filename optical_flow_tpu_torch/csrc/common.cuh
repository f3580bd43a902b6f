// Index helpers shared by the kernels' headers (update_matrices.cuh,
// polyexp.cuh, window_solve.cuh).

#pragma once

namespace oft {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Single reflection (REFLECT_101); callers guarantee n >= 2.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i;
}

}  // namespace oft
