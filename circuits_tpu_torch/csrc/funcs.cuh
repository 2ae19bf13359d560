// The CUfunction handles of a source's kernels, by which the kernel nodes of a
// captured CUDA graph are told apart (circuits_tpu_torch/engine/aot.py).
// Each source exports ctpu_<source>_funcs(void** out), which writes the
// handle (cudaGetFuncBySymbol) of each of its __global__ functions, in the
// order kernels.FUNCS lists them.
#pragma once
#include <cuda_runtime.h>

namespace ctpu {

inline int kernel_funcs(const void* const* syms, int n, void** out) {
  for (int i = 0; i < n; i++) {
    const cudaError_t err =
        cudaGetFuncBySymbol(reinterpret_cast<cudaFunction_t*>(&out[i]), syms[i]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace ctpu
