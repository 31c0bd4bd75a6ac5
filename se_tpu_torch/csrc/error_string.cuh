// The export that each kernel library's Python wrapper calls to name a CUDA
// error code (se_tpu_torch/ops/build.py).  Included once by every source.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* se_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
