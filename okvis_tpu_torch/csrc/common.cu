// Shared C entry point of the kernel library: readable CUDA error messages
// for the Python wrappers (ops/cuda_lib.py::check).
#include <cuda_runtime.h>

extern "C" const char* okvis_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
