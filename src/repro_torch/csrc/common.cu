// Shared C entry point of the kernel library: CUDA error text for the
// Python wrappers, which raise on any non-zero launch status.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
