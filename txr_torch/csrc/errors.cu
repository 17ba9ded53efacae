// Text of a CUDA runtime error code, for the Python wrappers' messages.

#include <cuda_runtime.h>

extern "C" const char* txr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
