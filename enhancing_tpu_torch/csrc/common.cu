// C entry shared by the kernel library: the text of a CUDA error code.
#include "common.cuh"

ETK_API const char* etk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
