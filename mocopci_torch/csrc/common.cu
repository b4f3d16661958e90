#include "common.cuh"

MOCOPCI_API const char* mocopci_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
