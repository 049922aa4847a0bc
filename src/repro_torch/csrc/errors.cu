#include "common.cuh"

// Human-readable name of a cudaError_t returned by an entry point.
REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
