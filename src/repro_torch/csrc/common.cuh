// Shared definitions for the HAP kernels.
//
// Every entry point has a plain C interface: device pointers and the
// stream come in as void*, sizes as int64, and the return value is the
// cudaError_t of the launch (0 on success). The library is compiled with
// --fmad=false and the arithmetic that must round like the plain PyTorch
// versions is written with explicit __fadd_rn/__fmul_rn, in the plain
// versions' order, so each product and sum is rounded once, as there.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

// Returns the launch status of the kernels just enqueued.
static inline int repro_launch_status() {
  return static_cast<int>(cudaGetLastError());
}
