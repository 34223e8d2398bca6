// Shared device helpers of the generated SPD stream kernels.
//
// A generated translation unit (repro_torch.core.codegen.StripeProgram
// .cuda_source) includes this header, defines `struct SpdCore` -- the
// core's per-step tile function, one thread per cell, cut into phases at
// every stencil read of an intermediate -- and then includes
// spd_stream.cuh for the two launches.
#pragma once

#include <cuda_runtime.h>

#define SPD_MAX_REGS 16

// Append_Reg scalars, passed to the kernel by value (no host-to-device
// copy per launch). Register-less cores pass the struct all the same.
struct SpdRegs {
  float v[SPD_MAX_REGS];
};

// One zero-fill stencil tap inside an R x C tile: plane[y][x], or 0 where
// (y, x) lies outside the tile. The tile's guard rows and columns hold
// the true neighbour values; cells that read the fill are cropped.
__device__ __forceinline__ float spd_tap(const float* __restrict__ plane,
                                         int y, int x, int R, int C) {
  return ((unsigned)y < (unsigned)R && (unsigned)x < (unsigned)C)
             ? plane[y * C + x]
             : 0.0f;
}
