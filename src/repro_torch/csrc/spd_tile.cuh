// Shared device helpers of the generated SPD stream kernels.
//
// A generated translation unit (repro_torch.core.codegen.StripeProgram
// .cuda_source) includes this header, defines `struct SpdCore` -- the
// core's per-step tile function, one thread per cell, cut into phases at
// every stencil read of an intermediate -- and then includes
// spd_stream.cuh for the launches.
#pragma once

#include <cuda_runtime.h>

#define SPD_MAX_REGS 16
#define SPD_THREADS 256

// Append_Reg scalars, passed to the kernel by value (no host-to-device
// copy per launch). Register-less cores pass the struct all the same.
struct SpdRegs {
  float v[SPD_MAX_REGS];
};

// The R x C tile a block steps, and its threads' walk over the cells:
// thread t takes cells t, t + SPD_THREADS, ... in row-major order, the
// first at (r0, c0); each next cell lies dr rows and dc columns on (dc <
// C: one comparison carries a column overflow into the row). Computed once
// per kernel, so a phase loop divides nothing.
struct SpdTile {
  int R, C, RC;
  int r0, c0, dr, dc;
};

__device__ __forceinline__ SpdTile spd_tile(int R, int C) {
  SpdTile t;
  t.R = R;
  t.C = C;
  t.RC = R * C;
  t.r0 = threadIdx.x / C;
  t.c0 = threadIdx.x - t.r0 * C;
  t.dr = SPD_THREADS / C;
  t.dc = SPD_THREADS - t.dr * C;
  return t;
}

// One zero-fill stencil tap inside an R x C tile: plane[y][x], or 0 where
// (y, x) lies outside the tile. The tile's guard rows and columns hold
// the true neighbour values; cells that read the fill are cropped.
__device__ __forceinline__ float spd_tap(const float* __restrict__ plane,
                                         int y, int x, int R, int C) {
  return ((unsigned)y < (unsigned)R && (unsigned)x < (unsigned)C)
             ? plane[y * C + x]
             : 0.0f;
}
