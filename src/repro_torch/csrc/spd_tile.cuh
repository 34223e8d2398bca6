// Shared device helpers of the generated SPD stream kernels.
//
// A generated translation unit (repro_torch.core.codegen.StripeProgram
// .cuda_source) includes this header, defines `struct SpdCore` -- the
// core's per-step tile functions, cut into phases at every stencil read of
// an intermediate -- and then includes spd_stream.cuh for the launches.
#pragma once

#include <cuda_runtime.h>

#define SPD_MAX_REGS 16
#ifndef SPD_THREADS
#define SPD_THREADS 256
#endif
#ifndef SPD_MIN_BLOCKS
#define SPD_MIN_BLOCKS 2  // blocks per SM the registers are sized for
#endif

// Append_Reg scalars, passed to the kernel by value (no host-to-device
// copy per launch). Register-less cores pass the struct all the same.
struct SpdRegs {
  float v[SPD_MAX_REGS];
};

// The R x C tile a block steps, and its threads' walk over the cells:
// thread t takes cells t, t + SPD_THREADS, ... in row-major order, the
// first at (r0, c0); each next cell lies dr rows and dc columns on (dc <
// C: one comparison carries a column overflow into the row). Computed once
// per kernel. The shipped step reads no (r, c): its stencil taps are
// single loads at constant offsets (below); a step printed with checked
// taps (a variant for measurement) carries (r, c) by this walk.
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

// The (r, c) of the stripe cells t + k SPD_THREADS that thread t owns in
// a register-state step, computed once per kernel (read by checked taps
// only).
template <int N>
struct SpdOwned {
  int r[N], c[N];
};

// Stencil taps. Every plane a step reads lies in one block of shared
// memory with SPD_GUARD_ROWS(HALO) rows of C cells before the first
// plane and after the last, so the tap (y - dy, x - dx) of any cell of
// any plane is the single load plane[idx - (dy C + dx)] and stays inside
// the allocation (|dy| <= HALO, |dx| <= HALO_X < C). A cell whose tap
// leaves the tile reads a neighbouring row, plane or guard instead of the
// plain version's zero: such cells lie within the step's reach of the
// tile edge, so they are stale after m steps in either version and are
// never stored (the centre is m HALO rows and m HALO_X columns in).
#define SPD_GUARD_ROWS(halo) ((halo) + 1)

// One zero-fill stencil tap with its bounds checked: plane[y][x], or 0
// where (y, x) lies outside the tile (the checked-tap variant).
__device__ __forceinline__ float spd_tap(const float* __restrict__ plane,
                                         int y, int x, int R, int C) {
  return ((unsigned)y < (unsigned)R && (unsigned)x < (unsigned)C)
             ? plane[y * C + x]
             : 0.0f;
}
