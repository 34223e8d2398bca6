// Shared device helpers of the generated SPD stream kernels.
//
// A generated translation unit (repro_torch.core.codegen.StripeProgram
// .cuda_source) first defines the owner layout from codegen.py's
// constants: SPD_THREADS a block, SPD_MIN_BLOCKS the blocks per SM its
// registers are sized for and, for a register-state core, SPD_CPT the
// stripe cells a thread owns. It then includes this header, defines
// `struct SpdCore` (the core's per-step tile functions, cut into phases at
// every stencil read of an intermediate) and includes spd_stream.cuh for
// the launches.
#pragma once

#include <cuda_runtime.h>

#define SPD_MAX_REGS 16

// Append_Reg scalars, passed to the kernel by value (no host-to-device
// copy per launch). Register-less cores pass the struct all the same.
struct SpdRegs {
  float v[SPD_MAX_REGS];
};

// The R x C tile a block steps, and its threads' walk over the cells:
// thread t takes cells t, t + SPD_THREADS, ... in row-major order, the
// first at (r0, c0); each next cell lies dr rows and dc columns on (dc <
// C: one comparison carries a column overflow into the row). Computed once
// per kernel. The steps read no (r, c): their stencil taps are single
// loads at constant offsets (below); the register-state store walk
// carries (r, c) this way to mask the center cells (spd_stream.cuh).
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
