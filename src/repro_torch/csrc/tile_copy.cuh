// Global <-> shared copies of the stream kernels' tiles, and the launch
// setup both stream libraries cache (sm_90a).
//
// A tile's stripe is P planes of R rows x C columns. The block walks its
// (plane, row) pairs with threads across each row's columns, in chunks of
// V floats: V = 4 is one 16-byte `cp.async.cg` per chunk (L2 only, one LSU
// instruction per 16 bytes), V = 1 a 4-byte `cp.async.ca`, the scalar path
// for what cannot be aligned (a width, block_w or m*halo_x that is not a
// multiple of 4, or a base pointer off 16 bytes). With V = 4 the launch
// guarantees W, block_w and m*halo_x are multiples of 4, so a chunk never
// straddles the periodic x edge and wraps whole: the wrapped columns and
// the ragged last column tile stay on the 16-byte path.
//
// Every thread's position in the walk is computed once per kernel
// (RowWalk); a row advances by additions, and the periodic wraps are a
// comparison and a subtraction per row (y) or per chunk (x). No index is
// divided per element.
//
// Completion: a thread's copies join a cp.async group at cp_async_commit;
// cp_async_wait<N> waits until at most N of its groups are in flight, and
// the __syncthreads that follows makes every thread's copies visible to
// the block.
#pragma once

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's walk over the (plane, row) pairs of P planes of `rows` rows
// of `chunks` chunks each: it starts at (p, r), takes chunks c0, c0 +
// cstep, ... of each row, and advances dp planes and dr rows per pass.
struct RowWalk {
  int p, r, dp, dr, c0, cstep, chunks;
};

__device__ __forceinline__ RowWalk row_walk(int P, int rows, int chunks,
                                            int nthreads) {
  RowWalk w;
  int q0, step;
  if (chunks <= nthreads) {
    step = nthreads / chunks;  // rows per pass
    q0 = threadIdx.x / chunks;
    w.c0 = threadIdx.x - q0 * chunks;
    w.cstep = chunks;
    if (q0 >= step) q0 = P * rows;  // idle: past the last row
  } else {
    step = 1;
    q0 = 0;
    w.c0 = threadIdx.x;
    w.cstep = nthreads;
  }
  w.p = q0 / rows;
  w.r = q0 - w.p * rows;
  w.dp = step / rows;
  w.dr = step - w.dp * rows;
  w.chunks = chunks;
  return w;
}

__device__ __forceinline__ void row_advance(const RowWalk& w, int& p, int& r,
                                            int rows) {
  p += w.dp;
  r += w.dr;
  if (r >= rows) {
    r -= rows;
    ++p;
  }
}

// Copy the P-plane stripe whose top-left cell is (y0, x0) into buf (P x R
// x C, row pitch C). `row(p, gy)` is the global address of column 0 of
// plane p's row gy. Columns are taken mod W; rows mod H when WRAP_Y (a
// periodic launch: -H <= y0 + r < 2H), as given otherwise. Issues the
// copies only: the caller commits and waits.
template <int V, bool WRAP_Y, class Row>
__device__ __forceinline__ void load_stripe(Row row, float* __restrict__ buf,
                                            const RowWalk& w, int P, int R,
                                            int C, int H, int W, int y0,
                                            int x0) {
  for (int p = w.p, r = w.r; p < P; row_advance(w, p, r, R)) {
    int gy = y0 + r;
    if (WRAP_Y) {
      if (gy < 0) gy += H;
      else if (gy >= H) gy -= H;
    }
    const float* src = row(p, gy);
    float* dst = buf + (p * R + r) * C;
    for (int ch = w.c0; ch < w.chunks; ch += w.cstep) {
      const int c = ch * V;
      int gx = x0 + c;
      while (gx < 0) gx += W;
      while (gx >= W) gx -= W;
      if (V == 4) {
        cp_async16(dst + c, src + gx);
      } else {
        cp_async4(dst + c, src + gx);
      }
    }
  }
}

// Write the bh x bw center cells of P planes of buf (R x C, the center at
// row mh, column mw) to `out` rows y0.. (plane stride `ps` rows, width W),
// columns x0..; columns at or past W (the ragged last column tile) are
// masked. The walk lies over P planes of bh rows of bw / V chunks.
template <int V>
__device__ __forceinline__ void store_center(const float* __restrict__ buf,
                                             float* __restrict__ out,
                                             const RowWalk& w, int P, int R,
                                             int C, int W, int ps, int y0,
                                             int x0, int bh, int mh,
                                             int mw) {
  for (int p = w.p, r = w.r; p < P; row_advance(w, p, r, bh)) {
    const float* src = buf + (p * R + r + mh) * C + mw;
    float* dst = out + ((size_t)p * ps + y0 + r) * W + x0;
    for (int ch = w.c0; ch < w.chunks; ch += w.cstep) {
      const int c = ch * V;
      if (x0 + c >= W) break;
      if (V == 4) {
        *reinterpret_cast<float4*>(dst + c) =
            *reinterpret_cast<const float4*>(src + c);
      } else {
        dst[c] = src[c];
      }
    }
  }
}

// Whether a launch takes the 16-byte path: the width, the column tile and
// the column guard m*halo_x multiples of 4 floats, both bases on 16 bytes.
static inline bool tile_vec4(const void* in, const void* out, int W, int bw,
                             int mw) {
  return W % 4 == 0 && bw % 4 == 0 && mw % 4 == 0 &&
         ((uintptr_t)in & 15) == 0 && ((uintptr_t)out & 15) == 0;
}

// Launch setup, done once per (kernel, device) and once per (kernel,
// device, shared-memory size), never per launch: the kernel's dynamic
// shared-memory limit is raised to the device's opt-in maximum, and the
// persistent grid (occupancy x SMs) is cached.
struct LaunchSetup {
  const void* fn;
  int dev;
  long long smem;
  int value;  // -1: attribute set; else blocks per SM x SMs
};

static int launch_setup(const void* fn, int dev, long long smem, int threads,
                        int* grid) {
  static std::mutex mu;
  static LaunchSetup seen[64];
  static int n = 0;
  std::lock_guard<std::mutex> lock(mu);
  bool attr = false;
  for (int i = 0; i < n; ++i) {
    if (seen[i].fn != fn || seen[i].dev != dev) continue;
    if (seen[i].smem < 0) attr = true;
    if (grid && seen[i].smem == smem) {
      *grid = seen[i].value;
      return 0;
    }
  }
  cudaError_t e;
  if (!attr) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return (int)e;
    if (n < 64) seen[n++] = {fn, dev, -1, -1};
  }
  if (!grid) return 0;
  int sms = 0, occ = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  *grid = occ * sms;
  if (n < 64) seen[n++] = {fn, dev, smem, *grid};
  return 0;
}
