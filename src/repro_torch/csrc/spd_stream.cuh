// Launch scaffolding of the generated SPD stream kernels (sm_90a).
//
// Included at the end of a generated translation unit, after
// `struct SpdCore` (P state planes, K materialized intermediates, the
// per-step stencil reach HALO / HALO_X, and `step(src, dst, mat, R, C,
// regs)`). Four launches share SpdCore::step:
//
//   spd_multistep           one thread block per (block_h x block_w) tile,
//                           synchronous loads -- replaces
//                           kernels/spd_stream/spd_stream.py:spd_multistep.
//   spd_multistep_streamed  persistent blocks (occupancy x SM count) walk
//                           the tiles; with double_buffer they prefetch the
//                           next tile's stripe with cp.async into a second
//                           buffer while the current one computes -- replaces
//                           kernels/spd_stream/streaming.py:
//                           spd_multistep_streamed.
//   spd_multistep_halo      the first launch over one guard-block-extended
//                           shard of a device mesh -- replaces
//                           kernels/spd_stream/sharded.py:spd_multistep_halo.
//   spd_multistep_halo_streamed
//                           the second launch over such a shard -- replaces
//                           kernels/spd_stream/streaming.py:
//                           spd_multistep_halo_streamed.
//
// A tile's stripe is (block_h + 2 m HALO) x (block_w + 2 m HALO_X) cells.
// The periodic launches load rows mod H (the periodic stripe assembly of
// the reference); the halo launches take an input of `rows` rows whose
// first and last block_h rows are guard blocks, so output block by's
// stripe starts at input row (by + 1) block_h - m HALO and never leaves
// the input (m HALO <= block_h): no row is wrapped, and the output has
// rows - 2 block_h rows. Columns are loaded mod the width of the array
// handed in, by every launch. m steps run ping/pong between two state
// buffers in shared memory, and only the center block_h x block_w cells
// are written, into a separate output (never in place).
//
// Rows are contiguous; the planes of the input and of the output may lie
// any whole number of rows apart (ips / ops rows), so a halo launch reads
// and writes row ranges of a larger guard-extended buffer in place of
// copies (docs/port.md §distribute).
//
// Bound: HBM bytes per launch >= 4 P (in_rows + out_rows) W B (each input
// word of a stripe row read once, each output word written once); the
// design answers it with m fused steps per round trip, so the arithmetic
// per byte grows with m while the traffic does not.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#define SPD_THREADS 256

// Load the P-plane stripe whose top-left cell is (y0, x0): columns mod W,
// rows mod H when WRAP_Y (the periodic launches), as given otherwise.
template <bool ASYNC, bool WRAP_Y>
__device__ __forceinline__ void spd_load_stripe(
    const float* __restrict__ in, float* __restrict__ buf, int H, int W,
    int ps, int y0, int x0, int R, int C) {
  const int RC = R * C;
  for (int i = threadIdx.x; i < SpdCore::P * RC; i += blockDim.x) {
    const int p = i / RC;
    const int rem = i - p * RC;
    const int r = rem / C;
    const int c = rem - r * C;
    int gy = y0 + r;
    if (WRAP_Y) {
      gy %= H;
      if (gy < 0) gy += H;
    }
    int gx = (x0 + c) % W;
    if (gx < 0) gx += W;
    const float* g = in + ((size_t)p * ps + gy) * W + gx;
    if (ASYNC) {
      __pipeline_memcpy_async(buf + i, g, sizeof(float));
    } else {
      buf[i] = *g;
    }
  }
}

// m fused steps, ping/pong between a and b; returns the buffer holding
// the result.
__device__ __forceinline__ float* spd_tile_steps(
    float* a, float* b, float* mat, int m, int R, int C,
    const SpdRegs& regs) {
  for (int s = 0; s < m; ++s) {
    SpdCore::step(a, b, mat, R, C, regs);
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Write the tile's center cells at output row y0; columns past W (the
// ragged last column tile) are masked.
__device__ __forceinline__ void spd_store_center(
    const float* __restrict__ buf, float* __restrict__ out, int W, int ps,
    int y0, int x0, int bh, int bw, int mh, int mw, int R, int C) {
  const int RC = R * C;
  const int n = bh * bw;
  for (int i = threadIdx.x; i < SpdCore::P * n; i += blockDim.x) {
    const int p = i / n;
    const int rem = i - p * n;
    const int r = rem / bw;
    const int c = rem - r * bw;
    const int gx = x0 + c;
    if (gx >= W) continue;
    out[((size_t)p * ps + (y0 + r)) * W + gx] =
        buf[p * RC + (r + mh) * C + (c + mw)];
  }
}

// GUARD: the input is a guard-block-extended shard (the halo launches).
template <bool GUARD>
__global__ void __launch_bounds__(SPD_THREADS)
spd_multistep_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int H, int W, int ips, int ops, int bh, int bw,
                     int m, int ntx, SpdRegs regs) {
  extern __shared__ float smem[];
  const int mh = m * SpdCore::HALO, mw = m * SpdCore::HALO_X;
  const int R = bh + 2 * mh, C = bw + 2 * mw, RC = R * C;
  float* s0 = smem;
  float* s1 = s0 + SpdCore::P * RC;
  float* mat = s1 + SpdCore::P * RC;
  const int by = blockIdx.x / ntx, bx = blockIdx.x - by * ntx;
  spd_load_stripe<false, !GUARD>(in, s0, H, W, ips, (by + GUARD) * bh - mh,
                                 bx * bw - mw, R, C);
  __syncthreads();
  const float* res = spd_tile_steps(s0, s1, mat, m, R, C, regs);
  spd_store_center(res, out, W, ops, by * bh, bx * bw, bh, bw, mh, mw, R, C);
}

template <bool GUARD>
__global__ void __launch_bounds__(SPD_THREADS)
spd_multistep_streamed_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int H, int W,
                              int ips, int ops, int bh, int bw, int m,
                              int ntx, int ntiles, int double_buffer,
                              SpdRegs regs) {
  extern __shared__ float smem[];
  const int mh = m * SpdCore::HALO, mw = m * SpdCore::HALO_X;
  const int R = bh + 2 * mh, C = bw + 2 * mw, RC = R * C;
  float* slot0 = smem;
  float* work = slot0 + SpdCore::P * RC;
  float* mat = work + SpdCore::P * RC;
  float* slot1 = mat + SpdCore::K * RC;  // only with double_buffer
  int tile = blockIdx.x;
  int slot = 0;
  if (double_buffer && tile < ntiles) {
    const int by = tile / ntx, bx = tile - by * ntx;
    spd_load_stripe<true, !GUARD>(in, slot0, H, W, ips,
                                  (by + GUARD) * bh - mh, bx * bw - mw, R, C);
    __pipeline_commit();
  }
  for (; tile < ntiles; tile += gridDim.x) {
    float* cur = slot ? slot1 : slot0;
    const int by = tile / ntx, bx = tile - by * ntx;
    if (double_buffer) {
      // Prefetch the next tile into the other slot (free since the end
      // of the previous iteration), then wait for this tile's copies.
      const int next = tile + gridDim.x;
      if (next < ntiles) {
        const int ny = next / ntx, nx = next - ny * ntx;
        spd_load_stripe<true, !GUARD>(in, slot ? slot0 : slot1, H, W, ips,
                                      (ny + GUARD) * bh - mh, nx * bw - mw,
                                      R, C);
      }
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      spd_load_stripe<false, !GUARD>(in, cur, H, W, ips,
                                     (by + GUARD) * bh - mh, bx * bw - mw, R,
                                     C);
    }
    __syncthreads();
    const float* res = spd_tile_steps(cur, work, mat, m, R, C, regs);
    spd_store_center(res, out, W, ops, by * bh, bx * bw, bh, bw, mh, mw, R,
                     C);
    __syncthreads();
    if (double_buffer) slot ^= 1;
  }
}

// Host entry points: plain C interface, pointers and the stream as void*,
// cudaGetLastError() (or -1 for an under-priced shared-memory size) as
// the return value. H is the input's row count; the output has H rows
// (periodic launches) or H - 2 bh rows (halo launches).

extern "C" long long spd_smem_bytes(int bh, int bw, int m, int nbuf) {
  const long long R = bh + 2LL * m * SpdCore::HALO;
  const long long C = bw + 2LL * m * SpdCore::HALO_X;
  return R * C * (nbuf * SpdCore::P + SpdCore::K) * (long long)sizeof(float);
}

static int spd_out_rows(bool guard, int H, int bh) {
  return guard ? H - 2 * bh : H;
}

template <bool GUARD>
static int spd_launch(const float* in, float* out, int H, int W, int ips,
                      int ops, int bh, int bw, int m, SpdRegs regs,
                      long long smem, void* stream) {
  if (smem < spd_smem_bytes(bh, bw, m, 2)) return -1;
  const int out_h = spd_out_rows(GUARD, H, bh);
  if (bh < 1 || out_h < bh || out_h % bh) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      spd_multistep_kernel<GUARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ntx = (W + bw - 1) / bw;
  const int ntiles = (out_h / bh) * ntx;
  spd_multistep_kernel<GUARD><<<ntiles, SPD_THREADS, (size_t)smem,
                                (cudaStream_t)stream>>>(
      in, out, H, W, ips, ops, bh, bw, m, ntx, regs);
  return (int)cudaGetLastError();
}

template <bool GUARD>
static int spd_launch_streamed(const float* in, float* out, int H, int W,
                               int ips, int ops, int bh, int bw, int m,
                               int double_buffer, SpdRegs regs,
                               long long smem, void* stream) {
  if (smem < spd_smem_bytes(bh, bw, m, double_buffer ? 3 : 2)) return -1;
  const int out_h = spd_out_rows(GUARD, H, bh);
  if (bh < 1 || out_h < bh || out_h % bh) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      spd_multistep_streamed_kernel<GUARD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, spd_multistep_streamed_kernel<GUARD>, SPD_THREADS, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) occ = 1;
  const int ntx = (W + bw - 1) / bw;
  const int ntiles = (out_h / bh) * ntx;
  const int grid = ntiles < occ * sms ? ntiles : occ * sms;
  spd_multistep_streamed_kernel<GUARD><<<grid, SPD_THREADS, (size_t)smem,
                                         (cudaStream_t)stream>>>(
      in, out, H, W, ips, ops, bh, bw, m, ntx, ntiles, double_buffer, regs);
  return (int)cudaGetLastError();
}

extern "C" int spd_multistep(const float* in, float* out, int H, int W,
                             int bh, int bw, int m, SpdRegs regs,
                             long long smem, void* stream) {
  return spd_launch<false>(in, out, H, W, H, H, bh, bw, m, regs, smem,
                           stream);
}

extern "C" int spd_multistep_streamed(const float* in, float* out, int H,
                                      int W, int bh, int bw, int m,
                                      int double_buffer, SpdRegs regs,
                                      long long smem, void* stream) {
  return spd_launch_streamed<false>(in, out, H, W, H, H, bh, bw, m,
                                    double_buffer, regs, smem, stream);
}

extern "C" int spd_multistep_halo(const float* in, float* out, int rows,
                                  int W, int ips, int ops, int bh, int bw,
                                  int m, SpdRegs regs, long long smem,
                                  void* stream) {
  return spd_launch<true>(in, out, rows, W, ips, ops, bh, bw, m, regs, smem,
                          stream);
}

extern "C" int spd_multistep_halo_streamed(
    const float* in, float* out, int rows, int W, int ips, int ops, int bh,
    int bw, int m, int double_buffer, SpdRegs regs, long long smem,
    void* stream) {
  return spd_launch_streamed<true>(in, out, rows, W, ips, ops, bh, bw, m,
                                   double_buffer, regs, smem, stream);
}
