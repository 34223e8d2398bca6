// Launch scaffolding of the generated SPD stream kernels (sm_90a).
//
// Included at the end of a generated translation unit, after
// `struct SpdCore` (P state planes, K materialized intermediates, the
// per-step stencil reach HALO / HALO_X, IN_PLACE -- the step may write
// its result over its input -- and `step(src, dst, mat, tile, regs)`). Four launches share SpdCore::step and the tile copies of
// tile_copy.cuh:
//
//   spd_multistep           one thread block per (block_h x block_w) tile;
//                           the stripe is copied, waited for, stepped and
//                           stored -- replaces
//                           kernels/spd_stream/spd_stream.py:spd_multistep.
//   spd_multistep_streamed  persistent blocks (occupancy x SM count) walk
//                           the tiles through a ring of load slots: with
//                           double_buffer, 2 slots, the next tile's stripe
//                           in flight (cp.async) while the current one
//                           computes; without, 1 slot, loaded then
//                           computed -- replaces
//                           kernels/spd_stream/streaming.py:
//                           spd_multistep_streamed.
//   spd_multistep_halo      the first launch over one guard-block-extended
//                           shard of a device mesh -- replaces
//                           kernels/spd_stream/sharded.py:spd_multistep_halo.
//   spd_multistep_halo_streamed
//                           the second launch over such a shard (GUARD =
//                           true of the streamed kernel) -- replaces
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
// buffers in shared memory (the streamed launch steps one buffer in place
// when IN_PLACE: its last phase reads the state pointwise only), and only
// the center block_h x block_w cells are written, into a separate output
// (never in place).
//
// Rows are contiguous; the planes of the input and of the output may lie
// any whole number of rows apart (ips / ops rows), so a halo launch reads
// and writes row ranges of a larger guard-extended buffer in place of
// copies (docs/port.md §distribute).
//
// Bound: HBM bytes per launch >= 4 P (in_rows + out_rows) W B (each input
// word of a stripe row read once, each output word written once). The
// design answers it with m fused steps per round trip, 16-byte copies in
// and out (tile_copy.cuh), the next tile's copies overlapping this tile's
// steps in the streamed launch, and no index division per element or per
// cell, so the steps' arithmetic is what the SMs issue.
#pragma once

#include "tile_copy.cuh"

// State buffers of the streamed launch (the ring's second slot comes on
// top with double_buffer); the declarative launch always ping/pongs two.
#define SPD_STREAM_BUFS (SpdCore::IN_PLACE ? 1 : 2)

// Every thread's walks, computed once per kernel: the stripe's load walk
// (P planes of R rows, C / V chunks), the center's store walk (P planes of
// bh rows, bw / V chunks) and the step's cell walk.
struct SpdWalks {
  RowWalk load, store;
  SpdTile tile;
};

__device__ __forceinline__ SpdWalks spd_walks(int R, int C, int bh, int bw,
                                              int vec) {
  SpdWalks w;
  const int V = vec ? 4 : 1;
  w.load = row_walk(SpdCore::P, R, C / V, SPD_THREADS);
  w.store = row_walk(SpdCore::P, bh, bw / V, SPD_THREADS);
  w.tile = spd_tile(R, C);
  return w;
}

// Issue the copies of the stripe whose top-left cell is (y0, x0): rows
// mod H when WRAP_Y (the periodic launches), as given otherwise; columns
// mod W.
template <bool WRAP_Y>
__device__ __forceinline__ void spd_load(const float* __restrict__ in,
                                         float* __restrict__ buf,
                                         const SpdWalks& w, int vec, int H,
                                         int W, int ps, int y0, int x0) {
  auto row = [=](int p, int gy) { return in + ((size_t)p * ps + gy) * W; };
  const int R = w.tile.R, C = w.tile.C;
  if (vec) {
    load_stripe<4, WRAP_Y>(row, buf, w.load, SpdCore::P, R, C, H, W, y0, x0);
  } else {
    load_stripe<1, WRAP_Y>(row, buf, w.load, SpdCore::P, R, C, H, W, y0, x0);
  }
}

__device__ __forceinline__ void spd_store(const float* __restrict__ buf,
                                          float* __restrict__ out,
                                          const SpdWalks& w, int vec, int W,
                                          int ps, int y0, int x0, int bh,
                                          int mh, int mw) {
  const int R = w.tile.R, C = w.tile.C;
  if (vec) {
    store_center<4>(buf, out, w.store, SpdCore::P, R, C, W, ps, y0, x0, bh,
                    mh, mw);
  } else {
    store_center<1>(buf, out, w.store, SpdCore::P, R, C, W, ps, y0, x0, bh,
                    mh, mw);
  }
}

// m fused steps, ping/pong between a and b; returns the buffer holding
// the result.
__device__ __forceinline__ float* spd_tile_steps(float* a, float* b,
                                                 float* mat, int m,
                                                 const SpdTile& t,
                                                 const SpdRegs& regs) {
  for (int s = 0; s < m; ++s) {
    SpdCore::step(a, b, mat, t, regs);
    float* x = a;
    a = b;
    b = x;
  }
  return a;
}

// GUARD: the input is a guard-block-extended shard (the halo launches).
template <bool GUARD>
__global__ void __launch_bounds__(SPD_THREADS)
spd_multistep_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int H, int W, int ips, int ops, int bh, int bw,
                     int m, int ntx, int vec, SpdRegs regs) {
  extern __shared__ __align__(16) float smem[];
  const int mh = m * SpdCore::HALO, mw = m * SpdCore::HALO_X;
  const int R = bh + 2 * mh, C = bw + 2 * mw, RC = R * C;
  float* s0 = smem;
  float* s1 = s0 + SpdCore::P * RC;
  float* mat = s1 + SpdCore::P * RC;
  const SpdWalks w = spd_walks(R, C, bh, bw, vec);
  const int by = blockIdx.x / ntx, bx = blockIdx.x - by * ntx;
  spd_load<!GUARD>(in, s0, w, vec, H, W, ips, (by + GUARD) * bh - mh,
                   bx * bw - mw);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* res = spd_tile_steps(s0, s1, mat, m, w.tile, regs);
  spd_store(res, out, w, vec, W, ops, by * bh, bx * bw, bh, mh, mw);
}

// The persistent walk. Block b takes tiles b, b + gridDim.x, ...; slot
// `cur` holds the current tile's stripe and is the state buffer of its m
// steps (with `work` the other ping/pong buffer unless IN_PLACE). With
// double_buffer the ring has 2 slots: the next tile's copies are issued
// into the other slot (free since the previous tile's store) before this
// tile's wait, so they overlap this tile's steps; cp_async_wait<1> then
// waits for this tile's group alone.
template <bool GUARD>
__global__ void __launch_bounds__(SPD_THREADS)
spd_multistep_streamed_kernel(const float* __restrict__ in,
                              float* __restrict__ out, int H, int W,
                              int ips, int ops, int bh, int bw, int m,
                              int ntx, int ntiles, int double_buffer,
                              int vec, SpdRegs regs) {
  extern __shared__ __align__(16) float smem[];
  const int mh = m * SpdCore::HALO, mw = m * SpdCore::HALO_X;
  const int R = bh + 2 * mh, C = bw + 2 * mw, RC = R * C;
  float* slot0 = smem;
  float* work = slot0 + SpdCore::P * RC;  // unused when IN_PLACE
  float* mat = slot0 + SPD_STREAM_BUFS * SpdCore::P * RC;
  float* slot1 = mat + SpdCore::K * RC;  // only with double_buffer
  const SpdWalks w = spd_walks(R, C, bh, bw, vec);
  // Issue tile t's copies into buf, as one cp.async group.
  auto issue = [&](int t, float* buf) {
    const int ty = t / ntx, tx = t - ty * ntx;
    spd_load<!GUARD>(in, buf, w, vec, H, W, ips, (ty + GUARD) * bh - mh,
                     tx * bw - mw);
    cp_async_commit();
  };
  float* cur = slot0;
  float* other = slot1;
  if (double_buffer && blockIdx.x < ntiles) issue(blockIdx.x, cur);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    if (double_buffer) {
      const int next = tile + gridDim.x;
      if (next < ntiles) {
        issue(next, other);
      } else {
        cp_async_commit();  // an empty group keeps the count
      }
      cp_async_wait<1>();
    } else {
      issue(tile, cur);
      cp_async_wait<0>();
    }
    __syncthreads();
    const int by = tile / ntx, bx = tile - by * ntx;
    const float* res = spd_tile_steps(cur, SpdCore::IN_PLACE ? cur : work,
                                      mat, m, w.tile, regs);
    spd_store(res, out, w, vec, W, ops, by * bh, bx * bw, bh, mh, mw);
    __syncthreads();
    if (double_buffer) {
      float* x = cur;
      cur = other;
      other = x;
    }
  }
}

// Host entry points: plain C interface, pointers and the stream as void*,
// the device ordinal whose launch setup is cached, cudaGetLastError() (or
// -1 for an under-priced shared-memory size) as the return value. H is
// the input's row count; the output has H rows (periodic launches) or
// H - 2 bh rows (halo launches).

extern "C" int spd_stream_buffers() { return SPD_STREAM_BUFS; }

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
                      long long smem, int dev, void* stream) {
  if (smem < spd_smem_bytes(bh, bw, m, 2)) return -1;
  const int out_h = spd_out_rows(GUARD, H, bh);
  if (bh < 1 || out_h < bh || out_h % bh) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)spd_multistep_kernel<GUARD>;
  int e = launch_setup(fn, dev, smem, SPD_THREADS, nullptr);
  if (e) return e;
  const int ntx = (W + bw - 1) / bw;
  const int ntiles = (out_h / bh) * ntx;
  const int vec = tile_vec4(in, out, W, bw, m * SpdCore::HALO_X);
  spd_multistep_kernel<GUARD><<<ntiles, SPD_THREADS, (size_t)smem,
                                (cudaStream_t)stream>>>(
      in, out, H, W, ips, ops, bh, bw, m, ntx, vec, regs);
  return (int)cudaGetLastError();
}

template <bool GUARD>
static int spd_launch_streamed(const float* in, float* out, int H, int W,
                               int ips, int ops, int bh, int bw, int m,
                               int double_buffer, SpdRegs regs,
                               long long smem, int dev, void* stream) {
  if (smem < spd_smem_bytes(bh, bw, m, SPD_STREAM_BUFS + !!double_buffer)) {
    return -1;
  }
  const int out_h = spd_out_rows(GUARD, H, bh);
  if (bh < 1 || out_h < bh || out_h % bh) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)spd_multistep_streamed_kernel<GUARD>;
  int grid = 0;
  int e = launch_setup(fn, dev, smem, SPD_THREADS, &grid);
  if (e) return e;
  const int ntx = (W + bw - 1) / bw;
  const int ntiles = (out_h / bh) * ntx;
  if (ntiles < grid) grid = ntiles;
  const int vec = tile_vec4(in, out, W, bw, m * SpdCore::HALO_X);
  spd_multistep_streamed_kernel<GUARD><<<grid, SPD_THREADS, (size_t)smem,
                                         (cudaStream_t)stream>>>(
      in, out, H, W, ips, ops, bh, bw, m, ntx, ntiles, double_buffer, vec,
      regs);
  return (int)cudaGetLastError();
}

extern "C" int spd_multistep(const float* in, float* out, int H, int W,
                             int bh, int bw, int m, SpdRegs regs,
                             long long smem, int dev, void* stream) {
  return spd_launch<false>(in, out, H, W, H, H, bh, bw, m, regs, smem, dev,
                           stream);
}

extern "C" int spd_multistep_streamed(const float* in, float* out, int H,
                                      int W, int bh, int bw, int m,
                                      int double_buffer, SpdRegs regs,
                                      long long smem, int dev,
                                      void* stream) {
  return spd_launch_streamed<false>(in, out, H, W, H, H, bh, bw, m,
                                    double_buffer, regs, smem, dev, stream);
}

extern "C" int spd_multistep_halo(const float* in, float* out, int rows,
                                  int W, int ips, int ops, int bh, int bw,
                                  int m, SpdRegs regs, long long smem,
                                  int dev, void* stream) {
  return spd_launch<true>(in, out, rows, W, ips, ops, bh, bw, m, regs, smem,
                          dev, stream);
}

extern "C" int spd_multistep_halo_streamed(
    const float* in, float* out, int rows, int W, int ips, int ops, int bh,
    int bw, int m, int double_buffer, SpdRegs regs, long long smem, int dev,
    void* stream) {
  return spd_launch_streamed<true>(in, out, rows, W, ips, ops, bh, bw, m,
                                   double_buffer, regs, smem, dev, stream);
}
