// Launch scaffolding of the generated SPD stream kernels (sm_90a).
//
// Included at the end of a generated translation unit, after
// `struct SpdCore` (P state planes, K materialized intermediates, the
// per-step stencil reach HALO / HALO_X, IN_PLACE -- the step may write
// its result over its input -- REG_STATE -- no phase reads a state plane
// by stencil, so each thread may keep its cells' state in registers --
// CPT, the cells each thread owns then, `step(src, dst, mat, tile, regs)`
// over shared state and, for REG_STATE cores, `step_owned(s, mat, tile,
// regs)` over register state). One kernel template,
// spd_multistep_kernel<GUARD>, serves the four launches:
//
//   spd_multistep           one thread block per (block_h x block_w) tile;
//                           the stripe is copied, waited for, stepped and
//                           stored -- replaces
//                           kernels/spd_stream/spd_stream.py:spd_multistep.
//   spd_multistep_streamed  persistent blocks (occupancy x SM count) walk
//                           the tiles, with the next tile's stripe in
//                           flight (cp.async) while the current one steps
//                           when double_buffer -- replaces
//                           kernels/spd_stream/streaming.py:
//                           spd_multistep_streamed.
//   spd_multistep_halo      the first launch over one guard-block-extended
//                           shard of a device mesh (GUARD = true) --
//                           replaces kernels/spd_stream/sharded.py:
//                           spd_multistep_halo.
//   spd_multistep_halo_streamed
//                           the second launch over such a shard --
//                           replaces kernels/spd_stream/streaming.py:
//                           spd_multistep_halo_streamed.
//
// A tile's stripe is (block_h + 2 m HALO) x (block_w + 2 m HALO_X) cells.
// The periodic launches load rows mod H (the periodic stripe assembly of
// the reference); the halo launches take an input of `rows` rows whose
// first and last block_h rows are guard blocks, so output block by's
// stripe starts at input row (by + 1) block_h - m HALO and never leaves
// the input (m HALO <= block_h): no row is wrapped, and the output has
// rows - 2 block_h rows. Columns are loaded mod the width of the array
// handed in, by every launch. Only the center block_h x block_w cells are
// written, into a separate output (never in place).
//
// State, by core and tile (spd_tile_planes prices each):
//  * REG_STATE, a tile of at most SPD_OWNER_CELLS cells: thread t owns
//    the stripe cells t + k SPD_THREADS (k < CPT) and keeps their P state
//    values in registers across the m steps; shared memory holds one load
//    slot (P planes) and the K materialized planes. Once the owners have
//    read a tile out of the slot, the next tile's copies are issued into
//    it (double_buffer) and overlap the m steps; the center cells go out
//    from the registers, each warp's stores on consecutive columns.
//  * REG_STATE, a larger tile: the state in the slot, stepped in place
//    (a REG_STATE core reads its state pointwise only), no prefetch; the
//    same P + K planes.
//  * Other cores: the state in shared memory, ping/pong between two
//    buffers (one, stepped in place, when IN_PLACE), plus a second ring
//    slot with double_buffer in the streamed launch.
//
// Rows are contiguous; the planes of the input and of the output may lie
// any whole number of rows apart (ips / ops rows), so a halo launch reads
// and writes row ranges of a larger guard-extended buffer in place of
// copies (docs/port.md §distribute).
//
// Batch axis (the periodic launches; replaces the reference's leading
// `*lead` axes, kernels/spd_stream/spd_stream.py and streaming.py): B
// independent members of P x H x W floats each, one after another, share
// one core, plan and register vector. B is a tile dimension, not a host
// loop: the launch has B (H / bh) ntx tiles, tile t is (member, ty, tx),
// and every load and store of the tile goes through its member's base,
// member x P ips W floats in, P ops W out, in 64 bits (a 4096^2 uLBM batch
// passes 2^31 floats by its 13th member); in-plane offsets stay 32-bit. A
// block splits its first tile once (spd_at) and advances by the grid with
// a carry per digit (spd_next): no index is divided per tile. The
// persistent walk crosses members, so a block's prefetch may fetch the
// next member's first tile. A member's
// base is 16-byte aligned whenever the 16-byte path is taken (W % 4 ==
// 0), so tile_vec4's test of the two bases covers every member. A block
// holds one member's tile: shared memory does not grow with B. The halo
// launches run one member (B = 1).
//
// Bound: HBM bytes per launch >= 4 P (in_rows + out_rows) W B (each input
// word of a stripe row read once, each output word written once). The
// design answers it with m fused steps per round trip, 16-byte copies in
// (tile_copy.cuh), the next tile's copies overlapping this tile's steps,
// and, since the steps' instructions are then what the SMs issue, few of
// them per cell-step: state in registers where no neighbour reads it, a
// stencil tap as one shared load at a constant offset, and no index
// division per element or per cell.
#pragma once

#include "tile_copy.cuh"

#define SPD_OWNER_CELLS (SPD_THREADS * SpdCore::CPT)

// Whether a tile of RC stripe cells keeps its state in the owners'
// registers (the rule of repro_torch StripeProgram.owned).
__device__ __forceinline__ bool spd_owned(int RC) {
  return SpdCore::REG_STATE && RC <= SPD_OWNER_CELLS;
}

// Tile t of a launch of `per` tiles a member, ntx a row of tiles: t, its
// member and its (ty, tx) within the member (no member division for a
// tile of the first member: every tile of a one-member launch).
struct SpdAt {
  int t, member, ty, tx;
};

__device__ __forceinline__ SpdAt spd_at(int t, int per, int ntx) {
  SpdAt a;
  a.t = t;
  a.member = t < per ? 0 : t / per;
  const int r = t - a.member * per;
  a.ty = r / ntx;
  a.tx = r - a.ty * ntx;
  return a;
}

// Tile a + d.t, from d = spd_at(d.t, per, ntx): each digit of d is below
// its radix (ntx, nty = per / ntx), so each carry is at most one.
__device__ __forceinline__ SpdAt spd_next(SpdAt a, const SpdAt& d, int nty,
                                          int ntx) {
  a.t += d.t;
  a.member += d.member;
  a.ty += d.ty;
  a.tx += d.tx;
  if (a.tx >= ntx) {
    a.tx -= ntx;
    ++a.ty;
  }
  if (a.ty >= nty) {
    a.ty -= nty;
    ++a.member;
  }
  return a;
}

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

// The register-state walk of a REG_STATE core over tiles b, b + grid, ...
// from `first` (`issue(a)` copies tile a into `slot` as one cp.async
// group; `next(a)` is the block's tile after a; members lie `oms` output
// floats apart). GUARD only makes the call from the kernel template
// dependent, so a core without step_owned never instantiates it.
template <class Core, bool GUARD, class Issue, class Next>
__device__ __forceinline__ void spd_owned_walk(
    float* __restrict__ out, const float* slot, float* mat,
    const SpdWalks& w, Issue issue, Next next, SpdAt first, long long oms,
    int W, int ops, int bh, int bw, int mh, int mw, int m, int ntiles,
    bool prefetch, const SpdRegs& regs) {
  constexpr int N = Core::CPT;
  const int C = w.tile.C, RC = w.tile.RC;
  float s[N][Core::P];
  if (prefetch && first.t < ntiles) issue(first);
  for (SpdAt a = first; a.t < ntiles; a = next(a)) {
    if (!prefetch) issue(a);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int cell = threadIdx.x + k * SPD_THREADS;
      if (cell >= RC) continue;
#pragma unroll
      for (int p = 0; p < Core::P; ++p) s[k][p] = slot[p * RC + cell];
    }
    __syncthreads();
    if (prefetch) {
      const SpdAt n = next(a);
      if (n.t < ntiles) issue(n);
    }
    for (int step = 0; step < m; ++step) {
      Core::step_owned(s, mat, w.tile, regs);
    }
    // The center cells out from the registers, through the member's
    // base, (r, c) walked again by additions; columns at or past W (the
    // ragged last tile) masked.
    float* base = out + a.member * oms + ((long long)a.ty * bh - mh) * W +
                  ((long long)a.tx * bw - mw);
    const int cend = min(mw + bw, W - a.tx * bw + mw);
    int r = w.tile.r0, c = w.tile.c0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int cell = threadIdx.x + k * SPD_THREADS;
      if (cell < RC && r >= mh && r < mh + bh && c >= mw && c < cend) {
#pragma unroll
        for (int p = 0; p < Core::P; ++p) {
          base[((long long)p * ops + r) * W + c] = s[k][p];
        }
      }
      r += w.tile.dr;
      c += w.tile.dc;
      if (c >= C) {
        c -= C;
        ++r;
      }
    }
  }
}

// GUARD: the input is a guard-block-extended shard (the halo launches).
// Block b takes tiles b, b + gridDim.x, ... of the ntiles (B members of
// `per` tiles each; one tile per block in the declarative launch, whose
// grid is the tile count). On shared state,
// slot `cur` holds the current tile's stripe and is the state buffer of
// its m steps (with `work` the other ping/pong buffer unless IN_PLACE).
// With prefetch the ring has 2 slots: the next tile's copies are issued
// into the other slot (free since the previous tile's store) before this
// tile's wait, so they overlap this tile's steps; cp_async_wait<1> then
// waits for this tile's group alone.
template <bool GUARD>
__global__ void __launch_bounds__(SPD_THREADS, SPD_MIN_BLOCKS)
spd_multistep_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int H, int W, int ips, int ops, int bh, int bw, int m,
                     int ntx, int per, int ntiles, int double_buffer,
                     int vec, SpdRegs regs) {
  extern __shared__ __align__(16) float smem[];
  const int mh = m * SpdCore::HALO, mw = m * SpdCore::HALO_X;
  const int R = bh + 2 * mh, C = bw + 2 * mw, RC = R * C;
  constexpr int BUFS = SpdCore::IN_PLACE ? 1 : 2;
  float* slot0 = smem + SPD_GUARD_ROWS(SpdCore::HALO) * C;
  float* work = slot0 + SpdCore::P * RC;  // unused when IN_PLACE
  float* mat = slot0 + BUFS * SpdCore::P * RC;
  float* slot1 = mat + SpdCore::K * RC;  // only with double_buffer
  const SpdWalks w = spd_walks(R, C, bh, bw, vec);
  // A member's floats in the input and in the output.
  const long long ims = (long long)SpdCore::P * ips * W;
  const long long oms = (long long)SpdCore::P * ops * W;
  // The block's tiles: its first split once, then a stride of the grid
  // (split only where the block takes a second tile: the declarative
  // launch's blocks take one).
  const SpdAt first = spd_at(blockIdx.x, per, ntx);
  SpdAt stride = {};
  int nty = 0;
  if (first.t + (int)gridDim.x < ntiles) {
    stride = spd_at(gridDim.x, per, ntx);
    nty = per / ntx;
  }
  auto next = [&](SpdAt a) {
    if (stride.t == 0) {  // the block's only tile
      a.t = ntiles;
      return a;
    }
    return spd_next(a, stride, nty, ntx);
  };
  // Issue tile a's copies into buf, as one cp.async group.
  auto issue_into = [&](const SpdAt& a, float* buf) {
    spd_load<!GUARD>(in + a.member * ims, buf, w, vec, H, W, ips,
                     (a.ty + GUARD) * bh - mh, a.tx * bw - mw);
    cp_async_commit();
  };
  if constexpr (SpdCore::REG_STATE) {
    if (spd_owned(RC)) {
      spd_owned_walk<SpdCore, GUARD>(
          out, slot0, mat, w, [&](const SpdAt& a) { issue_into(a, slot0); },
          next, first, oms, W, ops, bh, bw, mh, mw, m, ntiles,
          double_buffer != 0, regs);
      return;
    }
    double_buffer = 0;  // a larger tile: its state in the slot
  }
  float* cur = slot0;
  float* other = slot1;
  if (double_buffer && first.t < ntiles) issue_into(first, cur);
  for (SpdAt t = first; t.t < ntiles; t = next(t)) {
    if (double_buffer) {
      const SpdAt n = next(t);
      if (n.t < ntiles) {
        issue_into(n, other);
      } else {
        cp_async_commit();  // an empty group keeps the count
      }
      cp_async_wait<1>();
    } else {
      issue_into(t, cur);
      cp_async_wait<0>();
    }
    __syncthreads();
    float* a = cur;
    float* b = SpdCore::IN_PLACE ? cur : work;
    for (int s = 0; s < m; ++s) {
      SpdCore::step(a, b, mat, w.tile, regs);
      float* x = a;
      a = b;
      b = x;
    }
    spd_store(a, out + t.member * oms, w, vec, W, ops, t.ty * bh, t.tx * bw,
              bh, mh, mw);
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
// H - 2 bh rows (halo launches). B is the periodic launches' member
// count; the halo launches take one member.

// Planes of a launch's tile (repro_torch StripeProgram.launch_planes): a
// REG_STATE core's load slot and K planes, whichever walk the tile takes;
// otherwise its state buffers, the K planes and, in a streamed launch
// with double_buffer, the second ring slot.
extern "C" int spd_tile_planes(int streamed, int double_buffer) {
  if (SpdCore::REG_STATE) return SpdCore::P + SpdCore::K;
  const int bufs = SpdCore::IN_PLACE ? 1 : 2;
  return (bufs + (streamed && double_buffer ? 1 : 0)) * SpdCore::P +
         SpdCore::K;
}

// Stripe cells the owners hold in registers (0: the core keeps its state
// in shared memory).
extern "C" int spd_owner_cells() {
  return SpdCore::REG_STATE ? SPD_OWNER_CELLS : 0;
}

extern "C" long long spd_smem_bytes(int bh, int bw, int m, int planes) {
  const long long R = bh + 2LL * m * SpdCore::HALO;
  const long long C = bw + 2LL * m * SpdCore::HALO_X;
  return (R * planes + 2LL * SPD_GUARD_ROWS(SpdCore::HALO)) * C *
         (long long)sizeof(float);
}

template <bool GUARD>
static int spd_launch(const float* in, float* out, int B, int H, int W,
                      int ips, int ops, int bh, int bw, int m, int streamed,
                      int double_buffer, SpdRegs regs, long long smem,
                      int dev, void* stream) {
  if (!streamed) double_buffer = 0;
  if (smem < spd_smem_bytes(bh, bw, m,
                            spd_tile_planes(streamed, double_buffer))) {
    return -1;
  }
  const int out_h = GUARD ? H - 2 * bh : H;
  if (bh < 1 || out_h < bh || out_h % bh) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)spd_multistep_kernel<GUARD>;
  const int ntx = (W + bw - 1) / bw;
  const int per = (out_h / bh) * ntx;
  // tile indices (and a block's next, t + grid <= 2 ntiles) fit an int
  if (B < 1 || (long long)B * per > 0x3fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntiles = B * per;
  int grid = ntiles;
  int e = launch_setup(fn, dev, smem, SPD_THREADS, streamed ? &grid : nullptr);
  if (e) return e;
  if (ntiles < grid) grid = ntiles;
  const int vec = tile_vec4(in, out, W, bw, m * SpdCore::HALO_X);
  spd_multistep_kernel<GUARD><<<grid, SPD_THREADS, (size_t)smem,
                                (cudaStream_t)stream>>>(
      in, out, H, W, ips, ops, bh, bw, m, ntx, per, ntiles, double_buffer,
      vec, regs);
  return (int)cudaGetLastError();
}

extern "C" int spd_multistep(const float* in, float* out, int B, int H,
                             int W, int bh, int bw, int m, SpdRegs regs,
                             long long smem, int dev, void* stream) {
  return spd_launch<false>(in, out, B, H, W, H, H, bh, bw, m, 0, 0, regs,
                           smem, dev, stream);
}

extern "C" int spd_multistep_streamed(const float* in, float* out, int B,
                                      int H, int W, int bh, int bw, int m,
                                      int double_buffer, SpdRegs regs,
                                      long long smem, int dev,
                                      void* stream) {
  return spd_launch<false>(in, out, B, H, W, H, H, bh, bw, m, 1,
                           double_buffer, regs, smem, dev, stream);
}

extern "C" int spd_multistep_halo(const float* in, float* out, int rows,
                                  int W, int ips, int ops, int bh, int bw,
                                  int m, SpdRegs regs, long long smem,
                                  int dev, void* stream) {
  return spd_launch<true>(in, out, 1, rows, W, ips, ops, bh, bw, m, 0, 0,
                          regs, smem, dev, stream);
}

extern "C" int spd_multistep_halo_streamed(
    const float* in, float* out, int rows, int W, int ips, int ops, int bh,
    int bw, int m, int double_buffer, SpdRegs regs, long long smem, int dev,
    void* stream) {
  return spd_launch<true>(in, out, 1, rows, W, ips, ops, bh, bw, m, 1,
                          double_buffer, regs, smem, dev, stream);
}
