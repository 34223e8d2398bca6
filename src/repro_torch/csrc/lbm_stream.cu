// Hand-written fused m-step D2Q9 lattice-Boltzmann kernel for sm_90a.
//
// Replaces kernels/lbm_stream/lbm_stream.py:lbm_multistep (with _kernel and
// _step) of the JAX package. Per step: BGK collision on fluid cells
// (attr < 0.5) with one_tau; streaming f_i(x + e_i) <- f_i(x); full-way
// bounce-back on solid cells (attr >= 0.5), plus 6 w_i e_x,i u_lid on a
// moving lid (attr >= 1.5). Op for op the arithmetic of the port's plain
// version (repro_torch.kernels.lbm_stream.lbm_stream.lbm_multistep_plain);
// built with -fmad=false so no multiply-add is contracted.
//
// Tiling: a tile's stripe is (block_h + 2m) x (block_w + 2m) cells, rows
// mod H and columns mod W; stencil reads inside the tile zero-fill, so m
// guard cells per side go stale over m steps and only the center is
// written, into a separate output.
//
// Design (docs/port.md §tile):
//  * Persistent blocks (occupancy x SMs) walk the tiles.
//  * Register-resident populations: thread t owns the stripe cells t + k
//    LBM_THREADS (k < LBM_CPT) and keeps their 9 populations and attribute
//    in registers across the m steps. Collision reads registers and writes
//    the post-collision populations g (9 shared planes); after a barrier,
//    streaming reads each owned cell's 9 neighbours from g and bounces back
//    into registers. Only g and the load slot live in shared memory.
//  * A 1-slot load ring: the tile's 10 planes (9 populations, attributes)
//    arrive in the slot by 16-byte cp.async (tile_copy.cuh; 4-byte where
//    W, block_w or m is not a multiple of 4); once the owners have read
//    their cells into registers, the next tile's copies are issued into
//    the same slot and overlap this tile's m steps.
//  * The center cells go back through g (free after the last step) and
//    out in 16-byte stores.
//  * No index division per element or cell: each owned cell's (row,
//    column) and every copy walk are computed once per kernel.
//  * A tile with more stripe cells than the owners hold (lbm_max_cells:
//    a tall block_h, such as 256 or 300 at m 4) takes the second
//    instantiation, OWNED = false: the populations stay in the load slot
//    and are stepped there in place (collision reads the slot and writes
//    g, streaming reads g and writes the slot), the threads walk every
//    cell with a stride carrying (row, column) by additions, and there is
//    no prefetch. Same 19 planes, same arithmetic op for op.
// Shared memory: (9 + 10) planes of the stripe, 19.
//
// Bound: HBM bytes per launch >= (9 + 1 + 9) H W 4 B (populations and
// attributes read once, populations written once); m fused steps per
// round trip raise the arithmetic per byte (131 flops per cell-step).

#include "tile_copy.cuh"

#define LBM_THREADS 512
#define LBM_CPT 4         // stripe cells per thread: the owners hold 2048
#define LBM_MIN_BLOCKS 1  // blocks per SM the registers are sized for
#define LBM_PLANES 19

// BGK collision of one cell, gated to fluid cells: the post-collision
// populations into g[i * RC + cell]. The tables are local constants, and
// every loop is unrolled, so each index folds to a constant.
__device__ __forceinline__ void lbm_collide(const float (&fi)[9], float at,
                                            float one_tau, float* g, int RC,
                                            int cell) {
  const int kEX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  const int kEY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  const float w[9] = {0.44444445f, 0.11111111f, 0.11111111f, 0.11111111f,
                      0.11111111f, 0.027777778f, 0.027777778f,
                      0.027777778f, 0.027777778f};
  const bool fluid = at < 0.5f;
  float rho = fi[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) rho = rho + fi[i];
  const float inv_rho = 1.0f / rho;
  const float ux = (fi[1] + fi[5] + fi[8] - fi[3] - fi[6] - fi[7]) * inv_rho;
  const float uy = (fi[2] + fi[5] + fi[6] - fi[4] - fi[7] - fi[8]) * inv_rho;
  const float usq = ux * ux + uy * uy;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float feq;
    if (i == 0) {
      feq = w[0] * rho * (1.0f - 1.5f * usq);
    } else {
      const float cu = (float)kEX[i] * ux + (float)kEY[i] * uy;
      feq = w[i] * rho * (1.0f + 3.0f * cu + 4.5f * cu * cu - 1.5f * usq);
    }
    const float gi = fi[i] - one_tau * (fi[i] - feq);
    g[i * RC + cell] = fluid ? gi : fi[i];
  }
}

// Streaming of one cell from g (zero-fill taps inside the tile: in_u ..
// in_r say which neighbours lie inside), then bounce-back on solid cells
// and the lid correction on moving ones; the new populations into out.
__device__ __forceinline__ void lbm_stream(const float* g, int RC, int C,
                                           int cell, bool in_u, bool in_d,
                                           bool in_l, bool in_r, float at,
                                           float u_lid, float (&out)[9]) {
  const int kEX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  const int kEY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  const int kOPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  // the f32 roundings of 6 w_i e_x,i
  const float corr[9] = {0.0f, 0.6666666865348816f, 0.0f,
                         -0.6666666865348816f, 0.0f, 0.1666666716337204f,
                         -0.1666666716337204f, -0.1666666716337204f,
                         0.1666666716337204f};
  float st[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    // the tap at (r - ey, c - ex)
    const bool inside = (kEY[i] > 0 ? in_u : true) &&
                        (kEY[i] < 0 ? in_d : true) &&
                        (kEX[i] > 0 ? in_l : true) &&
                        (kEX[i] < 0 ? in_r : true);
    st[i] = inside ? g[i * RC + cell - kEY[i] * C - kEX[i]] : 0.0f;
  }
  const bool solid = at >= 0.5f, moving = at >= 1.5f;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float refl = st[kOPP[i]];
    const float bb = moving ? refl + corr[i] * u_lid : refl;
    out[i] = solid ? bb : st[i];
  }
}

// OWNED: the populations of the stripe cells t + k LBM_THREADS in the
// owners' registers (a tile of at most lbm_max_cells() cells); otherwise
// in the load slot, stepped in place, no prefetch.
template <bool OWNED>
__global__ void __launch_bounds__(LBM_THREADS, LBM_MIN_BLOCKS)
lbm_multistep_kernel(const float* __restrict__ f_in,
                     const float* __restrict__ attr_in,
                     float* __restrict__ f_out, int H, int W, int bh, int bw,
                     int m, int ntx, int ntiles, int vec, float one_tau,
                     float u_lid) {
  extern __shared__ __align__(16) float smem[];
  const int R = bh + 2 * m, C = bw + 2 * m, RC = R * C;
  float* g = smem;          // 9 planes: post-collision populations
  float* slot = g + 9 * RC;  // 10 planes: the load slot
  const int V = vec ? 4 : 1;
  const RowWalk lw = row_walk(10, R, C / V, LBM_THREADS);
  const RowWalk sw = row_walk(9, bh, bw / V, LBM_THREADS);
  auto row = [=](int p, int gy) {
    return p < 9 ? f_in + ((size_t)p * H + gy) * W : attr_in + (size_t)gy * W;
  };
  auto issue = [&](int t) {
    const int ty = t / ntx, tx = t - ty * ntx;
    if (vec) {
      load_stripe<4, true>(row, slot, lw, 10, R, C, H, W, ty * bh - m,
                           tx * bw - m);
    } else {
      load_stripe<1, true>(row, slot, lw, 10, R, C, H, W, ty * bh - m,
                           tx * bw - m);
    }
    cp_async_commit();
  };
  // The center of planes buf[0..8] (R x C) out to tile t.
  auto store = [&](const float* buf, int t) {
    const int by = t / ntx, bx = t - by * ntx;
    if (vec) {
      store_center<4>(buf, f_out, sw, 9, R, C, W, H, by * bh, bx * bw, bh, m,
                      m);
    } else {
      store_center<1>(buf, f_out, sw, 9, R, C, W, H, by * bh, bx * bw, bh, m,
                      m);
    }
  };
  if constexpr (!OWNED) {
    // Every cell with a stride; (r, c) carried by additions.
    const int r0 = threadIdx.x / C, c0 = threadIdx.x - r0 * C;
    const int dr = LBM_THREADS / C, dc = LBM_THREADS - dr * C;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      issue(tile);
      cp_async_wait<0>();
      __syncthreads();
      for (int s = 0; s < m; ++s) {
        for (int cell = threadIdx.x; cell < RC; cell += LBM_THREADS) {
          float fi[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) fi[i] = slot[i * RC + cell];
          lbm_collide(fi, slot[9 * RC + cell], one_tau, g, RC, cell);
        }
        __syncthreads();
        int r = r0, c = c0;
        for (int cell = threadIdx.x; cell < RC; cell += LBM_THREADS) {
          float fo[9];
          lbm_stream(g, RC, C, cell, r > 0, r < R - 1, c > 0, c < C - 1,
                     slot[9 * RC + cell], u_lid, fo);
#pragma unroll
          for (int i = 0; i < 9; ++i) slot[i * RC + cell] = fo[i];
          r += dr;
          c += dc;
          if (c >= C) {
            c -= C;
            ++r;
          }
        }
        __syncthreads();
      }
      store(slot, tile);
      __syncthreads();
    }
  } else {
    // The owned cells, their offsets and which of their neighbours lie
    // inside the tile (up, down, left, right).
    int cell[LBM_CPT];
    bool own[LBM_CPT], in_u[LBM_CPT], in_d[LBM_CPT], in_l[LBM_CPT],
        in_r[LBM_CPT], center[LBM_CPT];
#pragma unroll
    for (int k = 0; k < LBM_CPT; ++k) {
      cell[k] = threadIdx.x + k * LBM_THREADS;
      own[k] = cell[k] < RC;
      const int r = cell[k] / C, c = cell[k] - r * C;
      in_u[k] = r > 0;
      in_d[k] = r < R - 1;
      in_l[k] = c > 0;
      in_r[k] = c < C - 1;
      center[k] = r >= m && r < m + bh && c >= m && c < m + bw;
    }
    float fr[LBM_CPT][9];
    float at[LBM_CPT];
    if (blockIdx.x < ntiles) issue(blockIdx.x);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int k = 0; k < LBM_CPT; ++k) {
        if (!own[k]) continue;
#pragma unroll
        for (int i = 0; i < 9; ++i) fr[k][i] = slot[i * RC + cell[k]];
        at[k] = slot[9 * RC + cell[k]];
      }
      __syncthreads();
      if (tile + (int)gridDim.x < ntiles) issue(tile + gridDim.x);
      for (int s = 0; s < m; ++s) {
#pragma unroll
        for (int k = 0; k < LBM_CPT; ++k) {
          if (!own[k]) continue;
          float fi[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) fi[i] = fr[k][i];
          lbm_collide(fi, at[k], one_tau, g, RC, cell[k]);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < LBM_CPT; ++k) {
          if (!own[k]) continue;
          float fo[9];
          lbm_stream(g, RC, C, cell[k], in_u[k], in_d[k], in_l[k], in_r[k],
                     at[k], u_lid, fo);
#pragma unroll
          for (int i = 0; i < 9; ++i) fr[k][i] = fo[i];
        }
        __syncthreads();
      }
      // The center cells through g (free since the last barrier) and out.
#pragma unroll
      for (int k = 0; k < LBM_CPT; ++k) {
        if (!own[k] || !center[k]) continue;
#pragma unroll
        for (int i = 0; i < 9; ++i) g[i * RC + cell[k]] = fr[k][i];
      }
      __syncthreads();
      store(g, tile);
      __syncthreads();
    }
  }
}

extern "C" long long lbm_smem_bytes(int bh, int bw, int m) {
  return (long long)(bh + 2 * m) * (bw + 2 * m) * LBM_PLANES *
         (long long)sizeof(float);
}

// The most stripe cells the owners hold in registers; a larger tile takes
// the OWNED = false instantiation.
extern "C" int lbm_max_cells() { return LBM_THREADS * LBM_CPT; }

extern "C" int lbm_multistep(const float* f, const float* attr, float* out,
                             int H, int W, int bh, int bw, int m,
                             float one_tau, float u_lid, long long smem,
                             int dev, void* stream) {
  if (smem < lbm_smem_bytes(bh, bw, m)) return -1;
  if (bh < 1 || H % bh) return (int)cudaErrorInvalidValue;
  const bool owned = (long long)(bh + 2 * m) * (bw + 2 * m) <= lbm_max_cells();
  const void* fn = owned ? (const void*)lbm_multistep_kernel<true>
                         : (const void*)lbm_multistep_kernel<false>;
  int grid = 0;
  int e = launch_setup(fn, dev, smem, LBM_THREADS, &grid);
  if (e) return e;
  const int ntx = (W + bw - 1) / bw;
  const int ntiles = (H / bh) * ntx;
  if (ntiles < grid) grid = ntiles;
  const int vec = tile_vec4(f, out, W, bw, m) &&
                  ((uintptr_t)attr & 15) == 0;
  if (owned) {
    lbm_multistep_kernel<true><<<grid, LBM_THREADS, (size_t)smem,
                                 (cudaStream_t)stream>>>(
        f, attr, out, H, W, bh, bw, m, ntx, ntiles, vec, one_tau, u_lid);
  } else {
    lbm_multistep_kernel<false><<<grid, LBM_THREADS, (size_t)smem,
                                  (cudaStream_t)stream>>>(
        f, attr, out, H, W, bh, bw, m, ntx, ntiles, vec, one_tau, u_lid);
  }
  return (int)cudaGetLastError();
}
