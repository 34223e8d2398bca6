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
// Tiling: one thread block per (block_h x block_w) tile. Shared memory
// holds the (block_h + 2m) x (block_w + 2m) stripe of the 9 populations,
// a second 9-plane buffer for the post-collision values (streaming reads
// the neighbours' post-collision populations, so they are materialized
// over the tile and the block synchronizes) and the attribute plane:
// 19 planes in all. Rows and columns are loaded mod H and mod W; stencil
// reads inside the tile zero-fill, so m guard cells per side go stale
// over m steps and only the center is written, into a separate output.
//
// Bound: HBM bytes per launch >= (9 + 1 + 9) H W 4 B (populations and
// attributes read once, populations written once); m fused steps per
// round trip raise the arithmetic per byte (131 flops per cell-step).

#include <cuda_runtime.h>

#define LBM_THREADS 256

__device__ __forceinline__ float lbm_tap(const float* __restrict__ plane,
                                         int y, int x, int R, int C) {
  return ((unsigned)y < (unsigned)R && (unsigned)x < (unsigned)C)
             ? plane[y * C + x]
             : 0.0f;
}

__global__ void __launch_bounds__(LBM_THREADS)
lbm_multistep_kernel(const float* __restrict__ f_in,
                     const float* __restrict__ attr_in,
                     float* __restrict__ f_out, int H, int W, int bh, int bw,
                     int m, int ntx, float one_tau, float u_lid) {
  // Lattice directions, opposites, and the f32 roundings of the weights
  // and of 6 w_i e_x,i; every loop over them is unrolled, so each index
  // folds to a constant.
  const int kEX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
  const int kEY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
  const int kOPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};
  const float w[9] = {0.44444445f, 0.11111111f, 0.11111111f, 0.11111111f,
                      0.11111111f, 0.027777778f, 0.027777778f,
                      0.027777778f, 0.027777778f};
  const float corr[9] = {0.0f, 0.6666666865348816f, 0.0f,
                         -0.6666666865348816f, 0.0f, 0.1666666716337204f,
                         -0.1666666716337204f, -0.1666666716337204f,
                         0.1666666716337204f};
  extern __shared__ float smem[];
  const int R = bh + 2 * m, C = bw + 2 * m, RC = R * C;
  float* f = smem;           // 9 planes: the state
  float* g = f + 9 * RC;     // 9 planes: post-collision populations
  float* a = g + 9 * RC;     // 1 plane: attributes
  const int by = blockIdx.x / ntx, bx = blockIdx.x - by * ntx;
  const int y0 = by * bh - m, x0 = bx * bw - m;
  for (int i = threadIdx.x; i < 10 * RC; i += blockDim.x) {
    const int p = i / RC, rem = i - p * RC, r = rem / C, c = rem - r * C;
    int gy = (y0 + r) % H;
    if (gy < 0) gy += H;
    int gx = (x0 + c) % W;
    if (gx < 0) gx += W;
    const size_t cell = (size_t)gy * W + gx;
    if (p < 9) {
      f[i] = f_in[(size_t)p * H * W + cell];
    } else {
      a[rem] = attr_in[cell];
    }
  }
  __syncthreads();
  for (int s = 0; s < m; ++s) {
    // collide (BGK), gated to fluid cells
    for (int idx = threadIdx.x; idx < RC; idx += blockDim.x) {
      float fi[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) fi[i] = f[i * RC + idx];
      const bool fluid = a[idx] < 0.5f;
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
        g[i * RC + idx] = fluid ? gi : fi[i];
      }
    }
    __syncthreads();
    // stream (zero-fill taps inside the tile), then bounce-back
    for (int idx = threadIdx.x; idx < RC; idx += blockDim.x) {
      const int r = idx / C, c = idx - r * C;
      float st[9];
#pragma unroll
      for (int i = 0; i < 9; ++i)
        st[i] = lbm_tap(g + i * RC, r - kEY[i], c - kEX[i], R, C);
      const float at = a[idx];
      const bool solid = at >= 0.5f, moving = at >= 1.5f;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float refl = st[kOPP[i]];
        const float bb = moving ? refl + corr[i] * u_lid : refl;
        f[i * RC + idx] = solid ? bb : st[i];
      }
    }
    __syncthreads();
  }
  const int n = bh * bw;
  for (int i = threadIdx.x; i < 9 * n; i += blockDim.x) {
    const int p = i / n, rem = i - p * n, r = rem / bw, c = rem - r * bw;
    const int gx = bx * bw + c;
    if (gx >= W) continue;
    f_out[((size_t)p * H + by * bh + r) * W + gx] =
        f[p * RC + (r + m) * C + (c + m)];
  }
}

extern "C" long long lbm_smem_bytes(int bh, int bw, int m) {
  return (long long)(bh + 2 * m) * (bw + 2 * m) * 19 * (long long)sizeof(float);
}

extern "C" int lbm_multistep(const float* f, const float* attr, float* out,
                             int H, int W, int bh, int bw, int m,
                             float one_tau, float u_lid, long long smem,
                             void* stream) {
  if (smem < lbm_smem_bytes(bh, bw, m)) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      lbm_multistep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ntx = (W + bw - 1) / bw;
  lbm_multistep_kernel<<<(H / bh) * ntx, LBM_THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(f, attr, out, H, W, bh, bw,
                                                 m, ntx, one_tau, u_lid);
  return (int)cudaGetLastError();
}
