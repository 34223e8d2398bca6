// One fused AdamW pass for the port's training step, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's AdamW (train/optimizer.py) is
// plain jnp, which XLA fuses into a few passes. The port's plain version
// (train/optimizer.py: _global_norm and _update) runs one torch kernel for
// each op, with an f32 temporary for each: about 220 bytes of device
// traffic a parameter, which made the unfused f32 pass 66% of the busy time
// of the Mixtral training cell (3.16 B parameters). This file replaces it
// on a CUDA tensor.
//
// Bound on the card: bytes. The update reads p and g and the moments m and
// v once and writes p, m and v once: 22 bytes a parameter with bf16 p and g
// and f32 moments; the global norm reads g once more, 2 bytes. Nothing else
// goes to device memory, so the design is one read and one write of each
// state word:
//  * adamw_sumsq: every gradient part read once with 16-byte loads, squares
//    summed in f32; each block writes its partial to a scratch buffer (no
//    atomics), and one block (adamw_finalize) sums the partials in a fixed
//    order, so a run repeats bit for bit. It writes the norm and the clip
//    scale into a device buffer: the host reads nothing and never waits.
//  * adamw_step: one pass over every part. The parts travel as a table in
//    the kernel's parameters (as PyTorch's multi-tensor apply does), up to
//    ADAMW_MAX_PARTS a launch; the wrapper launches once per table. Blocks
//    (occupancy x SMs) walk tiles of ADAMW_TILE elements over the whole
//    table; a thread takes 8 elements of a tile, its p, g, m and v in
//    flight at once by 16-byte loads (one of bf16, two of f32), with a
//    scalar path for a part's ragged tail and for a part whose pointers
//    are not all 16-byte aligned. One vector a thread and 49 registers
//    keep 8 blocks on an SM: at the train cell's parts that walk took
//    24.3 ms against 26.5 ms for two vectors a thread at 108 registers
//    and 39.0 ms for four (H100 80GB HBM3, 700 W). lr, the clip scale and
//    the bias corrections are read from their device tensors.
//
// The arithmetic is _update's op for op, in f32 (built with -fmad=false, so
// no multiply-add is contracted, and IEEE / and sqrt):
//   gf = g * scale
//   mf = b1 * m + (1 - b1) * gf
//   vf = b2 * v + ((1 - b2) * gf) * gf
//   delta = (mf / bc1) / (sqrt(vf / bc2) + eps)   [+ wd * p on a matrix]
//   p = p - lr * delta
// with the Python scalars rounded to f32 as PyTorch rounds them (1 - b1 and
// 1 - b2 taken in double first), and p, m and v stored in their own dtypes
// by round-to-nearest-even. The finalize computes the scale as PyTorch does
// clamp(clip / clamp(norm, min=1e-9), max=1): a scalar over a tensor is the
// tensor's reciprocal times the scalar, and a NaN norm stays NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ADAMW_THREADS 256
#define ADAMW_VEC 8
#define ADAMW_TILE (ADAMW_THREADS * ADAMW_VEC)
#define ADAMW_MAX_PARTS 48
#define ADAMW_SUMSQ_BLOCKS 1024
#define ADAMW_FINALIZE_THREADS 1024

// Bits of AdamwPart::codes.
#define ADAMW_P_BF16 1
#define ADAMW_G_BF16 2
#define ADAMW_S_BF16 4
#define ADAMW_DECAY 8
#define ADAMW_ALIGNED 16

namespace {

// One contiguous tensor of the update (a parameter, or one layer of a
// stacked one): its tiles are [tile0, tile_end) of the table's walk.
struct AdamwPart {
  void* p;
  const void* g;
  void* m;
  void* v;
  long long numel;
  long long tile0;
  long long tile_end;
  int codes;
  int pad;
};

struct AdamwTable {
  AdamwPart part[ADAMW_MAX_PARTS];
  int n;
  int pad;
  long long tiles;
};

struct AdamwScalars {
  float lr, scale, bc1, bc2, b1, c1, b2, c2, eps, wd;
};

__device__ __forceinline__ float load1(const void* base, long long i,
                                       bool bf16) {
  return bf16 ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void store1(void* base, long long i, bool bf16,
                                       float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

// Elements [i, i + 8) by 16-byte loads (base + i 16-byte aligned).
__device__ __forceinline__ void load8(const void* base, long long i,
                                      bool bf16, float* x) {
  if (bf16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(base) + i));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
    const float4* q = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + i);
    const float4 a = __ldcs(q), b = __ldcs(q + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(void* base, long long i, bool bf16,
                                       const float* x) {
  if (bf16) {
    uint4 u;
    u.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
    u.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
    u.z = bf16_bits(x[4]) | (bf16_bits(x[5]) << 16);
    u.w = bf16_bits(x[6]) | (bf16_bits(x[7]) << 16);
    __stcs(reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i),
           u);
  } else {
    float4* q = reinterpret_cast<float4*>(static_cast<float*>(base) + i);
    __stcs(q, make_float4(x[0], x[1], x[2], x[3]));
    __stcs(q + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
}

// The 8 elements from i of one tensor: a vector where the whole run lies in
// the part and the part is aligned, else element by element (0 past the
// end).
__device__ __forceinline__ void load_run(const void* base, long long i,
                                         long long end, bool vec, bool bf16,
                                         float* x) {
  if (vec) {
    load8(base, i, bf16, x);
  } else {
#pragma unroll
    for (int k = 0; k < ADAMW_VEC; ++k)
      x[k] = i + k < end ? load1(base, i + k, bf16) : 0.0f;
  }
}

__device__ __forceinline__ void store_run(void* base, long long i,
                                          long long end, bool vec, bool bf16,
                                          const float* x) {
  if (vec) {
    store8(base, i, bf16, x);
  } else {
#pragma unroll
    for (int k = 0; k < ADAMW_VEC; ++k)
      if (i + k < end) store1(base, i + k, bf16, x[k]);
  }
}

// The part that holds tile t, from the part k that held the block's last
// tile (a block's tiles only increase).
__device__ __forceinline__ int part_of(const AdamwTable& t, long long tile,
                                       int k) {
  while (tile >= t.part[k].tile_end) ++k;
  return k;
}

__global__ void __launch_bounds__(ADAMW_THREADS)
    adamw_sumsq_kernel(const __grid_constant__ AdamwTable t,
                       float* partial) {
  float acc = 0.0f;
  int k = 0;
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    k = part_of(t, tile, k);
    const AdamwPart& pt = t.part[k];
    const long long i =
        (tile - pt.tile0) * ADAMW_TILE + (long long)threadIdx.x * ADAMW_VEC;
    const bool vec = (pt.codes & ADAMW_ALIGNED) && i + ADAMW_VEC <= pt.numel;
    float g[ADAMW_VEC];
    load_run(pt.g, i, pt.numel, vec, pt.codes & ADAMW_G_BF16, g);
#pragma unroll
    for (int e = 0; e < ADAMW_VEC; ++e) acc = acc + g[e] * g[e];
  }
  // a fixed reduction: shuffles within each warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = acc + __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[ADAMW_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < ADAMW_THREADS / 32; ++w) s = s + warp_sums[w];
    partial[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(ADAMW_FINALIZE_THREADS)
    adamw_finalize_kernel(const float* partial, int n, float clip,
                          float* out) {
  __shared__ float s[ADAMW_FINALIZE_THREADS];
  float a = 0.0f;
  for (int i = threadIdx.x; i < n; i += ADAMW_FINALIZE_THREADS)
    a = a + partial[i];
  s[threadIdx.x] = a;
  __syncthreads();
  for (int w = ADAMW_FINALIZE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] = s[threadIdx.x] + s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float norm = sqrtf(s[0]);
    const float lo = static_cast<float>(1e-9);
    const float d = norm < lo ? lo : norm;  // clamp(min=1e-9), NaN stays
    const float r = (1.0f / d) * clip;      // clip / d as torch computes it
    out[0] = norm;
    out[1] = r > 1.0f ? 1.0f : r;           // clamp(max=1), NaN stays
  }
}

__device__ __forceinline__ void adamw_element(float& p, float g, float& m,
                                              float& v,
                                              const AdamwScalars& s,
                                              bool decay) {
  const float gf = g * s.scale;
  const float mf = s.b1 * m + s.c1 * gf;
  const float vf = s.b2 * v + (s.c2 * gf) * gf;
  float delta = (mf / s.bc1) / (sqrtf(vf / s.bc2) + s.eps);
  if (decay) delta = delta + s.wd * p;
  p = p - s.lr * delta;
  m = mf;
  v = vf;
}

__global__ void __launch_bounds__(ADAMW_THREADS)
    adamw_step_kernel(const __grid_constant__ AdamwTable t, const float* lr,
                      const float* scale, const float* bc1, const float* bc2,
                      float b1, float c1, float b2, float c2, float eps,
                      float wd) {
  const AdamwScalars s{*lr, *scale, *bc1, *bc2, b1, c1, b2, c2, eps, wd};
  int k = 0;
  for (long long tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    k = part_of(t, tile, k);
    const AdamwPart& pt = t.part[k];
    const int c = pt.codes;
    const bool pb = c & ADAMW_P_BF16, gb = c & ADAMW_G_BF16,
               sb = c & ADAMW_S_BF16, decay = c & ADAMW_DECAY;
    const long long end = pt.numel;
    const long long i =
        (tile - pt.tile0) * ADAMW_TILE + (long long)threadIdx.x * ADAMW_VEC;
    const bool vec = (c & ADAMW_ALIGNED) && i + ADAMW_VEC <= end;
    float p[ADAMW_VEC], g[ADAMW_VEC], m[ADAMW_VEC], v[ADAMW_VEC];
    load_run(pt.p, i, end, vec, pb, p);
    load_run(pt.g, i, end, vec, gb, g);
    load_run(pt.m, i, end, vec, sb, m);
    load_run(pt.v, i, end, vec, sb, v);
#pragma unroll
    for (int e = 0; e < ADAMW_VEC; ++e)
      adamw_element(p[e], g[e], m[e], v[e], s, decay);
    store_run(pt.p, i, end, vec, pb, p);
    store_run(pt.m, i, end, vec, sb, m);
    store_run(pt.v, i, end, vec, sb, v);
  }
}

// Resident blocks of adamw_step_kernel on a device: occupancy x SMs.
int step_grid(int dev, int* grid) {
  int sms = 0, per = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, adamw_step_kernel, ADAMW_THREADS, 0);
  *grid = sms * (per > 0 ? per : 1);
  return (int)e;
}

}  // namespace

// The layout the Python wrapper mirrors (kernels/adamw/adamw.py checks it).
extern "C" int adamw_tile() { return ADAMW_TILE; }
extern "C" int adamw_max_parts() { return ADAMW_MAX_PARTS; }
extern "C" int adamw_sumsq_blocks() { return ADAMW_SUMSQ_BLOCKS; }
extern "C" long long adamw_table_bytes() { return sizeof(AdamwTable); }

// Squares of one table's gradients, summed into partial[0,
// ADAMW_SUMSQ_BLOCKS).
extern "C" int adamw_sumsq(const void* table, float* partial, void* stream) {
  const AdamwTable* t = static_cast<const AdamwTable*>(table);
  if (t->n < 1 || t->n > ADAMW_MAX_PARTS) return (int)cudaErrorInvalidValue;
  adamw_sumsq_kernel<<<ADAMW_SUMSQ_BLOCKS, ADAMW_THREADS, 0,
                       (cudaStream_t)stream>>>(*t, partial);
  return (int)cudaGetLastError();
}

// out[0] = sqrt(sum of partial[0, n)), out[1] = the clip scale.
extern "C" int adamw_finalize(const float* partial, int n, float clip,
                              float* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  adamw_finalize_kernel<<<1, ADAMW_FINALIZE_THREADS, 0,
                          (cudaStream_t)stream>>>(partial, n, clip, out);
  return (int)cudaGetLastError();
}

// One AdamW update of a table's parts in place.
extern "C" int adamw_step(const void* table, const float* lr,
                          const float* scale, const float* bc1,
                          const float* bc2, float b1, float c1, float b2,
                          float c2, float eps, float wd, int dev,
                          void* stream) {
  const AdamwTable* t = static_cast<const AdamwTable*>(table);
  if (t->n < 1 || t->n > ADAMW_MAX_PARTS || t->tiles < 1)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const int e = step_grid(dev, &grid);
  if (e) return e;
  if (t->tiles < grid) grid = (int)t->tiles;
  adamw_step_kernel<<<grid, ADAMW_THREADS, 0, (cudaStream_t)stream>>>(
      *t, lr, scale, bc1, bc2, b1, c1, b2, c2, eps, wd);
  return (int)cudaGetLastError();
}
