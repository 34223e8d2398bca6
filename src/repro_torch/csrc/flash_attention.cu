// Blocked online-softmax attention for sm_90a (docs/port.md §lm).
//
// Replaces the JAX package's kernels/flash_attention/flash_attention.py:
// flash_attention (pl.pallas_call with the body _kernel). One thread block
// owns BQ = 64 query rows of one (batch, q head) and sweeps the key tiles
// that the causal diagonal and the sliding window leave reachable, keeping
// the running max m, the denominator l and the accumulator in f32. The
// TPU's sequential k grid axis becomes this loop; its VMEM scratch becomes
// shared memory. GQA: q head h reads kv head h / (Hq / Hkv).
//
// Each of the 4 warps owns 16 query rows from the score tile to the output,
// so only the K/V tile loads need a block-wide barrier. bf16 inputs run both
// products on the tensor cores through WMMA (16x16x16 bf16 fragments, f32
// accumulate); the probabilities are rounded to bf16 for P·V, their sum l
// is taken in f32. f32 inputs run both products as scalar f32 FMAs (the
// tests' path, kept exact to the reference's arithmetic up to summation
// order). Masked scores are -1e30 as in the reference; scores of keys past
// Sk (a ragged last tile) are -inf so they add exactly 0.
//
// Bound on the card at the Qwen3-8B prefill shape (B 4, Hq 32, Hkv 8, S
// 2048, D 128, causal, bf16): operations, ~137 GFLOP of matrix products
// against ~84 MB moved. The design is the simple one (synchronous tile
// loads, WMMA, the accumulator in shared memory); wgmma, TMA and warp
// specialisation are for the kernel's redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

// The batch, head and sequence strides (elements) of q, k, v and the
// output; outside the anonymous namespace, since the C entry point takes it.
struct FlashStrides {
  long long q[3], k[3], v[3], o[3];
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 4;             // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;          // f32 score row stride
constexpr int LDP = BK + 8;          // bf16 probability row stride
constexpr float NEG = -1e30f;        // the reference's mask value
static_assert(BQ == BK, "load_rows stages BQ rows for Q, K and V alike");

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 1; };  // scalar reads
template <> struct Pad<bf16> { static constexpr int v = 8; };   // WMMA ldm

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

template <typename T, int D> struct Layout {
  static constexpr int LD = D + Pad<T>::v;  // Q/K/V row stride
  static constexpr int LDO = D + 4;         // f32 accumulator row stride
  static constexpr size_t q = 0;
  static constexpr size_t k = align128(q + sizeof(T) * BQ * LD);
  static constexpr size_t v = align128(k + sizeof(T) * BK * LD);
  static constexpr size_t s = align128(v + sizeof(T) * BK * LD);
  static constexpr size_t p = align128(s + sizeof(float) * BQ * LDS);
  static constexpr size_t o = align128(
      p + (sizeof(T) == 2 ? sizeof(bf16) * BQ * LDP : 0));
  static constexpr size_t m = align128(o + sizeof(float) * BQ * LDO);
  static constexpr size_t bytes = m + 3 * sizeof(float) * BQ;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [0, n) of a tile into shared memory, zero past `valid`; f32 rows
// are multiplied by `mul` (the query scale) as they land.
template <int D>
__device__ void load_rows(float* dst, const float* src, long long stride,
                          int valid, float mul) {
  constexpr int LD = D + Pad<float>::v;
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] * mul : 0.0f;
  }
}

template <int D>
__device__ void load_rows(bf16* dst, const bf16* src, long long stride,
                          int valid, float) {
  constexpr int LD = D + Pad<bf16>::v;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BQ * CH; i += THREADS) {
    int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int sq,
             int sk, FlashStrides st, float scale, int causal, int window) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD, LDO = L::LDO;
  constexpr bool TC = sizeof(T) == 2;  // tensor-core path
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::q);
  T* sK = reinterpret_cast<T*>(smem + L::k);
  T* sV = reinterpret_cast<T*>(smem + L::v);
  float* sS = reinterpret_cast<float*>(smem + L::s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::p);
  float* sO = reinterpret_cast<float*>(smem + L::o);
  float* sM = reinterpret_cast<float*>(smem + L::m);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = warp * 16;
  const int qrows = min(BQ, sq - q0);
  const int qoff = sk - sq + q0;  // absolute position of the tile's row 0

  const T* qb = q + b * st.q[0] + h * st.q[1] + (long long)q0 * st.q[2];
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];
  load_rows<D>(sQ, qb, st.q[2], qrows, TC ? 1.0f : scale);
  for (int i = lane; i < 16 * LDO; i += 32) sO[row0 * LDO + i] = 0.0f;
  if (lane < 16) {
    sM[row0 + lane] = NEG;
    sL[row0 + lane] = 0.0f;
  }

  // Reachable key tiles: the causal diagonal of the last row, and the
  // window's left edge of the first (the reference's block skipping).
  const int nkt = (sk + BK - 1) / BK;
  int kt_lo = 0, kt_hi = nkt - 1;
  if (causal) {
    int last = qoff + qrows - 1;
    kt_hi = last < 0 ? -1 : min(kt_hi, last / BK);
  }
  if (window > 0) {
    int first = qoff - window + 1;
    kt_lo = first > 0 ? first / BK : 0;
  }
  const float sscale = TC ? scale : 1.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(sK, kb + (long long)k0 * st.k[2], st.k[2], sk - k0, 1.0f);
    load_rows<D>(sV, vb + (long long)k0 * st.v[2], st.v[2], sk - k0, 1.0f);
    __syncthreads();

    // S = Q K^T over this warp's 16 rows.
    if constexpr (TC) {
      using namespace nvcuda;
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
          wmma::load_matrix_sync(a, sQ + row0 * LD + kk * 16, LD);
          wmma::load_matrix_sync(bm, sK + j * 16 * LD + kk * 16, LD);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(sS + row0 * LDS + j * 16, acc, LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int r = 0; r < 16; ++r) {
        const T* qr = sQ + (row0 + r) * LD;
        for (int c = lane; c < BK; c += 32) {
          const T* kr = sK + c * LD;
          float acc = 0.0f;
          for (int d = 0; d < D; ++d) acc += to_f32(qr[d]) * to_f32(kr[d]);
          sS[(row0 + r) * LDS + c] = acc;
        }
      }
    }
    __syncwarp();

    // Online softmax, one row at a time across the warp.
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const int qpos = qoff + row;
      float s[BK / 32];
      float mx = -INFINITY;
      for (int i = 0; i < BK / 32; ++i) {
        const int c = lane + 32 * i, kpos = k0 + c;
        float x = sS[row * LDS + c] * sscale;
        bool keep = true;
        if (causal) keep = keep && qpos >= kpos;
        if (window > 0) keep = keep && qpos - kpos < window;
        x = kpos >= sk ? -INFINITY : (keep ? x : NEG);
        s[i] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_prev = sM[row];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.0f;
      for (int i = 0; i < BK / 32; ++i) {
        const int c = lane + 32 * i;
        const float p = expf(s[i] - m_new);
        sum += p;
        if constexpr (TC) sP[row * LDP + c] = __float2bfloat16(p);
        else sS[row * LDS + c] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
        sA[row] = alpha;
      }
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const float alpha = sA[row0 + r];
      for (int d = lane; d < D; d += 32) sO[(row0 + r) * LDO + d] *= alpha;
    }
    __syncwarp();

    // O += P V over this warp's 16 rows.
    if constexpr (TC) {
      using namespace nvcuda;
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + row0 * LDO + j * 16, LDO,
                               wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, sP + row0 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(bm, sV + kk * 16 * LD + j * 16, LD);
          wmma::mma_sync(acc, a, bm, acc);
        }
        wmma::store_matrix_sync(sO + row0 * LDO + j * 16, acc, LDO,
                                wmma::mem_row_major);
      }
    } else {
      for (int r = 0; r < 16; ++r) {
        const float* pr = sS + (row0 + r) * LDS;
        for (int d = lane; d < D; d += 32) {
          float acc = 0.0f;
          for (int c = 0; c < BK; ++c) acc += pr[c] * to_f32(sV[c * LD + d]);
          sO[(row0 + r) * LDO + d] += acc;
        }
      }
    }
    __syncwarp();
  }

  __syncwarp();
  T* ob = o + b * st.o[0] + h * st.o[1];
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    if (row >= qrows) break;
    const float den = fmaxf(sL[row], 1e-30f);
    T* orow = ob + (long long)(q0 + row) * st.o[2];
    for (int d = lane; d < D; d += 32)
      store_out(orow + d, sO[row * LDO + d] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, FlashStrides st, float scale,
           int causal, int window, cudaStream_t stream) {
  const size_t bytes = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq / hkv, sq, sk, st,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError(), or -2 for a
// head dim or dtype this file does not instantiate.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int hq, int hkv, int sq, int sk, int d,
                                   FlashStrides st, float scale, int causal,
                                   int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(T, DD)                                                 \
  if (d == DD)                                                            \
    return launch<T, DD>(q, k, v, o, b, hq, hkv, sq, sk, st, scale, causal, \
                         window, s);
  if (dtype == 0) {
    FLASH_CASE(float, 32) FLASH_CASE(float, 64) FLASH_CASE(float, 128)
  } else if (dtype == 1) {
    FLASH_CASE(bf16, 32) FLASH_CASE(bf16, 64) FLASH_CASE(bf16, 128)
  }
#undef FLASH_CASE
  return -2;
}
