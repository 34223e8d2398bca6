// Blocked online-softmax attention for sm_90a (docs/port.md §lm).
//
// Replaces the JAX package's kernels/flash_attention/flash_attention.py:
// flash_attention (pl.pallas_call with the body _kernel): causal diagonal
// anchored at the end of the KV (q_off = Sk - Sq + q0), sliding window,
// GQA (q head h reads kv head h / (Hq / Hkv)), wholly masked key tiles
// skipped, f32 running max, denominator and accumulator. The TPU's
// sequential k grid axis becomes a loop inside the block.
//
// Bound on the card at the Qwen3-8B prefill launch (B 4, Hq 32, Hkv 8,
// S 2048, D 128, bf16, causal): operations. The two products are 137.5
// GFLOP; q, k, v and o are 168 MB moved once (q 67.1, k 16.8, v 16.8, o
// 67.1), about 820 flops per byte, above the card's ridge of ~295.
//
// bf16 at D 64, 112 and 128 (the models' path) runs hopper::flash_kernel,
// a warp-specialised block of three warpgroups per 128 query rows:
//   - a producer warpgroup, whose one elected thread issues TMA loads of
//     the Q tile once and of each reachable 128-key K/V tile into a ring
//     of two stages, each stage with a "full" mbarrier (transaction bytes)
//     and an "empty" one (the consumers' arrivals); it gives its registers
//     away with setmaxnreg.dec;
//   - two consumer warpgroups of 64 query rows each, stepping through a
//     tile 64 keys at a time: S = Q K^T by wgmma (both operands in
//     128-byte-swizzled shared memory, K-major), the online softmax on the
//     accumulator fragment in registers (exp2 with scale * log2 e folded
//     in, row max and sum over the quad), P rounded to bf16 in registers
//     and O += P V by wgmma with A from registers and V (MN-major) from
//     shared memory. O stays in registers across the key loop; the
//     epilogue stores it through the group's rows of the Q tile.
// ptxas allocates every role within the launch's 168 registers a thread
// (3 warps on each SM sub-partition), setmaxnreg.inc notwithstanding: a
// 128-key score fragment beside O (64 + 64 floats) made it serialise the
// wgmma chains, a 64-key one (32 + 64) does not. Causal launches take the
// query tiles heaviest first; the mask runs only on steps that cross the
// diagonal, the window's edge or Sk.
//
// D 112 (Zamba2's shared attention, 3584 / 32) is held in shared memory at
// the 128-column layout of D 128: the tensor maps keep 112 as the global
// extent, so TMA zero-fills the second box's 16 columns past D (and still
// counts them in the transaction bytes); Q K^T runs only the 7 k-slices of
// real columns, P V runs at n 128 (its last 16 columns stay 0) and the
// epilogue stores 112 columns. The registers are D 128's.
//
// Multi-head latent attention (Kimi K2, DeepSeek-V3: docs/port.md §mla)
// trains at D 192 for q and k and DV 128 for v and the output: every
// kernel is templated on (D, DV), Q K^T runs over D's 12 k-slices, P V and
// the epilogue over DV's columns, and V takes DV's layout in shared memory
// (Q 48 KiB, the K ring 96, the V ring 64: one block an SM, as at D 128).
// The consumer's registers are D 128's. In the backward dK += dS^T Q runs
// at n 192 (an n128 and an n64 product), and the dK dV kernel's two
// accumulators take 96 + 64 floats a thread.
//
// f32 (the tests' exact path) and bf16 at D 32 run simple::flash_kernel:
// 4 warps, 64-row tiles loaded synchronously, f32 scalar FMAs or (bf16)
// WMMA 16x16x16 fragments, the accumulator in shared memory.
//
// Masked scores are -1e30 as in the reference and the running max starts
// there, so a row whose first reachable tile is wholly masked adds exp(0)
// terms that a later unmasked key wipes out (alpha = 0); scores of keys
// past Sk (a ragged last tile, zero-filled by TMA) are -inf and add 0.
// Asked for it (lse not null), the Hopper kernel also writes each row's
// log-sum-exp of the scaled logits and the output in f32, for the
// backward.
//
// The backward (flash_attention_bwd; docs/port.md §train) replaces no
// TPU kernel: the JAX package differentiates its chunked reference
// (kernels/flash_attention/ops.py: attention), which the port ran as an
// f32 recompute under autograd, ~24 ms a layer at the train cell's shape.
// Bound: operations. Five products of 2 D flops per kept (query, key)
// pair and head (S and dP recomputed, dV, dK, dQ): 171.9 GFLOP at the
// Mixtral training launch (B 2, Hq 32, Hkv 8, S 2048, D 128, causal),
// 0.174 ms at 989 TFLOP/s, against ~200 MB of q, k, v, the f32 o, dO
// and the gradients moved once. The design keeps S, P, dP and dS in registers
// (wgmma accumulators, P and dS rounded to bf16 only as the A operand of
// the next product) and pays two recomputed products for determinism:
// dK and dV a key tile a block, dQ a query tile a block in a pass of its
// own, each element summed by one block in a fixed order, no atomics
// (7 products: 0.243 ms bound).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <mma.h>
#include <stdint.h>

// The batch, head and sequence strides (elements) of q, k, v and the
// output; outside the anonymous namespace, since the C entry point takes it.
struct FlashStrides {
  long long q[3], k[3], v[3], o[3];
};

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG = -1e30f;  // the reference's mask value

namespace simple {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int WARPS = 4;             // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;          // f32 score row stride
constexpr int LDP = BK + 8;          // bf16 probability row stride
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

}  // namespace simple

namespace hopper {

constexpr int BQ = 128;        // query rows per block: 64 per consumer
constexpr int BK = 128;        // keys per tile
constexpr int BN = 64;         // keys per softmax step (two to a tile)
constexpr int STAGES = 2;      // K/V ring depth
constexpr int BOX = 64;        // bf16 per 128-byte swizzled row (TMA box)
constexpr int THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float kLn2 = 0.6931471805599453f, kLog2e = 1.4426950408889634f;
static_assert(PRODUCER_REGS * 128 + 2 * CONSUMER_REGS * 128 <= 65536,
              "setmaxnreg split exceeds the SM's register file");

// The columns a head dim takes in shared memory: whole 64-column boxes (D
// 112 takes 128, its last 16 zero-filled by TMA and never stored).
template <int D> constexpr int kCols = (D + BOX - 1) / BOX * BOX;

// Shared memory: Q, the K ring, the V ring, then the barriers. A tile of R
// rows is kCols / 64 boxes of R x 128 bytes, each 1024-byte aligned, as
// the TMA's 128-byte swizzle and the wgmma descriptors expect; Q and K
// take the columns of D, V those of DV.
template <int D, int DV> struct Smem {
  static constexpr int q = 0;
  static constexpr int k = q + BQ * kCols<D> * 2;
  static constexpr int v = k + STAGES * BK * kCols<D> * 2;
  static constexpr int bar = v + STAGES * BK * kCols<DV> * 2;
  static constexpr int bytes = bar + 8 * (2 * STAGES + 1);
  static constexpr int alloc = bytes + 1024;  // slack to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared memory is addressed by 32-bit shared-window addresses throughout
// (one register, where a generic pointer takes two).
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait that cannot
// end (a fault in the ring's bookkeeping) traps after ~2^28 polls, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t addr, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// One 4-D TMA load (coordinates innermost first: d, s, head, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 1ull << 62;
}
// K-major operand (rows of 128 bytes, 8-row groups 1024 bytes apart; the
// leading offset is unused): Q and K in Q K^T.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major operand of R rows (keys) x D (N): 64-wide N blocks are the
// tile's boxes, R * 128 bytes apart; 8-key groups 1024 bytes apart. V in
// P V, with the instruction's transpose bit for B.
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D = A B (+ D): m64nNk16, f32 accumulate. _ss: A and B from shared memory
// (both K-major); _rs: A from registers (the k16 fragment), B MN-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A row's reduction over the 4 threads (a quad) that hold it.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The shared address of dynamic shared memory, rounded up to 1024 bytes.
__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// One 16-key slice of O += P V: m64nNk16 over the N = kCols columns of
// the MN-major tile of R rows at shared address b. N 192 (dK at D 192)
// runs as n128 over the first two boxes and n64 over the third, which
// fill the fragment's first 64 and last 32 floats as one n192 would.
template <int N, int R>
__device__ __forceinline__ void pv_product(float (&acc)[N / 2],
                                           const uint32_t (&pa)[4],
                                           uint32_t b) {
  static_assert(N == 64 || N == 128 || N == 192,
                "P V runs at n 64, n 128 or n 192");
  if constexpr (N == 192) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc), pa,
                  mnmajor_desc<R>(b));
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(acc + 64), pa,
                 mnmajor_desc<R>(b + 2 * R * 128));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(acc, pa, mnmajor_desc<R>(b));
  } else {
    wgmma_rs_n64(acc, pa, mnmajor_desc<R>(b));
  }
}

// S = Q K^T over D for one warpgroup's 64 rows of q (R rows a box) and
// BN keys from row k of a K tile (BK rows a box): D / 16 k-slices of 32
// bytes, 4 to a 128-byte box (the zero columns past D are not read).
// Issued and committed, not waited for.
template <int D, int R, int N = BN>
__device__ __forceinline__ void qk_product(float (&sc)[N / 2], uint32_t q,
                                           uint32_t k) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = kmajor_desc(q + box * R * 128 + off);
    const uint64_t db = kmajor_desc(k + box * BK * 128 + off);
    if constexpr (N == 128) wgmma_ss_n128(sc, da, db, kk > 0);
    else wgmma_ss_n64(sc, da, db, kk > 0);
  }
  wg_commit();
}

// Wait for the products in flight; sc is then safe to read.
template <int N>
__device__ __forceinline__ void retire(float (&sc)[N]) {
  wg_wait0();
  fence_regs(sc);
}

// P (the score fragment, rounded to bf16) as the k16 A fragments of P V:
// k-slice j packs the accumulator's n8 groups 2j and 2j + 1, no shuffle.
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[j][e] = pack_bf16(sc[8 * j + 2 * e], sc[8 * j + 2 * e + 1]);
}

// The A fragments stay live (their registers unused) until the products
// that read them have retired.
template <int N>
__device__ __forceinline__ void pv_tile(float (&acc)[N / 2],
                                        uint32_t (&pa)[BN / 16][4],
                                        uint32_t v) {
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)  // 16 keys of 128 bytes a slice
    pv_product<N, BK>(acc, pa[j], v + j * 16 * 128);
  wg_commit();
  wg_wait0();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[j][e])::"memory");
}

// The block's query tile and its reachable key tiles: the causal diagonal
// of the last row, and the window's left edge of the first (the
// reference's block skipping). Causal launches run the heaviest first.
struct Tile {
  int h, b, kvh, q0, qrows, qoff, kt_lo, kt_hi;
};

__device__ __forceinline__ Tile tile_of(int group, int sq, int sk,
                                        int causal, int window) {
  Tile t;
  const int ntq = (sq + BQ - 1) / BQ;
  const int qt = causal ? ntq - 1 - static_cast<int>(blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  t.h = blockIdx.x;
  t.b = blockIdx.y;
  t.kvh = t.h / group;
  t.q0 = qt * BQ;
  t.qrows = min(BQ, sq - t.q0);
  t.qoff = sk - sq + t.q0;  // absolute position of the tile's row 0
  t.kt_lo = 0;
  t.kt_hi = (sk + BK - 1) / BK - 1;
  if (causal) {
    const int last = t.qoff + t.qrows - 1;
    t.kt_hi = last < 0 ? -1 : min(t.kt_hi, last / BK);
  }
  if (window > 0) {
    const int first = t.qoff - window + 1;
    t.kt_lo = first > 0 ? first / BK : 0;
  }
  return t;
}

// Shared addresses of the block's buffers and barriers.
template <int D, int DV> struct Buffers {
  using S = Smem<D, DV>;
  uint32_t base;
  __device__ explicit Buffers(const void* raw) : base(smem_base(raw)) {}
  __device__ uint32_t q() const { return base + S::q; }
  __device__ uint32_t k(int s) const {
    return base + S::k + s * BK * kCols<D> * 2;
  }
  __device__ uint32_t v(int s) const {
    return base + S::v + s * BK * kCols<DV> * 2;
  }
  __device__ uint32_t full(int s) const { return base + S::bar + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return base + S::bar + 8 * (STAGES + s);
  }
  __device__ uint32_t qbar() const { return base + S::bar + 16 * STAGES; }
};

// One elected thread issues every load: Q once, then K and V of each
// reachable tile into the ring once the consumers have freed the stage.
// Every box counts whole in the transaction bytes, its zero fill past D or
// past the sequence included.
template <int D, int DV>
__device__ __forceinline__ void produce(const Buffers<D, DV>& sm,
                                        const Tile& t,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv) {
  constexpr int NB = kCols<D> / BOX;    // boxes in a row of a Q or K tile
  constexpr int NBV = kCols<DV> / BOX;  // of a V tile
  mbar_expect_tx(sm.qbar(), BQ * kCols<D> * 2);
  for (int nb = 0; nb < NB; ++nb)
    tma_load(sm.q() + nb * BQ * 128, tq, sm.qbar(), nb * BOX, t.q0, t.h, t.b);
  for (int kt = t.kt_lo, n = 0; kt <= t.kt_hi; ++kt, ++n) {
    const int s = n % STAGES;
    // The first round passes at once: parity 1 of a fresh barrier.
    mbar_wait(sm.empty(s), ((n / STAGES) & 1) ^ 1);
    mbar_expect_tx(sm.full(s), BK * (kCols<D> + kCols<DV>) * 2);
    for (int nb = 0; nb < NB || nb < NBV; ++nb) {
      if (nb < NB)
        tma_load(sm.k(s) + nb * BK * 128, tk, sm.full(s), nb * BOX, kt * BK,
                 t.kvh, t.b);
      if (nb < NBV)
        tma_load(sm.v(s) + nb * BK * 128, tv, sm.full(s), nb * BOX, kt * BK,
                 t.kvh, t.b);
    }
  }
}

// Consumer warpgroup wg owns block rows [64 wg, 64 wg + 64). Accumulator
// fragment of m64nN (thread t of the warpgroup, element i): row
// 16 (t / 32) + (t % 32) / 4 + (i & 2 ? 8 : 0), column
// 8 (i / 4) + 2 (t % 4) + (i & 1). S runs over the D columns of Q and
// K, O over the DV columns of V.
template <int D, int DV>
__device__ __forceinline__ void consume(const Buffers<D, DV>& sm,
                                        const Tile& t,
                                        int wg, bf16* __restrict__ o, int sk,
                                        const FlashStrides& st, float scale2,
                                        int causal, int window, int sq,
                                        float* __restrict__ lse,
                                        long long lse_b, long long lse_h,
                                        float* __restrict__ o32) {
  constexpr int ON = kCols<DV> / 2;  // O floats a consumer thread holds
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int rl = (tid / 32) * 16 + lane / 4;  // first of the thread's rows
  const int cq = 2 * (lane % 4);
  const int qlo = t.qoff + wg * 64;           // position of the group's row 0
  const int qp = qlo + rl;                    // positions qp and qp + 8
  const uint32_t q_wg = sm.q() + wg * 64 * 128;
  float acc[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) acc[i] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;  // l: this thread's part
  mbar_wait(sm.qbar(), 0);

  for (int kt = t.kt_lo, n = 0; kt <= t.kt_hi; ++kt, ++n) {
    const int s = n % STAGES;
    mbar_wait(sm.full(s), (n / STAGES) & 1);
#pragma unroll
    for (int step = 0; step < BK / BN; ++step) {
      float sc[BN / 2];
      qk_product<D, BQ>(sc, q_wg, sm.k(s) + step * BN * 128);
      retire(sc);

      // Scale into the log2 domain; mask only a step that crosses the
      // diagonal, the window's edge or Sk for some row of this group.
      const int k0 = kt * BK + step * BN;
      const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > qlo) ||
                        (window > 0 && qlo + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qpos = qp + (i & 2 ? 8 : 0);
          const bool keep = (!causal || qpos >= kpos) &&
                            (window <= 0 || qpos - kpos < window);
          sc[i] = kpos >= sk ? -INFINITY : (keep ? sc[i] * scale2 : NEG);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sc[i] *= scale2;
      }

      // Online softmax on the fragment: each thread holds 2 rows.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (i & 2) s1 += sc[i] = exp2f(sc[i] - mn1);
        else s0 += sc[i] = exp2f(sc[i] - mn0);
      }
      l0 = l0 * a0 + s0;
      l1 = l1 * a1 + s1;
#pragma unroll
      for (int i = 0; i < ON; ++i) acc[i] *= i & 2 ? a1 : a0;

      uint32_t pa[BN / 16][4];
      pack_p(sc, pa);
      pv_tile<kCols<DV>>(acc, pa, sm.v(s) + step * BN * 128);
    }
    mbar_arrive(sm.empty(s));
  }

  // Epilogue: normalise, round to bf16 and stage this group's rows in its
  // own rows of the Q tile (same 128-byte swizzle), then 16-byte stores of
  // the DV columns (the zero ones past DV stay in registers).
  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float i0 = 1.0f / fmaxf(sum0, 1e-30f);
  const float i1 = 1.0f / fmaxf(sum1, 1e-30f);
  const uint32_t qb = sm.q();
  const int r0 = wg * 64 + rl;  // block row; r0 + 8 has the same r0 % 8
  // For the backward (only FlashAttentionFn's forward asks): the rows'
  // log-sum-exp of the scaled logits (natural log), and the output in f32,
  // (B, Hq, Sq, D) contiguous, from which the backward's D = rowsum(dO o
  // O) is exact (D from the bf16 output breaks sum_k dS = 0, which dQ
  // leans on where the keys share a large mean).
  if (lse != nullptr) {
    if (lane % 4 == 0) {
      float* lrow = lse + t.b * lse_b + t.h * lse_h + t.q0;
      if (r0 < t.qrows) lrow[r0] = (m0 + log2f(sum0)) * kLn2;
      if (r0 + 8 < t.qrows) lrow[r0 + 8] = (m1 + log2f(sum1)) * kLn2;
    }
    float* orow = o32 + ((static_cast<long long>(t.b) * gridDim.x + t.h) *
                             sq + t.q0 + r0) * DV + cq;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      if (r0 < t.qrows)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j] * i0, acc[4 * j + 1] * i0);
      if (r0 + 8 < t.qrows)
        *reinterpret_cast<float2*>(orow + 8 * DV + 8 * j) =
            make_float2(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1);
    }
  }
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const uint32_t p = qb + (j / 8) * BQ * 128 +
                       (((j % 8) ^ (r0 % 8)) * 16) + cq * 2;
    st_shared(p + r0 * 128, pack_bf16(acc[4 * j] * i0, acc[4 * j + 1] * i0));
    st_shared(p + (r0 + 8) * 128,
              pack_bf16(acc[4 * j + 2] * i1, acc[4 * j + 3] * i1));
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  bf16* ob = o + t.b * st.o[0] + t.h * st.o[1];
  constexpr int CH = DV / 8;  // 16-byte chunks in a row
  for (int idx = tid; idx < 64 * CH; idx += 128) {
    const int row = wg * 64 + idx / CH, c = idx % CH;
    if (row >= t.qrows) break;
    const uint4 val = ld_shared16(qb + (c / 8) * BQ * 128 + row * 128 +
                                  ((c % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(ob + (long long)(t.q0 + row) * st.o[2] +
                              c * 8) = val;
  }
}

// Warpgroups 0 and 1 consume, warpgroup 2 produces; each role sets its
// register budget first and the two paths never rejoin.
template <int D, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
             int group, int sq, int sk, FlashStrides st, float scale2,
             int causal, int window, float* __restrict__ lse,
             long long lse_b, long long lse_h, float* __restrict__ o32) {
  extern __shared__ unsigned char smem_raw[];
  // Broadcast so the compiler sees the role as uniform in each warp.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    const Buffers<D, DV> sm(smem_raw);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 2 * 128);  // every consumer thread arrives
    }
    mbar_init(sm.qbar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 256)
      produce<D, DV>(Buffers<D, DV>(smem_raw),
                     tile_of(group, sq, sk, causal, window), &tq, &tk, &tv);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    consume<D, DV>(Buffers<D, DV>(smem_raw),
                   tile_of(group, sq, sk, causal, window), wg, o, sk, st,
                   scale2, causal, window, sq, lse, lse_b, lse_h, o32);
  }
}

// The two products alone on one tile, for the descriptor test: s = a k^T
// (a 64 x D, k 128 x D), o = bf16(s) v (v 128 x D); f32, row-major.
template <int D>
__global__ void __launch_bounds__(128)
probe_kernel(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, float* s_out,
             float* o_out) {
  constexpr int DC = kCols<D>, NB = DC / BOX;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sA = smem_base(smem_raw);
  const uint32_t sK = sA + 64 * DC * 2, sV = sK + BK * DC * 2;
  const uint32_t bar = sV + BK * DC * 2;
  const int t = threadIdx.x, lane = t % 32;
  if (t == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (64 + 2 * BK) * DC * 2);
    for (int nb = 0; nb < NB; ++nb) {
      tma_load(sA + nb * 64 * 128, &ta, bar, nb * BOX, 0, 0, 0);
      tma_load(sK + nb * BK * 128, &tk, bar, nb * BOX, 0, 0, 0);
      tma_load(sV + nb * BK * 128, &tv, bar, nb * BOX, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  const int row = (t / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  float acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.0f;
  for (int step = 0; step < BK / BN; ++step) {
    float sc[BN / 2];
    qk_product<D, 64>(sc, sA, sK + step * BN * 128);
    retire(sc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s_out[(row + (i & 2 ? 8 : 0)) * BK + step * BN + 8 * (i / 4) + cq +
            (i & 1)] = sc[i];
    uint32_t pa[BN / 16][4];
    pack_p(sc, pa);
    pv_tile<DC>(acc, pa, sV + step * BN * 128);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i)  // the n8 groups of the D columns
    o_out[(row + (i & 2 ? 8 : 0)) * D + 8 * (i / 4) + cq + (i & 1)] = acc[i];
}

// ------------------------------------------------------------- backward
//
// Three launches (flash_attention_bwd below): flash_bwd_dot_kernel, the
// rows' D = rowsum(dO o O) in f32 from the forward's f32 output;
// flash_bwd_dkdv_kernel, a block per
// 64-key tile of one KV head, dK and dV summed in registers over every
// query tile that reaches the key tile and every query head of the group;
// flash_bwd_dq_kernel, a block per 64-query tile of one head, dQ summed in
// registers over the reachable key tiles. Each output element is summed
// by one block in a fixed order, so a launch is deterministic. Both main
// kernels are one warpgroup of 128 threads, two blocks to an SM: two
// resident tiles loaded once, a ring of two stages of two streamed tiles
// that one thread refills by TMA once every thread is done with a stage.

constexpr int BT = 64;            // rows of every backward tile
constexpr int BWD_THREADS = 128;  // one warpgroup
constexpr int BWD_STAGES = 2;

// Shared memory of a main backward kernel: two resident tiles, the ring of
// two tiles a stage, then (dK dV only) each stage's 64 log-sum-exps and
// 64 D values, then the barriers: one per stage and one for the resident
// tiles. Each pair is a tile of D columns (Q or K) and one of DV (V or
// dO), in that order.
template <int D, int DV> struct BwdSmem {
  static constexpr int tile = BT * kCols<D> * 2;    // Q or K
  static constexpr int tile_v = BT * kCols<DV> * 2;  // V or dO
  static constexpr int pair = tile + tile_v;
  static constexpr int res = 0;
  static constexpr int ring = res + pair;
  static constexpr int vec = ring + BWD_STAGES * pair;
  static constexpr int bar = vec + BWD_STAGES * 2 * BT * 4;
  static constexpr int bytes = bar + 8 * (BWD_STAGES + 1);
  static constexpr int alloc = bytes + 1024;  // slack to align the base
};

// One 1-D bulk copy (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// A 64 x 64 product over D of two K-major 64-row tiles (a's rows are M,
// b's rows are N): D / 16 k-slices, issued, not committed.
template <int D>
__device__ __forceinline__ void ss_tiles(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_n64(acc, kmajor_desc(a + box * BT * 128 + off),
                 kmajor_desc(b + box * BT * 128 + off), kk > 0);
  }
}

// acc (64 x N) += A (64 x 64, the k16 fragments in registers) B, B the 64
// rows of an MN-major tile: 4 k-slices, issued, not committed.
template <int N>
__device__ __forceinline__ void rs_tile(float (&acc)[N / 2],
                                        const uint32_t (&pa)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    pv_product<N, BT>(acc, pa[j], b + j * 16 * 128);
}

// The A fragments stay live until the products that read them retire.
__device__ __forceinline__ void hold(uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[j][e])::"memory");
}

// A 64 x 64 fragment as the k16 A fragments of a product.
__device__ __forceinline__ void pack_frag(const float (&x)[32],
                                          uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      pa[j][e] = pack_bf16(x[8 * j + 2 * e], x[8 * j + 2 * e + 1]);
}

// Store a 64-row accumulator (times mul, rounded to bf16) to rows [0,
// rows) of g (row stride ld): staged through the 64-row tile at smem
// address tile in its own 128-byte swizzle, then 16-byte stores of the D
// columns. Every product that read the tile has retired.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[kCols<D> / 2],
                                           float mul, uint32_t tile,
                                           bf16* __restrict__ g,
                                           long long ld, int rows) {
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  __syncthreads();  // every thread is past its last read of the tile
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint32_t p = tile + (j / 8) * BT * 128 +
                       (((j % 8) ^ (r0 % 8)) * 16) + cq * 2;
    st_shared(p + r0 * 128, pack_bf16(acc[4 * j] * mul,
                                      acc[4 * j + 1] * mul));
    st_shared(p + (r0 + 8) * 128, pack_bf16(acc[4 * j + 2] * mul,
                                            acc[4 * j + 3] * mul));
  }
  __syncthreads();
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  for (int idx = tid; idx < BT * CH; idx += BWD_THREADS) {
    const int row = idx / CH, c = idx % CH;
    if (row >= rows) break;
    const uint4 val = ld_shared16(tile + (c / 8) * BT * 128 + row * 128 +
                                  ((c % 8) ^ (row % 8)) * 16);
    *reinterpret_cast<uint4*>(g + row * ld + c * 8) = val;
  }
}

// Whether score (query row qr, key kc) is kept: inside both sequences and
// the forward's causal and window rules (the diagonal at Sk - Sq).
__device__ __forceinline__ bool kept(int qr, int kc, int sq, int sk,
                                     int causal, int window) {
  const int d = sk - sq + qr - kc;  // query position - key position
  return qr < sq && kc < sk && (!causal || d >= 0) &&
         (window <= 0 || d < window);
}

// Whether some score of the 64 x 64 tile (queries from q0, keys from k0)
// is cut by a rule: only such tiles run the mask.
__device__ __forceinline__ bool edge_tile(int q0, int k0, int sq, int sk,
                                          int causal, int window) {
  const int lo = sk - sq + q0 - (k0 + BT - 1);  // least query - key
  return q0 + BT > sq || k0 + BT > sk || (causal && lo < 0) ||
         (window > 0 && lo + 2 * (BT - 1) >= window);
}

// D = rowsum(dO o O) in f32 for rows [0, sqp) of each (batch, head), 0
// past Sq, from the forward's f32 output: 16 threads a row, 4 columns a
// thread at a time.
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const float* __restrict__ o,
                     const bf16* __restrict__ dout, float* __restrict__ dvec,
                     int hq, int sq, int sqp, int d, long long vs,
                     FlashStrides in, FlashStrides grad, int rows) {
  const int row = blockIdx.x * 16 + threadIdx.x / 16, part = threadIdx.x % 16;
  const int s = row % sqp, bh = row / sqp, h = bh % hq, b = bh / hq;
  float acc = 0.0f;
  if (row < rows && s < sq) {
    const float* orow = o + b * in.o[0] + h * in.o[1] + s * in.o[2];
    const bf16* drow = dout + b * grad.o[0] + h * grad.o[1] + s * grad.o[2];
    for (int c = part * 4; c < d; c += 64) {
      const float4 x = *reinterpret_cast<const float4*>(orow + c);
      const uint2 y = *reinterpret_cast<const uint2*>(drow + c);
      const float2 y0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y.x));
      const float2 y1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&y.y));
      acc += x.x * y0.x + x.y * y0.y + x.z * y1.x + x.w * y1.y;
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) dvec[bh * vs + s] = acc;
}

// dK and dV of one 64-key tile of KV head blockIdx.x in batch blockIdx.y;
// blockIdx.z is the key tile, the lowest (under a causal mask the most
// query tiles) first. In the transposed products the keys are M: S^T =
// K Q^T and dP^T = V dO^T from shared memory, P^T = exp(S^T - LSE) and
// dS^T = P^T (dP^T - D) in f32 on the fragment, then dV += P^T dO and dK
// += dS^T Q with P^T and dS^T rounded to bf16 in registers. S^T runs
// over the D columns of K and Q, dP^T over the DV columns of V and dO.
template <int D, int DV>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ dvec, long long vs,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      FlashStrides grad, int hq, int group, int sq, int sk,
                      float scale, float scale2, int causal, int window) {
  using S = BwdSmem<D, DV>;
  constexpr int ON = kCols<D> / 2, ONV = kCols<DV> / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sK = base + S::res, sV = sK + S::tile;
  const int tid = threadIdx.x, lane = tid % 32;
  const int rl = (tid / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BT;
  // The query tiles that reach the key tile: causal, from the one whose
  // last position reaches k0; the window, up to k0 + 63 + window - 1.
  const int off = sk - sq, nqt = (sq + BT - 1) / BT;
  int qt_lo = 0, qt_hi = nqt - 1;
  if (causal) {
    const int first = k0 - off;
    qt_lo = first > 0 ? first / BT : 0;
  }
  if (window > 0) {
    const int last = k0 + BT - 1 + window - 1 - off;
    qt_hi = last < 0 ? -1 : min(qt_hi, last / BT);
  }
  const int nq = max(qt_hi - qt_lo + 1, 0), total = nq * group;
  const CUtensorMap *pq = &tq, *pdo = &tdo;
  auto full = [&](int s) { return base + S::bar + 8 * s; };
  const uint32_t rbar = base + S::bar + 8 * BWD_STAGES;
  auto ring = [&](int s, int i) {
    return base + S::ring + s * S::pair + i * S::tile;
  };
  auto vec = [&](int s, int i) {
    return base + S::vec + (2 * s + i) * BT * 4;
  };
  // Item n: query head kvh * group + n / nq, query tile qt_lo + n % nq.
  auto load = [&](int n) {
    const int s = n % BWD_STAGES, h = kvh * group + n / nq;
    const int q0 = (qt_lo + n % nq) * BT;
    mbar_expect_tx(full(s), S::pair + 2 * BT * 4);
    for (int nb = 0; nb < kCols<D> / BOX || nb < kCols<DV> / BOX; ++nb) {
      if (nb < kCols<D> / BOX)
        tma_load(ring(s, 0) + nb * BT * 128, pq, full(s), nb * BOX, q0, h, b);
      if (nb < kCols<DV> / BOX)
        tma_load(ring(s, 1) + nb * BT * 128, pdo, full(s), nb * BOX, q0, h,
                 b);
    }
    const long long row = (static_cast<long long>(b) * hq + h) * vs + q0;
    bulk_load(vec(s, 0), lse + row, BT * 4, full(s));
    bulk_load(vec(s, 1), dvec + row, BT * 4, full(s));
  };
  if (tid == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(full(s), 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(rbar, S::pair);
    for (int nb = 0; nb < kCols<D> / BOX || nb < kCols<DV> / BOX; ++nb) {
      if (nb < kCols<D> / BOX)
        tma_load(sK + nb * BT * 128, &tk, rbar, nb * BOX, k0, kvh, b);
      if (nb < kCols<DV> / BOX)
        tma_load(sV + nb * BT * 128, &tv, rbar, nb * BOX, k0, kvh, b);
    }
    for (int n = 0; n < min(total, BWD_STAGES); ++n) load(n);
  }
  __syncthreads();

  float acc_dk[ON], acc_dv[ONV];
#pragma unroll
  for (int i = 0; i < ON; ++i) acc_dk[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < ONV; ++i) acc_dv[i] = 0.0f;
  mbar_wait(rbar, 0);
  for (int n = 0; n < total; ++n) {
    const int s = n % BWD_STAGES;
    const int q0 = (qt_lo + n % nq) * BT;
    mbar_wait(full(s), (n / BWD_STAGES) & 1);
    const uint32_t sQ = ring(s, 0), sDO = ring(s, 1);
    float sc[32], dp[32];
    wg_fence();
    ss_tiles<D>(sc, sK, sQ);
    ss_tiles<DV>(dp, sV, sDO);
    wg_commit();
    retire(sc);
    fence_regs(dp);

    // Fragment element i: key k0 + rl (+ 8 if i & 2), query q0 + 8 (i /
    // 4) + cq + (i & 1): each thread's queries come in pairs.
    const bool edge = edge_tile(q0, k0, sq, sk, causal, window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t c = 4 * (8 * j + cq);
      uint32_t l0, l1, d0, d1;
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                   : "=r"(l0), "=r"(l1) : "r"(vec(s, 0) + c));
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                   : "=r"(d0), "=r"(d1) : "r"(vec(s, 1) + c));
      const float lse2[2] = {__uint_as_float(l0) * kLog2e,
                             __uint_as_float(l1) * kLog2e};
      const float dd[2] = {__uint_as_float(d0), __uint_as_float(d1)};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float p = exp2f(sc[i] * scale2 - lse2[e]);
          if (edge && !kept(q0 + 8 * j + cq + e, k0 + rl + 8 * r, sq, sk,
                            causal, window))
            p = 0.0f;
          sc[i] = p;
          dp[i] = p * (dp[i] - dd[e]);
        }
    }
    uint32_t pa[4][4], pb[4][4];
    pack_frag(sc, pa);
    pack_frag(dp, pb);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wg_fence();
    rs_tile<kCols<DV>>(acc_dv, pa, sDO);
    rs_tile<kCols<D>>(acc_dk, pb, sQ);
    wg_commit();
    wg_wait0();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    hold(pa);
    hold(pb);
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && n + BWD_STAGES < total) load(n + BWD_STAGES);
  }

  const int rows = min(BT, sk - k0);
  store_tile<D>(acc_dk, scale, sK,
                dk + b * grad.k[0] + kvh * grad.k[1] + k0 * grad.k[2],
                grad.k[2], rows);
  store_tile<DV>(acc_dv, 1.0f, sV,
                dv + b * grad.v[0] + kvh * grad.v[1] + k0 * grad.v[2],
                grad.v[2], rows);
}

// dQ of one 64-query tile of head blockIdx.x in batch blockIdx.y;
// blockIdx.z picks the tile, under a causal mask the last (the most key
// tiles) first. S = Q K^T and dP = dO V^T, P and dS as in the dK dV
// kernel with the row's LSE and D in registers, dQ += dS K.
template <int D, int DV>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, long long vs,
                    bf16* __restrict__ dq, FlashStrides grad, int hq,
                    int group, int sq, int sk, float scale, float scale2,
                    int causal, int window) {
  using S = BwdSmem<D, DV>;
  constexpr int ON = kCols<D> / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t sQ = base + S::res, sDO = sQ + S::tile;
  const int tid = threadIdx.x, lane = tid % 32;
  const int rl = (tid / 32) * 16 + lane / 4, cq = 2 * (lane % 4);
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / group;
  const int nqt = (sq + BT - 1) / BT;
  const int qt = causal ? nqt - 1 - static_cast<int>(blockIdx.z)
                        : static_cast<int>(blockIdx.z);
  const int q0 = qt * BT, qoff = sk - sq + q0;
  int kt_lo = 0, kt_hi = (sk + BT - 1) / BT - 1;
  if (causal) {
    const int last = qoff + min(BT, sq - q0) - 1;
    kt_hi = last < 0 ? -1 : min(kt_hi, last / BT);
  }
  if (window > 0) {
    const int first = qoff - window + 1;
    kt_lo = first > 0 ? first / BT : 0;
  }
  const int total = max(kt_hi - kt_lo + 1, 0);
  const CUtensorMap *pk = &tk, *pv = &tv;
  auto full = [&](int s) { return base + S::bar + 8 * s; };
  const uint32_t rbar = base + S::bar + 8 * BWD_STAGES;
  auto ring = [&](int s, int i) {
    return base + S::ring + s * S::pair + i * S::tile;
  };
  auto load = [&](int n) {
    const int s = n % BWD_STAGES, kk0 = (kt_lo + n) * BT;
    mbar_expect_tx(full(s), S::pair);
    for (int nb = 0; nb < kCols<D> / BOX || nb < kCols<DV> / BOX; ++nb) {
      if (nb < kCols<D> / BOX)
        tma_load(ring(s, 0) + nb * BT * 128, pk, full(s), nb * BOX, kk0, kvh,
                 b);
      if (nb < kCols<DV> / BOX)
        tma_load(ring(s, 1) + nb * BT * 128, pv, full(s), nb * BOX, kk0, kvh,
                 b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < BWD_STAGES; ++s) mbar_init(full(s), 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(rbar, S::pair);
    for (int nb = 0; nb < kCols<D> / BOX || nb < kCols<DV> / BOX; ++nb) {
      if (nb < kCols<D> / BOX)
        tma_load(sQ + nb * BT * 128, &tq, rbar, nb * BOX, q0, h, b);
      if (nb < kCols<DV> / BOX)
        tma_load(sDO + nb * BT * 128, &tdo, rbar, nb * BOX, q0, h, b);
    }
    for (int n = 0; n < min(total, BWD_STAGES); ++n) load(n);
  }
  // This thread's two rows: their log-sum-exp (log2 units) and D.
  const long long row = (static_cast<long long>(b) * hq + h) * vs + q0 + rl;
  const float lse2[2] = {lse[row] * kLog2e, lse[row + 8] * kLog2e};
  const float dd[2] = {dvec[row], dvec[row + 8]};
  __syncthreads();

  float acc[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) acc[i] = 0.0f;
  mbar_wait(rbar, 0);
  for (int n = 0; n < total; ++n) {
    const int s = n % BWD_STAGES, k0 = (kt_lo + n) * BT;
    mbar_wait(full(s), (n / BWD_STAGES) & 1);
    const uint32_t sK = ring(s, 0), sV = ring(s, 1);
    float sc[32], dp[32];
    wg_fence();
    ss_tiles<D>(sc, sQ, sK);
    ss_tiles<DV>(dp, sDO, sV);
    wg_commit();
    retire(sc);
    fence_regs(dp);

    // Fragment element i: query q0 + rl (+ 8 if i & 2), key k0 + 8 (i /
    // 4) + cq + (i & 1).
    const bool edge = edge_tile(q0, k0, sq, sk, causal, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i & 2) ? 1 : 0;
      float p = exp2f(sc[i] * scale2 - lse2[r]);
      if (edge && !kept(q0 + rl + 8 * r, k0 + 8 * (i / 4) + cq + (i & 1),
                        sq, sk, causal, window))
        p = 0.0f;
      dp[i] = p * (dp[i] - dd[r]);
    }
    uint32_t pa[4][4];
    pack_frag(dp, pa);
    fence_regs(acc);
    wg_fence();
    rs_tile<kCols<D>>(acc, pa, sK);
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    hold(pa);
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && n + BWD_STAGES < total) load(n + BWD_STAGES);
  }
  store_tile<D>(acc, scale, sQ,
                dq + b * grad.q[0] + h * grad.q[1] + q0 * grad.q[2],
                grad.q[2], min(BT, sq - q0));
}

}  // namespace hopper

// ----------------------------------------------------------------- host

// cuTensorMapEncodeTiled from the driver library the process has loaded
// (no link against libcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeFn>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, S, H, B) of a bf16 tensor with the element strides
// st = (batch, head, seq), read in boxes of 64 x rows with the 128-byte
// swizzle. Needs a 16-byte-aligned base and 16-byte-multiple strides.
bool make_map(CUtensorMap* map, const void* p, int d, int s, int h, int b,
              const long long* st, int rows) {
  EncodeFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(s), cuuint64_t(h),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2,
                                 cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(hopper::BOX), cuuint32_t(rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_simple(const void* q, const void* k, const void* v, void* o,
                  int b, int hq, int hkv, int sq, int sk, FlashStrides st,
                  float scale, int causal, int window, cudaStream_t stream) {
  using namespace simple;
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

template <int D, int DV>
int launch_hopper(const void* q, const void* k, const void* v, void* o,
                  int b, int hq, int hkv, int sq, int sk, FlashStrides st,
                  float scale, int causal, int window, float* lse,
                  long long lse_b, long long lse_h, float* o32,
                  cudaStream_t stream) {
  using namespace hopper;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, sq, hq, b, st.q, BQ) ||
      !make_map(&tk, k, D, sk, hkv, b, st.k, BK) ||
      !make_map(&tv, v, DV, sk, hkv, b, st.v, BK))
    return -3;
  constexpr int bytes = Smem<D, DV>::alloc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  flash_kernel<D, DV><<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), hq / hkv, sq, sk, st,
      scale * kLog2e, causal, window, lse, lse_b, lse_h, o32);
  return (int)cudaGetLastError();
}

// The backward's three launches on one stream: D, then dK dV, then dQ.
template <int D, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dvec, void* dq,
               void* dk, void* dv, int b, int hq, int hkv, int sq, int sk,
               long long vs, FlashStrides in, FlashStrides grad, float scale,
               int causal, int window, cudaStream_t stream) {
  using namespace hopper;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, D, sq, hq, b, in.q, BT) ||
      !make_map(&tk, k, D, sk, hkv, b, in.k, BT) ||
      !make_map(&tv, v, DV, sk, hkv, b, in.v, BT) ||
      !make_map(&tdo, dout, DV, sq, hq, b, grad.o, BT))
    return -3;
  const int sqp = (sq + BT - 1) / BT * BT, rows = b * hq * sqp;
  flash_bwd_dot_kernel<<<(rows + 15) / 16, 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const bf16*>(dout), dvec, hq,
      sq, sqp, DV, vs, in, grad, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int bytes = BwdSmem<D, DV>::alloc;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  const int group = hq / hkv;
  flash_bwd_dkdv_kernel<D, DV><<<dim3(hkv, b, (sk + BT - 1) / BT),
                                 BWD_THREADS, bytes, stream>>>(
      tq, tk, tv, tdo, lse, dvec, vs, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), grad, hq, group, sq, sk, scale,
      scale * kLog2e, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, DV><<<dim3(hq, b, sqp / BT), BWD_THREADS, bytes,
                               stream>>>(
      tq, tk, tv, tdo, lse, dvec, vs, static_cast<bf16*>(dq), grad, hq,
      group, sq, sk, scale, scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_probe(const void* a, const void* k, const void* v, float* s,
                 float* o, cudaStream_t stream) {
  using namespace hopper;
  const long long sa[3] = {64LL * D, 64LL * D, D};
  const long long sb[3] = {(long long)BK * D, (long long)BK * D, D};
  CUtensorMap ta, tk, tv;
  if (!make_map(&ta, a, D, 64, 1, 1, sa, 64) ||
      !make_map(&tk, k, D, BK, 1, 1, sb, BK) ||
      !make_map(&tv, v, D, BK, 1, 1, sb, BK))
    return -3;
  constexpr int bytes = (64 + 2 * BK) * kCols<D> * 2 + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<D><<<1, 128, bytes, stream>>>(ta, tk, tv, s, o);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; d the head dim of q and k, dv that of v
// and the output. Returns cudaGetLastError(), -2 for a pair of head dims
// or a dtype this file does not instantiate (or an LSE asked of the
// simple kernel, which writes none), -3 for a TMA descriptor that
// cuTensorMapEncodeTiled refuses. bf16 at (d, dv) (64, 64), (112, 112),
// (128, 128) and (192, 128) (multi-head latent attention) runs the Hopper
// kernel, which also writes, when lse is not null, each row's log-sum-exp
// at lse[b * lse_b + h * lse_h + s] and the output in f32 to o32, (B, Hq,
// Sq, dv) contiguous; f32 and bf16 at D 32 run the simple one (dv = d).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int b,
                                   int hq, int hkv, int sq, int sk, int d,
                                   int dv, FlashStrides st, float scale,
                                   int causal,
                                   int window, float* lse, long long lse_b,
                                   long long lse_h, float* o32,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(LAUNCH, DD, DDV, ...)                                    \
  if (d == DD && dv == DDV)                                                 \
    return LAUNCH(q, k, v, o, b, hq, hkv, sq, sk, st, scale, causal, window, \
                  __VA_ARGS__);
  if (dtype == 1) {
    FLASH_CASE((launch_hopper<64, 64>), 64, 64, lse, lse_b, lse_h, o32, s)
    FLASH_CASE((launch_hopper<112, 112>), 112, 112, lse, lse_b, lse_h, o32, s)
    FLASH_CASE((launch_hopper<128, 128>), 128, 128, lse, lse_b, lse_h, o32, s)
    FLASH_CASE((launch_hopper<192, 128>), 192, 128, lse, lse_b, lse_h, o32, s)
  }
  if (lse != nullptr || o32 != nullptr) return -2;
  if (dtype == 0) {
    FLASH_CASE((launch_simple<float, 32>), 32, 32, s)
    FLASH_CASE((launch_simple<float, 64>), 64, 64, s)
    FLASH_CASE((launch_simple<float, 112>), 112, 112, s)
    FLASH_CASE((launch_simple<float, 128>), 128, 128, s)
  } else if (dtype == 1) {
    FLASH_CASE((launch_simple<bf16, 32>), 32, 32, s)
  }
#undef FLASH_CASE
  return -2;
}

// The backward of the Hopper path (bf16 at the forward's (d, dv) pairs):
// dq, dk and dv (the strides of grad.q, grad.k, grad.v) from q, k, v, the
// forward's f32 output o (in.o) and its log-sum-exp, and dout (grad.o);
// q, k, dq and dk have d columns, v, o, dout and dv (at gv) have dv. lse
// and dvec (D's scratch) are f32 (B, Hq, vs) with vs a multiple of 4 and
// at least Sq rounded up to 64; the rows past Sq are read and never used.
// Returns as flash_attention_fwd.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* dvec, void* dq, void* dk, void* gv,
                                   int b, int hq, int hkv, int sq, int sk,
                                   int d, int dv, long long vs,
                                   FlashStrides in, FlashStrides grad,
                                   float scale, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD_CASE(DD, DDV)                                                    \
  if (d == DD && dv == DDV)                                                  \
    return launch_bwd<DD, DDV>(q, k, v, o, dout, lse, dvec, dq, dk, gv, b,   \
                               hq, hkv, sq, sk, vs, in, grad, scale, causal, \
                               window, s);
  BWD_CASE(64, 64)
  BWD_CASE(112, 112)
  BWD_CASE(128, 128)
  BWD_CASE(192, 128)
#undef BWD_CASE
  return -2;
}

// Test entry: the Hopper kernel's two products on one tile (a 64 x d,
// k and v 128 x d, contiguous bf16; s 64 x 128 and o 64 x d, f32).
extern "C" int flash_wgmma_probe(const void* a, const void* k, const void* v,
                                 float* s, float* o, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_probe<64>(a, k, v, s, o, st);
  if (d == 112) return launch_probe<112>(a, k, v, s, o, st);
  if (d == 128) return launch_probe<128>(a, k, v, s, o, st);
  return -2;
}
