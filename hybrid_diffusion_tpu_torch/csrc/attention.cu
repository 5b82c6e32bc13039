// Fused spatial self-attention for the U-Net bottleneck, sm_90a: the
// forward and the backward, in bf16, fp16 and fp32.
//
// Replaces the TPU kernel hybrid_diffusion_tpu/ops/attention.py:63,
// _pallas_attention (body _attention_kernel): out = softmax(q·kᵀ/√d)·v for
// every (batch, head) slice, with fp32 scores and softmax and the output in
// the input dtype. By dtype (hd_attention_fwd), and by (N, d) as measured on
// an H100 (the routes: attention_route.h; PERF.md):
//
//   attention_fwd_wgmma_kernel (bf16, fp16 at d 32 from N = WG_MIN_N, 257,
//     and at d 64): Hopper's warpgroup products (wgmma) fed by TMA,
//     FlashAttention-3-style; P rounded to the input type;
//   attention_fwd_mma_kernel (bf16, fp16 at d 16, and at d 32 below N 257:
//     the CFG model's shapes, where it was faster): the Ampere-style
//     mma.sync kernel of the same arithmetic;
//   attention_fwd_tf32_kernel (fp32): every product as three m16n8k8 TF32
//     products (3xTF32), fp32-accurate, P kept in fp32.
//
// Bound at the flagship shape (B = 8, N = 32·32 = 1024 tokens, h = 8 heads,
// d = 32), per call:
//   operations  4·B·h·N²·d = 8.6 GFLOP  -> 8.7 us at 989 TFLOP/s (bf16 tensor cores),
//                                          17 us at 495 TFLOP/s (TF32, for fp32 inputs)
//   bytes       4·B·N·h·d·2 = 16.8 MB   -> 5.0 us at 3.35 TB/s (10 us in fp32)
//   exponentials B·h·N² = 67.1 M        -> about 17 us at the H100's ~3.9 T/s
//                                          special-function rate
// The exponentials, not the products, are the real floor in bf16 at d 16 and
// 32. In fp32 the design below computes each product as three TF32 products,
// so its own floor is 3 × 17 = 52 us.
//
// The bf16/fp16 forward on wgmma (attention_fwd_wgmma_kernel):
// - Products: a block is one producer warp and two consumer warpgroups; a
//   work tile is 128 queries of one (batch, head), 64 a consumer. S = Q·Kᵀ is
//   a wgmma with both operands read from shared memory by descriptor; P
//   stays in registers as the A operand of O += P·V, whose B operand, V, is
//   read transposed (d contiguous) by its descriptor: no ldmatrix, no
//   transposition pass.
// - Bytes: the producer's one thread issues every copy by TMA (a 4-D tensor
//   map over the strided (B, N, h, d) view: the packed q|k|v projection is
//   never split), into a ring of WGF_STAGES K/V tiles of 128 keys and two Q
//   slots, each with a full and an empty mbarrier. The grid is persistent
//   (one block an SM), so the next work tile's Q and K/V load under this
//   one's epilogue. TMA's swizzle (32, 64, 128 bytes at d 16, 32, 64: a row
//   of d values) is the one the wgmma descriptors read. The output goes
//   through a swizzled staging tile to a TMA store.
// - Exponentials: log2(e)/√d is folded into one FFMA per score,
//   p = exp2(s·c − m·c), evaluated by ex2.approx; the online softmax keeps a
//   running max per row (four chains, then the 4 lanes of a quad with
//   shuffles) and per-lane partial sums, reduced once at the end. P·V goes
//   in two parts of 64 keys, the second part's exponentials under the
//   first part's products. The two consumers' softmax and products
//   interleave on the SM.
// - What did not pay (attention_variants.py, PERF.md): a second score
//   accumulator so that the next tile's S overlaps this tile's softmax (it
//   needs more than the 168 registers a thread of a nine-warp block, and
//   ptxas serialized the wgmma), FA3's ping-pong of the two consumers, K/V
//   tiles of 64 keys, S as two products of 64 keys, three consumers, P·V
//   at once or in four parts.
// - Ragged N: TMA zero-fills rows past N and does not store them; keys past
//   N are masked to −inf before the max.
// The mma.sync forward is FlashAttention-2-style: 4 warps own 128 queries,
// two m16 tiles a warp, K/V tiles of 64 keys by cp.async into XOR-swizzled
// shared tiles, ldmatrix fragments, P reused in registers as the A fragment
// of P·V.
// Both routes need 16-byte-aligned pointers and strides that are multiples
// of 8 elements (the wrapper checks; the model's packed views meet them).
//
// The fp32 kernel takes the place of a SIMT kernel (one query a thread, a
// chain of dependent FMAs a key), which was bounded by the 67 TFLOP/s of the
// FMA units and reached a quarter of it on an H100. One TF32 product rounds each operand
// to 10 mantissa bits, past the fp32 tolerance (1e-5; a single pass errs by
// ~3e-4 on random inputs). Split x = hi + lo, both TF32 (round to nearest,
// ties away: cvt.rna.tf32.f32), and a·b = a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
// up to the dropped a_lo·b_lo, ~2^-22 relative; the small products go into
// the fp32 accumulator first. So the kernel does three times the products
// on a unit with 7.4 times the FMA units' rate. What it does about the rest:
// - Operand splits cost ALU work (five instructions each), so each value is
//   split once where it is read: Q once into registers (hi and lo A
//   fragments, straight from device memory) for the whole key loop; K and V
//   as their fragments are read from shared memory, each split feeding
//   every m16 tile of the warp; P in registers. K and V stay single fp32
//   copies in shared memory (half the bytes of split tiles, one copy pass).
// - Fragment maps: both products sum over an axis whose order is free, so
//   the k index of each step is mapped to the element that makes a lane's
//   reads contiguous (see the kernel): a float4 of Q or K covers two k8
//   steps; the scores' C fragment is P's A fragment once key k t and t+4 of
//   a step are read as keys 2t and 2t+1 (V's rows follow); the output's d
//   order lets a lane read V at all n8 tiles as one vector and store 2W
//   contiguous output values per row, with no staging.
// - Bank conflicts: K and V tiles have padded row strides (tf32_k_stride,
//   tf32_v_stride) under which every quarter-warp's vector read hits 32
//   distinct banks at d 16, 32 and 64.
// - Small N: with two m16 tiles a warp (128 queries a block), B 2, N 64
//   (64² images) gives 16 blocks of which half the warps idle. The m16
//   tiles a warp are a template argument, and at d 16 and 32 the launcher
//   takes the one-tile instance whenever the two-tile grid would leave an
//   SM without a block, which doubles the warps at work there.
// - Rounding: the tensor cores round each mma's sum toward zero. Fed the
//   running output directly, the 3 mma of every key step would bias it
//   (6e-6 measured on an H100 at N 1024, against the 1e-5 tolerance), so
//   each key step's three products are summed in a zeroed fragment that is
//   added to the output with an FADD.
// - Registers: Q's hi and lo fragments take 4·d/8·2 per m16 tile, so d 64
//   would hold one m16 tile a warp and d 16 and 32 hold two. (At d 64 the
//   wgmma kernel runs instead: this one's lse instance spilled.) Key tiles
//   of 32 keys
//   keep half the scores of 64 live; P·V walks the output tiles W at a time,
//   so that only W tiles' V fragments are live; K and V fragments are read
//   with volatile loads, and the kernel promises one block a multiprocessor
//   (__launch_bounds__): without either, ptxas spilled at d 64.
// Keys at or past N are zero-filled and masked as above. This route needs
// 16-byte-aligned pointers and strides in multiples of 4 elements.
//
// The backward replaces the reverse mode of the TPU kernel:
// _pallas_attention_bwd (hybrid_diffusion_tpu/ops/attention.py:98), the vjp
// of _xla_attention at the saved q, k, v. It computes dq, dk, dv from q, k,
// v, the forward's output O and its per-row log-sum-exp (the forward's LSE
// instance writes lse = m·c + log2(l), c = log2(e)/√d, at its epilogue), and
// dO. In fp32 two kernels, the pre-pass and attention_bwd_tf32_kernel
// (3xTF32 on mma.sync, FA2's order, dQ summed into dq itself; see the
// kernel); in bf16 and fp16 three kernels on one stream, one launch to the
// wrapper:
//   attention_bwd_prep_kernel  D = rowsum(dO∘O) in fp32 (FA2's identity,
//     for rowsum(P∘dP)), and the fp32 dQ accumulator set to zero;
//   attention_bwd_wgmma_kernel one block a (key tile of 128, batch·head),
//     walking every query tile, in bf16 at d 32 from N = WG_MIN_N (257);
//     attention_bwd_mma_kernel, 64 keys a block on mma.sync, elsewhere (d 16,
//     d 64, and d 32 below N 257: the CFG model's shapes, where it was
//     faster, and d 64, where the wgmma one spilled; fp16 at every N, where
//     ptxas serialized the wgmma one and it was slower; mma_bwd);
//   attention_bwd_dq_kernel    dQ rounded once from fp32 to T.
// Rounding follows the vjp of _xla_attention where it costs nothing: S and
// P in fp32, P rounded to T for dV = Pᵀ·dO, dP = dO·Vᵀ accumulated in fp32
// and rounded to T, dS = P∘(dP − D)/√d in fp32, every sum of a product in
// fp32 and each gradient rounded once. Two departures, measured by the CPU
// emulation (tests/test_torch_attention_bwd.py): D from the rounded output
// in place of rowsum(P∘dP), and dS rounded to T as the operand of dK and
// dQ's products.
//
// Bound at the train shape (B = 16, N = 1024, h = 8, d = 32), per call:
//   operations  10·B·h·N²·d = 43 GFLOP (S again, dP, dV, dK, dQ) -> 43 us
//   bytes       (8·B·N·h·d·2 + lse) = 17 MB                      -> 5 us
//   exponentials B·h·N² = 134 M                                  -> 34 us
// so the products and the exponentials, not the bytes.
//
// Where the design had to choose:
// - The two transposes. Pᵀ feeds dV and dSᵀ feeds dK. Each consumer
//   warpgroup owns 64 keys and computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with the
//   keys on the M side, so that Pᵀ and dSᵀ come out as accumulators that are
//   the register A operands of dV += Pᵀ·dO and dK += dSᵀ·Q as they lie; dO
//   and Q are read transposed by their descriptors. Only dQ = dS·K needs dS
//   the other way round: each consumer stores its dSᵀ in a swizzled shared
//   tile, which dQ's wgmma reads transposed.
// - dQ across key blocks: each consumer's fp32 partial over its 64 keys goes
//   through shared memory to one asynchronous TMA reduce-add (cp.reduce.
//   async.bulk.tensor .add.f32) into a scratch the pre-pass zeroes, issued
//   by one thread, where the mma.sync kernel had every thread issue float2
//   atomics. A second kernel over query tiles would be deterministic but
//   recompute S, P and dP (a half more products). So dQ's low bits vary from
//   run to run (the smoke prints the spread); dK and dV are written once, by
//   one block, and repeat exactly.
// - Ragged N. Keys at or past N are zero-filled and get P = 0 (a padded
//   key's exp2(0 − lse) would otherwise reach 2^33 on inputs whose real
//   scores are all very negative, past fp16's range, and turn dQ into
//   inf·0). Queries at or past N are zero-filled and get P = 0 too (the
//   wgmma kernel masks their columns, whose flat lse and D may be the next
//   (batch, head)'s; the mma.sync kernel takes their lse as +inf); the TMA
//   stores and reduce-adds write no row past N.
// - grad_out's layout. The kernel reads dO by strides as it reads q, k, v;
//   the wrapper copies it only where it is not in 16-byte chunks.
// - Filling the card. 128 keys a block (two consumers of 64, eight warps,
//   255 registers a thread): the train shape's B·h = 128 gives 1024 blocks
//   (7.8 waves of one block an SM), the head-sharded one's 32 gives 256 (1.9
//   waves).
// - Scale. 1/√d enters dS once; the exp2 constant c carries it for P alone.
//
// Measured times: PERF.md.
//
// The output is a contiguous (B, N, h, d) tensor; the innermost (d) stride of
// q, k and v must be 1. A ragged N is masked in every kernel.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attention_route.h"

namespace {

struct Strides {
  int64_t b, n, h;  // in elements; the d stride is 1
};

// ---------------------------------------------------------------------------
// bf16 / fp16 on mma.sync: the forward at d 32 and N < WG_MIN_N (launch).

constexpr int MMA_WARPS = 4;    // warps per block
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_M_TILES = 2;  // m16 query tiles per warp
constexpr int MMA_BLOCK_M = 16 * MMA_M_TILES * MMA_WARPS;
constexpr int MMA_BLOCK_N = 64; // keys per K/V tile
constexpr int MMA_STAGES = 2;  // K/V tiles in flight in shared memory
static_assert(MMA_BLOCK_N % 16 == 0, "tile shape");

constexpr int mma_smem_bytes(int D) {  // the Q tile, then the K and V rings
  return (MMA_BLOCK_M + 2 * MMA_STAGES * MMA_BLOCK_N) * D * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `chunk` of row `row` in a tile of rows of
// D 16-bit values. The chunks of each 128-byte line are XOR-permuted by the
// line's index, so that the 8 row addresses of one ldmatrix phase (8 rows,
// one chunk column) fall in 8 different bank groups at every D (unswizzled,
// d 32 rows of 64 bytes would collide 4 ways).
template <int D>
__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  const int linear = row * (D / 8) + chunk;
  return static_cast<uint32_t>(((linear & ~7) | ((linear ^ (linear >> 3)) & 7)) * 16);
}

// 16-byte asynchronous copy; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-bit input types: the m16n8k16 product (fp32 accumulate) and the
// packing of two fp32 values into one 32-bit fragment register (the lower
// column in the lower half).
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float round(float x) {  // to bf16 and back
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ float round(float x) {  // to fp16 and back
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Copies ROWS rows of D values (row r of the tile is row first + r of the
// slice, at base + row·stride) into a swizzled shared tile; rows at or past N
// are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t tile, const T* base,
                                          int64_t stride, int first, int N) {
  constexpr int CHUNKS = ROWS * D / 8;
#pragma unroll
  for (int i = 0; i < (CHUNKS + MMA_THREADS - 1) / MMA_THREADS; ++i) {
    const int c = threadIdx.x + i * MMA_THREADS;
    if (CHUNKS % MMA_THREADS == 0 || c < CHUNKS) {
      const int r = c / (D / 8), chunk = c % (D / 8);
      const bool valid = first + r < N;
      const T* src = base + (valid ? first + r : 0) * stride + chunk * 8;
      cp_async_16(tile + swizzle<D>(r, chunk), src, valid);
    }
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4·g + t. An A fragment
// holds rows g and g+8, columns 2t, 2t+1 (+8); a B fragment columns g, rows
// 2t, 2t+1 (+8); a C fragment rows g and g+8, columns 2t, 2t+1. Each warp
// owns MMA_M_TILES m16 tiles of queries, so that every K and V fragment it
// reads from shared memory feeds MMA_M_TILES products. With LSE the kernel
// also writes each query row's log-sum-exp in its exp2 domain, m·c +
// log2(l) (c = log2(e)/√d), to the contiguous fp32 (B, h, N) `lse`: the
// backward's P is exp2(s·c − lse).
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int N, int H, Strides qs,
                         Strides ks, Strides vs, float scale_log2) {
  constexpr int MT = MMA_M_TILES;
  constexpr int WARP_M = 16 * MT;          // queries per warp
  constexpr int KSTEPS = D / 16;           // k16 steps of Q·Kᵀ
  constexpr int S_TILES = MMA_BLOCK_N / 8; // n8 score tiles of one key tile
  constexpr int O_TILES = D / 8;           // n8 tiles of the output
  constexpr int KV_BYTES = MMA_BLOCK_N * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * MMA_BLOCK_M;
  const T* q_base = q + b * qs.b + head * qs.h;
  const T* k_base = k + b * ks.b + head * ks.h;
  const T* v_base = v + b * vs.b + head * vs.h;
  const uint32_t sq = smem_u32(smem);
  const uint32_t sk = sq + MMA_BLOCK_M * D * 2;
  const uint32_t sv = sk + MMA_STAGES * KV_BYTES;
  const int n_tiles = (N + MMA_BLOCK_N - 1) / MMA_BLOCK_N;

  // Prologue: Q and the first STAGES-1 K/V tiles, one commit group per tile
  // (Q rides with tile 0). A group is committed even when empty, so that
  // "tile i has landed" is always "at most STAGES-2 groups pending".
  load_tile<T, D, MMA_BLOCK_M>(sq, q_base, qs.n, m0, N);
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile<T, D, MMA_BLOCK_N>(sk + s * KV_BYTES, k_base, ks.n, s * MMA_BLOCK_N, N);
      load_tile<T, D, MMA_BLOCK_N>(sv + s * KV_BYTES, v_base, vs.n, s * MMA_BLOCK_N, N);
    }
    cp_async_commit();
  }

  uint32_t qf[MT][KSTEPS][4];  // this warp's queries, A fragments
  float acc[MT][O_TILES][4];   // unnormalised output rows g and g+8 of each m16
  float m_run[MT][2];          // running max of the raw scores of each row
  float l_run[MT][2];          // this lane's share of each row's running sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int t = 0; t < O_TILES; ++t)
      acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // tile `it` is visible, and every warp is done with it-1
    {
      const int next = it + MMA_STAGES - 1;
      if (next < n_tiles) {
        const int s = next % MMA_STAGES;
        load_tile<T, D, MMA_BLOCK_N>(sk + s * KV_BYTES, k_base, ks.n, next * MMA_BLOCK_N, N);
        load_tile<T, D, MMA_BLOCK_N>(sv + s * KV_BYTES, v_base, vs.n, next * MMA_BLOCK_N, N);
      }
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldmatrix_x4(qf[mt][kk], sq + swizzle<D>(warp * WARP_M + mt * 16 + (lane & 15),
                                                  kk * 2 + (lane >> 4)));
    }
    const uint32_t sk_t = sk + (it % MMA_STAGES) * KV_BYTES;
    const uint32_t sv_t = sv + (it % MMA_STAGES) * KV_BYTES;

    // S = Q·Kᵀ in fp32: one ldmatrix.x4 of K gives the B fragments of two
    // n8 key tiles for one k16 step (a key row, d contiguous, is the
    // column-major B operand as it lies).
    float s[MT][S_TILES][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < S_TILES; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < S_TILES; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sk_t + swizzle<D>(j * 8 + (lane & 7) + ((lane >> 4) << 3),
                                          kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Mma<T>::mma(s[mt][j], qf[mt][kk], kb[0], kb[1]);
          Mma<T>::mma(s[mt][j + 1], qf[mt][kk], kb[2], kb[3]);
        }
      }
    }
    const int key0 = it * MMA_BLOCK_N;
    if (key0 + MMA_BLOCK_N > N) {  // the ragged last tile: mask keys >= N
#pragma unroll
      for (int j = 0; j < S_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * (lane & 3) + (e & 1) >= N)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) s[mt][j][e] = -INFINITY;
    }

    // Online softmax on the fragments: rows g (r = 0) and g+8 (r = 1) of
    // each m16 tile, each spread over the 4 lanes of a quad. Every tile
    // holds a key < N, so the new max is finite; exp2(-inf) rescales the
    // empty first state to 0.
    // P = exp2(s·c − m·c), one FFMA and one EX2 a score. P is rounded to the
    // input type here, before P·V, as _xla_attention rounds its
    // probabilities (probs.astype(q.dtype)); the sum l stays in fp32. The
    // C fragments of n8 key tiles 2kk and 2kk+1 are the A fragment of k16
    // step kk, so P never leaves the registers.
    uint32_t pf[MT][S_TILES / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[mt][r];
#pragma unroll
        for (int j = 0; j < S_TILES; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = fast_exp2((m_run[mt][r] - mx) * scale_log2);
        m_run[mt][r] = mx;
        l_run[mt][r] *= corr;
#pragma unroll
        for (int t = 0; t < O_TILES; ++t) {
          acc[mt][t][2 * r] *= corr;
          acc[mt][t][2 * r + 1] *= corr;
        }
        mc[r] = mx * scale_log2;
      }
#pragma unroll
      for (int j = 0; j < S_TILES; ++j) {
        const float p0 = fast_exp2(fmaf(s[mt][j][0], scale_log2, -mc[0]));
        const float p1 = fast_exp2(fmaf(s[mt][j][1], scale_log2, -mc[0]));
        const float p2 = fast_exp2(fmaf(s[mt][j][2], scale_log2, -mc[1]));
        const float p3 = fast_exp2(fmaf(s[mt][j][3], scale_log2, -mc[1]));
        l_run[mt][0] += p0 + p1;
        l_run[mt][1] += p2 + p3;
        pf[mt][j / 2][(j & 1) * 2] = Mma<T>::pack(p0, p1);
        pf[mt][j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
      }
    }

    // O += P·V: ldmatrix.trans of V gives the B fragments of two n8 output
    // tiles for one k16 step of keys.
#pragma unroll
    for (int kk = 0; kk < MMA_BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int t = 0; t < O_TILES; t += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sv_t + swizzle<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                                t + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Mma<T>::mma(acc[mt][t], pf[mt][kk], vb[0], vb[1]);
          Mma<T>::mma(acc[mt][t + 1], pf[mt][kk], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // Epilogue: divide by l, round to T, stage the warp's rows in its own rows
  // of the Q tile (its Q fragments are in registers), then write each row
  // < N to the contiguous (B, N, h, d) output in 16-byte stores.
  __syncwarp();
  const int g = lane >> 2;
  const uint32_t col = (lane & 3) * 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv_l[r] = 1.f / l;
      if constexpr (LSE) {
        const int row = m0 + warp * WARP_M + mt * 16 + g + 8 * r;
        if ((lane & 3) == 0 && row < N)
          lse[static_cast<int64_t>(bh) * N + row] = m_run[mt][r] * scale_log2 + log2f(l);
      }
    }
    const int row0 = warp * WARP_M + mt * 16 + g;
#pragma unroll
    for (int t = 0; t < O_TILES; ++t) {
      *reinterpret_cast<uint32_t*>(smem + swizzle<D>(row0, t) + col) =
          Mma<T>::pack(acc[mt][t][0] * inv_l[0], acc[mt][t][1] * inv_l[0]);
      *reinterpret_cast<uint32_t*>(smem + swizzle<D>(row0 + 8, t) + col) =
          Mma<T>::pack(acc[mt][t][2] * inv_l[1], acc[mt][t][3] * inv_l[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < WARP_M * (D / 8); c += 32) {
    const int r = c / (D / 8), chunk = c % (D / 8);
    const int row = m0 + warp * WARP_M + r;
    if (row < N) {
      const uint4 val = *reinterpret_cast<const uint4*>(smem + swizzle<D>(warp * WARP_M + r, chunk));
      *reinterpret_cast<uint4*>(o + ((static_cast<int64_t>(b) * N + row) * H + head) * D +
                                chunk * 8) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 backward: the pre-pass and dQ's conversion (every route), and
// the mma.sync kernel at d 32 and N < WG_MIN_N (launch_bwd).

constexpr int BWD_WARPS = 4;                 // warps per block
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int BWD_BLOCK_N = 16 * BWD_WARPS;  // keys per block: one m16 tile a warp
constexpr int BWD_BLOCK_M = 64;              // queries per step of the loop
// Queries per sub-step: a step's products up to dK run in sub-steps of
// this many queries, so that only their scores, dP and fragments are live
// at once. 32 at d 32 and 64: 128 and 213 registers, against 166 and 255
// for the whole step (4 blocks a multiprocessor at d 32, not 3: on an H100
// the head-sharded shape 7% faster, the train shape 1-2% slower); 64 at
// d 16, where registers are not short (the CFG step's N 1024 up to 3%
// faster). attention_variants.py --backward times both.
__host__ __device__ constexpr int bwd_sub_m(int D) { return D == 16 ? 64 : 32; }
constexpr int BWD_STAGES = 2;                // Q/dO tiles in flight in shared memory
static_assert(BWD_THREADS == MMA_THREADS, "load_tile copies with MMA_THREADS threads");
static_assert(BWD_THREADS == 2 * BWD_BLOCK_M, "one thread a query row's lse and one its D");
constexpr int BWD_PREP_THREADS = 256;        // the pre-pass and the dQ conversion

// The K and V tiles, the Q and dO rings, the dSᵀ tile, then the lse and D
// rings (fp32).
constexpr int bwd_smem_bytes(int D) {
  return (2 * BWD_BLOCK_N + 2 * BWD_STAGES * BWD_BLOCK_M) * D * 2 +
         BWD_BLOCK_N * BWD_BLOCK_M * 2 + 2 * BWD_STAGES * BWD_BLOCK_M * 4;
}

// The pre-pass, one 16-byte chunk (8 values of 16 bits, 4 of fp32) of a
// (b, n, h) row a thread, D/8 (D/4) neighbouring lanes a row: D = rowsum(dO∘O)
// in fp32 into the contiguous (B, h, N) `delta`, and the row's fp32 dQ
// accumulator set to zero.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_PREP_THREADS)
attention_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                          float* __restrict__ delta, float* __restrict__ dq_acc,
                          int N, int H, int64_t rows, Strides os, Strides dos) {
  constexpr int PER = 16 / sizeof(T);  // values a chunk
  constexpr int G = D / PER;           // lanes of one row; G divides 32
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * BWD_PREP_THREADS + threadIdx.x;
  const int64_t row = idx / G;  // (b·N + n)·H + h
  const int chunk = static_cast<int>(idx % G);
  const bool valid = row < rows;
  const int head = static_cast<int>(row % H);
  const int64_t bn = row / H;
  const int n = static_cast<int>(bn % N);
  const int64_t b = bn / N;
  float sum = 0.f;
  if (valid) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + n * os.n + head * os.h + chunk * PER);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + b * dos.b + n * dos.n + head * dos.h + chunk * PER);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        sum = fmaf(__uint_as_float(ow[i]), __uint_as_float(gw[i]), sum);
      } else {
        const float2 a = Mma<T>::unpack(ow[i]), c = Mma<T>::unpack(gw[i]);
        sum = fmaf(a.x, c.x, fmaf(a.y, c.y, sum));
      }
    }
    float4* z = reinterpret_cast<float4*>(dq_acc + row * D + chunk * PER);
#pragma unroll
    for (int i = 0; i < PER / 4; ++i) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (valid && chunk == 0) delta[(b * H + head) * N + n] = sum;
}

// The fp32 dQ accumulator, rounded once to T: 8 values a thread.
template <typename T>
__global__ void __launch_bounds__(BWD_PREP_THREADS)
attention_bwd_dq_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                        int64_t chunks) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * BWD_PREP_THREADS + threadIdx.x;
  if (c >= chunks) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * c];
  const float4 e = reinterpret_cast<const float4*>(dq_acc)[2 * c + 1];
  reinterpret_cast<uint4*>(dq)[c] = make_uint4(Mma<T>::pack(a.x, a.y), Mma<T>::pack(a.z, a.w),
                                               Mma<T>::pack(e.x, e.y), Mma<T>::pack(e.z, e.w));
}

// One block a (key tile of BWD_BLOCK_N, batch·head); warp w owns keys
// 16w..16w+15 of the tile as one m16 tile, so the keys are on the M side of
// the first four products and their C fragments are the next products' A
// fragments (layouts as in the forward):
//   Sᵀ  = K·Qᵀ      A: K (registers, loaded once)    B: Q rows (ldmatrix)
//   dPᵀ = V·dOᵀ     A: V (ldmatrix, each step)       B: dO rows (ldmatrix)
//   dV += Pᵀ·dO     A: Pᵀ (Sᵀ's C fragments)        B: dO (ldmatrix.trans)
//   dK += dSᵀ·Q     A: dSᵀ (C fragments)             B: Q (ldmatrix.trans)
//   dQ += dS·K      A: dS (the dSᵀ tile, ldmatrix.trans)  B: K (ldmatrix.trans)
// For dQ, warp w takes queries 16w..16w+15 of the step against all the
// block's keys, and adds its fp32 C fragments to dq_acc with float2 atomics.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
attention_bwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
                         int N, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                         float scale_log2, float scale) {
  constexpr int KSTEPS = D / 16;              // k16 steps over d (Sᵀ, dPᵀ)
  constexpr int SUB_M = bwd_sub_m(D);         // queries a sub-step
  constexpr int SUB_TILES = SUB_M / 8;        // its n8 query tiles
  constexpr int SUB_STEPS = SUB_M / 16;       // its k16 steps of queries (dV, dK)
  static_assert(BWD_BLOCK_M % SUB_M == 0 && SUB_M % 16 == 0, "tile shape");
  constexpr int O_TILES = D / 8;              // n8 tiles over d (dV, dK, dQ)
  constexpr int KV_BYTES = BWD_BLOCK_N * D * 2;
  constexpr int QT_BYTES = BWD_BLOCK_M * D * 2;
  constexpr int DS_OFFSET = 2 * KV_BYTES + 2 * BWD_STAGES * QT_BYTES;
  constexpr int STAT_OFFSET = DS_OFFSET + BWD_BLOCK_N * BWD_BLOCK_M * 2;
  extern __shared__ __align__(128) unsigned char smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BWD_BLOCK_N;
  const T* q_base = q + b * qs.b + head * qs.h;
  const T* k_base = k + b * ks.b + head * ks.h;
  const T* v_base = v + b * vs.b + head * vs.h;
  const T* do_base = dout + b * dos.b + head * dos.h;
  const float* lse_row = lse + static_cast<int64_t>(bh) * N;
  const float* delta_row = delta + static_cast<int64_t>(bh) * N;
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + KV_BYTES;
  const uint32_t sq = sv + KV_BYTES;
  const uint32_t sdo = sq + BWD_STAGES * QT_BYTES;
  const uint32_t sds = sk + DS_OFFSET;
  float* const stats = reinterpret_cast<float*>(smem + STAT_OFFSET);  // [lse, D][stage][row]
  const int m_tiles = (N + BWD_BLOCK_M - 1) / BWD_BLOCK_M;

  // Thread i < BWD_BLOCK_M carries the lse of query row m0 + i, thread
  // BWD_BLOCK_M + i its D. Rows at or past N are never read: lse +inf makes
  // their P exactly 0, and D 0.
  const int stat_row = threadIdx.x % BWD_BLOCK_M;
  const bool is_lse = threadIdx.x < BWD_BLOCK_M;
  const float* stat_src = is_lse ? lse_row : delta_row;
  auto row_stat = [&](int m0) {
    const int r = m0 + stat_row;
    return r < N ? stat_src[r] : (is_lse ? INFINITY : 0.f);
  };
  float* const my_stat = stats + (is_lse ? 0 : BWD_STAGES * BWD_BLOCK_M) + stat_row;

  // Prologue: the block's K and V tiles and the first Q and dO tiles, one
  // commit group; the first lse and D through registers.
  load_tile<T, D, BWD_BLOCK_N>(sk, k_base, ks.n, n0, N);
  load_tile<T, D, BWD_BLOCK_N>(sv, v_base, vs.n, n0, N);
  load_tile<T, D, BWD_BLOCK_M>(sq, q_base, qs.n, 0, N);
  load_tile<T, D, BWD_BLOCK_M>(sdo, do_base, dos.n, 0, N);
  cp_async_commit();
  my_stat[0] = row_stat(0);

  uint32_t kf[KSTEPS][4];  // this warp's keys, A fragments
  float dk_acc[O_TILES][4], dv_acc[O_TILES][4];
#pragma unroll
  for (int tt = 0; tt < O_TILES; ++tt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[tt][e] = dv_acc[tt][e] = 0.f;
  // Keys at or past N (zero-filled) get P = 0: their dS then is 0 too, so
  // no padded key reaches dQ, whatever the inputs.
  const int key_lo = n0 + warp * 16 + g;
  const bool key_lo_ok = key_lo < N, key_hi_ok = key_lo + 8 < N;

  for (int it = 0; it < m_tiles; ++it) {
    const int st = it % BWD_STAGES;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` and its lse, D are visible; every warp is done with it-1
    float next_stat = 0.f;
    if (it + 1 < m_tiles) {
      const int ns = (it + 1) % BWD_STAGES;
      load_tile<T, D, BWD_BLOCK_M>(sq + ns * QT_BYTES, q_base, qs.n, (it + 1) * BWD_BLOCK_M, N);
      load_tile<T, D, BWD_BLOCK_M>(sdo + ns * QT_BYTES, do_base, dos.n, (it + 1) * BWD_BLOCK_M, N);
      next_stat = row_stat((it + 1) * BWD_BLOCK_M);
    }
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(kf[kk], sk + swizzle<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
    }
    const uint32_t sq_t = sq + st * QT_BYTES;
    const uint32_t sdo_t = sdo + st * QT_BYTES;
    const float* lse_t = stats + st * BWD_BLOCK_M;
    const float* delta_t = stats + (BWD_STAGES + st) * BWD_BLOCK_M;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in fp32, SUB_M queries at a time: a Q or
    // dO row, d contiguous, is the column-major B operand as it lies (the
    // forward's K). V's A fragments are read at each k16 step, not held:
    // at d 64, holding them as well as K's took ptxas past 255 registers.
#pragma unroll 1
    for (int sub = 0; sub < BWD_BLOCK_M / SUB_M; ++sub) {
      const int j0 = sub * SUB_TILES;   // the sub-step's first n8 query tile
      float s[SUB_TILES][4], dp[SUB_TILES][4];
#pragma unroll
      for (int j = 0; j < SUB_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t vf[4];
        ldmatrix_x4(vf, sv + swizzle<D>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
        for (int j = 0; j < SUB_TILES; j += 2) {
          const uint32_t off = swizzle<D>((j0 + j) * 8 + (lane & 7) + ((lane >> 4) << 3),
                                          kk * 2 + ((lane >> 3) & 1));
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, sq_t + off);
          ldmatrix_x4(ob, sdo_t + off);
          Mma<T>::mma(s[j], kf[kk], qb[0], qb[1]);
          Mma<T>::mma(s[j + 1], kf[kk], qb[2], qb[3]);
          Mma<T>::mma(dp[j], vf, ob[0], ob[1]);
          Mma<T>::mma(dp[j + 1], vf, ob[2], ob[3]);
        }
      }

      // Pᵀ = exp2(s·c − lse) and dSᵀ = Pᵀ∘(dPᵀ − D)/√d, rows g and g+8
      // (keys) and columns 2t, 2t+1 (queries) of each n8 tile. dP is
      // rounded to T first, as the JAX vjp rounds it; P (for dV) and dS
      // (for dK and dQ) are rounded to T as they are packed into A
      // fragments; dSᵀ also goes to shared memory for dQ.
      uint32_t pf[SUB_STEPS][4], dsf[SUB_STEPS][4];
#pragma unroll
      for (int j = 0; j < SUB_TILES; ++j) {
        const int col = (j0 + j) * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
        float p[4], ds[4];
        p[0] = key_lo_ok ? fast_exp2(fmaf(s[j][0], scale_log2, -l2.x)) : 0.f;
        p[1] = key_lo_ok ? fast_exp2(fmaf(s[j][1], scale_log2, -l2.y)) : 0.f;
        p[2] = key_hi_ok ? fast_exp2(fmaf(s[j][2], scale_log2, -l2.x)) : 0.f;
        p[3] = key_hi_ok ? fast_exp2(fmaf(s[j][3], scale_log2, -l2.y)) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = p[e] * (Mma<T>::round(dp[j][e]) - ((e & 1) ? d2.y : d2.x)) * scale;
        pf[j / 2][(j & 1) * 2] = Mma<T>::pack(p[0], p[1]);
        pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
        const uint32_t lo = Mma<T>::pack(ds[0], ds[1]), hi = Mma<T>::pack(ds[2], ds[3]);
        dsf[j / 2][(j & 1) * 2] = lo;
        dsf[j / 2][(j & 1) * 2 + 1] = hi;
        *reinterpret_cast<uint32_t*>(smem + DS_OFFSET +
                                     swizzle<BWD_BLOCK_M>(warp * 16 + g, j0 + j) + 4 * t) = lo;
        *reinterpret_cast<uint32_t*>(smem + DS_OFFSET +
                                     swizzle<BWD_BLOCK_M>(warp * 16 + g + 8, j0 + j) + 4 * t) = hi;
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q: ldmatrix.trans of dO and Q gives the
      // B fragments of two n8 tiles of d for one k16 step of queries.
#pragma unroll
      for (int kk = 0; kk < SUB_STEPS; ++kk) {
#pragma unroll
        for (int tt = 0; tt < O_TILES; tt += 2) {
          const uint32_t off = swizzle<D>(
              (sub * SUB_STEPS + kk) * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
              tt + (lane >> 4));
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, sdo_t + off);
          ldmatrix_x4_trans(qb, sq_t + off);
          Mma<T>::mma(dv_acc[tt], pf[kk], ob[0], ob[1]);
          Mma<T>::mma(dv_acc[tt + 1], pf[kk], ob[2], ob[3]);
          Mma<T>::mma(dk_acc[tt], dsf[kk], qb[0], qb[1]);
          Mma<T>::mma(dk_acc[tt + 1], dsf[kk], qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp's dSᵀ rows are in shared memory

    // dQ rows 16w..16w+15 of this step += dS·K over the block's keys: the
    // dSᵀ tile read with ldmatrix.trans is dS's A fragment, K read with
    // ldmatrix.trans the B fragments (the forward's V).
    float dq[O_TILES][4];
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) dq[tt][0] = dq[tt][1] = dq[tt][2] = dq[tt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BWD_BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, sds + swizzle<BWD_BLOCK_M>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                       warp * 2 + ((lane >> 3) & 1)));
#pragma unroll
      for (int tt = 0; tt < O_TILES; tt += 2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, sk + swizzle<D>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                              tt + (lane >> 4)));
        Mma<T>::mma(dq[tt], a, kb[0], kb[1]);
        Mma<T>::mma(dq[tt + 1], a, kb[2], kb[3]);
      }
    }
    const int row = it * BWD_BLOCK_M + warp * 16 + g;
    float* dst = dq_acc + ((static_cast<int64_t>(b) * N + row) * H + head) * D + 2 * t;
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) {
      if (row < N)
        atomicAdd(reinterpret_cast<float2*>(dst + tt * 8), make_float2(dq[tt][0], dq[tt][1]));
      if (row + 8 < N)
        atomicAdd(reinterpret_cast<float2*>(dst + 8 * H * D + tt * 8),
                  make_float2(dq[tt][2], dq[tt][3]));
    }
    if (it + 1 < m_tiles) my_stat[((it + 1) % BWD_STAGES) * BWD_BLOCK_M] = next_stat;
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // Epilogue: dV, then dK, rounded to T, staged in this warp's own rows of
  // the V tile (only this warp reads them), each key row < N written to
  // the contiguous (B, N, h, d) output in 16-byte stores.
  const uint32_t col = t * 4;
  auto store = [&](const float (&acc)[O_TILES][4], T* out) {
    __syncwarp();
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) {
      *reinterpret_cast<uint32_t*>(smem + KV_BYTES + swizzle<D>(warp * 16 + g, tt) + col) =
          Mma<T>::pack(acc[tt][0], acc[tt][1]);
      *reinterpret_cast<uint32_t*>(smem + KV_BYTES + swizzle<D>(warp * 16 + g + 8, tt) + col) =
          Mma<T>::pack(acc[tt][2], acc[tt][3]);
    }
    __syncwarp();
#pragma unroll
    for (int c = lane; c < 16 * (D / 8); c += 32) {
      const int r = c / (D / 8), chunk = c % (D / 8);
      const int key = n0 + warp * 16 + r;
      if (key < N)
        *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * N + key) * H + head) * D +
                                  chunk * 8) =
            *reinterpret_cast<const uint4*>(smem + KV_BYTES + swizzle<D>(warp * 16 + r, chunk));
    }
  };
  store(dv_acc, dv);
  store(dk_acc, dk);
}

// ---------------------------------------------------------------------------
// The Hopper layer: TMA tensor maps, an mbarrier ring, wgmma descriptors.

constexpr int WG_THREADS = 128;  // a warpgroup
// The register file is split among the SM's four sub-partitions, each
// holding every fourth warp of a block: a ninth warp (a producer warp beside
// two consumer warpgroups) puts three warps on one of them and caps every
// thread at 168 registers, as a producer warpgroup does (12 warps); eight
// warps have 255. ptxas kept the 168 under setmaxnreg and spilled (PERF.md).
constexpr int WG_ROWS = 64;      // rows of a wgmma tile (M)
// The routes by dtype, N and d: attention_route.h.

// Byte offset `off` in a tile whose rows are permuted by TMA's swizzle of SW
// bytes (32, 64 or 128): the 16-byte chunk index (bits 4..) XOR the bits 7..
// of the offset, as TMA writes the tile and wgmma reads it. Tiles start on a
// 1024-byte boundary, so the pattern is the same relative to the tile.
template <int SW>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// A wgmma shared-memory descriptor of a tile of rows of SW bytes (the
// swizzle span) at `addr`: the stride between 8-row groups `sbo` in bytes;
// the leading offset is unused (every operand is one swizzle atom wide).
// Moving along the atom (a k16 step of a K-major operand) adds to `addr`.
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo) {
  constexpr uint64_t layout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives, and expects `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of parity `parity` to complete. The loop stays inside
// the asm, so that ptxas sees no divergent path ahead of the wgmma that
// follow (which it would serialize). A wait that never ends (a lost
// arrival) traps after 2^22 tries: the launch fails, the card does not hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\n"
      "mov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 4194304;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Orders this thread's shared-memory writes before later asynchronous-proxy
// accesses (wgmma operands, TMA stores and reductions).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier `id` (1..15) over `count` threads (a warpgroup's 128).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}


// TMA: one thread copies a box between a 4-D tensor map (d, h, N, B) and
// shared memory. Loads complete on an mbarrier; stores and fp32 reduce-adds
// are bulk groups of the issuing thread.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N of this thread's bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// After a wgmma wait: the accumulators' registers are written here, so that
// the compiler reads them after the wait and not before. Before a
// wgmma.fence: the registers a wgmma reads are final here, so that the
// compiler does not compute them inside the wgmma's pipeline stage (ptxas
// would then serialize the wgmma).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// One m64nNk16 wgmma step, fp32 accumulation, T = bf16 or fp16: d (N/2
// registers a thread) = A·B + (scale_d ? d : 0). wgmma_ss reads A and B by
// shared-memory descriptors, wgmma_rs A from registers (the m16n8k16 A
// fragment of each warp's 16 rows); TA, TB transpose the operand read from
// shared memory (1: M or N contiguous, 0: K contiguous). The accumulator
// layout is the m16n8 C fragment of each warp's 16 rows, repeated over N/8
// tiles: d[4j..4j+3] = rows g, g, g+8, g+8, columns 8j + 2t, +1.
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         uint32_t scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "an N the kernels use");
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 32) {
    if constexpr (BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "%16, %17, p, 1, 1, %19, %20;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    if constexpr (!BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "%16, %17, p, 1, 1, %19, %20;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    if constexpr (BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "%32, %33, p, 1, 1, %35, %36;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    if constexpr (!BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "%32, %33, p, 1, 1, %35, %36;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    if constexpr (BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, %67, %68;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
    if constexpr (!BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
          "%64, %65, p, 1, 1, %67, %68;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b, uint32_t scale_d) {
  static_assert(N == 32 || N == 64, "an N the kernels use");
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  if constexpr (N == 32) {
    if constexpr (BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
    if constexpr (!BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
          "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  } else if constexpr (N == 64) {
    if constexpr (BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
    if constexpr (!BF16)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
          "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
}

// The forward on wgmma (bf16, fp16), FlashAttention-3's shape: a persistent
// grid of blocks of two consumer warpgroups and one producer warp. A work
// tile is WGF_BLOCK_M queries of one (batch, head); each consumer owns 64 of
// them. The producer's one thread issues every copy by TMA, into a ring of
// WGF_STAGES K/V tiles and two Q slots (the next work tile's Q loads under
// this one); each consumer computes
//   S  = Q·Kᵀ   wgmma, A: its Q rows, B: the K tile (both K-major)
//   O += P·V    wgmma, A: P in registers, B: the V tile (transposed: d
//               contiguous)
// with the online softmax of the mma.sync kernel in between (log2(e)/√d
// folded into one FFMA, P rounded to T as the A fragment), and issues the
// next tile's S right after this tile's P·V. Its output goes through a
// swizzled staging tile to a TMA store, which drops rows past N; keys past N
// (TMA's zero fill) are masked to −inf. The producer is a ninth warp, which
// caps every thread at 168 registers: one accumulator of scores (64
// registers a thread at 128 keys) fits, two (to overlap the next tile's S
// with this tile's softmax) do not, and with eight warps and the loads
// issued by a consumer thread, or with two accumulators, the kernel was
// slower (PERF.md).
constexpr int WGF_CONSUMERS = 2;          // consumer warpgroups a block
constexpr int WGF_THREADS = WGF_CONSUMERS * WG_THREADS + 32;
constexpr int WGF_BLOCK_M = WGF_CONSUMERS * WG_ROWS;  // queries a work tile
constexpr int WGF_BLOCK_N = 128;          // keys a K/V tile
constexpr int WGF_STAGES = 3;             // K/V tiles in the ring
constexpr int WGF_Q_SLOTS = 2;            // Q tiles in flight (the next work tile's)
constexpr int WGF_PV_PARTS = 2;           // P·V of a K/V tile in this many parts

constexpr int wgf_smem_bytes(int D) {
  return 1024 +  // to align the tiles to 1024 bytes
         (WGF_Q_SLOTS * WGF_BLOCK_M + 2 * WGF_STAGES * WGF_BLOCK_N + WGF_BLOCK_M) * 2 * D +
         8 * 2 * (WGF_Q_SLOTS + WGF_STAGES);
}

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(WGF_THREADS, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap o_map,
                           float* __restrict__ lse, int N, int H, int BH, float scale_log2) {
  constexpr int ROW = 2 * D;           // bytes of a row of d values: the swizzle span
  constexpr uint32_t SBO = 8 * ROW;    // bytes between 8-row groups
  constexpr int Q_BYTES = WGF_BLOCK_M * ROW;
  constexpr int KV_BYTES = WGF_BLOCK_N * ROW;
  constexpr int O_BYTES = WG_ROWS * ROW;
  constexpr int S_TILES = WGF_BLOCK_N / 8;  // n8 score tiles of a K/V tile
  constexpr int O_TILES = D / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + WGF_Q_SLOTS * Q_BYTES;
  const uint32_t sv = sk + WGF_STAGES * KV_BYTES;
  const uint32_t so = sv + WGF_STAGES * KV_BYTES;
  const uint32_t bars = so + WGF_CONSUMERS * O_BYTES;
  const auto q_full = [&](int i) { return bars + 8 * i; };
  const auto q_empty = [&](int i) { return bars + 8 * (WGF_Q_SLOTS + i); };
  const auto kv_full = [&](int i) { return bars + 8 * (2 * WGF_Q_SLOTS + i); };
  const auto kv_empty = [&](int i) { return bars + 8 * (2 * WGF_Q_SLOTS + WGF_STAGES + i); };
  const int q_blocks = (N + WGF_BLOCK_M - 1) / WGF_BLOCK_M;
  const int n_tiles = (N + WGF_BLOCK_N - 1) / WGF_BLOCK_N;
  const int work = q_blocks * BH;  // this block's work tiles: blockIdx.x, + gridDim.x, ...
  const auto work_of = [&](int w, int& b, int& head, int& m0) {
    const int bh = w / q_blocks;
    b = bh / H, head = bh % H, m0 = (w % q_blocks) * WGF_BLOCK_M;
  };

  // A slot is free again when every consumer warp has arrived.
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < WGF_Q_SLOTS; ++i)
      mbar_init(q_full(i), 1), mbar_init(q_empty(i), 4 * WGF_CONSUMERS);
#pragma unroll
    for (int i = 0; i < WGF_STAGES; ++i)
      mbar_init(kv_full(i), 1), mbar_init(kv_empty(i), 4 * WGF_CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= WGF_CONSUMERS * WG_THREADS) {  // the producer warp
    if (threadIdx.x == WGF_CONSUMERS * WG_THREADS) {
      int it = 0;  // K/V tiles issued, over every work tile
      int qi = 0;  // work tiles issued
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++qi) {
        int b, head, m0;
        work_of(w, b, head, m0);
        const int qs = qi % WGF_Q_SLOTS;
        if (qi >= WGF_Q_SLOTS) mbar_wait(q_empty(qs), (qi / WGF_Q_SLOTS - 1) & 1);
        mbar_arrive_tx(q_full(qs), Q_BYTES);
        tma_load(sq + qs * Q_BYTES, &q_map, q_full(qs), 0, head, m0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % WGF_STAGES;
          if (it >= WGF_STAGES) mbar_wait(kv_empty(s), (it / WGF_STAGES - 1) & 1);
          mbar_arrive_tx(kv_full(s), 2 * KV_BYTES);
          tma_load(sk + s * KV_BYTES, &k_map, kv_full(s), 0, head, j * WGF_BLOCK_N, b);
          tma_load(sv + s * KV_BYTES, &v_map, kv_full(s), 0, head, j * WGF_BLOCK_N, b);
        }
      }
    }
    return;
  }

  const int c = threadIdx.x / WG_THREADS;  // this consumer's 64 rows of the work tile
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const uint32_t so_c = so + c * O_BYTES;
  int it = 0, qi = 0;  // this consumer's K/V tiles and work tiles, as the producer counts them
  for (int w = blockIdx.x; w < work; w += gridDim.x, ++qi) {
    int b, head, m0;
    work_of(w, b, head, m0);
    const int bh = b * H + head;
    const int qs = qi % WGF_Q_SLOTS;
    const uint32_t q_rows = sq + qs * Q_BYTES + c * WG_ROWS * ROW;
    float acc[D / 2];  // the unnormalised output, rows g and g+8 of the warp's 16
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[WGF_BLOCK_N / 2];  // the scores of one K/V tile

    // S of K/V tile `tile` into `sc`, one commit group.
    const auto issue_s = [&](int tile) {
      const uint32_t sk_s = sk + (tile % WGF_STAGES) * KV_BYTES;
      mbar_wait(kv_full(tile % WGF_STAGES), (tile / WGF_STAGES) & 1);
      wgmma_fence();  // S's first k step ignores what `sc` held (scale-d 0)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<T, WGF_BLOCK_N, 0, 0>(sc, make_desc<ROW>(q_rows + 32 * kk, SBO),
                                       make_desc<ROW>(sk_s + 32 * kk, SBO), kk > 0);
      wgmma_commit();
    };
    // Key tile j of the work tile (the K/V tile `it`), its S issued into
    // `sc`; the commit groups in flight at the top are P·V(j−1) and S(j).
    // FIRST and LAST (compile-time, so that the wgmma waits are the same at
    // every step a call site stands for) mark the work tile's first and last.
    const auto step = [&](auto first, auto last, int j) {
      constexpr bool FIRST = decltype(first)::value, LAST = decltype(last)::value;
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(acc);
      if (lane == 0) {
        if (!FIRST) mbar_arrive(kv_empty((it - 1) % WGF_STAGES));
        if (LAST) mbar_arrive(q_empty(qs));  // Q's last read is done
      }
      const int key0 = j * WGF_BLOCK_N;
      if (LAST && key0 + WGF_BLOCK_N > N) {  // the ragged last tile: mask keys >= N
#pragma unroll
        for (int jj = 0; jj < S_TILES; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + jj * 8 + 2 * t + (e & 1) >= N) sc[4 * jj + e] = -INFINITY;
      }
      // The online softmax, rows g (r = 0) and g+8 (r = 1), each spread over
      // the 4 lanes of a quad: the max in four independent chains, then the
      // quad's shuffles. Every tile holds a key < N, so the new max is finite;
      // exp2(−inf) rescales the empty first state to 0.
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float part[4] = {m_run[r], -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
        for (int jj = 0; jj < S_TILES; ++jj)
          part[jj % 4] = fmaxf(part[jj % 4], fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]));
        float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = fast_exp2((m_run[r] - mx) * scale_log2);
        m_run[r] = mx;
        mc[r] = mx * scale_log2;
        l_run[r] *= corr;
#pragma unroll
        for (int tt = 0; tt < O_TILES; ++tt) {
          acc[4 * tt + 2 * r] *= corr;
          acc[4 * tt + 2 * r + 1] *= corr;
        }
      }
      // P = exp2(s·c − m·c), rounded to T: n8 tiles 2kk and 2kk+1 are the A
      // fragment of k16 step kk of P·V. The row sums in two chains a row.
      // P·V goes in WGF_PV_PARTS parts of the keys, each issued once its P
      // is packed, so that the next part's exponentials run under it.
      constexpr int PART = S_TILES / WGF_PV_PARTS;  // n8 score tiles a part
      const uint32_t sv_s = sv + (it % WGF_STAGES) * KV_BYTES;
      float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      fence_regs(acc);
#pragma unroll
      for (int part = 0; part < WGF_PV_PARTS; ++part) {
        uint32_t pf[PART / 2][4];
#pragma unroll
        for (int i = 0; i < PART; ++i) {
          const int jj = part * PART + i;
          const float p0 = fast_exp2(fmaf(sc[4 * jj], scale_log2, -mc[0]));
          const float p1 = fast_exp2(fmaf(sc[4 * jj + 1], scale_log2, -mc[0]));
          const float p2 = fast_exp2(fmaf(sc[4 * jj + 2], scale_log2, -mc[1]));
          const float p3 = fast_exp2(fmaf(sc[4 * jj + 3], scale_log2, -mc[1]));
          ps[0][jj & 1] += p0 + p1;
          ps[1][jj & 1] += p2 + p3;
          pf[i / 2][(i & 1) * 2] = Mma<T>::pack(p0, p1);
          pf[i / 2][(i & 1) * 2 + 1] = Mma<T>::pack(p2, p3);
        }
        fence_regs(pf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PART / 2; ++kk)
          wgmma_rs<T, D, 1>(acc, pf[kk],
                            make_desc<ROW>(sv_s + (part * PART / 2 + kk) * 16 * ROW, SBO), 1u);
        wgmma_commit();
      }
      l_run[0] += ps[0][0] + ps[0][1];
      l_run[1] += ps[1][0] + ps[1][1];
      ++it;
      if constexpr (!LAST) issue_s(it);
    };

    const std::true_type yes{};
    const std::false_type no{};
    mbar_wait(q_full(qs), (qi / WGF_Q_SLOTS) & 1);
    issue_s(it);
    if (n_tiles == 1) {
      step(yes, yes, 0);
    } else {
      step(yes, no, 0);
      for (int j = 1; j + 1 < n_tiles; ++j) step(no, no, j);
      step(no, yes, n_tiles - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(kv_empty((it - 1) % WGF_STAGES));

    // Epilogue: divide by l, round to T, stage the rows in this consumer's
    // swizzled tile (once the previous work tile's store has read it), and
    // store them by TMA, which writes rows < N only.
    float inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv_l[r] = 1.f / l;
      if constexpr (LSE) {
        const int row = m0 + c * WG_ROWS + warp * 16 + g + 8 * r;
        if (t == 0 && row < N)
          lse[static_cast<int64_t>(bh) * N + row] = m_run[r] * scale_log2 + log2f(l);
      }
    }
    if (tid == 0) bulk_wait_read<0>();
    named_bar_sync(1 + c, WG_THREADS);
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) {
      st_shared_u32(so_c + swz<ROW>(r0 * ROW + tt * 16 + t * 4),
                    Mma<T>::pack(acc[4 * tt] * inv_l[0], acc[4 * tt + 1] * inv_l[0]));
      st_shared_u32(so_c + swz<ROW>((r0 + 8) * ROW + tt * 16 + t * 4),
                    Mma<T>::pack(acc[4 * tt + 2] * inv_l[1], acc[4 * tt + 3] * inv_l[1]));
    }
    fence_proxy_async();
    named_bar_sync(1 + c, WG_THREADS);
    if (tid == 0) {
      tma_store(&o_map, so_c, 0, head, m0 + c * WG_ROWS, b);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// The backward on wgmma (bf16, fp16): one block a (key tile of WGB_BLOCK_N,
// batch·head), two consumer warpgroups, each owning 64 keys on the M side of
// its products, as in the mma.sync kernel:
//   Sᵀ  = K·Qᵀ    A: its K rows            B: the Q tile      (smem, K-major)
//   dPᵀ = V·dOᵀ   A: its V rows            B: the dO tile     (smem, K-major)
//   dV += Pᵀ·dO   A: Pᵀ (Sᵀ's accumulator, in registers)  B: dO (transposed)
//   dK += dSᵀ·Q   A: dSᵀ (registers)                       B: Q (transposed)
//   dQ  = dS·K    A: dSᵀ from its shared tile (transposed)  B: its K rows (transposed)
// K and V arrive once by TMA; the first thread streams the Q and dO tiles of
// WGB_BLOCK_M queries, with their lse and D, through the ring by TMA, two
// tiles ahead. lse and D are read as one flat array each, so the ragged last
// tile of a (batch, head) reads the next one's values: those columns (and
// the zero-filled Q and dO rows) get P = 0. A consumer issues, after a
// tile's P and dS, its dQ, its dV and dK and the next tile's Sᵀ and dPᵀ,
// and stages dQ once they are done, before the next tile's P and dS.
// (Issuing the next Sᵀ and dPᵀ before this tile's P and dS, into a second
// pair of accumulators, made ptxas serialize the wgmma for want of registers
// and was slower; so was staging dQ under the other products; PERF.md.)
// dSᵀ alternates between two
// shared tiles. A consumer's fp32 dQ partial over its 64 keys goes through
// one of its two swizzled staging tiles to one TMA reduce-add a box into the
// scratch the pre-pass zeroed, issued by its first thread after the next
// step's dSᵀ barrier, which also tells it that every thread has staged its
// share. dK and dV go out once, by TMA stores.
constexpr int WGB_THREADS = 2 * WG_THREADS;  // two consumers; thread 0 loads
constexpr int WGB_BLOCK_N = 2 * WG_ROWS;  // keys a block: 64 a consumer
constexpr int WGB_BLOCK_M = WG_ROWS;      // queries a step
constexpr int WGB_STAGES = 4;             // Q/dO tiles in the ring
// The ring holds the tile being freed, this one, the next (its Sᵀ, dPᵀ in
// flight) and the one being loaded.
static_assert(WGB_STAGES >= 4, "the loads would wait on the tile being read");
// fp32 columns of one dQ reduce box: its rows are at most 128 bytes (the
// widest swizzle), so d 64 takes two boxes.
__host__ __device__ constexpr int wgb_dq_box(int D) { return D < 32 ? D : 32; }

constexpr int wgb_smem_bytes(int D) {
  return 1024 +                                   // to align the tiles to 1024 bytes
         2 * WGB_BLOCK_N * 2 * D +                // K, V
         WGB_STAGES * 2 * WGB_BLOCK_M * 2 * D +   // the Q and dO ring
         2 * 2 * WG_ROWS * WGB_BLOCK_M * 2 +      // dSᵀ, two tiles a consumer
         2 * 2 * WGB_BLOCK_M * D * 4 +            // dQ staging, two a consumer
         WGB_STAGES * 2 * WGB_BLOCK_M * 4 +       // the lse and D ring
         8 * (1 + 2 * WGB_STAGES);
}

template <typename T, int D>
__global__ void __launch_bounds__(WGB_THREADS, 1)
attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap dk_map,
                           const __grid_constant__ CUtensorMap dv_map,
                           const __grid_constant__ CUtensorMap dq_map,
                           const __grid_constant__ CUtensorMap lse_map,
                           const __grid_constant__ CUtensorMap delta_map,
                           int N, int H, float scale_log2, float scale) {
  constexpr int ROW = 2 * D;                // bytes of a row of d values: the swizzle span
  constexpr uint32_t SBO = 8 * ROW;
  constexpr int KV_BYTES = WGB_BLOCK_N * ROW;
  constexpr int QT_BYTES = WGB_BLOCK_M * ROW;
  constexpr int DS_ROW = 2 * WGB_BLOCK_M;   // 128 bytes: one key's dS over the step's queries
  constexpr int DS_BYTES = WG_ROWS * DS_ROW;
  constexpr int QB = wgb_dq_box(D);         // fp32 columns of a dQ reduce box
  constexpr int QB_ROW = 4 * QB;            // its row bytes: its swizzle span
  constexpr int DQ_BYTES = WGB_BLOCK_M * D * 4;
  constexpr int STAT_BYTES = 2 * WGB_BLOCK_M * 4;  // a stage's lse, then its D
  constexpr int Q_STEPS = WGB_BLOCK_M / 16;        // k16 steps over queries (dV, dK)
  constexpr int O_TILES = D / 8;
  constexpr int ACC = WGB_BLOCK_M / 2;             // Sᵀ or dPᵀ registers a thread
  static_assert(DS_ROW == 128, "dSᵀ rows are one 128-byte swizzle atom");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + KV_BYTES;
  const uint32_t sq = sv + KV_BYTES;
  const uint32_t sdo = sq + WGB_STAGES * QT_BYTES;
  const uint32_t sds = sdo + WGB_STAGES * QT_BYTES;
  const uint32_t sdq = sds + 4 * DS_BYTES;
  const uint32_t stats = sdq + 4 * DQ_BYTES;
  const uint32_t bars = stats + WGB_STAGES * STAT_BYTES;
  const uint32_t kv_full = bars;
  const auto full = [&](int i) { return bars + 8 * (1 + i); };
  const auto empty = [&](int i) { return bars + 8 * (1 + WGB_STAGES + i); };
  const int bh = blockIdx.y, b = bh / H, head = bh % H;
  const int n0 = blockIdx.x * WGB_BLOCK_N;
  const int m_tiles = (N + WGB_BLOCK_M - 1) / WGB_BLOCK_M;

  const int c = threadIdx.x / WG_THREADS;  // this consumer's 64 keys of the block
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool loader = threadIdx.x == 0;

  // A stage is full when its Q, dO, lse and D tiles have landed; free when
  // the 8 consumer warps have arrived.
  if (loader) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int i = 0; i < WGB_STAGES; ++i) mbar_init(full(i), 1), mbar_init(empty(i), 8);
    fence_barrier_init();
  }
  __syncthreads();

  // The loads, by the loader thread: query tile j to stage j mod WGB_STAGES
  // once tile j − WGB_STAGES has freed it.
  const auto load_q = [&](int j) {
    const int s = j % WGB_STAGES;
    if (j >= WGB_STAGES) mbar_wait(empty(s), (j / WGB_STAGES - 1) & 1);
    mbar_arrive_tx(full(s), 2 * QT_BYTES + STAT_BYTES);
    tma_load(sq + s * QT_BYTES, &q_map, full(s), 0, head, j * WGB_BLOCK_M, b);
    tma_load(sdo + s * QT_BYTES, &do_map, full(s), 0, head, j * WGB_BLOCK_M, b);
    const int flat = bh * N + j * WGB_BLOCK_M;
    tma_load_1d(stats + s * STAT_BYTES, &lse_map, full(s), flat);
    tma_load_1d(stats + s * STAT_BYTES + WGB_BLOCK_M * 4, &delta_map, full(s), flat);
  };
  if (loader) {
    mbar_arrive_tx(kv_full, 2 * KV_BYTES);
    tma_load(sk, &k_map, kv_full, 0, head, n0, b);
    tma_load(sv, &v_map, kv_full, 0, head, n0, b);
    for (int j = 0; j < 2 && j < m_tiles; ++j) load_q(j);
  }

  const uint32_t k_rows = sk + c * WG_ROWS * ROW;
  const uint32_t v_rows = sv + c * WG_ROWS * ROW;
  // Keys at or past N (zero-filled) get P = 0: their dS is 0 too, so no
  // padded key reaches dQ, whatever the inputs.
  const int key_lo = n0 + c * WG_ROWS + warp * 16 + g;
  const bool key_lo_ok = key_lo < N, key_hi_ok = key_lo + 8 < N;
  const int r0 = warp * 16 + g;
  float dv[D / 2], dk[D / 2], dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

  // Sᵀ and dPᵀ of query tile j into (st, dp), one commit group.
  const auto issue_sdp = [&](int j, float (&st)[ACC], float (&dp)[ACC]) {
    const int s = j % WGB_STAGES;
    mbar_wait(full(s), (j / WGB_STAGES) & 1);
    wgmma_fence();  // the first k step ignores what (st, dp) held (scale-d 0)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<T, WGB_BLOCK_M, 0, 0>(st, make_desc<ROW>(k_rows + 32 * kk, SBO),
                                     make_desc<ROW>(sq + s * QT_BYTES + 32 * kk, SBO), kk > 0);
      wgmma_ss<T, WGB_BLOCK_M, 0, 0>(dp, make_desc<ROW>(v_rows + 32 * kk, SBO),
                                     make_desc<ROW>(sdo + s * QT_BYTES + 32 * kk, SBO), kk > 0);
    }
    wgmma_commit();
  };
  // dQ of query tile j (in `dq`, its products complete) into this
  // consumer's staging tile j mod 2, whose last reduce-add (tile j − 2) has
  // read it (thread 0 waited for that before step j's barrier, which this
  // thread has passed); then fenced for the reduce-add's asynchronous read.
  const auto stage_dq = [&](int j) {
    const uint32_t tile = sdq + (2 * c + (j & 1)) * DQ_BYTES;
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) {
      const int col = tt * 8 + 2 * t;
      const uint32_t box = tile + (col / QB) * WGB_BLOCK_M * QB_ROW;
      const int cw = col % QB;
      st_shared_f2(box + swz<QB_ROW>(r0 * QB_ROW + cw * 4), dq[4 * tt], dq[4 * tt + 1]);
      st_shared_f2(box + swz<QB_ROW>((r0 + 8) * QB_ROW + cw * 4), dq[4 * tt + 2], dq[4 * tt + 3]);
    }
    fence_proxy_async();
  };
  // By thread 0, after a barrier that every thread passed after staging
  // tile j: its reduce-adds, which drop rows past N, as one bulk group.
  const auto reduce_dq = [&](int j) {
    const uint32_t tile = sdq + (2 * c + (j & 1)) * DQ_BYTES;
#pragma unroll
    for (int cc = 0; cc < D / QB; ++cc)
      tma_reduce_add(&dq_map, tile + cc * WGB_BLOCK_M * QB_ROW, cc * QB, head,
                     j * WGB_BLOCK_M, b);
    bulk_commit();
  };
  // Query tile j, its Sᵀ and dPᵀ issued into (st, dp); FIRST and LAST
  // (compile-time, so that every wgmma wait has a fixed count where it
  // stands) mark the first and last tile. The commit groups in flight at the
  // top are dQ(j−1), dV/dK(j−1) and Sᵀ/dPᵀ(j); dQ(j−1) is staged right
  // after them, before this tile's P and dS.
  float st[ACC], dp[ACC];
  const auto step = [&](auto first, auto last, int j) {
    constexpr bool FIRST = decltype(first)::value, LAST = decltype(last)::value;
    const int s = j % WGB_STAGES;
    if (loader && j + 2 < m_tiles) load_q(j + 2);  // two tiles ahead
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    if constexpr (!FIRST) {
      if (lane == 0) mbar_arrive(empty((j - 1) % WGB_STAGES));
      stage_dq(j - 1);
    }

    // Pᵀ = exp2(s·c − lse) and dSᵀ = Pᵀ∘(dPᵀ − D)/√d, rows g and g+8 (keys)
    // and columns 2t, 2t+1 (queries) of each n8 tile. dP is rounded to T
    // first, as the JAX vjp rounds it; P (for dV) and dS (for dK and dQ) are
    // rounded to T as they are packed into A fragments; dSᵀ also goes to
    // this consumer's shared tile j mod 2 for dQ.
    const uint32_t lse_s = stats + s * STAT_BYTES, delta_s = lse_s + WGB_BLOCK_M * 4;
    const uint32_t ds_t = sds + (2 * c + (j & 1)) * DS_BYTES;
    uint32_t pf[Q_STEPS][4], dsf[Q_STEPS][4];
    const int q_left = LAST ? N - j * WGB_BLOCK_M : WGB_BLOCK_M;  // queries below N
#pragma unroll
    for (int jj = 0; jj < WGB_BLOCK_M / 8; ++jj) {
      const int col = jj * 8 + 2 * t;
      const float2 l2 = ld_shared_f2(lse_s + 4 * col);
      const float2 d2 = ld_shared_f2(delta_s + 4 * col);
      const bool q0 = col < q_left, q1 = col + 1 < q_left;
      float p[4], ds[4];
      p[0] = key_lo_ok && q0 ? fast_exp2(fmaf(st[4 * jj], scale_log2, -l2.x)) : 0.f;
      p[1] = key_lo_ok && q1 ? fast_exp2(fmaf(st[4 * jj + 1], scale_log2, -l2.y)) : 0.f;
      p[2] = key_hi_ok && q0 ? fast_exp2(fmaf(st[4 * jj + 2], scale_log2, -l2.x)) : 0.f;
      p[3] = key_hi_ok && q1 ? fast_exp2(fmaf(st[4 * jj + 3], scale_log2, -l2.y)) : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = p[e] * (Mma<T>::round(dp[4 * jj + e]) - ((e & 1) ? d2.y : d2.x)) * scale;
      pf[jj / 2][(jj & 1) * 2] = Mma<T>::pack(p[0], p[1]);
      pf[jj / 2][(jj & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
      const uint32_t lo = Mma<T>::pack(ds[0], ds[1]), hi = Mma<T>::pack(ds[2], ds[3]);
      dsf[jj / 2][(jj & 1) * 2] = lo;
      dsf[jj / 2][(jj & 1) * 2 + 1] = hi;
      st_shared_u32(ds_t + swz<128>(r0 * DS_ROW + col * 2), lo);
      st_shared_u32(ds_t + swz<128>((r0 + 8) * DS_ROW + col * 2), hi);
    }
    fence_proxy_async();
    // Before the barrier: dQ(j−2)'s reduce-add has read staging tile j mod
    // 2, which dQ(j) is staged in after it.
    if (tid == 0) bulk_wait_read<0>();
    named_bar_sync(1 + c, WG_THREADS);  // dSᵀ(j) and dQ(j−1)'s staging are written
    if (!FIRST && tid == 0) reduce_dq(j - 1);

    const uint32_t sq_s = sq + s * QT_BYTES, sdo_s = sdo + s * QT_BYTES;
    fence_regs(pf);
    fence_regs(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_ROWS / 16; ++kk)
      wgmma_ss<T, D, 1, 1>(dq, make_desc<128>(ds_t + kk * 16 * DS_ROW, 8 * DS_ROW),
                           make_desc<ROW>(k_rows + kk * 16 * ROW, SBO), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < Q_STEPS; ++kk) {
      wgmma_rs<T, D, 1>(dv, pf[kk], make_desc<ROW>(sdo_s + kk * 16 * ROW, SBO), 1u);
      wgmma_rs<T, D, 1>(dk, dsf[kk], make_desc<ROW>(sq_s + kk * 16 * ROW, SBO), 1u);
    }
    wgmma_commit();
    if constexpr (!LAST) issue_sdp(j + 1, st, dp);
  };

  const std::true_type yes{};
  const std::false_type no{};
  mbar_wait(kv_full, 0);
  issue_sdp(0, st, dp);
  if (m_tiles == 1) {
    step(yes, yes, 0);
  } else {
    step(yes, no, 0);
    for (int j = 1; j + 1 < m_tiles; ++j) step(no, no, j);
    step(no, yes, m_tiles - 1);
  }
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(dq);
  stage_dq(m_tiles - 1);  // its staging tile's last reduce-add was waited for in the last step
  named_bar_sync(1 + c, WG_THREADS);
  if (tid == 0) reduce_dq(m_tiles - 1);

  // Epilogue: dV and dK rounded to T, staged in this consumer's own V and K
  // rows (only it reads them), stored by TMA, which writes keys < N only.
#pragma unroll
  for (int tt = 0; tt < O_TILES; ++tt) {
    st_shared_u32(v_rows + swz<ROW>(r0 * ROW + tt * 16 + t * 4), Mma<T>::pack(dv[4 * tt], dv[4 * tt + 1]));
    st_shared_u32(v_rows + swz<ROW>((r0 + 8) * ROW + tt * 16 + t * 4),
                  Mma<T>::pack(dv[4 * tt + 2], dv[4 * tt + 3]));
    st_shared_u32(k_rows + swz<ROW>(r0 * ROW + tt * 16 + t * 4), Mma<T>::pack(dk[4 * tt], dk[4 * tt + 1]));
    st_shared_u32(k_rows + swz<ROW>((r0 + 8) * ROW + tt * 16 + t * 4),
                  Mma<T>::pack(dk[4 * tt + 2], dk[4 * tt + 3]));
  }
  fence_proxy_async();
  named_bar_sync(1 + c, WG_THREADS);
  if (tid == 0) {
    tma_store(&dv_map, v_rows, 0, head, n0 + c * WG_ROWS, b);
    tma_store(&dk_map, k_rows, 0, head, n0 + c * WG_ROWS, b);
    bulk_commit();
    bulk_wait<0>();
  }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on the tensor cores.

constexpr int TF32_WARPS = 4;    // warps per block
constexpr int TF32_THREADS = 32 * TF32_WARPS;
constexpr int TF32_BLOCK_N = 32; // keys per K/V tile
constexpr int TF32_STAGES = 2;   // K/V tiles in flight in shared memory

// m16 query tiles a warp holds when the grid is large: two at d 16 and 32,
// which halves the K and V splits per product; one at d 64, where two would
// not fit in 255 registers (Q's hi and lo fragments alone take 128).
__host__ __device__ constexpr int tf32_m_tiles(int D) { return D <= 32 ? 2 : 1; }
// Row strides of the K and V tiles in floats, padded so that the fragment
// reads below hit distinct banks: a quarter-warp's 16-byte K reads (rows g,
// g+1 of one pair, four chunks each) need (stride/4) % 8 == 4; its V reads
// (rows 2t, columns W·g) need stride/4 odd.
__host__ __device__ constexpr int tf32_k_stride(int D) { return (D / 4) % 8 == 4 ? D : D + 16; }
__host__ __device__ constexpr int tf32_v_stride(int D) { return D + 4; }
// At d 64 each warp keeps its Q lo fragments in shared memory, not in
// registers (below): 16 bytes a lane and k step.
__host__ __device__ constexpr bool tf32_q_lo_shared(int D) { return D == 64; }
constexpr int tf32_smem_bytes(int D) {
  return TF32_STAGES * TF32_BLOCK_N * (tf32_k_stride(D) + tf32_v_stride(D)) * 4 +
         (tf32_q_lo_shared(D) ? TF32_WARPS * (D / 8) * 32 * 16 : 0);
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, with
// the 13 low bits zero: cvt.rna.tf32.f32 written out, so that the CPU
// emulation reproduces it bit for bit. (Finite x; no overflow below 3e38.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + (an error of at most 2^-22 |x|), both exact TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a·b, m16n8k8, TF32 in, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copies TF32_BLOCK_N rows of D floats (row r of the tile is row first + r of the
// slice) into a shared tile of row stride STRIDE floats; rows at or past N
// are zero-filled.
template <int D, int STRIDE>
__device__ __forceinline__ void load_tile_f32(uint32_t tile, const float* base,
                                              int64_t stride, int first, int N) {
  constexpr int CHUNKS = TF32_BLOCK_N * D / 4;
  static_assert(CHUNKS % TF32_THREADS == 0, "tile shape");
#pragma unroll
  for (int i = 0; i < CHUNKS / TF32_THREADS; ++i) {
    const int c = threadIdx.x + i * TF32_THREADS;
    const int r = c / (D / 4), chunk = c % (D / 4);
    const bool valid = first + r < N;
    const float* src = base + (valid ? first + r : 0) * stride + chunk * 4;
    cp_async_16(tile + (r * STRIDE + chunk * 4) * 4, src, valid);
  }
}

// W consecutive floats (W = 2 or 4) at shared address `addr`, as one
// volatile load. ptxas keeps volatile loads in program order, so it does not
// hoist the reads of later fragments above the products of this one: with
// plain loads it did, and spilled at d 64.
template <int W>
__device__ __forceinline__ void load_vec(float (&x)[W], uint32_t addr) {
  if constexpr (W == 4)
    asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]) : "r"(addr));
  else
    asm volatile("ld.volatile.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(x[0]), "=f"(x[1]) : "r"(addr));
}
// A lane's four TF32 A-fragment registers to and from shared memory, as one
// 16-byte access (the volatile load stays in program order, as load_vec's).
__device__ __forceinline__ void store_frag(uint32_t addr, const uint32_t (&a)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]));
}
__device__ __forceinline__ void load_frag(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ld.volatile.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}
template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32): lane = 4·g + t. A holds
// (row g, k t), (g+8, t), (g, t+4), (g+8, t+4); B (k t, column g), (t+4, g);
// C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1). Both products sum over an
// axis whose order is free, so each k index is mapped to the element that
// makes a lane's reads contiguous:
// - Q·Kᵀ, k = d: steps 2i and 2i+1 take d 16i+4t, +1 (k t, t+4) and d
//   16i+4t+2, +3. A lane reads d 16i+4t..+3 of a Q or K row as one float4.
// - P·V, k = key: k t and t+4 of key step j are keys 8j+2t and 8j+2t+1, the
//   columns 2t, 2t+1 that the C fragment of score tile j already holds, so
//   P's A fragment is (c0, c2, c1, c3) of it, with no shuffle.
// - P·V, n = d: column g of output tile nt is d 8W·(nt/W) + W·g + nt%W, W =
//   min(D/8, 4). A lane reads the V values of all tiles at one key as W
//   contiguous floats, and holds 2W contiguous output values per row group.
// One block a multiprocessor is all that __launch_bounds__ promises: small
// grids and d 16 ran faster on an H100 (PERF.md). At d 64 Q's hi and lo
// fragments would take 128 of the 255 registers, and the LSE instance
// spilled, so each lane keeps its Q lo fragments in shared memory
// (tf32_q_lo_shared) and reads one a k step; a lane reads only what it
// wrote, so no barrier.
// With LSE the kernel also writes each query row's log-sum-exp, as the
// 16-bit kernels' LSE instances do: the fp32 backward's P is exp2(s·c − lse).
template <int D, int MT, bool LSE>
__global__ void __launch_bounds__(TF32_THREADS, 1)
attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int N, int H, Strides qs, Strides ks,
                          Strides vs, float scale_log2) {
  constexpr int KSTEPS = D / 8;             // k8 steps of Q·Kᵀ
  constexpr int S_TILES = TF32_BLOCK_N / 8; // n8 score tiles = k8 steps of P·V
  constexpr int O_TILES = D / 8;            // n8 tiles of the output
  constexpr int W = O_TILES < 4 ? O_TILES : 4;
  constexpr int SK = tf32_k_stride(D), SV = tf32_v_stride(D);
  constexpr int K_FLOATS = TF32_BLOCK_N * SK, V_FLOATS = TF32_BLOCK_N * SV;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + TF32_STAGES * K_FLOATS * 4;
  constexpr bool Q_LO_SHARED = tf32_q_lo_shared(D);
  static_assert(!Q_LO_SHARED || MT == 1, "one m16 tile a warp keeps its Q lo in shared memory");

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x * TF32_WARPS + warp) * MT * 16;  // MT m16 tiles a warp
  const uint32_t sq = sv + TF32_STAGES * V_FLOATS * 4 + warp * KSTEPS * 32 * 16;  // Q lo
  const float* q_base = q + b * qs.b + head * qs.h;
  const float* k_base = k + b * ks.b + head * ks.h;
  const float* v_base = v + b * vs.b + head * vs.h;
  const int n_tiles = (N + TF32_BLOCK_N - 1) / TF32_BLOCK_N;

  // Prologue: the first STAGES-1 K/V tiles, one commit group per tile (a
  // group is committed even when empty, as in the kernel above).
#pragma unroll
  for (int st = 0; st < TF32_STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile_f32<D, SK>(sk + st * K_FLOATS * 4, k_base, ks.n, st * TF32_BLOCK_N, N);
      load_tile_f32<D, SV>(sv + st * V_FLOATS * 4, v_base, vs.n, st * TF32_BLOCK_N, N);
    }
    cp_async_commit();
  }

  // This warp's queries, split once into TF32 hi and lo A fragments, read
  // straight from device memory (rows at or past N are zero).
  uint32_t qh[MT][KSTEPS][4], ql[MT][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + g + 8 * half;
      const bool valid = row < N;
      const float* src = q_base + static_cast<int64_t>(valid ? row : 0) * qs.n + 4 * t;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const float4 x = valid ? __ldg(reinterpret_cast<const float4*>(src + 16 * i))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        split_tf32(x.x, qh[mt][2 * i][half], ql[mt][2 * i][half]);
        split_tf32(x.y, qh[mt][2 * i][half + 2], ql[mt][2 * i][half + 2]);
        split_tf32(x.z, qh[mt][2 * i + 1][half], ql[mt][2 * i + 1][half]);
        split_tf32(x.w, qh[mt][2 * i + 1][half + 2], ql[mt][2 * i + 1][half + 2]);
      }
    }
  if constexpr (Q_LO_SHARED)
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) store_frag(sq + (kk * 32 + lane) * 16, ql[0][kk]);

  float acc[MT][O_TILES][4];  // unnormalised output rows g and g+8 of each m16
  float m_run[MT][2];         // running max of the raw scores of each row
  float l_run[MT][2];         // this lane's share of each row's running sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < O_TILES; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<TF32_STAGES - 2>();
    __syncthreads();  // tile `it` is visible, and every warp is done with it-1
    {
      const int next = it + TF32_STAGES - 1;
      if (next < n_tiles) {
        const int st = next % TF32_STAGES;
        load_tile_f32<D, SK>(sk + st * K_FLOATS * 4, k_base, ks.n, next * TF32_BLOCK_N, N);
        load_tile_f32<D, SV>(sv + st * V_FLOATS * 4, v_base, vs.n, next * TF32_BLOCK_N, N);
      }
      cp_async_commit();
    }
    const uint32_t kt = sk + (it % TF32_STAGES) * K_FLOATS * 4;
    const uint32_t vt = sv + (it % TF32_STAGES) * V_FLOATS * 4;

    // S = Q·Kᵀ as 3xTF32: per score tile, the two small products of every
    // k step first, then the big ones, into one fp32 accumulator. K is split
    // as its fragments are read.
    float s[MT][S_TILES][4];
#pragma unroll
    for (int j = 0; j < S_TILES; ++j) {
      uint32_t kh[KSTEPS][2], kl[KSTEPS][2];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        float x[4];
        load_vec<4>(x, kt + ((8 * j + g) * SK + 16 * i + 4 * t) * 4);
        split_tf32(x[0], kh[2 * i][0], kl[2 * i][0]);
        split_tf32(x[1], kh[2 * i][1], kl[2 * i][1]);
        split_tf32(x[2], kh[2 * i + 1][0], kl[2 * i + 1][0]);
        split_tf32(x[3], kh[2 * i + 1][1], kl[2 * i + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          if constexpr (Q_LO_SHARED) {
            uint32_t a[4];
            load_frag(a, sq + (kk * 32 + lane) * 16);
            mma_tf32(s[mt][j], a, kh[kk]);
          } else {
            mma_tf32(s[mt][j], ql[mt][kk], kh[kk]);
          }
          mma_tf32(s[mt][j], qh[mt][kk], kl[kk]);
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) mma_tf32(s[mt][j], qh[mt][kk], kh[kk]);
      }
    }
    const int key0 = it * TF32_BLOCK_N;
    if (key0 + TF32_BLOCK_N > N) {  // the ragged last tile: mask keys >= N
#pragma unroll
      for (int j = 0; j < S_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + j * 8 + 2 * t + (e & 1) >= N)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) s[mt][j][e] = -INFINITY;
    }

    // Online softmax on the fragments, as in the kernel above; P stays in
    // fp32 (the fp32 JAX path does not round it) and overwrites S.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[mt][r];
#pragma unroll
        for (int j = 0; j < S_TILES; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = fast_exp2((m_run[mt][r] - mx) * scale_log2);
        m_run[mt][r] = mx;
        l_run[mt][r] *= corr;
#pragma unroll
        for (int nt = 0; nt < O_TILES; ++nt) {
          acc[mt][nt][2 * r] *= corr;
          acc[mt][nt][2 * r + 1] *= corr;
        }
        const float mc = mx * scale_log2;
#pragma unroll
        for (int j = 0; j < S_TILES; ++j) {
          const float p0 = fast_exp2(fmaf(s[mt][j][2 * r], scale_log2, -mc));
          const float p1 = fast_exp2(fmaf(s[mt][j][2 * r + 1], scale_log2, -mc));
          l_run[mt][r] += p0 + p1;
          s[mt][j][2 * r] = p0;
          s[mt][j][2 * r + 1] = p1;
        }
      }
    }

    // O += P·V as 3xTF32: per key step j, V rows 8j+2t and 8j+2t+1 (k t and
    // t+4), split as read; then P_lo·V_hi, P_hi·V_lo, P_hi·V_hi into a zeroed
    // fragment, added to the output with one FADD. The tensor cores round
    // each mma's sum toward zero: fed the running output directly, 3 mma a
    // key step (384 at N 1024) bias it by ~2e-5 relative (6e-6 absolute on
    // an H100); these partial sums are about 1/128 of its size.
#pragma unroll
    for (int j = 0; j < S_TILES; ++j)
#pragma unroll
      for (int grp = 0; grp < O_TILES / W; ++grp) {  // W output tiles at a time
        uint32_t vh[W][2], vl[W][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[W];
          load_vec<W>(x, vt + ((8 * j + 2 * t + r) * SV + 8 * W * grp + W * g) * 4);
#pragma unroll
          for (int w = 0; w < W; ++w) split_tf32(x[w], vh[w][r], vl[w][r]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ph[4], pl[4];
          split_tf32(s[mt][j][0], ph[0], pl[0]);
          split_tf32(s[mt][j][2], ph[1], pl[1]);
          split_tf32(s[mt][j][1], ph[2], pl[2]);
          split_tf32(s[mt][j][3], ph[3], pl[3]);
#pragma unroll
          for (int w = 0; w < W; ++w) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(part, pl, vh[w]);
            mma_tf32(part, ph, vl[w]);
            mma_tf32(part, ph, vh[w]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][grp * W + w][e] += part[e];
          }
        }
      }
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // Epilogue: the rows' sums over their quads, each row's lse (LSE), then
  // divide by l and write each row < N straight from the fragments: a lane
  // holds d 8W·grp + 2W·t .. +2W−1 of rows g and g+8.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float& l = l_run[mt][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = m0 + mt * 16 + g + 8 * half;
      if constexpr (LSE)
        if (t == 0 && row < N)
          lse[static_cast<int64_t>(bh) * N + row] = m_run[mt][half] * scale_log2 + log2f(l);
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv_l = 1.f / l_run[mt][half];
      const int row = m0 + mt * 16 + g + 8 * half;
      if (row >= N) continue;
      float* dst = o + ((static_cast<int64_t>(b) * N + row) * H + head) * D;
#pragma unroll
      for (int grp = 0; grp < O_TILES / W; ++grp)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x[W];
#pragma unroll
          for (int w = 0; w < W; ++w) x[w] = acc[mt][grp * W + w][2 * half + c] * inv_l;
          store_vec<W>(dst + 8 * W * grp + W * (2 * t + c), x);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 backward: 3xTF32 on mma.sync (m16n8k8), the FlashAttention-2 order of
// attention_bwd_mma_kernel: one block a (key tile of TB_BLOCK_N, batch·head),
// warp w owning keys 16w..16w+15 as one m16 tile, walking the query tiles of
// TB_BLOCK_M in sub-steps of tb_sub_m(d) queries:
//   Sᵀ  = K·Qᵀ      A: K (registers at d 16, 32; read each step at d 64)  B: Q rows
//   dPᵀ = V·dOᵀ     A: V (read each step)                                B: dO rows
//   dV += Pᵀ·dO     A: Pᵀ (Sᵀ's C fragments)   B: dO, read across its rows
//   dK += dSᵀ·Q     A: dSᵀ (C fragments)       B: Q, read across its rows
//   dQ += dS·K      A: the dSᵀ tile, read across its rows  B: K, read across its rows
// Every product is three TF32 products (a_lo·b_hi, a_hi·b_lo, a_hi·b_hi) of
// operands split as the forward splits them (split_tf32), P and dS in fp32.
// Sᵀ and dPᵀ sum over d into one accumulator; dV, dK and dQ, which sum over
// many k steps, take each step's three products in a zeroed fragment and add
// it with an FADD, as the forward's P·V does (the tensor cores round each
// mma's sum toward zero). ldmatrix.trans takes only 16-bit types, so the
// three operands read across their rows (Pᵀ·dO's dO, dSᵀ·Q's Q, dS·K's K and
// dS) come from plain shared-memory loads: a lane reads W = min(d/8, 4)
// neighbouring d values of one row (the forward's P·V map of n to d), and dS
// one value at (key t, query g). The K, V, Q and dO tiles have a row stride
// of d + 8 floats with the 16-byte chunks of rows 4..7 of every 8 swapped in
// pairs (tb_off), which keeps both read patterns of each tile (rows g, or
// rows 2t and 2t+1 / t and t+4) free of bank conflicts at d 16, 32 and 64;
// the dSᵀ tile, written from C fragments and read one value a lane, has a
// row stride of TB_BLOCK_M + 8 (tests/test_torch_attention_bwd_tf32.py
// checks both). dQ's fp32 partial of each (block, query tile) is added to
// the caller's dq with float2 atomics, so its low bits vary from run to run;
// dK and dV are written once.
constexpr int TB_WARPS = 4;
constexpr int TB_THREADS = 32 * TB_WARPS;
constexpr int TB_BLOCK_N = 16 * TB_WARPS;  // keys a block
constexpr int TB_BLOCK_M = 64;             // queries a step
// Queries a sub-step of Sᵀ, dPᵀ, dV and dK: their scores and dP are live
// at once; 16 at d 64, where 32 spilled at 255 registers.
__host__ __device__ constexpr int tb_sub_m(int D) { return D == 64 ? 16 : 32; }
constexpr int TB_STAGES = 2;               // Q/dO tiles in flight
constexpr int TB_DS_STRIDE = TB_BLOCK_M + 8;
static_assert(TB_THREADS == 2 * TB_BLOCK_M, "one thread a query row's lse and one its D");
__host__ __device__ constexpr int tb_stride(int D) { return D + 8; }
constexpr int tb_smem_bytes(int D) {  // K, V, the Q and dO rings, dSᵀ, the lse and D rings
  return ((2 * TB_BLOCK_N + 2 * TB_STAGES * TB_BLOCK_M) * tb_stride(D) +
          TB_BLOCK_N * TB_DS_STRIDE + 2 * TB_STAGES * TB_BLOCK_M) * 4;
}

// Float offset of (row, col) in a K, V, Q or dO tile.
template <int D>
__host__ __device__ constexpr int tb_off(int row, int col) {
  return row * tb_stride(D) + (((col >> 2) ^ (((row >> 2) & 1) << 1)) << 2) + (col & 3);
}

// ROWS rows of D floats (row r of the tile is row first + r of the slice)
// into a tb_off tile; rows at or past N are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_tb(uint32_t tile, const float* base, int64_t stride,
                                             int first, int N) {
  constexpr int CHUNKS = ROWS * D / 4;
  static_assert(CHUNKS % TB_THREADS == 0, "tile shape");
#pragma unroll
  for (int i = 0; i < CHUNKS / TB_THREADS; ++i) {
    const int c = threadIdx.x + i * TB_THREADS;
    const int r = c / (D / 4), chunk = c % (D / 4);
    const bool valid = first + r < N;
    const float* src = base + (valid ? first + r : 0) * stride + chunk * 4;
    cp_async_16(tile + tb_off<D>(r, chunk * 4) * 4, src, valid);
  }
}

__device__ __forceinline__ float ld_volatile_f32(uint32_t addr) {
  float x;
  asm volatile("ld.volatile.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

// c += a·b as 3xTF32: the two small products, then the big one.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}
// acc += a·b, the three products summed in a zeroed fragment first.
__device__ __forceinline__ void mma_3xtf32_add(float (&acc)[4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                               const uint32_t (&bl)[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(part, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}
template <int R>
__device__ __forceinline__ void split_frag(const float (&x)[R], uint32_t (&hi)[R],
                                           uint32_t (&lo)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// Fragment maps (m16n8k8 TF32 as above: A (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); B (t, g), (t+4, g); C (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)):
// - Sᵀ and dPᵀ, k = d: k t and t+4 of step kk are d 8kk+2t and 8kk+2t+1, so
//   each A or B read is one float2 of a row.
// - dV and dK, k = query: k t and t+4 of step j are queries 8j+2t and 8j+2t+1,
//   the columns that Sᵀ's C fragment of tile j holds: Pᵀ's A fragment is
//   (c0, c2, c1, c3) of it, with no shuffle; n = d as in the forward's P·V.
// - dQ, k = key: k t and t+4 of step kk are keys 8kk+t and 8kk+t+4.
template <int D>
__global__ void __launch_bounds__(TB_THREADS, 1)
attention_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                          int N, int H, Strides qs, Strides ks, Strides vs, Strides dos,
                          float scale_log2, float scale) {
  constexpr int KSTEPS = D / 8;                 // k8 steps over d (Sᵀ, dPᵀ)
  constexpr int SUB_M = tb_sub_m(D);            // queries a sub-step
  constexpr int SUB_TILES = SUB_M / 8;          // its n8 query tiles
  constexpr int O_TILES = D / 8;                // n8 tiles over d (dV, dK, dQ)
  constexpr int W = O_TILES < 4 ? O_TILES : 4;  // d values a lane reads of a row
  constexpr int KV_FLOATS = TB_BLOCK_N * tb_stride(D);
  constexpr int QT_FLOATS = TB_BLOCK_M * tb_stride(D);
  // K's split A fragments stay in registers at d 16 and 32; at d 64 they
  // would take 64 registers, and K is read again at each step like V. At d
  // 64 the loops over k steps are not unrolled either: unrolled, ptxas
  // spilled at 255 registers.
  constexpr bool KEEP_K = D <= 32;
  constexpr int UNROLL = D == 64 ? 1 : 8;
  extern __shared__ __align__(128) unsigned char smem[];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TB_BLOCK_N;
  const float* q_base = q + b * qs.b + head * qs.h;
  const float* k_base = k + b * ks.b + head * ks.h;
  const float* v_base = v + b * vs.b + head * vs.h;
  const float* do_base = dout + b * dos.b + head * dos.h;
  const float* lse_row = lse + static_cast<int64_t>(bh) * N;
  const float* delta_row = delta + static_cast<int64_t>(bh) * N;
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + KV_FLOATS * 4;
  const uint32_t sq = sv + KV_FLOATS * 4;
  const uint32_t sdo = sq + TB_STAGES * QT_FLOATS * 4;
  const uint32_t sds = sdo + TB_STAGES * QT_FLOATS * 4;
  float* const stats = reinterpret_cast<float*>(smem + (sds - sk) + TB_BLOCK_N * TB_DS_STRIDE * 4);
  const int m_tiles = (N + TB_BLOCK_M - 1) / TB_BLOCK_M;

  // Thread i < TB_BLOCK_M carries the lse of query row m0 + i, thread
  // TB_BLOCK_M + i its D; rows at or past N get lse +inf (P exactly 0), D 0.
  const int stat_row = threadIdx.x % TB_BLOCK_M;
  const bool is_lse = threadIdx.x < TB_BLOCK_M;
  const float* stat_src = is_lse ? lse_row : delta_row;
  auto row_stat = [&](int m0) {
    const int r = m0 + stat_row;
    return r < N ? stat_src[r] : (is_lse ? INFINITY : 0.f);
  };
  float* const my_stat = stats + (is_lse ? 0 : TB_STAGES * TB_BLOCK_M) + stat_row;

  load_tile_tb<D, TB_BLOCK_N>(sk, k_base, ks.n, n0, N);
  load_tile_tb<D, TB_BLOCK_N>(sv, v_base, vs.n, n0, N);
  load_tile_tb<D, TB_BLOCK_M>(sq, q_base, qs.n, 0, N);
  load_tile_tb<D, TB_BLOCK_M>(sdo, do_base, dos.n, 0, N);
  cp_async_commit();
  my_stat[0] = row_stat(0);

  // An A fragment of K or V rows (this warp's keys) at k step kk, split.
  const auto key_frag = [&](uint32_t tile, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    float a0[2], a1[2];
    load_vec<2>(a0, tile + tb_off<D>(warp * 16 + g, 8 * kk + 2 * t) * 4);
    load_vec<2>(a1, tile + tb_off<D>(warp * 16 + g + 8, 8 * kk + 2 * t) * 4);
    const float x[4] = {a0[0], a1[0], a0[1], a1[1]};
    split_frag(x, hi, lo);
  };
  uint32_t kh[KEEP_K ? KSTEPS : 1][4], kl[KEEP_K ? KSTEPS : 1][4];
  float dk_acc[O_TILES][4], dv_acc[O_TILES][4];
#pragma unroll
  for (int tt = 0; tt < O_TILES; ++tt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[tt][e] = dv_acc[tt][e] = 0.f;
  // Keys at or past N (zero-filled) get P = 0: their dS then is 0 too.
  const int key_lo = n0 + warp * 16 + g;
  const bool key_lo_ok = key_lo < N, key_hi_ok = key_lo + 8 < N;

  for (int it = 0; it < m_tiles; ++it) {
    const int st = it % TB_STAGES;
    cp_async_wait<0>();
    __syncthreads();  // tile `it` and its lse, D are visible; every warp is done with it-1
    float next_stat = 0.f;
    if (it + 1 < m_tiles) {
      const int ns = (it + 1) % TB_STAGES;
      load_tile_tb<D, TB_BLOCK_M>(sq + ns * QT_FLOATS * 4, q_base, qs.n, (it + 1) * TB_BLOCK_M, N);
      load_tile_tb<D, TB_BLOCK_M>(sdo + ns * QT_FLOATS * 4, do_base, dos.n, (it + 1) * TB_BLOCK_M, N);
      next_stat = row_stat((it + 1) * TB_BLOCK_M);
    }
    cp_async_commit();
    if constexpr (KEEP_K) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) key_frag(sk, kk, kh[kk], kl[kk]);
      }
    }
    const uint32_t sq_t = sq + st * QT_FLOATS * 4;
    const uint32_t sdo_t = sdo + st * QT_FLOATS * 4;
    const float* lse_t = stats + st * TB_BLOCK_M;
    const float* delta_t = stats + (TB_STAGES + st) * TB_BLOCK_M;

#pragma unroll 1
    for (int sub = 0; sub < TB_BLOCK_M / SUB_M; ++sub) {
      const int q0 = sub * SUB_M;  // the sub-step's first query of the tile
      float s[SUB_TILES][4], dp[SUB_TILES][4];
#pragma unroll
      for (int j = 0; j < SUB_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: a Q or dO row, d contiguous, is the B
      // operand as it lies.
#pragma unroll UNROLL
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t vh[4], vl[4];
        key_frag(sv, kk, vh, vl);
        uint32_t kh_s[4], kl_s[4];
        if constexpr (KEEP_K) {
#pragma unroll
          for (int e = 0; e < 4; ++e) kh_s[e] = kh[KEEP_K ? kk : 0][e], kl_s[e] = kl[KEEP_K ? kk : 0][e];
        } else {
          key_frag(sk, kk, kh_s, kl_s);
        }
#pragma unroll
        for (int j = 0; j < SUB_TILES; ++j) {
          const int off = tb_off<D>(q0 + 8 * j + g, 8 * kk + 2 * t) * 4;
          float xq[2], xo[2];
          load_vec<2>(xq, sq_t + off);
          load_vec<2>(xo, sdo_t + off);
          uint32_t qh[2], ql[2], oh[2], ol[2];
          split_frag(xq, qh, ql);
          split_frag(xo, oh, ol);
          mma_3xtf32(s[j], kh_s, kl_s, qh, ql);
          mma_3xtf32(dp[j], vh, vl, oh, ol);
        }
      }

      // Pᵀ = exp2(s·c − lse) and dSᵀ = Pᵀ∘(dPᵀ − D)/√d in fp32, rows g and
      // g+8 (keys) and columns 2t, 2t+1 (queries) of each n8 tile; dSᵀ also
      // goes to its shared tile for dQ. Both overwrite their accumulators.
#pragma unroll
      for (int j = 0; j < SUB_TILES; ++j) {
        const int col = q0 + 8 * j + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + col);
        const float p0 = key_lo_ok ? fast_exp2(fmaf(s[j][0], scale_log2, -l2.x)) : 0.f;
        const float p1 = key_lo_ok ? fast_exp2(fmaf(s[j][1], scale_log2, -l2.y)) : 0.f;
        const float p2 = key_hi_ok ? fast_exp2(fmaf(s[j][2], scale_log2, -l2.x)) : 0.f;
        const float p3 = key_hi_ok ? fast_exp2(fmaf(s[j][3], scale_log2, -l2.y)) : 0.f;
        dp[j][0] = p0 * (dp[j][0] - d2.x) * scale;
        dp[j][1] = p1 * (dp[j][1] - d2.y) * scale;
        dp[j][2] = p2 * (dp[j][2] - d2.x) * scale;
        dp[j][3] = p3 * (dp[j][3] - d2.y) * scale;
        s[j][0] = p0, s[j][1] = p1, s[j][2] = p2, s[j][3] = p3;
        st_shared_f2(sds + ((warp * 16 + g) * TB_DS_STRIDE + col) * 4, dp[j][0], dp[j][1]);
        st_shared_f2(sds + ((warp * 16 + g + 8) * TB_DS_STRIDE + col) * 4, dp[j][2], dp[j][3]);
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q, one k8 step of queries at a time: a
      // lane reads W neighbouring d values of query rows 8j+2t and 8j+2t+1.
#pragma unroll
      for (int j = 0; j < SUB_TILES; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        const float da[4] = {dp[j][0], dp[j][2], dp[j][1], dp[j][3]};
        split_frag(pa, ph, pl);
        split_frag(da, dh, dl);
        // dO's fragments and dV's products, then Q's and dK's, so that only
        // one operand's split fragments are live at a time.
        const auto rows_product = [&](uint32_t tile, const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float (&acc)[O_TILES][4]) {
#pragma unroll
          for (int grp = 0; grp < O_TILES / W; ++grp) {
            uint32_t bh[W][2], bl[W][2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float x[W];
              load_vec<W>(x, tile + tb_off<D>(q0 + 8 * j + 2 * t + r, 8 * W * grp + W * g) * 4);
#pragma unroll
              for (int w = 0; w < W; ++w) split_tf32(x[w], bh[w][r], bl[w][r]);
            }
#pragma unroll
            for (int w = 0; w < W; ++w) mma_3xtf32_add(acc[grp * W + w], ah, al, bh[w], bl[w]);
          }
        };
        rows_product(sdo_t, ph, pl, dv_acc);
        rows_product(sq_t, dh, dl, dk_acc);
      }
    }
    __syncthreads();  // every warp's dSᵀ rows are in shared memory

    // dQ rows 16w..16w+15 of this tile += dS·K over the block's keys, each
    // k8 step of keys in a zeroed fragment; then float2 atomics.
    float dq_acc[O_TILES][4];
#pragma unroll
    for (int tt = 0; tt < O_TILES; ++tt) dq_acc[tt][0] = dq_acc[tt][1] = dq_acc[tt][2] = dq_acc[tt][3] = 0.f;
#pragma unroll UNROLL
    for (int kk = 0; kk < TB_BLOCK_N / 8; ++kk) {
      const uint32_t row_a = sds + ((8 * kk + t) * TB_DS_STRIDE + warp * 16 + g) * 4;
      const float xa[4] = {ld_volatile_f32(row_a), ld_volatile_f32(row_a + 8 * 4),
                           ld_volatile_f32(row_a + 4 * TB_DS_STRIDE * 4),
                           ld_volatile_f32(row_a + (4 * TB_DS_STRIDE + 8) * 4)};
      uint32_t ah[4], al[4];
      split_frag(xa, ah, al);
#pragma unroll
      for (int grp = 0; grp < O_TILES / W; ++grp) {
        uint32_t kbh[W][2], kbl[W][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x[W];
          load_vec<W>(x, sk + tb_off<D>(8 * kk + t + 4 * r, 8 * W * grp + W * g) * 4);
#pragma unroll
          for (int w = 0; w < W; ++w) split_tf32(x[w], kbh[w][r], kbl[w][r]);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) mma_3xtf32_add(dq_acc[grp * W + w], ah, al, kbh[w], kbl[w]);
      }
    }
    // A lane holds d 8W·grp + 2W·t .. +2W−1 of query rows g and g+8.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = it * TB_BLOCK_M + warp * 16 + g + 8 * half;
      if (row < N) {
        float* dst = dq + ((static_cast<int64_t>(b) * N + row) * H + head) * D;
#pragma unroll
        for (int grp = 0; grp < O_TILES / W; ++grp)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int w = 0; w < W; w += 2)
              atomicAdd(reinterpret_cast<float2*>(dst + 8 * W * grp + W * (2 * t + c) + w),
                        make_float2(dq_acc[grp * W + w][2 * half + c],
                                    dq_acc[grp * W + w + 1][2 * half + c]));
      }
    }
    if (it + 1 < m_tiles) my_stat[((it + 1) % TB_STAGES) * TB_BLOCK_M] = next_stat;
  }
  cp_async_wait<0>();  // only empty groups remain; leave none behind

  // Epilogue: dV and dK straight from the fragments, rows (keys) < N.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = n0 + warp * 16 + g + 8 * half;
    if (key >= N) continue;
    const int64_t at = ((static_cast<int64_t>(b) * N + key) * H + head) * D;
#pragma unroll
    for (int grp = 0; grp < O_TILES / W; ++grp)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float xv[W], xk[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          xv[w] = dv_acc[grp * W + w][2 * half + c];
          xk[w] = dk_acc[grp * W + w][2 * half + c];
        }
        store_vec<W>(dv + at + 8 * W * grp + W * (2 * t + c), xv);
        store_vec<W>(dk + at + 8 * W * grp + W * (2 * t + c), xk);
      }
  }
}

// The current device's count of SMs, queried once per device and cached.
cudaError_t sm_count(int& sms) {
  static std::atomic<int> counts[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  sms = counts[device].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) counts[device].store(sms, std::memory_order_relaxed);
  }
  return err;
}

template <int D, int MT>
void launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int N, int H, Strides qs, Strides ks, Strides vs, float scale_log2,
                 cudaStream_t stream) {
  constexpr int block_m = 16 * MT * TF32_WARPS;
  const dim3 grid((N + block_m - 1) / block_m, B * H);
  const auto kernel = lse ? attention_fwd_tf32_kernel<D, MT, true>
                          : attention_fwd_tf32_kernel<D, MT, false>;
  if (tf32_smem_bytes(D) > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         tf32_smem_bytes(D));
  kernel<<<grid, TF32_THREADS, tf32_smem_bytes(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, N, H, qs, ks, vs,
      scale_log2);
}

// cuTensorMapEncodeTiled, from the driver through the runtime's entry-point
// query (so the library links no -lcuda); looked up once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled& fn) {
  static std::atomic<EncodeTiled> cached{nullptr};
  fn = cached.load(std::memory_order_acquire);
  if (fn != nullptr) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
  fn = reinterpret_cast<EncodeTiled>(p);
  cached.store(fn, std::memory_order_release);
  return cudaSuccess;
}

// The TMA map of a (B, N, h, d) tensor at `base` (element strides `s`, the d
// stride 1) as dims (d, h, N, B): a box of `box_d` values by `rows` rows of
// one (batch, head), swizzled by its row bytes (32, 64 or 128), which is how
// the kernels' shared tiles are laid out. Rows past N read as zeros and are
// not written.
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, int B, int N, int H, int D, Strides s, int box_d,
                     int rows) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(encode);
  if (err != cudaSuccess) return err;
  // An axis of length 1 may carry any stride: give it one TMA takes.
  const uint64_t eb = static_cast<uint64_t>(elem_bytes);
  const cuuint64_t sh = H > 1 ? s.h * eb : static_cast<uint64_t>(D) * eb;
  const cuuint64_t sn = N > 1 ? s.n * eb : sh * H;
  const cuuint64_t sb = B > 1 ? s.b * eb : sn * N;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sh, sn, sb};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const int row_bytes = box_d * elem_bytes;
  const CUtensorMapSwizzle swizzle = row_bytes == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_128B;
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA map of `n` contiguous fp32 values at `base`, in boxes of `box`;
// values past n read as zeros.
cudaError_t make_flat_map(CUtensorMap* map, const float* base, int64_t n, int box) {
  EncodeTiled encode;
  const cudaError_t err = encode_tiled(encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {0};  // none for one dimension
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem_strides[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base),
                            dims, strides, boxes, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The contiguous (B, N, h, d) outputs' strides.
Strides contiguous(int N, int H, int D) {
  return Strides{static_cast<int64_t>(N) * H * D, static_cast<int64_t>(H) * D, D};
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int N, int H, Strides qs, Strides ks, Strides vs,
                             float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t err;
  if ((err = make_map(&maps[0], map_type<T>(), 2, q, B, N, H, D, qs, D, WGF_BLOCK_M)) ||
      (err = make_map(&maps[1], map_type<T>(), 2, k, B, N, H, D, ks, D, WGF_BLOCK_N)) ||
      (err = make_map(&maps[2], map_type<T>(), 2, v, B, N, H, D, vs, D, WGF_BLOCK_N)) ||
      (err = make_map(&maps[3], map_type<T>(), 2, o, B, N, H, D, contiguous(N, H, D), D,
                      WG_ROWS)))
    return err;
  const auto kernel = lse ? attention_fwd_wgmma_kernel<T, D, true>
                          : attention_fwd_wgmma_kernel<T, D, false>;
  constexpr int smem = wgf_smem_bytes(D);
  if ((err = allow_smem(kernel, smem))) return err;
  int sms = 0;
  if ((err = sm_count(sms))) return err;
  // Persistent: one block an SM (or a work tile), walking work tiles.
  const int64_t work = static_cast<int64_t>(B) * H * ((N + WGF_BLOCK_M - 1) / WGF_BLOCK_M);
  const int grid = static_cast<int>(work < sms ? work : sms);
  kernel<<<grid, WGF_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], lse, N,
                                                   H, B * H, scale_log2);
  return cudaGetLastError();
}

// Launches the forward of type T; `lse` non-null takes the instance that
// also writes the log-sum-exp.
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int N, int H, Strides qs, Strides ks,
                   Strides vs, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {
    constexpr int MT = tf32_m_tiles(D);
    // MT m16 tiles a warp, unless the grid of such blocks would leave SMs
    // without a block: then one, which puts twice the warps to work.
    int sms = 0;
    if constexpr (MT > 1) {
      const cudaError_t err = sm_count(sms);
      if (err != cudaSuccess) return err;
    }
    constexpr int wide_m = 16 * MT * TF32_WARPS;
    if (MT > 1 && static_cast<int64_t>(B) * H * ((N + wide_m - 1) / wide_m) >= sms)
      launch_tf32<D, MT>(q, k, v, o, lse, B, N, H, qs, ks, vs, scale_log2, stream);
    else
      launch_tf32<D, 1>(q, k, v, o, lse, B, N, H, qs, ks, vs, scale_log2, stream);
  } else {
    if constexpr (wgf_built(D))
      if (!mma_fwd(N, D))
        return launch_fwd_wgmma<T, D>(q, k, v, o, lse, B, N, H, qs, ks, vs, scale_log2, stream);
    if constexpr (mma_fwd_built(D)) {
      constexpr int smem = mma_smem_bytes(D);
      auto kernel = lse ? attention_fwd_mma_kernel<T, D, true>
                        : attention_fwd_mma_kernel<T, D, false>;
      const cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      const dim3 grid((N + MMA_BLOCK_M - 1) / MMA_BLOCK_M, B * H);
      kernel<<<grid, MMA_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), lse, N, H, qs, ks, vs,
          scale_log2);
    }
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, float* dq_acc, void* dk,
                             void* dv, int B, int N, int H, Strides qs, Strides ks, Strides vs,
                             Strides dos, float scale_log2, float scale, cudaStream_t stream) {
  CUtensorMap maps[9];
  const Strides out = contiguous(N, H, D);
  const int64_t rows = static_cast<int64_t>(B) * H * N;
  cudaError_t err;
  if ((err = make_map(&maps[0], map_type<T>(), 2, q, B, N, H, D, qs, D, WGB_BLOCK_M)) ||
      (err = make_map(&maps[1], map_type<T>(), 2, k, B, N, H, D, ks, D, WGB_BLOCK_N)) ||
      (err = make_map(&maps[2], map_type<T>(), 2, v, B, N, H, D, vs, D, WGB_BLOCK_N)) ||
      (err = make_map(&maps[3], map_type<T>(), 2, dout, B, N, H, D, dos, D, WGB_BLOCK_M)) ||
      (err = make_map(&maps[4], map_type<T>(), 2, dk, B, N, H, D, out, D, WG_ROWS)) ||
      (err = make_map(&maps[5], map_type<T>(), 2, dv, B, N, H, D, out, D, WG_ROWS)) ||
      (err = make_map(&maps[6], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, B, N, H, D, out,
                      wgb_dq_box(D), WGB_BLOCK_M)) ||
      (err = make_flat_map(&maps[7], lse, rows, WGB_BLOCK_M)) ||
      (err = make_flat_map(&maps[8], delta, rows, WGB_BLOCK_M)))
    return err;
  constexpr int smem = wgb_smem_bytes(D);
  if ((err = allow_smem(attention_bwd_wgmma_kernel<T, D>, smem))) return err;
  const dim3 grid((N + WGB_BLOCK_N - 1) / WGB_BLOCK_N, B * H);
  attention_bwd_wgmma_kernel<T, D><<<grid, WGB_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], maps[8], N, H,
      scale_log2, scale);
  return cudaGetLastError();
}

// The backward of type T: the pre-pass, the main kernel and, for bf16 and
// fp16, the dQ conversion (fp32 accumulates into dq itself, which is then
// dq_acc), on one stream; the error of the first launch that fails.
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, float* dq_acc,
                       void* dq, void* dk, void* dv, int B, int N, int H, Strides qs,
                       Strides ks, Strides vs, Strides os, Strides dos,
                       cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * N * H;
  const int64_t prep_threads = rows * (D * sizeof(T) / 16);
  attention_bwd_prep_kernel<T, D>
      <<<static_cast<unsigned>((prep_threads + BWD_PREP_THREADS - 1) / BWD_PREP_THREADS),
         BWD_PREP_THREADS, 0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                                        delta, dq_acc, N, H, rows, os, dos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = 1.f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {  // dq_acc is dq: no conversion
    constexpr int smem = tb_smem_bytes(D);
    if ((err = allow_smem(attention_bwd_tf32_kernel<D>, smem))) return err;
    const dim3 grid((N + TB_BLOCK_N - 1) / TB_BLOCK_N, B * H);
    attention_bwd_tf32_kernel<D><<<grid, TB_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, dq_acc, static_cast<float*>(dk),
        static_cast<float*>(dv), N, H, qs, ks, vs, dos, 1.4426950408889634f * scale, scale);
    return cudaGetLastError();
  } else {
    constexpr bool FP16 = std::is_same_v<T, __half>;
    if (!mma_bwd(N, D, FP16)) {
      if constexpr (wgb_built(D, FP16))
        err = launch_bwd_wgmma<T, D>(q, k, v, dout, lse, delta, dq_acc, dk, dv, B, N, H, qs, ks, vs,
                                     dos, 1.4426950408889634f * scale, scale, stream);
      if (err != cudaSuccess) return err;
    } else {
      constexpr int smem = bwd_smem_bytes(D);
      if ((err = allow_smem(attention_bwd_mma_kernel<T, D>, smem))) return err;
      const dim3 grid((N + BWD_BLOCK_N - 1) / BWD_BLOCK_N, B * H);
      attention_bwd_mma_kernel<T, D><<<grid, BWD_THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<const T*>(dout), lse, delta, dq_acc, static_cast<T*>(dk),
          static_cast<T*>(dv), N, H, qs, ks, vs, dos, 1.4426950408889634f * scale, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }

    const int64_t chunks = rows * (D / 8);
    attention_bwd_dq_kernel<T>
        <<<static_cast<unsigned>((chunks + BWD_PREP_THREADS - 1) / BWD_PREP_THREADS),
           BWD_PREP_THREADS, 0, stream>>>(dq_acc, static_cast<T*>(dq), chunks);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int N, int H, Strides qs,
                       Strides ks, Strides vs, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, N, H, qs, ks, vs, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, N, H, qs, ks, vs, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, N, H, qs, ks, vs, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* delta, float* dq_acc, void* dq, void* dk, void* dv,
                         int B, int N, int H, Strides qs, Strides ks, Strides vs,
                         Strides os, Strides dos, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv,
                                       B, N, H, qs, ks, vs, os, dos, stream);
    case 32: return launch_bwd<T, 32>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv,
                                       B, N, H, qs, ks, vs, os, dos, stream);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv,
                                       B, N, H, qs, ks, vs, os, dos, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned_16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Both kernels copy 16-byte chunks: every pointer 16-byte aligned and every
// stride of an axis longer than 1 a multiple of 16 bytes (8 elements of 16
// bits, 4 of fp32).
bool aligned_16(const void* p, int B, int N, int H, Strides s, int elem_bytes) {
  const int64_t strides = (B > 1 ? s.b : 0) | (N > 1 ? s.n : 0) | (H > 1 ? s.h : 0);
  return aligned_16(p) && (strides & (16 / elem_bytes - 1)) == 0;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides are in elements. Returns
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int hd_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int B, int N, int H, int D, int dtype,
                                int64_t q_sb, int64_t q_sn, int64_t q_sh,
                                int64_t k_sb, int64_t k_sn, int64_t k_sh,
                                int64_t v_sb, int64_t v_sn, int64_t v_sh,
                                void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const int eb = dtype == 0 ? 4 : 2;
  if (!(aligned_16(q, B, N, H, qs, eb) && aligned_16(k, B, N, H, ks, eb) &&
        aligned_16(v, B, N, H, vs, eb) && aligned_16(o)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, nullptr, B, N, H, qs, ks, vs, s);
    case 1: return dispatch_d<__half>(D, q, k, v, o, nullptr, B, N, H, qs, ks, vs, s);
    case 2: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, nullptr, B, N, H, qs, ks, vs, s);
    default: return cudaErrorInvalidValue;
  }
}

// The forward that also writes the fp32 log-sum-exp of each query row, in
// the kernel's exp2 domain, to the contiguous (B, h, N) `lse`; as
// hd_attention_fwd otherwise.
extern "C" int hd_attention_fwd_lse(const void* q, const void* k, const void* v,
                                    void* o, float* lse, int B, int N, int H, int D,
                                    int dtype, int64_t q_sb, int64_t q_sn, int64_t q_sh,
                                    int64_t k_sb, int64_t k_sn, int64_t k_sh,
                                    int64_t v_sb, int64_t v_sn, int64_t v_sh,
                                    void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B * H > 65535 || lse == nullptr)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh};
  const int eb = dtype == 0 ? 4 : 2;
  if (!(aligned_16(q, B, N, H, qs, eb) && aligned_16(k, B, N, H, ks, eb) &&
        aligned_16(v, B, N, H, vs, eb) && aligned_16(o)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, lse, B, N, H, qs, ks, vs, s);
    case 1: return dispatch_d<__half>(D, q, k, v, o, lse, B, N, H, qs, ks, vs, s);
    case 2: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, N, H, qs, ks, vs, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: dq, dk, dv (contiguous (B, N, h, d), the input type) of
// out = softmax(q·kᵀ/√d)·v for the incoming gradient `dout`, from the
// forward's inputs, its output `o` and its `lse` (hd_attention_fwd_lse).
// `delta` (fp32, B·h·N) and, for bf16 and fp16, `dq_acc` (fp32, B·N·h·d) are
// the caller's scratch; the pre-pass fills both (fp32 sums into dq, and
// dq_acc is not read). q, k, v, o and dout are strided (B, N, h, d) views
// as hd_attention_fwd takes them. dtype as there.
extern "C" int hd_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, const float* lse,
                                float* delta, float* dq_acc, void* dq, void* dk, void* dv,
                                int B, int N, int H, int D, int dtype,
                                int64_t q_sb, int64_t q_sn, int64_t q_sh,
                                int64_t k_sb, int64_t k_sn, int64_t k_sh,
                                int64_t v_sb, int64_t v_sn, int64_t v_sh,
                                int64_t o_sb, int64_t o_sn, int64_t o_sh,
                                int64_t do_sb, int64_t do_sn, int64_t do_sh,
                                void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B * H > 65535) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sn, q_sh}, ks{k_sb, k_sn, k_sh}, vs{v_sb, v_sn, v_sh},
      os{o_sb, o_sn, o_sh}, dos{do_sb, do_sn, do_sh};
  const int eb = dtype == 0 ? 4 : 2;
  if (dtype == 0) dq_acc = static_cast<float*>(dq);
  if (!(aligned_16(q, B, N, H, qs, eb) && aligned_16(k, B, N, H, ks, eb) &&
        aligned_16(v, B, N, H, vs, eb) && aligned_16(o, B, N, H, os, eb) &&
        aligned_16(dout, B, N, H, dos, eb) && aligned_16(lse) && aligned_16(delta) &&
        aligned_16(dq_acc) && aligned_16(dq) && aligned_16(dk) && aligned_16(dv)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_bwd<float>(D, q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, B, N,
                                 H, qs, ks, vs, os, dos, s);
    case 1:
      return dispatch_bwd<__half>(D, q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, B,
                                  N, H, qs, ks, vs, os, dos, s);
    case 2:
      return dispatch_bwd<__nv_bfloat16>(D, q, k, v, o, dout, lse, delta, dq_acc, dq, dk,
                                         dv, B, N, H, qs, ks, vs, os, dos, s);
    default: return cudaErrorInvalidValue;
  }
}
