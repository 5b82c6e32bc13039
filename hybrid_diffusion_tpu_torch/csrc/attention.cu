// Fused spatial self-attention forward for the U-Net bottleneck, sm_90a.
//
// Replaces the TPU kernel hybrid_diffusion_tpu/ops/attention.py:63,
// _pallas_attention (body _attention_kernel): out = softmax(q·kᵀ/√d)·v for
// every (batch, head) slice, with fp32 scores and softmax and the output in
// the input dtype. Two kernels, chosen by dtype in hd_attention_fwd, both on
// the tensor cores (mma.sync), FlashAttention-2-style:
//
//   attention_fwd_mma_kernel (bf16, fp16): m16n8k16 products, fp32
//     accumulation, P rounded to the input type;
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
// The exponentials, not the products, are the real floor in bf16 at d 32. In
// fp32 the design below computes each product as three TF32 products, so
// its own floor is 3 × 17 = 52 us.
//
// What the bf16/fp16 design does about each:
// - Operations: both products run as mma.sync (bf16/fp16 in, fp32 out). One
//   block of MMA_WARPS (4) warps owns 16·MMA_M_TILES·MMA_WARPS (128) queries
//   of one (batch, head) slice: a (8, 64) grid of 512 blocks at the flagship.
//   Each warp keeps its MMA_M_TILES (2) m16 tiles of queries as A fragments
//   in registers for the whole key loop (loaded once by ldmatrix; Q is not
//   pre-scaled, which would round it differently) and walks the keys in
//   tiles of MMA_BLOCK_N (64). K fragments come from ldmatrix as they lie (a
//   key row with d contiguous is the column-major B operand), V
//   fragments from ldmatrix.trans; each feeds the products of every m16 tile
//   of the warp, which halves the shared-memory reads per product against
//   one m16 tile a warp (the reads, 512 bytes an ldmatrix.x4, otherwise take
//   about as long as the products at d 32 and longer at d 64). The scores'
//   C fragments, rounded to the input type, are reused in registers as the
//   A fragments of P·V: no score or probability touches shared or device
//   memory. Rounding P to the input type before P·V is what the JAX main
//   path does (_xla_attention: probs.astype(q.dtype)).
// - Exponentials: log2(e)/√d is folded into one FFMA per score,
//   p = exp2(s·c − m·c), evaluated by ex2.approx; the online softmax keeps a
//   running max per row (reduced over the 4 lanes of a quad with shuffles)
//   and a per-lane partial sum, reduced once at the end.
// - Bytes: q, k and v are read once per query tile with 16-byte cp.async
//   copies straight from their strided (B, N, h, d) layout (the packed q|k|v
//   projection is never split or transposed), into two K/V tile buffers in
//   shared memory, so the next tile's copy overlaps this tile's math. The
//   16-byte chunks are XOR-swizzled so that ldmatrix does not collide on
//   banks. The output is staged in shared memory and written in
//   16-byte stores. Keys at or past N are zero-filled by the copy and masked
//   to −inf before the max; query rows past N are computed and not stored.
//   This route needs 16-byte-aligned pointers and strides that are multiples
//   of 8 elements (the wrapper checks; the model's packed views meet them).
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
//   holds one m16 tile a warp and d 16 and 32 two. Key tiles of 32 keys
//   keep half the scores of 64 live; P·V walks the output tiles W at a time,
//   so that only W tiles' V fragments are live; K and V fragments are read
//   with volatile loads, and the kernel promises one block a multiprocessor
//   (__launch_bounds__): without either, ptxas spilled at d 64.
// Keys at or past N are zero-filled and masked as above. This route needs
// 16-byte-aligned pointers and strides in multiples of 4 elements.
//
// Measured times: PERF.md.
//
// The output is a contiguous (B, N, h, d) tensor; the innermost (d) stride of
// q, k and v must be 1. A ragged N is masked in both kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

struct Strides {
  int64_t b, n, h;  // in elements; the d stride is 1
};

// ---------------------------------------------------------------------------
// bf16 / fp16: the tensor-core kernel.

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
// reads from shared memory feeds MMA_M_TILES products.
template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int N,
                         int H, Strides qs, Strides ks, Strides vs,
                         float scale_log2) {
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
constexpr int tf32_smem_bytes(int D) {
  return TF32_STAGES * TF32_BLOCK_N * (tf32_k_stride(D) + tf32_v_stride(D)) * 4;
}
static_assert(tf32_smem_bytes(64) <= 48 * 1024, "no opt-in to more shared memory");

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
// One block a multiprocessor is all that __launch_bounds__ promises: with it
// ptxas fits d 64 in 255 registers without spills, and small grids and d 16
// ran faster on an H100 (PERF.md).
template <int D, int MT>
__global__ void __launch_bounds__(TF32_THREADS, 1)
attention_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int N, int H, Strides qs, Strides ks, Strides vs,
                          float scale_log2) {
  constexpr int KSTEPS = D / 8;             // k8 steps of Q·Kᵀ
  constexpr int S_TILES = TF32_BLOCK_N / 8; // n8 score tiles = k8 steps of P·V
  constexpr int O_TILES = D / 8;            // n8 tiles of the output
  constexpr int W = O_TILES < 4 ? O_TILES : 4;
  constexpr int SK = tf32_k_stride(D), SV = tf32_v_stride(D);
  constexpr int K_FLOATS = TF32_BLOCK_N * SK, V_FLOATS = TF32_BLOCK_N * SV;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sk = smem_u32(smem);
  const uint32_t sv = sk + TF32_STAGES * K_FLOATS * 4;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x * TF32_WARPS + warp) * MT * 16;  // MT m16 tiles a warp
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
          mma_tf32(s[mt][j], ql[mt][kk], kh[kk]);
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

  // Epilogue: divide by l and write each row < N straight from the
  // fragments: a lane holds d 8W·grp + 2W·t .. +2W−1 of rows g and g+8.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = l_run[mt][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv_l = 1.f / l;
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
void launch_tf32(const void* q, const void* k, const void* v, void* o, int B,
                 int N, int H, Strides qs, Strides ks, Strides vs, float scale_log2,
                 cudaStream_t stream) {
  constexpr int block_m = 16 * MT * TF32_WARPS;
  const dim3 grid((N + block_m - 1) / block_m, B * H);
  attention_fwd_tf32_kernel<D, MT><<<grid, TF32_THREADS, tf32_smem_bytes(D), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), N, H, qs, ks, vs,
      scale_log2);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int N, int H, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
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
      launch_tf32<D, MT>(q, k, v, o, B, N, H, qs, ks, vs, scale_log2, stream);
    else
      launch_tf32<D, 1>(q, k, v, o, B, N, H, qs, ks, vs, scale_log2, stream);
  } else {
    constexpr int smem = mma_smem_bytes(D);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          attention_fwd_mma_kernel<T, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid((N + MMA_BLOCK_M - 1) / MMA_BLOCK_M, B * H);
    attention_fwd_mma_kernel<T, D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), N, H, qs, ks, vs,
        scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int N, int H, Strides qs, Strides ks,
                       Strides vs, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, N, H, qs, ks, vs, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, N, H, qs, ks, vs, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, N, H, qs, ks, vs, stream);
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
    case 0: return dispatch_d<float>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 1: return dispatch_d<__half>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 2: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    default: return cudaErrorInvalidValue;
  }
}
