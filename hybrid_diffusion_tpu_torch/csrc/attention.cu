// Fused spatial self-attention forward for the U-Net bottleneck, sm_90a.
//
// Replaces the TPU kernel hybrid_diffusion_tpu/ops/attention.py:63,
// _pallas_attention (body _attention_kernel): out = softmax(q·kᵀ/√d)·v for
// every (batch, head) slice, with fp32 scores and softmax and the output in
// the input dtype. Two kernels, chosen by dtype in hd_attention_fwd:
//
//   attention_fwd_mma_kernel (bf16, fp16): a FlashAttention-2-style forward
//     on the tensor cores (mma.sync m16n8k16, fp32 accumulation);
//   attention_fwd_kernel (fp32): one query per thread on the fp32 FMA units.
//     TF32 tensor cores would round the products past the fp32 tolerance, so
//     fp32 keeps this simple, exact kernel.
//
// Bound at the flagship shape (B = 8, N = 32·32 = 1024 tokens, h = 8 heads,
// d = 32, bf16), per call:
//   operations  4·B·h·N²·d = 8.6 GFLOP  -> 8.7 us at 989 TFLOP/s (bf16 tensor cores)
//   bytes       4·B·N·h·d·2 = 16.8 MB   -> 5.0 us at 3.35 TB/s
//   exponentials B·h·N² = 67.1 M        -> about 17 us at the H100's ~3.9 T/s
//                                          special-function rate
// The exponentials, not the products, are the real floor at d 32.
//
// What the tensor-core design does about each:
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
// Measured times: PERF.md.
//
// The SIMT fp32 kernel stages K and V tiles of 32 keys as fp32 in shared
// memory, read as broadcasts, with one query, a running max and sum and a
// d-wide accumulator per thread (bound at the flagship shape in fp32:
// 8.6 GFLOP at 67 TFLOP/s = 128 us).
//
// The output is a contiguous (B, N, h, d) tensor; the innermost (d) stride of
// q, k and v must be 1. A ragged N is masked in both kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// fp32: the SIMT kernel.

constexpr int BLOCK_M = 128;  // queries per block, one per thread
constexpr int BLOCK_N = 32;   // keys per shared-memory tile

// Only float is instantiated: bf16 and fp16 take the tensor-core kernel.
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  int64_t b, n, h;  // in elements; the d stride is 1
};

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_M)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int N, int H,
                     Strides qs, Strides ks, Strides vs, float scale_log2) {
  __shared__ __align__(16) float k_tile[BLOCK_N][D];
  __shared__ __align__(16) float v_tile[BLOCK_N][D];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int head = bh % H;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * BLOCK_M + tid;
  const bool active = row < N;

  const T* k_base = k + b * ks.b + head * ks.h;
  const T* v_base = v + b * vs.b + head * vs.h;

  // The query, pre-scaled so that exp2 of a score difference is the softmax
  // weight: exp((s - m)/sqrt(d)) == exp2((s - m)·log2(e)/sqrt(d)).
  float q_reg[D];
  float acc[D];
  {
    const T* q_row = q + b * qs.b + static_cast<int64_t>(active ? row : 0) * qs.n +
                     head * qs.h;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      q_reg[i] = active ? to_f32(q_row[i]) * scale_log2 : 0.f;
      acc[i] = 0.f;
    }
  }
  float m = -INFINITY;  // running max of the scaled scores
  float l = 0.f;        // running sum of exp2(score - m)

  for (int start = 0; start < N; start += BLOCK_N) {
    // Stage the K and V tiles as fp32; keys past N are zero and masked below.
#pragma unroll
    for (int e = tid; e < BLOCK_N * D; e += BLOCK_M) {
      const int j = e / D;
      const int i = e % D;
      const int key = start + j;
      float kv = 0.f, vv = 0.f;
      if (key < N) {
        kv = to_f32(k_base[static_cast<int64_t>(key) * ks.n + i]);
        vv = to_f32(v_base[static_cast<int64_t>(key) * vs.n + i]);
      }
      k_tile[j][i] = kv;
      v_tile[j][i] = vv;
    }
    __syncthreads();

    const int valid = min(BLOCK_N, N - start);
    float s[BLOCK_N];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_tile[j][i]);
        dot = fmaf(q_reg[i], kk.x, dot);
        dot = fmaf(q_reg[i + 1], kk.y, dot);
        dot = fmaf(q_reg[i + 2], kk.z, dot);
        dot = fmaf(q_reg[i + 3], kk.w, dot);
      }
      s[j] = j < valid ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite.
    const float m_new = fmaxf(m, tile_max);
    const float correction = exp2f(m - m_new);
    l *= correction;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[i] *= correction;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = exp2f(s[j] - m_new);  // 0 for a masked key
      l += p;
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_tile[j][i]);
        acc[i] = fmaf(p, vv.x, acc[i]);
        acc[i + 1] = fmaf(p, vv.y, acc[i + 1]);
        acc[i + 2] = fmaf(p, vv.z, acc[i + 2]);
        acc[i + 3] = fmaf(p, vv.w, acc[i + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (active) {
    const float inv_l = 1.f / l;
    T* o_row = o + ((static_cast<int64_t>(b) * N + row) * H + head) * D;
#pragma unroll
    for (int i = 0; i < D; ++i) o_row[i] = from_f32<T>(acc[i] * inv_l);
  }
}

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int N, int H, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  if constexpr (std::is_same_v<T, float>) {
    const dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
    attention_fwd_kernel<T, D><<<grid, BLOCK_M, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), N, H, qs, ks, vs,
        scale_log2);
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

// The tensor-core route copies 16-byte chunks: every pointer 16-byte aligned
// and every stride of an axis longer than 1 a multiple of 8 elements.
bool aligned_16(const void* p, int B, int N, int H, Strides s) {
  const int64_t strides = (B > 1 ? s.b : 0) | (N > 1 ? s.n : 0) | (H > 1 ? s.h : 0);
  return aligned_16(p) && (strides & 7) == 0;
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
  if (dtype != 0 && !(aligned_16(q, B, N, H, qs) && aligned_16(k, B, N, H, ks) &&
                      aligned_16(v, B, N, H, vs) && aligned_16(o)))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 1: return dispatch_d<__half>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 2: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    default: return cudaErrorInvalidValue;
  }
}
