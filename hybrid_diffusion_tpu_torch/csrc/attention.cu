// Fused spatial self-attention forward for the U-Net bottleneck, sm_90a.
//
// Replaces the TPU kernel hybrid_diffusion_tpu/ops/attention.py::_pallas_attention
// (body _attention_kernel): out = softmax(q·kᵀ/√d)·v for every (batch, head)
// slice, with scores, softmax and the product in fp32 and the output in the
// input dtype.
//
// Bound at the flagship shape (B = 8, N = 32·32 = 1024 tokens, h = 8 heads,
// d = 32, bf16), per call:
//   operations  4·B·h·N²·d = 8.6 GFLOP  -> 8.7 us at 989 TFLOP/s (bf16 tensor cores)
//   bytes       4·B·N·h·d·2 = 16.8 MB   -> 5.0 us at 3.35 TB/s
// so it is bound by operations, at about 9 us.
//
// What the design does about that bound. The TPU kernel keeps a whole N×N
// fp32 score matrix (4 MiB at N = 1024) in VMEM; an SM has at most 227 KB of
// shared memory, so this kernel never forms it. One block owns BLOCK_M
// queries of one (batch, head) slice, one query per thread. It walks the keys
// in tiles of BLOCK_N: each K and V tile is staged once in shared memory (as
// fp32) and read by every thread of the block as a broadcast, and each thread
// keeps its query, a running max, a running sum and its d-wide accumulator in
// registers (the online softmax). Device memory sees q, k, v read once per
// query tile and the output written once; no score ever leaves the SM. The
// arithmetic runs on the fp32 FMA units, not the tensor cores, so it cannot
// reach the bf16 bound above (the fp32 FMA peak is 67 TFLOP/s): this is the
// simple, exact first version. Tensor cores (wgmma), TMA and warp
// specialisation are the next step.
//
// q, k and v are read in their (B, N, h, d) layout through strides, so the
// (B, N, h, d) -> (B·h, N, d) transposes of the TPU wrapper, and the copies
// that a split of the packed qkv projection would need, are not made. The
// innermost (d) stride must be 1. The output is a contiguous (B, N, h, d)
// tensor. A ragged N (not a multiple of either tile) is masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;  // queries per block, one per thread
constexpr int BLOCK_N = 32;   // keys per shared-memory tile

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int N, int H, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  attention_fwd_kernel<T, D><<<grid, BLOCK_M, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), N, H, qs, ks, vs,
      scale_log2);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 1: return dispatch_d<__half>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    case 2: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, N, H, qs, ks, vs, s);
    default: return cudaErrorInvalidValue;
  }
}
