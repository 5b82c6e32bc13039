// Which kernel of attention.cu each call runs, by dtype, N and d: the
// routes chosen by timing both kernels on an H100 (attention_variants.py;
// PERF.md), and the instances each route needs built. attention.cu includes
// it; it is plain C++ as well, so that the CPU tests compile the routes
// (tests/test_torch_attention_bwd_tf32.py) and the Python side can name
// them (ops/attention.py, kernel_route).
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

namespace {

// Where the mma.sync kernels run in place of the wgmma ones, as
// measured on an H100 (attention_variants.py; PERF.md): at d 16 (the
// forward and the backward), at d 32 below N = WG_MIN_N, the backward at
// d 64 (there the wgmma one spills) and the fp16 backward at every N (ptxas
// serializes its wgmma instance, C7517 and C7514, which ran 5% slower than
// the mma.sync one at (16, 1024, 8, 32)). mma_fwd_built: the d the mma.sync
// forward instances are built for; wgf_built, wgb_built: the wgmma ones'.
constexpr int WG_MIN_N = 257;
__host__ __device__ constexpr bool mma_fwd(int N, int D) {
  return D == 16 || (D == 32 && N < WG_MIN_N);
}
__host__ __device__ constexpr bool mma_bwd(int N, int D, bool fp16) {
  return fp16 || D != 32 || N < WG_MIN_N;
}
__host__ __device__ constexpr bool mma_fwd_built(int D) { return D <= 32; }
__host__ __device__ constexpr bool wgf_built(int D) { return D != 16; }
__host__ __device__ constexpr bool wgb_built(int D, bool fp16) { return !fp16 && D == 32; }

}  // namespace

// The name of the kernel that hd_attention_fwd (backward 0) or
// hd_attention_bwd (backward 1) launches for this dtype (as there), N and d,
// as mma_fwd and mma_bwd choose; fp32 has one kernel each way.
extern "C" const char* hd_attention_route(int backward, int dtype, int N, int D) {
  if (dtype == 0) return backward ? "attention_bwd_tf32_kernel" : "attention_fwd_tf32_kernel";
  if (backward)
    return mma_bwd(N, D, dtype == 1) ? "attention_bwd_mma_kernel" : "attention_bwd_wgmma_kernel";
  return mma_fwd(N, D) ? "attention_fwd_mma_kernel" : "attention_fwd_wgmma_kernel";
}
