"""Time design variants of the fp32 attention kernel, or of the bf16
backward kernel, against the kept one.

    python -m hybrid_diffusion_tpu_torch.attention_variants [--backward]

Each variant is `csrc/attention.cu` with a few named edits (EDITS: each old
text must occur exactly once in the source, or the script stops). All
variants are built by nvcc at once into `_build/variants/`; the script
prints each one's fp32 instances' registers, spills and HMMA count. Then, at
each shape of SHAPES, on one set of inputs, every variant's fp32 kernel is
held against the plain version (max abs error ≤ 1e-5, as in chip_smoke.py)
and timed with `utils/timing.device_ms`, in the order of VARIANTS and then
reversed (so that each variant's two times bracket the others), beside
`scaled_dot_product_attention` (fp32, TF32 off). Prints one JSON line per
shape and the card's nvidia-smi line.

With --backward the same for the bf16 backward (BWD_EDITS, BWD_SHAPES):
each variant's `hd_attention_bwd` on the kept forward's output and lse,
held against the plain twin `attention_backward_reference` within
BWD_RTOL, except for the diagnostic variants (DIAGNOSTIC: they leave work
out to show its cost, so their gradients are wrong and are only timed),
beside SDPA's backward alone (its forward once, then the backward with
retain_graph).
"""

from __future__ import annotations

import concurrent.futures
import json
import sys

import torch
import torch.nn.functional as F

from .ops import attention as att
from .utils import cuda_build
from .utils.timing import device_ms

ATOL = 1e-5

# (old text, new text) edits of the source, each undoing one choice of the
# kept design.
EDITS = {
    # Two m16 tiles a warp at d 16 and 32 at every shape: the launcher never
    # takes the one-tile instance when the grid would leave SMs without a
    # block.
    "no_switch": [("((N + wide_m - 1) / wide_m) >= sms)",
                   "((N + wide_m - 1) / wide_m) >= 0)")],
    # One m16 tile a warp at every d and shape.
    "one_tile": [("{ return D <= 32 ? 2 : 1; }", "{ return 1; }")],
    # One m16 tile a warp at d 16.
    "one_tile_d16": [("{ return D <= 32 ? 2 : 1; }",
                      "{ return D == 32 ? 2 : 1; }")],
    # Key tiles of 64 keys (d 64 then needs more than 48 KiB of shared
    # memory, which the launch opts into).
    "block_n64": [
        ("constexpr int TF32_BLOCK_N = 32;", "constexpr int TF32_BLOCK_N = 64;"),
        ("static_assert(tf32_smem_bytes(64) <= 48 * 1024, "
         "\"no opt-in to more shared memory\");\n", ""),
        ("  attention_fwd_tf32_kernel<D, MT><<<",
         "  cudaFuncSetAttribute(attention_fwd_tf32_kernel<D, MT>,\n"
         "                       cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "                       tf32_smem_bytes(D));\n"
         "  attention_fwd_tf32_kernel<D, MT><<<")],
    # K and V fragments read with plain (not volatile) loads.
    "plain_loads": [(
        "  if constexpr (W == 4)\n"
        "    asm volatile(\"ld.volatile.shared.v4.f32",
        "  const void* p = __cvta_shared_to_generic(addr);\n"
        "  if constexpr (W == 4) {\n"
        "    const float4 v = *static_cast<const float4*>(p);\n"
        "    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;\n"
        "  } else {\n"
        "    const float2 v = *static_cast<const float2*>(p);\n"
        "    x[0] = v.x, x[1] = v.y;\n"
        "  }\n"
        "  return;\n"
        "  if constexpr (W == 4)\n"
        "    asm volatile(\"ld.volatile.shared.v4.f32")],
    # No promise of one block a multiprocessor.
    "no_launch_bound": [("__launch_bounds__(TF32_THREADS, 1)",
                         "__launch_bounds__(TF32_THREADS)")],
    # The operand split in float arithmetic (Veltkamp, on the FMA pipe): hi
    # is x rounded to 11 significant bits, lo = x - hi exact (12 bits), fed
    # to the mma as it is, so the tensor cores drop its 13 low bits.
    "veltkamp": [(
        "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));\n",
        "  const float c = fmaf(x, 8192.f, x);  // x·(2^13 + 1)\n"
        "  const float h = c - (c - x);\n"
        "  hi = __float_as_uint(h);\n  lo = __float_as_uint(x - h);\n")],
}
VARIANTS = {"kept": [], **{name: [name] for name in EDITS}}

# Edits of the bf16/fp16 backward kernel.
BWD_EDITS = {
    # Diagnostic: no atomic adds of dQ (dQ stays zero; ptxas then drops
    # dQ's products as well), to show what dQ costs.
    "no_dq_atomics": [("      if (row < N)\n        atomicAdd(",
                       "      if (row < 0)\n        atomicAdd("),
                      ("      if (row + 8 < N)\n        atomicAdd(",
                       "      if (row + 8 < 0)\n        atomicAdd(")],
    # Each query step's products up to dK in one pass of 64 queries at
    # every d, not two sub-steps of 32 at d 32 and 64: twice the scores and
    # dP live at once.
    "sub_m64": [("{ return D == 16 ? 64 : 32; }", "{ return 64; }")],
}
BWD_VARIANTS = {"kept": [], **{name: [name] for name in BWD_EDITS}}
DIAGNOSTIC = {"no_dq_atomics"}
# (B, N, h, d), bf16: the flagship train step, the head-sharded TP step,
# the CFG train step's N 1024 (batch 80) and the CFG sampler's N 256.
BWD_SHAPES = [(16, 1024, 8, 32), (8, 1024, 4, 32), (80, 1024, 8, 16),
              (160, 256, 8, 32)]
# Against the plain twin, each gradient against its own largest value:
# the bf16 tolerance that chip_smoke.py holds against the fp32 autograd.
BWD_RTOL = att.BWD_RTOL["bfloat16", "randn"]
# (B, N, h, d): the flagship (256², batch 8), the smoke's path phase (64²,
# batch 2), 64² at batch 8, 128² at batch 2, a ragged N, d 16 and d 64.
SHAPES = [(8, 1024, 8, 32), (2, 64, 8, 32), (8, 64, 8, 32), (2, 256, 8, 32),
          (8, 1000, 8, 32), (8, 1024, 8, 16), (2, 1000, 8, 64)]


def variant_source(edits: list[str], table: dict = EDITS) -> str:
    src = (cuda_build.CSRC_DIR / att.SOURCE).read_text()
    for name in edits:
        for old, new in table[name]:
            if src.count(old) != 1:
                sys.exit(f"attention_variants: edit {name!r} matches the "
                         f"source {src.count(old)} times, expected once: "
                         f"{old!r}")
            src = src.replace(old, new)
    return src


def build_all(backward: bool = False
              ) -> dict[str, cuda_build.BuiltLibrary]:
    folder = cuda_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    paths = {}
    variants, table = ((BWD_VARIANTS, BWD_EDITS) if backward
                       else (VARIANTS, EDITS))
    for name, edits in variants.items():
        path = folder / f"attention_{'bwd_' * backward}{name}.cu"
        path.write_text(variant_source(edits, table))
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(cuda_build.build, paths.values())))
    for name, lib in built.items():
        att.bind(lib.lib)
        hmma = cuda_build.sass_opcode_counts(lib.path, "HMMA")
        for sym, res in sorted(cuda_build.kernel_resources(lib.ptxas_log).items()):
            inst = att.kernel_instance(sym)
            if inst is None or not (inst[0].startswith("attention_bwd")
                                    if backward else inst[1] == torch.float32):
                continue
            print(f"  {name} {inst[0]} {inst[1]} d {inst[2]}: "
                  f"{res.registers} registers, {res.spill_bytes} bytes "
                  f"spilled, {hmma.get(sym, 0)} HMMA", flush=True)
    return built


def main_backward() -> None:
    built = build_all(backward=True)
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(BWD_VARIANTS) + list(reversed(BWD_VARIANTS))
    for B, N, h, d in BWD_SHAPES:
        qkv = torch.randn(B, N, 3, h, d, device="cuda",
                          generator=gen).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)  # the model's packed, strided views
        g = torch.randn(B, N, h, d, device="cuda",
                        generator=gen).to(torch.bfloat16)
        out, lse = att.call_library_lse(built["kept"].lib, q, k, v)
        ref = att.attention_backward_reference(q, k, v, out, lse, g)
        row = {"shape": [B, N, h, d]}
        times: dict[str, list[float]] = {name: [] for name in BWD_VARIANTS}
        for name in order:
            lib = built[name].lib

            def call():
                return att.call_library_bwd(lib, q, k, v, out, lse, g)

            if not times[name] and name not in DIAGNOSTIC:
                err = att.grad_rel_err(call(), ref)
                if not err <= BWD_RTOL:
                    sys.exit(f"attention_variants: {name} errs by {err} > "
                             f"{BWD_RTOL} at {(B, N, h, d)}")
                row[f"{name}_err"] = err
            times[name].append(device_ms(call, reps=15, inner=5))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        s_out = F.scaled_dot_product_attention(qt, kt, vt)
        row["sdpa_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
            s_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True),
            reps=15, inner=5)
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
        print(json.dumps(row), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cuda_build.nvidia_smi_line()
    if "--backward" in sys.argv[1:]:
        main_backward()
        print(smi, flush=True)
        return
    built = build_all()
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for B, N, h, d in SHAPES:
        qkv = torch.randn(B, N, 3, h, d, device="cuda", generator=gen)
        q, k, v = qkv.unbind(2)  # the model's packed, strided views
        att._check_cuda_inputs(q, k, v)
        ref = att.attention_reference(q, k, v)
        row = {"shape": [B, N, h, d]}
        times: dict[str, list[float]] = {name: [] for name in VARIANTS}
        for name in order:
            fn = built[name].lib.hd_attention_fwd
            if not times[name]:
                err = (att.call_library(fn, q, k, v) - ref).abs().max().item()
                if not err <= ATOL:
                    sys.exit(f"attention_variants: {name} errs by {err} > "
                             f"{ATOL} at {(B, N, h, d)}")
                row[f"{name}_err"] = err
            times[name].append(
                device_ms(lambda: att.call_library(fn, q, k, v)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
        print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
