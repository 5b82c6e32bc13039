"""Time design variants of the fp32 attention kernel against the kept one.

    python -m hybrid_diffusion_tpu_torch.attention_variants

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
# (B, N, h, d): the flagship (256², batch 8), the smoke's path phase (64²,
# batch 2), 64² at batch 8, 128² at batch 2, a ragged N, d 16 and d 64.
SHAPES = [(8, 1024, 8, 32), (2, 64, 8, 32), (8, 64, 8, 32), (2, 256, 8, 32),
          (8, 1000, 8, 32), (8, 1024, 8, 16), (2, 1000, 8, 64)]


def variant_source(edits: list[str]) -> str:
    src = (cuda_build.CSRC_DIR / att.SOURCE).read_text()
    for name in edits:
        for old, new in EDITS[name]:
            if src.count(old) != 1:
                sys.exit(f"attention_variants: edit {name!r} matches the "
                         f"source {src.count(old)} times, expected once: "
                         f"{old!r}")
            src = src.replace(old, new)
    return src


def build_all() -> dict[str, cuda_build.BuiltLibrary]:
    folder = cuda_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, edits in VARIANTS.items():
        path = folder / f"attention_{name}.cu"
        path.write_text(variant_source(edits))
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(cuda_build.build, paths.values())))
    for name, lib in built.items():
        att.bind(lib.lib)
        hmma = cuda_build.sass_opcode_counts(lib.path, "HMMA")
        for sym, res in sorted(cuda_build.kernel_resources(lib.ptxas_log).items()):
            inst = att.kernel_instance(sym)
            if inst is not None and inst[1] == torch.float32:
                print(f"  {name} d {inst[2]}: {res.registers} registers, "
                      f"{res.spill_bytes} bytes spilled, {hmma.get(sym, 0)} "
                      f"HMMA", flush=True)
    return built


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cuda_build.nvidia_smi_line()
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
