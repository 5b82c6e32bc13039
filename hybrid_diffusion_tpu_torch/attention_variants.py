"""Time design variants of the attention kernels against the kept ones.

    python -m hybrid_diffusion_tpu_torch.attention_variants [--forward | --backward]

Each variant is `csrc/attention.cu` with a few named edits (each old text
must occur exactly once in the source, or the script stops). All variants of
a mode are built by nvcc at once into `_build/variants/`; the script prints
each timed instance's registers, spills, tensor-core and TMA opcodes and
ptxas's notes that it serialized the instance's wgmma (C75xx). Then, at each
shape of the mode, on one set of inputs, every variant is held against the
plain version and timed with `utils/timing.device_ms`, in the order of the
variants and then reversed (so that each variant's two times bracket the
others), beside PyTorch's scaled_dot_product_attention. Prints one JSON line
per shape (each variant's error, the kernel its dispatch chose, its times)
and the card's nvidia-smi line.

  (no flag)   the fp32 mma.sync forward's design choices (EDITS, SHAPES;
              max abs error <= 1e-5, as in chip_smoke.py), beside SDPA in
              fp32 with TF32 off;
  --forward   the bf16/fp16 forward (FWD_EDITS, FWD_SHAPES: the wgmma
              kernel's choices, where the dispatch sends a shape, and the
              route itself: wgmma or mma.sync at every N), within 2^-6 of
              max|out|; and the fp32 forward (3xTF32, one route) at
              FP32_FWD_SHAPES with the kept library alone, within 1e-5,
              beside SDPA in fp32;
  --backward  the backward (BWD_EDITS, BWD_SHAPES): each variant's
              `hd_attention_bwd` on the kept forward's output and lse, held
              against the plain twin `attention_backward_reference` within
              the ops module's BWD_RTOL for its dtype, except for the
              diagnostic variants (DIAGNOSTIC: they leave work out to show
              its cost, so their gradients are wrong and are only timed),
              beside SDPA's backward alone (its forward once, then the
              backward with retain_graph); fp32 (3xTF32, one route) at its
              shapes with the kept library alone.
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
    # Key tiles of 64 keys (the launch opts into more than 48 KiB of shared
    # memory where a d needs it).
    "block_n64": [
        ("constexpr int TF32_BLOCK_N = 32;", "constexpr int TF32_BLOCK_N = 64;")],
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
    # Q's lo fragments in registers at d 64 too, not in shared memory (the
    # LSE instance spilled so).
    "q_lo_registers": [("constexpr bool tf32_q_lo_shared(int D) { return D == 64; }",
                        "constexpr bool tf32_q_lo_shared(int D) { return false; }")],
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

# Edits of the bf16/fp16 wgmma kernels (--forward, --backward).
# The wgmma kernels at d 32 at every N, where the mma.sync ones run below
# N = 257; the mma.sync ones at d 32 at every N (the kernels the wgmma ones
# replaced at N >= 257).
WGMMA_EVERY_N = [("constexpr int WG_MIN_N = 257;", "constexpr int WG_MIN_N = 0;")]
MMA_SYNC = [("constexpr int WG_MIN_N = 257;",
             "constexpr int WG_MIN_N = 1 << 30;")]
FWD_EDITS = {
    # K/V tiles of 64 keys, not 128.
    "block_n64": [("constexpr int WGF_BLOCK_N = 128;",
                   "constexpr int WGF_BLOCK_N = 64;")],
    # One block a work tile, not a persistent grid of one block an SM.
    "not_persistent": [("const int grid = static_cast<int>(work < sms ? work : sms);",
                        "const int grid = static_cast<int>(work);")],
    # Three consumer warpgroups a block (192 queries a work tile): 13 warps,
    # 128 registers a thread; with K/V tiles of 128 or of 64 keys.
    "three_consumers": [("constexpr int WGF_CONSUMERS = 2;",
                         "constexpr int WGF_CONSUMERS = 3;")],
    "three_consumers_n64": [("constexpr int WGF_CONSUMERS = 2;",
                             "constexpr int WGF_CONSUMERS = 3;"),
                            ("constexpr int WGF_BLOCK_N = 128;",
                             "constexpr int WGF_BLOCK_N = 64;")],
    # P·V of a K/V tile at once (one part) or in four.
    "pv_one_part": [("constexpr int WGF_PV_PARTS = 2;", "constexpr int WGF_PV_PARTS = 1;")],
    "pv_four_parts": [("constexpr int WGF_PV_PARTS = 2;", "constexpr int WGF_PV_PARTS = 4;")],
    "wgmma_every_n": WGMMA_EVERY_N,
    "mma_sync": MMA_SYNC,
}
FWD_VARIANTS = {"kept": [], **{name: [name] for name in FWD_EDITS}}
# (B, N, h, d): the fp32 serving call (bf16=False), the path and tparity
# phases' 64², the CFG sampler's N 1024 at 2B = 160 in fp32, d 64.
FP32_FWD_SHAPES = [(8, 1024, 8, 32, "float32"), (2, 64, 8, 32, "float32"),
                   (160, 1024, 8, 16, "float32"), (2, 1024, 8, 64, "float32")]
# (B, N, h, d, dtype): in bf16 the flagship serving call, the CFG sampler's
# four at 2B = 160, the head-sharded TP step; in fp16 the serving and TP
# shapes (fp16 takes the dispatch that bf16's times chose).
FWD_SHAPES = [(8, 1024, 8, 32, "bfloat16"), (160, 1024, 8, 16, "bfloat16"),
              (160, 256, 8, 32, "bfloat16"), (160, 64, 8, 32, "bfloat16"),
              (160, 16, 8, 32, "bfloat16"), (8, 1024, 4, 32, "bfloat16"),
              (8, 1024, 8, 32, "float16"), (8, 1024, 4, 32, "float16")]
# Against the fp32 plain version, within 2^-6 of max|out| (chip_smoke.py's
# CFG_RTOL, which its CFG shapes are held to).
FWD_RTOL = 2.0 ** -6
BWD_EDITS = {
    # Diagnostic: no TMA reduce-add of dQ (dQ stays zero), to show what the
    # reduction costs.
    "no_dq_reduce": [("    for (int cc = 0; cc < D / QB; ++cc)\n"
                      "      tma_reduce_add(",
                      "    for (int cc = 0; cc < D / QB * 0; ++cc)\n"
                      "      tma_reduce_add(")],
    # The wgmma backward at d 32 at every N, in fp16 too (the dispatch sends
    # fp16's to mma.sync, and the library builds no fp16 wgmma backward).
    "wgmma_every_n": WGMMA_EVERY_N + [
        ("return fp16 || D != 32 || N < WG_MIN_N;",
         "return D != 32 || N < WG_MIN_N;"),
        ("{ return !fp16 && D == 32; }", "{ return D == 32; }")],
    "mma_sync": MMA_SYNC,
}
BWD_VARIANTS = {"kept": [], **{name: [name] for name in BWD_EDITS}}
DIAGNOSTIC = {"no_dq_reduce"}
# (B, N, h, d, dtype): in bf16 the flagship train step, the head-sharded TP
# step and the CFG train step's four at batch 80; in fp16 the train and TP
# shapes.
BWD_SHAPES = [(16, 1024, 8, 32, "bfloat16"), (8, 1024, 4, 32, "bfloat16"),
              (80, 1024, 8, 16, "bfloat16"), (80, 256, 8, 32, "bfloat16"),
              (80, 64, 8, 32, "bfloat16"), (80, 16, 8, 32, "bfloat16"),
              (16, 1024, 8, 32, "float16"), (8, 1024, 4, 32, "float16"),
              # fp32 (bf16=False): the flagship and CFG train steps, tparity.
              (16, 1024, 8, 32, "float32"), (80, 1024, 8, 16, "float32"),
              (2, 64, 8, 32, "float32")]
# mode -> (variants, edits)
MODES = {"fp32": (VARIANTS, EDITS), "forward": (FWD_VARIANTS, FWD_EDITS),
         "backward": (BWD_VARIANTS, BWD_EDITS)}
OPCODES = ("HMMA", "HGMMA", "UTMALDG", "UTMASTG", "UTMAREDG")
# (B, N, h, d): the flagship (256², batch 8), the smoke's path phase (64²,
# batch 2), 64² at batch 8, 128² at batch 2, a ragged N, d 16 and d 64.
SHAPES = [(8, 1024, 8, 32), (2, 64, 8, 32), (8, 64, 8, 32), (2, 256, 8, 32),
          (8, 1000, 8, 32), (8, 1024, 8, 16), (2, 1000, 8, 64)]


def variant_source(edits: list[str], table: dict) -> str:
    """The source with the routes' header inlined (a variant is built from
    its own folder), then the edits."""
    src = (cuda_build.CSRC_DIR / att.SOURCE).read_text().replace(
        f'#include "{att.ROUTE_HEADER}"\n',
        (cuda_build.CSRC_DIR / att.ROUTE_HEADER).read_text())
    for name in edits:
        for old, new in table[name]:
            if src.count(old) != 1:
                sys.exit(f"attention_variants: edit {name!r} matches the "
                         f"source {src.count(old)} times, expected once: "
                         f"{old!r}")
            src = src.replace(old, new)
    return src


def build_all(mode: str) -> dict[str, cuda_build.BuiltLibrary]:
    """Every variant of `mode` ("fp32", "forward" or "backward"), built by
    nvcc at once; prints the registers, spills and tensor-core and TMA
    opcodes of the instances the mode times."""
    folder = cuda_build.BUILD_DIR / "variants"
    folder.mkdir(parents=True, exist_ok=True)
    variants, table = MODES[mode]
    paths = {}
    for name, edits in variants.items():
        path = folder / f"attention_{mode}_{name}.cu"
        path.write_text(variant_source(edits, table))
        paths[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(cuda_build.build, paths.values())))
    timed = {"fp32": "attention_fwd_tf32_kernel",
             "forward": "attention_fwd_", "backward": "attention_bwd_"}[mode]
    for name, lib in built.items():
        att.bind(lib.lib)
        ops = cuda_build.sass_opcode_table(lib.path, OPCODES)
        notes = cuda_build.wgmma_serialization_notes(lib.ptxas_log)
        for sym, res in sorted(cuda_build.kernel_resources(lib.ptxas_log).items()):
            inst = att.kernel_instance(sym)
            if inst is None or not inst[0].startswith(timed):
                continue
            counts = {op: n for op, n in ops.get(sym, {}).items() if n}
            print(f"  {name} {inst[0]} {inst[1]} d {inst[2]}: "
                  f"{res.registers} registers, {res.spill_bytes} bytes "
                  f"spilled, {counts}, wgmma serialized: "
                  f"{notes.get(sym, []) or 'no'}", flush=True)
    return built


def main_forward() -> None:
    built = build_all("forward")
    gen = torch.Generator("cuda").manual_seed(0)
    for B, N, h, d, dtype in FWD_SHAPES + FP32_FWD_SHAPES:
        fp32 = dtype == "float32"
        names = ["kept"] if fp32 else list(FWD_VARIANTS)
        order = names + names[::-1]
        qkv = torch.randn(B, N, 3, h, d, device="cuda",
                          generator=gen).to(getattr(torch, dtype))
        q, k, v = qkv.unbind(2)  # the model's packed, strided views
        ref = att.attention_reference(q.float(), k.float(), v.float())
        tol = ATOL if fp32 else FWD_RTOL * ref.abs().max().item()
        row = {"shape": [B, N, h, d], "dtype": dtype}
        times: dict[str, list[float]] = {name: [] for name in names}
        for name in order:
            fn = built[name].lib.hd_attention_fwd
            if not times[name]:
                err = (att.call_library(fn, q, k, v).float()
                       - ref).abs().max().item()
                if not err <= tol:
                    sys.exit(f"attention_variants: {name} errs by {err} > "
                             f"{tol} at {(B, N, h, d, dtype)}")
                row[f"{name}_err"] = err
                row[f"{name}_kernel"] = built[name].lib.hd_attention_route(
                    0, att._DTYPE_CODES[q.dtype], N, d).decode()
            times[name].append(
                device_ms(lambda: att.call_library(fn, q, k, v)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = att.bound_ms(
            4.0 * B * h * N * N * d, 4.0 * B * N * h * d * q.element_size(),
            dtype)
        if fp32:  # three TF32 products a product
            row["tf32x3_floor_ms"] = (12.0 * B * h * N * N * d
                                      / att.H100_PEAKS["flops"][dtype] * 1e3)
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
        print(json.dumps(row), flush=True)


def main_backward() -> None:
    built = build_all("backward")
    gen = torch.Generator("cuda").manual_seed(0)
    for B, N, h, d, dtype in BWD_SHAPES:
        names = list(BWD_VARIANTS) if dtype != "float32" else ["kept"]
        order = names + names[::-1]
        qkv = torch.randn(B, N, 3, h, d, device="cuda",
                          generator=gen).to(getattr(torch, dtype))
        q, k, v = qkv.unbind(2)  # the model's packed, strided views
        g = torch.randn(B, N, h, d, device="cuda",
                        generator=gen).to(q.dtype)
        out, lse = att.call_library_lse(built["kept"].lib, q, k, v)
        ref = att.attention_backward_reference(q, k, v, out, lse, g)
        # Each gradient against its own largest value, within the tolerance
        # that chip_smoke.py holds the kernel to against the fp32 autograd.
        tol = att.BWD_RTOL[dtype, "randn"]
        row = {"shape": [B, N, h, d], "dtype": dtype}
        times: dict[str, list[float]] = {name: [] for name in names}
        for name in order:
            lib = built[name].lib

            def call():
                return att.call_library_bwd(lib, q, k, v, out, lse, g)

            if not times[name] and name not in DIAGNOSTIC:
                err = att.grad_rel_err(call(), ref)
                if not err <= tol:
                    sys.exit(f"attention_variants: {name} errs by {err} > "
                             f"{tol} at {(B, N, h, d, dtype)}")
                row[f"{name}_err"] = err
                row[f"{name}_kernel"] = built[name].lib.hd_attention_route(
                    1, att._DTYPE_CODES[q.dtype], N, d).decode()
            times[name].append(device_ms(call, reps=15, inner=5))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        s_out = F.scaled_dot_product_attention(qt, kt, vt)
        row["sdpa_bwd_ms"] = device_ms(lambda: torch.autograd.grad(
            s_out, (qt, kt, vt), g.transpose(1, 2), retain_graph=True),
            reps=15, inner=5)
        # q, k, v, out, dout in and dq, dk, dv out, with lse; S again, dP,
        # dV, dK and dQ.
        row["bound_ms"], row["bound_by"] = att.bound_ms(
            10.0 * B * h * N * N * d,
            8.0 * B * N * h * d * q.element_size() + 4.0 * B * h * N, dtype)
        if dtype == "float32":  # three TF32 products a product
            row["tf32x3_floor_ms"] = (30.0 * B * h * N * N * d
                                      / att.H100_PEAKS["flops"][dtype] * 1e3)
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
        print(json.dumps(row), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("attention_variants: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cuda_build.nvidia_smi_line()
    for flag, run in (("--forward", main_forward), ("--backward", main_backward)):
        if flag in sys.argv[1:]:
            run()
            print(smi, flush=True)
            return
    built = build_all("fp32")
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
        row["bound_ms"], row["bound_by"] = att.bound_ms(
            4.0 * B * h * N * N * d, 4.0 * B * N * h * d * q.element_size(),
            str(q.dtype).split(".")[-1])
        for name, ms in times.items():
            row[f"{name}_ms"] = ms
        print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
