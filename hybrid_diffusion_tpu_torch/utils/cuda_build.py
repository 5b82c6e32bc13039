"""Build a hand-written CUDA source into a shared library and load it.

Each kernel source under `csrc/` has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into a `.so` under `_build/` (git-ignored) the
first time a CUDA tensor needs it, and loaded with `ctypes`. The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
`kernel_resources` reads each kernel's registers and spills from ptxas's
report, `sass_opcode_table` counts instructions by opcode in each kernel's
machine code (`cuobjdump -sass`), and `nvidia_smi_line` reads the card's name and
power limit, which every measurement script prints beside its numbers.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# ptxas's --split-compile=0 assembles the kernels on every core: it cut
# chip_smoke.py's nvcc time on the H100 machine by about a third (PERF.md).
# nvcc's own --split-compile (NVVM's passes) is left out: it changed one
# kernel's code (the 16-bit mma.sync backward at d 16: 107 registers, not
# 125, and 7% slower).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-Xptxas",
              "--split-compile=0")
NVCC_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    cached: bool          # True when the .so was already built
    build_seconds: float  # nvcc wall time; 0.0 when cached
    ptxas_log: str        # nvcc's -Xptxas -v report (registers, spills)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def build(source_name: str | Path) -> BuiltLibrary:
    """Compile `csrc/<source_name>` (if its hash, or that of a header beside
    it, changed) and load it; an absolute path names a source elsewhere."""
    src = CSRC_DIR / source_name
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    stem = f"{src.stem}_{digest.hexdigest()[:16]}"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = BUILD_DIR / f"lib{stem}.so"
    log_path = BUILD_DIR / f"{stem}.ptxas.log"
    if so_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuiltLibrary(ctypes.CDLL(str(so_path)), so_path, True, 0.0, log)

    # Build into a private temporary name, then rename: a concurrent build
    # of the same source never sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        try:
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                check=True)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed on {src.name} (exit "
                               f"{e.returncode}):\n{e.stdout}\n{e.stderr}") from e
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    return BuiltLibrary(ctypes.CDLL(str(so_path)), so_path, False, seconds, log)


def wgmma_serialization_notes(ptxas_log: str) -> dict[str, list[str]]:
    """Per kernel symbol, the codes of ptxas's notes that it serialized the
    kernel's wgmma (C7510-C7520: "wgmma.mma_async instructions are
    serialized ...", "warpgroup.wait is injected ..."): each one costs the
    overlap of a warpgroup's products with its other work."""
    notes: dict[str, list[str]] = collections.defaultdict(list)
    for line in ptxas_log.splitlines():
        if m := re.search(r"\((C75\d\d)\).*'([^']+)'", line):
            notes[m.group(2)].append(m.group(1))
    return dict(notes)


@dataclasses.dataclass(frozen=True)
class KernelResources:
    registers: int
    spill_bytes: int  # spill stores + spill loads


def kernel_resources(ptxas_log: str) -> dict[str, KernelResources]:
    """Per kernel symbol, what `-Xptxas -v` reported for it."""
    found: dict[str, dict[str, int]] = {}
    current = None
    for line in ptxas_log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            current = found.setdefault(m.group(1), {"regs": 0, "spill": 0})
        elif current is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                            line):
            current["spill"] = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            current["regs"] = int(m.group(1))
    return {k: KernelResources(v["regs"], v["spill"])
            for k, v in found.items()}


def find_cuobjdump() -> str:
    """`cuobjdump` beside nvcc, else the copy in Triton's package."""
    candidate = Path(find_nvcc()).parent / "cuobjdump"
    if candidate.exists():
        return str(candidate)
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin is not None:
        candidate = (Path(spec.origin).parent / "backends" / "nvidia" / "bin"
                     / "cuobjdump")
        if candidate.exists():
            return str(candidate)
    raise RuntimeError("cuobjdump not found beside nvcc or in Triton's "
                       "triton/backends/nvidia/bin/")


def sass_opcode_table(so_path: Path, opcodes) -> dict[str, dict[str, int]]:
    """Per kernel symbol in the library, the count of SASS instructions of
    each opcode in `opcodes` (e.g. "HGMMA", "UTMALDG"): an instruction counts
    for an opcode whose name is its own up to a "." suffix. One pass of
    `cuobjdump -sass`."""
    out = subprocess.run([find_cuobjdump(), "-sass", str(so_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    wanted = set(opcodes)
    table: dict[str, dict[str, int]] = {}
    current = None
    pattern = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)\b")
    for line in out.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = table.setdefault(m.group(1), dict.fromkeys(wanted, 0))
        elif current is not None and (m := pattern.search(line)) \
                and m.group(1) in wanted:
            current[m.group(1)] += 1
    return table


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout
    return out.strip().splitlines()[0]
