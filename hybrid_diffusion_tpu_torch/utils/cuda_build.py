"""Build a hand-written CUDA source into a shared library and load it.

Each kernel source under `csrc/` has a plain C interface. It is compiled by
`nvcc` for Hopper (`sm_90a`) into a `.so` under `_build/` (git-ignored) the
first time a CUDA tensor needs it, and loaded with `ctypes`. The library's
file name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
`nvidia_smi_line` reads the card's name and power limit, which every
measurement script prints beside its numbers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def build(source_name: str) -> BuiltLibrary:
    """Compile `csrc/<source_name>` (if its hash changed) and load it."""
    src = CSRC_DIR / source_name
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
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


def nvidia_smi_line() -> str:
    """The first card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout
    return out.strip().splitlines()[0]
