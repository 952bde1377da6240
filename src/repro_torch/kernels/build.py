"""Build the Hopper kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>/`` at the
root of the checkout, keyed by a hash of the source and the flags, so a
fresh checkout builds everything it needs from the sources alone and a
changed source never loads a stale library. Builds happen at first CUDA
use (or in ``build_all``), never at import: a CPU-only host imports
every module without a compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

#: every kernel source of the package, by name (csrc/<name>.cu)
SOURCES = ("flash_decode", "lora_matmul", "flash_attention", "moe_ffn",
           "ssd_scan")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the Hopper kernels are built with "
                       "the CUDA toolkit on the machine that has the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}" / f"lib{name}.so"


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (``-Xptxas -v``: registers,
    shared memory and spills per kernel), or "" if it was never built."""
    log = library_path(name).with_name("build.log")
    return log.read_text() if log.exists() else ""


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for a library that was already built). Raises with
    the compiler's output if any build fails."""
    started = {}
    seconds = {name: 0.0 for name in names}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in started.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib = library_path(name)
        lib.with_name("build.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, lib)     # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, building it first if
    this checkout has not built it yet."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
