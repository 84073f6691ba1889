"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
into `build/whmr_tpu_torch/lib<name>-<hash>.so` at the root of the checkout
(a directory `.gitignore` lists) the first time it is needed. The hash covers
the source and the flags, so an edited source is rebuilt and never loaded
stale. Nothing here runs at import time: the CPU tests import every module
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "whmr_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): CUDA kernels are built at first use")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile the named kernel unless it is built already.

    Returns the compiler output ("" when nothing was compiled; ptxas prints
    registers, shared memory and spills per kernel). Raises RuntimeError
    when nvcc fails.
    """
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
