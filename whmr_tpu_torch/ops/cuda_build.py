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


def build_all(names) -> Dict[str, str]:
    """Compile the named kernels that are not built yet: one nvcc process
    for each source, all started together.

    Returns the compiler output of each ("" when nothing was compiled;
    ptxas prints registers, shared memory and spills per kernel). Raises
    RuntimeError when any nvcc fails, after all have ended.
    """
    outputs = {name: "" for name in names}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
            outputs[name] = text
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
