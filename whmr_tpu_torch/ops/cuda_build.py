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
import re
import shutil
import subprocess
import threading
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
# Serialises `build_all` and `load`: the threads of one process (a server's
# request threads, its batching worker and a warm-up) may reach a kernel's
# first use together, and each kernel is then built, and loaded, once.
_build_lock = threading.RLock()


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


def build_all(names, force: bool = False) -> Dict[str, str]:
    """Compile the named kernels that are not built yet (all of them with
    `force`): one nvcc process for each source, all started together.

    Returns the compiler output of each ("" when nothing was compiled;
    ptxas prints registers, shared memory and spills per kernel). Raises
    RuntimeError when any nvcc fails, after all have ended.
    """
    with _build_lock:
        return _build_all(names, force)


def _build_all(names, force: bool) -> Dict[str, str]:
    outputs = {name: "" for name in names}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Unique to the process and the thread: two builders never write
        # into one temporary file.
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
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
    """The kernel's shared library, built first if needed (cached per
    process; the first use from several threads builds it once)."""
    with _build_lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


_PTXAS_FUNCTION = re.compile(r"(?:Compiling entry function '|Function properties for )([^'\s]+)")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGISTERS = re.compile(r"Used (\d+) registers")


def ptxas_report(text: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each function in `build_all`'s output
    (nvcc -Xptxas -v), by mangled name: {"registers", "spill_stores",
    "spill_loads"}."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = _PTXAS_FUNCTION.search(line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _PTXAS_SPILLS.search(line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = _PTXAS_REGISTERS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return report
