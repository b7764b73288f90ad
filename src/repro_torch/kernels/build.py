"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``repro_torch/csrc`` is compiled by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout, into
``build/kernels/<hash>/`` at the repository root (listed in .gitignore),
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as it is.  Nothing is compiled when a module is
imported: the CPU tests import every module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from repro_torch.core.timing import Stopwatch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built on a host with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build(force: bool = False) -> float:
    """Compile the library if it is not built yet; returns the seconds the
    compile took (0.0 when an up-to-date library was already there).  The
    compiler's report (registers, shared memory, spills) is kept beside
    the library as ``nvcc.log``."""
    out = library_path()
    if out.exists() and not force:
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources()]]
    sw = Stopwatch()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = sw.elapsed()
    (out.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)                 # atomic: no half-written library
    return took


def load() -> ctypes.CDLL:
    """The loaded library, building it first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            P, I = ctypes.c_void_p, ctypes.c_int
            for name in ("flash_decode_f32", "flash_decode_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [P, P, P, P, I, P, P, P, P,
                               I, I, I, I, I, I, I, ctypes.c_float, P]
                fn.restype = I
            _lib = lib
        return _lib
