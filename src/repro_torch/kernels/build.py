"""Build and load the port's CUDA kernels.

Every ``*.cu`` file under ``repro_torch/csrc`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout, into
``build/kernels/<hash>/`` at the repository root (listed in .gitignore),
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is loaded as it is.  Nothing is compiled when a module is
imported: the CPU tests import every module on a host without ``nvcc``.
The library links the CUDA runtime only: the TMA tensor-map encoder
(``cuTensorMapEncodeTiled``, a driver function) is found at run time
through ``cudaGetDriverEntryPoint`` (``csrc/flash_attention.cu``), so no
``-lcuda`` is needed.
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

from repro_torch.core import timing
from repro_torch.core.timing import Stopwatch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    build took (0.0 when an up-to-date library was already there).  The
    sources compile in parallel, one ``nvcc`` each; the compiler's report
    (registers, shared memory, spills) is kept beside the library as
    ``nvcc.log``."""
    out = library_path()
    if out.exists() and not force:
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    sw = Stopwatch()
    jobs = []
    for src in sources():
        obj = out.parent / f"{src.stem}.{tag}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{stderr[-4000:]}")
    tmp = out.with_suffix(f".{tag}")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *[str(obj) for _, obj, _ in jobs]],
                              capture_output=True, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}"
                   f"{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n"
                          f"{link.stderr[-4000:]}")
    took = sw.elapsed()
    (out.parent / "nvcc.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, out)                 # atomic: no half-written library
    return took


def load() -> ctypes.CDLL:
    """The loaded library, building it first if needed (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            with timing.span("kernels.load") as sp:
                sp.set(compiled=build() > 0)
                _lib = _bind(ctypes.CDLL(str(library_path())))
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point's argument and result types."""
    P, I = ctypes.c_void_p, ctypes.c_int
    F = ctypes.c_float
    for name in ("flash_decode_f32", "flash_decode_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, I, P, I, I, I, I, I, I, I,
                       F, P]
        fn.restype = I
    for name in ("flash_attention_f32", "flash_attention_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I,
                       ctypes.POINTER(ctypes.c_int64), I, I, I, I,
                       F, P]
        fn.restype = I
    I64P = ctypes.POINTER(ctypes.c_int64)
    for name in ("mamba1_scan_f32", "mamba1_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                       I64P, P]
        fn.restype = I
    for name in ("ssd_scan_f32", "ssd_scan_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                       I, I64P, P]
        fn.restype = I
    return lib
