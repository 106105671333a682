"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain ``extern "C"`` interface.  Libraries go to ``kernels/_build/`` (listed
in ``.gitignore``), named by a hash of the source, the headers in ``csrc/``
and the flags, so a changed source builds anew and an unchanged one loads at
once; each build's compiler log (``-Xptxas -v``) is kept beside it.
Nothing is built when the package is imported: the first launch builds, or
a caller (``chip_smoke.py``) calls :func:`build` up front to time it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd", "rmsnorm", "adamw")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path("/usr/local/cuda/bin/nvcc")
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler log of the built library ``name`` (ptxas registers,
    shared memory and spills of each kernel)."""
    return library_path(name).with_suffix(".log").read_text()


def build(names: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns each new build's
    compiler log (ptxas register and shared-memory report, also kept for
    :func:`build_log`); raises ``RuntimeError`` with the log if a compile
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LIBS:
        build((name,))
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
