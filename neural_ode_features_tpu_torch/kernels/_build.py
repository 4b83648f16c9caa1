"""Build the port's CUDA kernels from ``csrc/`` at first use and load them.

Route: ``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Each source
``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so``; the hash covers
every file in ``csrc/`` and the flags, so an edited source is rebuilt and a
stale library is never loaded.  Only the sources in the repository are
built.  ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["KERNELS", "build_all", "load", "check"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
KERNELS = ("odefunc", "rk_step", "odefunc_bwd", "conv_probe")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process, tmp_path, lib_path)`` or None."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> str:
    proc, tmp, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library
    return log


def build_all() -> dict[str, str]:
    """Build every kernel not yet built, one ``nvcc`` per source in
    parallel.  Returns the compiler output (``-Xptxas -v``: registers,
    shared memory, spills) per kernel built now."""
    jobs = {name: _start(name) for name in KERNELS}
    return {name: _finish(name, job) for name, job in jobs.items()
            if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.nodef_error_string.argtypes = [ctypes.c_int]
        lib.nodef_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = lib.nodef_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
