"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. They are compiled with
``nvcc`` into one shared library at first use, and the library is loaded
with ``ctypes``; no PyTorch headers are compiled. The library's name carries
a hash of the sources and flags, so an edit rebuilds. Builds go to
``_build/`` inside the package (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import every module of the port
on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sum(_sources(), []):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsslc_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (no CUDA toolkit): the port's CUDA kernels "
            "cannot be built on this machine"
        )
    return found


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Raises with nvcc's stderr when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cu, _ = _sources()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}: "
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points. Every pointer and the stream are ``c_void_p``, so no pointer is
    cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sslc_flash_attn_fwd.argtypes = [vp] * 8 + [ci] * 7 + [vp]
    lib.sslc_flash_attn_fwd.restype = ci
    lib.sslc_cuda_error_string.argtypes = [ci]
    lib.sslc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.sslc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
