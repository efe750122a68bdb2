"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use each
``.cu`` file is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library, which is loaded with
``ctypes``; no PyTorch headers are compiled. The library links the CUDA
driver (``-lcuda``) for ``cuTensorMapEncodeTiled``, which builds the TMA
descriptors of the tensor-core kernels. The library's name carries a
hash of the sources and flags, so an edit rebuilds. Builds go to
``_build/`` inside the package (listed in ``.gitignore``), and ptxas's
report of registers, shared memory and spills per kernel is kept beside the
library (:func:`ptxas_report`); :func:`sass_instruction_counts` reads the
built machine code.

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-lcuda",)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sum(_sources(), []):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsslc_kernels_{h.hexdigest()[:16]}.so"


def _cuda_tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = pathlib.Path(CUDA_HOME) / "bin" / name
        if path.exists():
            return str(path)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (no CUDA toolkit): the port's CUDA kernels "
            "cannot be built or read on this machine"
        )
    return found


def sass_instruction_counts(opcode: str) -> dict:
    """{kernel symbol: number of SASS instructions whose opcode starts with
    ``opcode``} in the built library, from ``cuobjdump -sass`` (e.g.
    ``HGMMA``: Hopper's warpgroup tensor-core product)."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(build())],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "*/" in line:
            op = line.split("*/", 1)[1].split()
            if op and op[0].startswith("@"):  # a predicate guard
                op = op[1:]
            if op and op[0].startswith(opcode):
                counts[name] += 1
    return counts


def ptxas_report() -> str:
    """ptxas's ``-v`` lines (registers, shared memory, spills per kernel)
    from the build of the current sources; empty before the build."""
    path = library_path().with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all in parallel, then one link. Raises with
    nvcc's stderr when a step fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cu, _ = _sources()
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _cuda_tool("nvcc")
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    compiles = []
    for src, obj in zip(cu, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report = []
    try:
        failed = None
        for cmd, proc in compiles:
            _, err = proc.communicate()
            report.append(err)
            if proc.returncode != 0 and failed is None:
                failed = (cmd, proc.returncode, err)
        if failed is not None:
            cmd, code, err = failed
            raise RuntimeError(
                f"nvcc failed with exit code {code}: {' '.join(cmd)}\n{err}")
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        # the driver library's link stub, where the toolkit keeps one
        cuda = pathlib.Path(nvcc).resolve().parent.parent
        stubs = [f"-L{d}" for d in (cuda / "lib64" / "stubs",
                                    cuda / "targets" / "x86_64-linux" / "lib"
                                    / "stubs") if d.is_dir()]
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs), *stubs,
               *LINK_FLAGS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc link failed with exit code {proc.returncode}: "
                f"{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    lib.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points. Every pointer and the stream are ``c_void_p``, so no pointer is
    cut to 32 bits."""
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # ..., use_dropout, keep_threshold, keep_scale, seed, device, stream
    dropout = [ctypes.c_uint, ctypes.c_float, ctypes.c_ulonglong, ci, vp]
    # ..., B, H, Tq, Tk, causal, is_bf16, use_dropout, ...
    for name, n_ptr, n_int in (("sslc_flash_attn_fwd", 8, 7),
                               ("sslc_flash_attn_bwd_dq", 10, 7),
                               ("sslc_flash_attn_bwd_dkv", 11, 7)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [ci] * n_int + dropout
        fn.restype = ci
    # ..., is_bf16, device, stream
    for name, n_ptr, n_int in (("sslc_conv1d_fwd", 4, 6),
                               ("sslc_conv1d_dx", 3, 6),
                               ("sslc_conv1d_dw", 4, 8)):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [ci] * (n_int + 2) + [vp]
        fn.restype = ci
    lib.sslc_cuda_error_string.argtypes = [ci]
    lib.sslc_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.sslc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
