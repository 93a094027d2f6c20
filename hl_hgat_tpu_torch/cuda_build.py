"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface, declared for ``ctypes``
in ``SIGNATURES``; it is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so`` at first use and opened once by ``load``.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt.  Several sources build in parallel,
one ``nvcc`` each.  ``check`` turns a returned ``cudaError_t`` into an
error.  Nothing happens at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I, _Q, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t
_ERROR_STRING = {"hlhgat_cuda_error_string": ([_I], ctypes.c_char_p)}
# The C interface each source exports (``extern "C"``): {function: (argument
# types, result type)}, applied once when its library is opened.  A pointer
# is ``c_void_p``; every library has ``hlhgat_cuda_error_string`` for ``check``.
SIGNATURES = {
    "laguerre_dense": {
        "hlhgat_laguerre_fused_smem": ([_I] * 3, _Z),
        "hlhgat_laguerre_fused_fwd": ([_P] * 6 + [_I] * 6 + [_P], _I),
        "hlhgat_laguerre_terms_fwd": ([_P] * 3 + [_I] * 5 + [_P], _I),
        **_ERROR_STRING,
    },
    "laguerre_dense_bwd": {
        "hlhgat_laguerre_fused_bwd_smem": ([_I] * 3, _Z),
        "hlhgat_laguerre_fused_bwd_splits": ([_I] * 3, _I),
        "hlhgat_laguerre_fused_bwd": ([_P] * 8 + [_I] * 7 + [_P], _I),
        "hlhgat_laguerre_terms_bwd": ([_P] * 3 + [_I] * 5 + [_P], _I),
        **_ERROR_STRING,
    },
    "laguerre_band": {
        "hlhgat_band_fused_fwd": ([_P] * 6 + [_I] * 8 + [_P], _I),
        "hlhgat_band_terms_fwd": ([_P] * 3 + [_I] * 6 + [_P], _I),
        "hlhgat_band_fused_bwd_splits": ([_I] * 6, _I),
        "hlhgat_band_fused_bwd": ([_P] * 9 + [_I] * 9 + [_P], _I),
        "hlhgat_band_terms_bwd": ([_P] * 4 + [_I] * 6 + [_P], _I),
        "hlhgat_band_step_plan": ([_I] * 4 + [_P], _I),
        "hlhgat_band_product_plan": ([_I] * 7 + [_P], _I),
        **_ERROR_STRING,
    },
    "ell_spmm": {
        "hlhgat_ell_spmm": ([_P] * 4 + [_Q, _I, _Q, _I, _I, _P], _I),
        **_ERROR_STRING,
    },
}
SOURCES = tuple(SIGNATURES)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def tensor_core_opcodes(name: str) -> dict[str, dict[str, int]]:
    """``{mangled kernel name: {"HMMA": n, "HGMMA": m}}`` in the built
    library of ``csrc/<name>.cu``, read from ``cuobjdump -sass`` (the
    toolkit binary next to ``nvcc``).  ``mma.sync`` on bfloat16 and on TF32
    operands compiles to HMMA, ``wgmma`` to HGMMA."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(library_path(name))],
        capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    kernel = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            kernel = line.split(":", 1)[1].strip()
            counts[kernel] = {"HMMA": 0, "HGMMA": 0}
        elif kernel is not None:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[kernel][op] += 1
    return counts


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(SRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: compiler log}`` for the libraries built now (the
    ``-Xptxas=-v`` register and shared-memory report, also kept beside the
    library as ``.log``); raises with the log if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        else:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its ``SIGNATURES`` set, opened
    once; every missing library of the package is built first, all at
    once."""
    if name not in SOURCES:
        raise KeyError(f"unknown CUDA source {name!r}")
    build()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise ``RuntimeError`` with CUDA's message if ``code``, a
    ``cudaError_t`` a function of ``lib`` returned, is not success."""
    if code != 0:
        msg = lib.hlhgat_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {code})")
