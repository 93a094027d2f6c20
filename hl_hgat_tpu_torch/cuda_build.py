"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first use and
loaded with ``ctypes``.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt.  Several
sources build in parallel, one ``nvcc`` each.  Nothing happens at import.
"""

from __future__ import annotations

import ctypes
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
SOURCES = ("laguerre_dense", "laguerre_dense_bwd", "ell_spmm")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def tensor_core_opcodes(name: str) -> dict[str, int]:
    """``{mangled kernel name: count of HMMA / HGMMA opcodes}`` in the
    built library of ``csrc/<name>.cu``, read from ``cuobjdump -sass`` (the
    toolkit binary next to ``nvcc``).  Both ``mma.sync`` on bfloat16 and on
    TF32 operands compile to HMMA; ``wgmma`` to HGMMA."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(library_path(name))],
        capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    kernel = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            kernel = line.split(":", 1)[1].strip()
            counts[kernel] = 0
        elif kernel is not None and ("HMMA" in line or "HGMMA" in line):
            counts[kernel] += 1
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
    ``-Xptxas=-v`` register and shared-memory report); raises with the log
    if any build fails.
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
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        else:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``; every missing library of the
    package is built first, all at once."""
    if name not in SOURCES:
        raise KeyError(f"unknown CUDA source {name!r}")
    build()
    return ctypes.CDLL(str(library_path(name)))
