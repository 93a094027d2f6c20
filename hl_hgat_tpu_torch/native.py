"""ctypes binding of the host C++ preprocessing kernels (``csrc/hlhgat_native.cpp``,
``csrc/hlhgat_pack.cpp``).

The port's counterpart of ``hl_hgat_tpu/native.py``.  Both sources are
compiled with ``g++`` at first use into one ``_build/libhlhgat_native-<hash>.so``
and loaded with ctypes; nothing happens at import.  The hash covers the
sources, the flags and what ``-march=native`` means on this host (``g++
-Q --help=target``), so a library built for another CPU is never loaded.
A failed build raises with the compiler's log: there is no quiet NumPy
fallback.  The NumPy versions of the same functions stay in the modules
that call them (``complex/build.py``), under names of their own, for the
tests.

Ten entry points, all with declared ``argtypes``/``restype``:
``graclus_match`` and ``coarse_edges`` (the MLGC matcher of
``complex/coarsen.py``), ``coo_to_ell``, ``max_row_nnz``, ``hodge_l1``,
``l1_pair_count``, the three fills of the packed collate
(``packed_fill_level``, ``packed_fill_rows``, ``packed_fill_pool``) and its
bin planner ``ffd_pack`` (``hlhgat_pack.cpp``, the port's own), driven by
``data/fast_collate.py``.  ctypes releases the interpreter lock during a
call, so a collate on a prefetch thread overlaps the training step.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
# the JAX package's native/hlhgat_native.cpp, copied unchanged
SOURCE = _PKG / "csrc" / "hlhgat_native.cpp"
PACK_SOURCE = _PKG / "csrc" / "hlhgat_pack.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host library needs it on PATH")
    return cxx


@functools.cache
def library_path() -> Path:
    """Where the library for these sources, these flags and this CPU lives."""
    target = subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, check=True).stdout
    digest = hashlib.sha256(SOURCE.read_bytes() + PACK_SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode() + target.encode()).hexdigest()
    return BUILD_DIR / f"libhlhgat_native-{digest[:16]}.so"


def build() -> float:
    """Compile the library unless it exists; the seconds the build took
    (0.0 when it was there).  Raises with the compiler's log on failure.
    Concurrent builds (several test workers) each write a file of their
    own and move it into place atomically."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), str(PACK_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} + {PACK_SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    sig = {
        "graclus_match": ([i64, i64, i32p, i32p, ctypes.c_void_p, i64p], None),
        "coarse_edges": ([i64, i32p, i32p, i64p, i32p, i32p, i64p], i64),
        "coo_to_ell": ([i64, i32p, i32p, f32p, i64, i64, i32p, f32p], ctypes.c_int32),
        "max_row_nnz": ([i64, i32p, f32p, i64], i64),
        "hodge_l1": ([i64, i64, i32p, i32p, ctypes.c_float, i32p, i32p, f32p], i64),
        "l1_pair_count": ([i64, i64, i32p, i32p], i64),
        "packed_fill_level": ([
            i64, i64p, i32p, i32p, i32p,  # slots: sample, bin, node and edge offsets
            i32p, i32p,  # num_nodes, num_edges
            i64p, i32p, i32p, f32p,  # L0 arena
            i64p, i32p, i32p, f32p,  # L1 arena
            i64p, i32p, i32p,  # edge arena
            i32p,  # gid
            i64, i64,  # s_pad, e_pad
            f32p, f32p, f32p, f32p, f32p, f32p, i32p, i32p,  # outputs
        ], None),
        "packed_fill_rows": ([i64, i64p, i32p, i32p, i64p, f32p, i64, i64, f32p], None),
        "packed_fill_pool": ([
            i64, i64p, i32p, i32p, i32p, i32p, i32p,
            i64p, i64p, i64p, i64p,
            i64, i64, i64, i64, i64,
            f32p, f32p,
        ], None),
        "ffd_pack": ([i64, i64p, i64p, i64, i64p, i64, i64, i64p, i64p], i64),
    }
    for name, (args, res) in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def load() -> ctypes.CDLL:
    """The library, built first if it is missing (one build a process)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _declare(ctypes.CDLL(str(library_path())))
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (False where g++ or the
    build fails; ``load`` raises with the reason)."""
    try:
        load()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return False
    return True


def graclus_match(src: np.ndarray, dst: np.ndarray, weight: np.ndarray | None,
                  num_nodes: int) -> np.ndarray:
    """Greedy heavy-edge matching on the symmetrized edge list: nodes in
    index order, each node's neighbours by descending float32 weight (input
    order among ties; every weight 1 when ``weight`` is None).  The
    representative (smaller) node id per node, int64."""
    lib = load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    out = np.empty(num_nodes, np.int64)
    w = None if weight is None else np.ascontiguousarray(weight, np.float32)
    lib.graclus_match(num_nodes, src.shape[0], src, dst,
                      None if w is None else w.ctypes.data_as(ctypes.c_void_p), out)
    return out


def coarse_edges(c_node: np.ndarray, src: np.ndarray, dst: np.ndarray):
    """First-seen dedup of the (min, max) cluster pairs of the fine edges:
    (coarse src, coarse dst, fine→coarse edge id with −1 where both ends
    fall into one cluster)."""
    lib = load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    c_node = np.ascontiguousarray(c_node, np.int64)
    e = src.shape[0]
    out_src, out_dst = np.empty(e, np.int32), np.empty(e, np.int32)
    c_edge = np.empty(e, np.int64)
    n = int(lib.coarse_edges(e, src, dst, c_node, out_src, out_dst, c_edge))
    return out_src[:n].copy(), out_dst[:n].copy(), c_edge


def hodge_l1(src: np.ndarray, dst: np.ndarray, num_nodes: int, scale: float):
    """L1 = B1ᵀB1 as coalesced COO sorted by (row, col), values × ``scale``
    in float32: (rows, cols, vals)."""
    lib = load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    e = src.shape[0]
    cap = max(int(lib.l1_pair_count(num_nodes, e, src, dst)), 1)
    rows, cols = np.empty(cap, np.int32), np.empty(cap, np.int32)
    vals = np.empty(cap, np.float32)
    nnz = int(lib.hodge_l1(num_nodes, e, src, dst, float(scale), rows, cols, vals))
    return rows[:nnz].copy(), cols[:nnz].copy(), vals[:nnz].copy()


def coo_to_ell(rows, cols, vals, num_rows: int, width: int | None = None):
    """ELL [num_rows, width] (cols, vals) of a COO matrix, zero values
    dropped, slots in COO order; ``width`` defaults to the longest row.
    Raises ValueError when a row does not fit."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float32)
    if width is None:
        width = int(lib.max_row_nnz(rows.shape[0], rows, vals, num_rows))
    width = max(int(width), 1)
    ell_cols = np.empty((num_rows, width), np.int32)
    ell_vals = np.empty((num_rows, width), np.float32)
    if lib.coo_to_ell(rows.shape[0], rows, cols, vals, num_rows, width, ell_cols, ell_vals):
        raise ValueError(f"a row exceeds ELL width {width}")
    return ell_cols, ell_vals
