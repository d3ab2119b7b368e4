"""Native (C++) host tier: the stateless batch-index stream and row gather
(counterpart of ``mipnerf360_tpu/native``), and the PNG row unfilter of the
port's own PNG reader (``utils/png.py``).

``batcher.cpp`` and ``png.cpp`` are built with ``g++`` at first use into one
library in ``build/mipnerf360_torch/`` (the name carries a hash of the
sources, so an edited source is rebuilt) and loaded with ctypes. Every entry point has a
NumPy path that is bit-identical, taken when ``g++`` or the build is missing;
:func:`native_available` says which path runs. Both are host code.

The RNG is a stateless counter-based splitmix64 stream: draw ``j`` of stream
``(seed, start)`` is ``splitmix64(seed ^ splitmix64(start + j)) % n_rays``.
Statelessness makes data order resume-deterministic (the trainer derives
``start`` from the global step) and independent of dispatch chunking.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops._build import BUILD_DIR

SRC_PATH = Path(__file__).resolve().parent / "batcher.cpp"
SOURCES = (SRC_PATH, SRC_PATH.with_name("png.cpp"))
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _default_threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                       + b"".join(src.read_bytes() for src in SOURCES))
    return BUILD_DIR / f"libbatcher-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    # Per-process temp name: concurrent first uses (parallel pytest workers)
    # never rename a half-written file from another process into place.
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.is_file() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.mnr_sample_indices.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.mnr_sample_indices.restype = None
        lib.mnr_fill_batch_stack.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
        lib.mnr_fill_batch_stack.restype = None
        lib.mnr_png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.mnr_png_unfilter.restype = ctypes.c_int64
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the g++ build runs; False when the NumPy path does."""
    return _load() is not None


# --- splitmix64, vectorized NumPy (the bit-identical path) ------------------

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    x = (x + _SM_GAMMA).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(30))) * _SM_M1).astype(np.uint64)
    x = ((x ^ (x >> np.uint64(27))) * _SM_M2).astype(np.uint64)
    return (x ^ (x >> np.uint64(31))).astype(np.uint64)


def sample_indices(seed: int, start: int, total: int,
                   n_rays: int) -> np.ndarray:
    """Deterministic uniform ray indices [total] (int64) for stream
    (seed, start)."""
    lib = _load()
    if lib is not None:
        out = np.empty(total, np.int64)
        lib.mnr_sample_indices(
            ctypes.c_uint64(seed & (2**64 - 1)),
            ctypes.c_uint64(start & (2**64 - 1)),
            total, n_rays,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _default_threads())
        return out
    counters = np.arange(start, start + total, dtype=np.uint64)
    h = _splitmix64_np(np.uint64(seed & (2**64 - 1)) ^ _splitmix64_np(counters))
    return (h % np.uint64(n_rays)).astype(np.int64)


def fill_batch_stack(seed: int, start: int, total: int,
                     arrays: Sequence[np.ndarray]) -> list:
    """Gather ``total`` uniformly sampled rows from each [n_rays, dim] float32
    array, all using ONE shared index stream. Returns [total, dim] arrays."""
    n_rays = arrays[0].shape[0]
    lib = _load()
    if lib is None:
        idx = sample_indices(seed, start, total, n_rays)
        return [np.ascontiguousarray(a[idx]) for a in arrays]
    for a in arrays:
        if not (a.dtype == np.float32 and a.ndim == 2 and a.flags.c_contiguous
                and a.shape[0] == n_rays):
            raise ValueError(
                "fill_batch_stack needs C-contiguous float32 [n_rays, dim] "
                f"arrays with n_rays={n_rays}; got {a.dtype} {a.shape}")
    outs = [np.empty((total, a.shape[1]), np.float32) for a in arrays]
    n = len(arrays)
    src_ptrs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    dst_ptrs = (ctypes.c_void_p * n)(
        *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
    dims = (ctypes.c_int64 * n)(*[a.shape[1] for a in arrays])
    lib.mnr_fill_batch_stack(
        ctypes.c_uint64(seed & (2**64 - 1)),
        ctypes.c_uint64(start & (2**64 - 1)),
        total, n_rays, src_ptrs, dims, n,
        dst_ptrs, _default_threads())
    return outs


# --- PNG row unfilter ---------------------------------------------------------


def _png_unfilter_np(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The NumPy path of :func:`png_unfilter` (and its reference): Sub and
    Up whole rows at a time, Average and Paeth pixel by pixel."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    zero = np.zeros(bpp, np.int64)
    for y in range(h):
        kind, cur = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 1:
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1)
        elif kind == 2:
            cur = cur + prev
        elif kind in (3, 4):
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else zero
                b = prev[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else zero
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        prev = cur & 0xFF
        out[y] = prev
    return out


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct a PNG image's bytes from its decompressed scanlines.

    ``rows``: [h, 1 + stride] uint8, each row a filter-type byte and its
    filtered bytes; ``bpp``: bytes per pixel. Returns [h, stride] uint8.
    Raises ValueError on an unknown filter type."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if (rows.ndim != 2 or rows.shape[1] < 1 or not 1 <= bpp <= 8
            or (rows.shape[1] - 1) % bpp):
        raise ValueError(f"bad PNG scanlines {rows.shape} for {bpp} bytes "
                         "per pixel")
    lib = _load()
    if lib is None:
        return _png_unfilter_np(rows, bpp)
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = lib.mnr_png_unfilter(rows.ctypes.data, out.ctypes.data, h, stride,
                               bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type "
                         f"{rows[bad - 1, 0]}")
    return out
