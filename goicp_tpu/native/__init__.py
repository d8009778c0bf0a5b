"""ctypes bindings for the native host runtime (libgoicp_host.so).

Builds lazily on first use (`make -C goicp_tpu/native`), and again whenever
the library is older than its sources; every binding has a pure-Python
fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libgoicp_host.so")
_SOURCES = ("frontier.cpp", "parsers.cpp", "Makefile")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if _stale():
        try:
            subprocess.run(["make", "-C", _DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gf_new.restype = ctypes.c_void_p
    lib.gf_new.argtypes = [ctypes.c_uint64]
    lib.gf_free.argtypes = [ctypes.c_void_p]
    lib.gf_size.restype = ctypes.c_uint64
    lib.gf_size.argtypes = [ctypes.c_void_p]
    lib.gf_min_lb.restype = ctypes.c_float
    lib.gf_min_lb.argtypes = [ctypes.c_void_p]
    lib.gf_min_dropped_lb.restype = ctypes.c_double
    lib.gf_min_dropped_lb.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.gf_push_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  f32p, f32p, f32p, f32p, f32p, i32p, f32p]
    lib.gf_pop_batch.restype = ctypes.c_int64
    lib.gf_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_float,
                                 f32p, f32p, f32p, f32p, f32p, i32p, f32p]
    lib.gf_clear.argtypes = [ctypes.c_void_p]
    lib.parse_mol2_atoms.restype = ctypes.c_int64
    lib.parse_mol2_atoms.argtypes = [ctypes.c_char_p, ctypes.c_int64, f64p,
                                     ctypes.c_char_p]
    lib.parse_float_table.restype = ctypes.c_int64
    lib.parse_float_table.argtypes = [ctypes.c_char_p, ctypes.c_int64, f64p]
    _lib = lib
    return lib


def _stale() -> bool:
    """Missing, or older than any of its sources (a library copied from
    another checkout or built by an older Makefile is rebuilt)."""
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_DIR, f)) > built
               for f in _SOURCES)


def available() -> bool:
    return _load() is not None


class NativeFrontier:
    """Batched min-heap over rotation cubes (native, with Python fallback
    handled by the caller)."""

    def __init__(self, capacity: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("libgoicp_host.so unavailable")
        self._lib = lib
        self._h = lib.gf_new(capacity)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gf_free(self._h)
            self._h = None

    def __len__(self):
        return int(self._lib.gf_size(self._h))

    @property
    def min_lb(self) -> float:
        return float(self._lib.gf_min_lb(self._h))

    @property
    def min_dropped_lb(self) -> float:
        return float(self._lib.gf_min_dropped_lb(self._h))

    def push(self, lb, a, b, c, w, level, ub):
        lb = np.ascontiguousarray(lb, np.float32)
        n = len(lb)
        self._lib.gf_push_batch(
            self._h, n, lb,
            np.ascontiguousarray(a, np.float32),
            np.ascontiguousarray(b, np.float32),
            np.ascontiguousarray(c, np.float32),
            np.ascontiguousarray(w, np.float32),
            np.ascontiguousarray(level, np.int32),
            np.ascontiguousarray(ub, np.float32))

    def pop(self, max_n: int, opt_err: float):
        out = [np.empty(max_n, np.float32) for _ in range(6)]
        level = np.empty(max_n, np.int32)
        k = self._lib.gf_pop_batch(self._h, max_n, np.float32(opt_err),
                                   out[0], out[1], out[2], out[3], out[4],
                                   level, out[5])
        k = int(k)
        return (out[0][:k], out[1][:k], out[2][:k], out[3][:k], out[4][:k],
                level[:k], out[5][:k])

    def clear(self):
        self._lib.gf_clear(self._h)


def parse_mol2_atoms(path: str, max_n: int = 1 << 20):
    """Native mol2 ATOM-block parse -> (coords (N,3) f64, names list[str]),
    or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    coords = np.empty((max_n, 3), np.float64)
    names = ctypes.create_string_buffer(max_n * 8)
    n = lib.parse_mol2_atoms(path.encode(), max_n, coords, names)
    if n < 0:
        return None
    raw = names.raw[: n * 8]
    out_names = [raw[i * 8:(i + 1) * 8].split(b"\0", 1)[0].decode()
                 for i in range(n)]
    return coords[:n].copy(), out_names


def parse_float_table(path: str, max_vals: int):
    lib = _load()
    if lib is None:
        return None
    out = np.empty(max_vals, np.float64)
    n = lib.parse_float_table(path.encode(), max_vals, out)
    if n < 0:
        return None
    return out[:n].copy()
