"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime is C++ throughout; in this design the compute
path is XLA and only genuinely sequential host-side pieces stay native.
Currently: the exact DistributeOctTree (native/octree.cc).  The shared
library is built on first use with g++ and cached next to the sources.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "octree.cc")
_LIB = os.path.join(_ROOT, "native", "liboctree.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
            ):
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     _SRC, "-o", _LIB],
                    check=True, capture_output=True,
                )
            lib = ctypes.CDLL(_LIB)
            lib.distribute_octree.restype = ctypes.c_int
            lib.distribute_octree.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ]
            _lib = lib
        except Exception:
            _failed = True
    return _lib


def distribute_octree_native(
    xs, ys, responses, min_x, max_x, min_y, max_y, n_target
) -> Optional[np.ndarray]:
    """Exact native DistributeOctTree; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    rs = np.ascontiguousarray(responses, np.float32)
    n = len(xs)
    out = np.zeros(max(4 * n_target + 64, 64), np.int64)
    fp = ctypes.POINTER(ctypes.c_float)
    count = lib.distribute_octree(
        xs.ctypes.data_as(fp), ys.ctypes.data_as(fp), rs.ctypes.data_as(fp),
        n, int(min_x), int(max_x), int(min_y), int(max_y), int(n_target),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), len(out),
    )
    if count < 0:
        return None
    return out[:count]
