"""Native (C++) host components, bound with ctypes.

Counterpart of `raytracing_gpu_tpu/native/__init__.py`: the binned-SAH BVH
builder `bvh_builder.cpp` (this package's own copy of the source), compiled
with g++ at first use into `build/torch_native/` at the root of the
checkout, with the JAX package's flags, and rebuilt when the source is
newer than the library.  There is no numpy fallback: a failed build raises
with the compiler's message.

`-march=native` makes the floating-point code, and so the BVH topology, a
function of the host CPU; hits and radiance do not depend on the topology,
apart from exact ties.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
_ROOT = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")
LIBRARY = os.path.join(BUILD_DIR, "libbvh_builder.so")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compile() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"BVH builder build failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"BVH builder build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)


def get_lib() -> ctypes.CDLL:
    """The builder library, compiled if missing or older than its source."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIBRARY)
                    or os.path.getmtime(_SRC) > os.path.getmtime(LIBRARY)):
                _compile()
            lib = ctypes.CDLL(LIBRARY)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            lib.rt_build_bvh.restype = ctypes.c_int
            lib.rt_build_bvh.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int,
                                         fp, fp, ip, ip, ip, ctypes.c_int]
            _lib = lib
        return _lib


def build_bvh_native(bounds_min: np.ndarray, bounds_max: np.ndarray,
                     leaf_size: int = 4) -> tuple:
    """Binned-SAH BVH over (P, 3) primitive bounds: (node_min (M, 3),
    node_max (M, 3), hit_link (M,), miss_link (M,), leaf_prims (M, K))
    numpy arrays, as the JAX package's `build_bvh_native` returns them."""
    lib = get_lib()
    n = len(bounds_min)
    cap = max(2 * n, 4)
    bmin = np.ascontiguousarray(bounds_min, np.float32)
    bmax = np.ascontiguousarray(bounds_max, np.float32)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    hit_link = np.empty(cap, np.int32)
    miss_link = np.empty(cap, np.int32)
    leaf_prims = np.empty((cap, leaf_size), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    count = lib.rt_build_bvh(
        bmin.ctypes.data_as(fp), bmax.ctypes.data_as(fp), n, leaf_size,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        hit_link.ctypes.data_as(ip), miss_link.ctypes.data_as(ip),
        leaf_prims.ctypes.data_as(ip), cap)
    if count < 0:
        raise RuntimeError(f"BVH build of {n} primitives failed (node "
                           f"capacity {cap})")
    return (node_min[:count], node_max[:count], hit_link[:count],
            miss_link[:count], leaf_prims[:count])
