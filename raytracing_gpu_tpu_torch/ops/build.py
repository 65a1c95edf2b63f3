"""Build and load the port's CUDA kernels.

At first use, `nvcc` compiles every `.cu` source in `csrc/` for Hopper
(`sm_90a`), one process per source, all started together, and links the
objects into one shared library with a plain C interface, under
`build/torch_kernels/` at the root of the checkout; `ctypes` loads it.  The
library is rebuilt when a source (`.cu` or `.cuh`) is newer than it.  A
failed build or load raises: nothing falls back to the plain PyTorch
versions.

The flags keep every multiply and add rounding on its own (`-fmad=false`,
no `--use_fast_math`), so the kernels round like their plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_kernels")
LIBRARY = os.path.join(BUILD_DIR, "librt_torch_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class RtParams(ctypes.Structure):
    """Launch constants of the megakernel entries (`rt_trace_chunk`,
    `rt_trace_pixels`, `rt_trace_rays`, `rt_trace_occupancy`,
    `rt_walk_chunk`, `rt_walk_packed_pixels`, `rt_walk_packed`,
    `rt_walk_occupancy`), passed by value; the field order and types follow
    `struct RtParams` in csrc/megakernel.cuh.  `rays` stays NULL here: the
    ray-plane entries set it from their argument; `wave`, `spp`, `grid`,
    `wave0` and `waves` shape the chunk launches, and the per-wave entries
    set them themselves."""

    _fields_ = [
        ("origin", ctypes.c_float * 3), ("llc", ctypes.c_float * 3),
        ("hor", ctypes.c_float * 3), ("ver", ctypes.c_float * 3),
        ("cu", ctypes.c_float * 3), ("cv", ctypes.c_float * 3),
        ("lens_radius", ctypes.c_float),
        ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
        ("t_min", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("time0", ctypes.c_float), ("time_span", ctypes.c_float),
        ("img_h", ctypes.c_int), ("img_w", ctypes.c_int),
        ("pix_base", ctypes.c_int), ("n", ctypes.c_int),
        ("seed", ctypes.c_int), ("max_depth", ctypes.c_int),
        ("n_rects", ctypes.c_int), ("n_boxes", ctypes.c_int),
        ("n_spheres", ctypes.c_int), ("n_sph_nodes", ctypes.c_int),
        ("n_tri_rows", ctypes.c_int), ("n_tri_nodes", ctypes.c_int),
        ("n_sphere_media", ctypes.c_int),
        ("n_box_media", ctypes.c_int), ("has_time", ctypes.c_int),
        ("rr_start", ctypes.c_int), ("features", ctypes.c_int),
        ("wave", ctypes.c_int), ("spp", ctypes.c_int),
        ("grid", ctypes.c_int), ("wave0", ctypes.c_int),
        ("waves", ctypes.c_int), ("rays", ctypes.c_void_p),
    ]


class RtTables(ctypes.Structure):
    """The megakernels' nine device tables, passed by value: rects, boxes,
    spheres, media, the sphere BVH's node records and links, the triangle
    rows and their BVH's node records and links (`struct RtTables` in
    csrc/megakernel.cuh)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "rects", "boxes", "spheres", "media", "sph_nodes", "sph_links",
        "tri_rows", "tri_nodes", "tri_links")]


class BuildResult(NamedTuple):
    library: str
    seconds: float  # 0.0 when the library was up to date
    log: str  # nvcc's output, including ptxas' register and spill report


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    `nvcc` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the "
                           "PATH to build the CUDA kernels")
    return found


def _stale() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    built = os.path.getmtime(LIBRARY)
    return any(os.path.getmtime(s) > built for s in sources())


def _run(cmd: list, what: str) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {_BUILD_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what} ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    return log


def build(force: bool = False) -> BuildResult:
    """Compile csrc/ into LIBRARY when it is missing or older than a source:
    one nvcc per `.cu` file, run in parallel, then one link.  Raises
    RuntimeError with nvcc's output when a step fails."""
    if not force and not _stale():
        return BuildResult(LIBRARY, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(c)}.{tag}.o")
            for c in cu]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(cu)) as pool:
        logs = list(pool.map(
            lambda c_o: _run([nvcc(), *NVCC_FLAGS, "-c", "-o", c_o[1],
                              c_o[0]], os.path.basename(c_o[0])),
            zip(cu, objs)))
    tmp = f"{LIBRARY}.{tag}"
    logs.append(_run([nvcc(), "-shared", "-o", tmp, *objs], "the link"))
    for o in objs:
        os.remove(o)
    os.replace(tmp, LIBRARY)
    return BuildResult(LIBRARY, time.perf_counter() - t0, "".join(logs))


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry's argtypes and
    restype declared.  Raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            ptr = ctypes.c_void_p
            # (tables, params[, rays], outputs..., stream)
            for name, n_in, n_out in (("rt_trace_chunk", 0, 2),
                                      ("rt_trace_pixels", 0, 1),
                                      ("rt_trace_rays", 1, 1),
                                      ("rt_walk_chunk", 0, 7),
                                      ("rt_walk_packed_pixels", 0, 6),
                                      ("rt_walk_packed", 1, 6)):
                fn = getattr(lib, name)
                fn.argtypes = [RtTables, RtParams, *[ptr] * (n_in + n_out + 1)]
                fn.restype = ctypes.c_int
            for name in ("rt_trace_occupancy", "rt_walk_occupancy"):
                getattr(lib, name).argtypes = [RtTables, RtParams, ptr]
                getattr(lib, name).restype = ctypes.c_int
            i32 = ctypes.c_int
            lib.rt_hit.argtypes = [*[ptr] * 8, *[i32] * 7, ctypes.c_float,
                                   *[ptr] * 11]
            lib.rt_hit.restype = ctypes.c_int
            lib.rt_pcg_uniform.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ptr, ptr]
            lib.rt_pcg_uniform.restype = ctypes.c_int
            lib.rt_fma_chain.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int,
                                         ptr]
            lib.rt_fma_chain.restype = ctypes.c_int
            lib.rt_device_peaks.argtypes = [ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_double)]
            lib.rt_device_peaks.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
