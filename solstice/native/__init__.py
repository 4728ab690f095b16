"""Native (C++) runtime components, bound via ctypes.

The reference's host-side runtime — scene-array management and the
acceleration-structure build (solr/engines/GPUKernel.cpp: compactBoxes)
— is C++.  This package holds the framework's native equivalents:

* ``lbvh.cc`` — Morton-ordered median-split LBVH builder with skip
  ("rope") pointers, the hot host-side path when scenes mutate.

The library is compiled on demand with ``g++ -O3`` into ``.cache/native``
in the checkout (:mod:`solstice.utils.cache`; ``SOLR_NATIVE_CACHE``
overrides it) and loaded with ctypes.  All
entry points degrade gracefully: callers fall back to the pure-NumPy
builders in :mod:`solstice.ops.bvh` when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "load_library", "native_available", "lbvh_build", "triangle_aabbs",
    "obj_load",
]

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SRCS = [
    os.path.join(_SRC_DIR, "lbvh.cc"),
    os.path.join(_SRC_DIR, "objparse.cc"),
]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False


_CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


def _compiler_fingerprint() -> str:
    """Compiler identity folded into the cache key: -march=native output
    must never be loaded on a different CPU/compiler (SIGILL risk when a
    cache dir is shared over NFS or survives a machine migration)."""
    import platform

    try:
        ver = subprocess.run(
            ["g++", "--version"], capture_output=True, timeout=10
        ).stdout.decode(errors="replace").splitlines()[:1]
    except Exception:
        ver = ["unknown"]
    return "|".join(
        [platform.machine(), platform.processor() or "?", *ver, *_CXX_FLAGS]
    )


def _cache_dir() -> str:
    """Private per-user cache directory, created 0700 and ownership-
    checked before any .so is loaded from it (a world-writable /tmp path
    would let another local user plant a library)."""
    root = os.environ.get("SOLR_NATIVE_CACHE")
    if root is None:
        from solstice.utils.cache import CACHE_ROOT

        root = os.path.join(CACHE_ROOT, "native")
    os.makedirs(root, mode=0o700, exist_ok=True)
    st = os.stat(root)
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        raise RuntimeError(
            f"native cache dir {root!r} is not exclusively owned/writable "
            "by the current user; refusing to load code from it"
        )
    return root


def _cache_path() -> str:
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(_compiler_fingerprint().encode())
    return os.path.join(_cache_dir(), f"solr_native_{h.hexdigest()[:16]}.so")


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native library; None on failure
    (logged once — callers fall back to the NumPy builder)."""
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _LOAD_FAILED:
            return _LIB
        tmp = None
        try:
            so = _cache_path()
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                try:
                    subprocess.run(
                        ["g++", *_CXX_FLAGS, *_SRCS, "-o", tmp],
                        check=True, capture_output=True, timeout=120,
                    )
                except subprocess.CalledProcessError as e:
                    raise RuntimeError(
                        "g++ failed: "
                        + e.stderr.decode(errors="replace")[:500]
                    ) from e
                os.replace(tmp, so)  # atomic vs concurrent builders
                tmp = None
            lib = ctypes.CDLL(so)
            lib.solr_lbvh_build.restype = ctypes.c_int64
            lib.solr_lbvh_build.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.solr_triangle_aabbs.restype = None
            lib.solr_triangle_aabbs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.obj_count.restype = ctypes.c_int
            lib.obj_count.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            lib.obj_parse.restype = ctypes.c_int
            lib.obj_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_longlong, ctypes.c_void_p,
            ]
            _LIB = lib
        except Exception as e:
            from solstice.utils.logging import log_warning

            log_warning(
                "native LBVH builder unavailable (%s); "
                "falling back to the NumPy builder", e,
            )
            _LOAD_FAILED = True
        finally:
            if tmp is not None and os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
    return _LIB


def native_available() -> bool:
    return load_library() is not None


def _c_f32(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def lbvh_build(
    aabb_min: np.ndarray, aabb_max: np.ndarray, leaf_size: int
) -> Optional[Tuple[np.ndarray, ...]]:
    """Native LBVH build.

    Returns (order, starts, ends, skips, depths, nmin, nmax) — the same
    intermediates the NumPy path in :func:`solstice.ops.bvh.build_bvh`
    computes — or None when the native library is unavailable.
    """
    lib = load_library()
    if lib is None:
        return None
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    n = amin.shape[0]
    # Median splitting halves ranges exactly, so leaves number at most
    # 2*ceil(n/leaf_size) and nodes at most twice that.
    cap = 4 * ((n + leaf_size - 1) // leaf_size) + 8
    order = np.empty(n, np.int32)
    starts = np.empty(cap, np.int32)
    ends = np.empty(cap, np.int32)
    skips = np.empty(cap, np.int32)
    depths = np.empty(cap, np.int32)
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    k = lib.solr_lbvh_build(
        _c_f32(amin), _c_f32(amax), n, leaf_size, _c_f32(order),
        _c_f32(starts), _c_f32(ends), _c_f32(skips), _c_f32(depths),
        _c_f32(nmin), _c_f32(nmax), cap,
    )
    if k <= 0:
        return None  # capacity or argument failure: let NumPy handle it
    return (
        order, starts[:k], ends[:k], skips[:k], depths[:k],
        nmin[:k], nmax[:k],
    )


def triangle_aabbs(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native per-triangle AABBs; None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    n = v0.shape[0]
    out_min = np.empty((n, 3), np.float32)
    out_max = np.empty((n, 3), np.float32)
    lib.solr_triangle_aabbs(
        _c_f32(v0), _c_f32(v1), _c_f32(v2), n, _c_f32(out_min), _c_f32(out_max)
    )
    return out_min, out_max


def obj_load(path: str):
    """Native OBJ geometry parse (reference analog: OBJReader.cpp's
    C++ ingest; the Python line loop in solstice.io.obj is ~6x slower —
    measured 1.77 s vs 0.31 s at 200k faces).

    Returns a dict with arrays ``v (nv,3) f32``, ``vt (nvt,2)``,
    ``vn (nvn,3)``, ``f_v/f_vt/f_vn (ntris,3) i32`` (0-based; -1 =
    absent), ``f_slot (ntris,) i32`` (usemtl slot by first appearance;
    -1 = before any usemtl), ``mtllibs`` (list of str), ``usemtls``
    (slot-ordered list of str) — or None when the native library is
    unavailable (callers fall back to the Python parser).
    """
    lib = load_library()
    if lib is None:
        return None
    counts = np.zeros(4, np.int64)
    if lib.obj_count(path.encode(), ctypes.c_void_p(counts.ctypes.data)):
        return None
    nv, nvt, nvn, nf = (int(x) for x in counts)
    v = np.empty((nv, 3), np.float32)
    vt = np.empty((max(nvt, 1), 2), np.float32)
    vn = np.empty((max(nvn, 1), 3), np.float32)
    f_v = np.empty((nf, 3), np.int32)
    f_vt = np.empty((nf, 3), np.int32)
    f_vn = np.empty((nf, 3), np.int32)
    f_slot = np.empty(nf, np.int32)
    names = ctypes.create_string_buffer(1 << 20)
    rc = lib.obj_parse(
        path.encode(),
        ctypes.c_void_p(v.ctypes.data), ctypes.c_void_p(vt.ctypes.data),
        ctypes.c_void_p(vn.ctypes.data), ctypes.c_void_p(f_v.ctypes.data),
        ctypes.c_void_p(f_vt.ctypes.data),
        ctypes.c_void_p(f_vn.ctypes.data),
        ctypes.c_void_p(f_slot.ctypes.data), names, len(names),
        # Pass-1 counts cap every pass-2 write: a file that changed
        # between the passes yields rc 3, not heap corruption.
        ctypes.c_void_p(counts.ctypes.data),
    )
    if rc:
        return None
    mtl_part, _, use_part = names.value.decode(errors="replace").partition(
        "\x01"
    )
    return {
        "v": v, "vt": vt[:nvt], "vn": vn[:nvn],
        "f_v": f_v, "f_vt": f_vt, "f_vn": f_vn, "f_slot": f_slot,
        "mtllibs": [m for m in mtl_part.split("\n") if m],
        "usemtls": [m for m in use_part.split("\n") if m],
    }
