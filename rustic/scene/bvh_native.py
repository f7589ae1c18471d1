"""ctypes bindings for the C++ binned-SAH BVH builder (native/bvh.cpp).

The native builder implements the same algorithm as bvh.py and is used
automatically when `native/libbvh.so` has been built (see native/build.sh).
Falls back silently to the NumPy builder otherwise.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libbvh.so",
    )


def _try_build(path: str) -> bool:
    """Build libbvh.so on first use (kept out of git; g++ is cheap)."""
    import subprocess

    src = os.path.join(os.path.dirname(path), "bvh.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", path, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(path)
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and not _try_build(path):
        return None
    lib = ctypes.CDLL(path)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # vertices [V*3]
        ctypes.c_int,  # V
        ctypes.POINTER(ctypes.c_int),  # tri vertex indices [T*3]
        ctypes.c_int,  # T
        ctypes.c_int,  # sah_samples
        ctypes.POINTER(ctypes.c_float),  # out aabb_min [ (2T-1)*3 ]
        ctypes.POINTER(ctypes.c_float),  # out aabb_max
        ctypes.POINTER(ctypes.c_int),  # out left_first
        ctypes.POINTER(ctypes.c_int),  # out count
        ctypes.POINTER(ctypes.c_int),  # out permutation [T]
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_bvh(
    vertices: np.ndarray, triangles: np.ndarray, sah_samples: int = 128
) -> Tuple["object", np.ndarray]:
    from rustic.scene.bvh import BVH

    lib = _load()
    assert lib is not None
    verts = np.ascontiguousarray(np.asarray(vertices, np.float32)[:, :3])
    tri = np.ascontiguousarray(np.asarray(triangles, np.int32)[:, :3])
    n_tris = len(tri)
    max_nodes = max(2 * n_tris - 1, 1)
    aabb_min = np.empty((max_nodes, 3), np.float32)
    aabb_max = np.empty((max_nodes, 3), np.float32)
    left_first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    perm = np.empty(n_tris, np.int32)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    n_nodes = lib.bvh_build(
        fptr(verts),
        len(verts),
        iptr(tri),
        n_tris,
        sah_samples,
        fptr(aabb_min),
        fptr(aabb_max),
        iptr(left_first),
        iptr(count),
        iptr(perm),
    )
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    bvh = BVH(
        aabb_min=aabb_min[:n_nodes].copy(),
        aabb_max=aabb_max[:n_nodes].copy(),
        left_first=left_first[:n_nodes].copy(),
        count=count[:n_nodes].copy(),
    )
    return bvh, perm.astype(np.int64)
