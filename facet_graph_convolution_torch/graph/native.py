"""ctypes bindings to the port's C++ host kernels (``csrc/graphlib.cpp``).

The port's own copy of ``facet_graph_convolution_tpu/graph/native.py`` and
of its library ``native/graphlib.cpp``: Graclus matching, masked BFS patch
growth, the facet adjacency K-list and the OBJ parser in C++, with the NumPy
paths of :mod:`..coarsen`, :mod:`..patching`, :mod:`..adjacency` and
:mod:`...geometry.obj_io` as fallback and oracle. The four hooks take the
library as the JAX package's do, so that for one mesh and seed the port
builds the patches and pyramids that the JAX package builds by default.

The library is built at first use with ``g++ -O3 -march=native -shared -fPIC
-std=c++17`` (the JAX package's flags) into ``csrc/build/libgraph.so``,
which ``.gitignore`` lists; it is rebuilt when the source is newer. Each
build writes a file of its own and renames it into place, so processes that
start at once do not load a half-written library. ``FGC_DISABLE_NATIVE=1``,
the JAX package's switch, puts both packages on their NumPy paths. A failed
build warns once and leaves the process on the NumPy paths, as in the JAX
package; :func:`available` says whether the library loaded.

Native and NumPy coarsen differently for the same seed, in both packages,
at one step: ``_match_one_level`` inverts the node weights (the column sums
of the float32 weight matrix) as ``1.0 / weights``, which NumPy computes in
float32, while :func:`match_one_level_native` casts them to float64 first.
The edge scores ``w_ij · (1/d_i + 1/d_j)`` then differ in their last bits;
near-ties pick other partners (on a noisy subdivision-4 icosphere, at the
second trial of the second matching level) and the total associations that
choose among the 3 trials differ. With the weights cast to float64 the NumPy
matching gives the native clusters and associations bit for bit. Neither
package is changed to hide this; the port's tests hold native against
native and NumPy against NumPy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(CSRC, "graphlib.cpp")
LIBRARY = os.path.join(CSRC, "build", "libgraph.so")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_LOAD_FAILED = False
_LOCK = threading.Lock()


def _build() -> None:
    """Compile the library if it is missing or older than its source."""
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, LIBRARY)


def _load() -> ctypes.CDLL:
    global _LIB, _LOAD_FAILED
    if os.environ.get("FGC_DISABLE_NATIVE"):
        raise ImportError("native disabled via FGC_DISABLE_NATIVE")
    if _LOAD_FAILED:
        raise ImportError("native build failed earlier in this process")
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if not os.path.exists(SOURCE):
            _LOAD_FAILED = True
            raise ImportError("native source not found")
        try:
            _build()
            lib = ctypes.CDLL(LIBRARY)
        except Exception as exc:
            # remember the failure so that hot loops do not start a failing
            # compiler on every call; warn once
            _LOAD_FAILED = True
            warnings.warn(f"native graph kernels unavailable ({exc}); falling back to "
                          "NumPy paths (slower preprocessing)")
            raise ImportError(str(exc)) from exc

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

        lib.match_one_level.restype = ctypes.c_double
        lib.match_one_level.argtypes = [
            i64p, i64p, f64p, ctypes.c_int64,          # rr, cc, vv, nnz
            i64p, f64p, ctypes.c_int64,                # rid, inv_weights, N
            i32p,                                      # out cluster_id
        ]
        lib.grow_patch.restype = ctypes.c_int64
        lib.grow_patch.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64,      # adj0 (zero-indexed), N, K
            ctypes.c_int64, ctypes.c_int64,            # seed, nodes_num
            i8p, ctypes.c_int64,                       # mask, min_size
            i64p, i64p, i64p, i64p,                    # out_adj, old_idx, scratch new_idx, meta
        ]
        lib.face_adjacency.restype = ctypes.c_int64
        lib.face_adjacency.argtypes = [
            i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # faces, F, V, k
            i32p,                                      # out fadj [F, k]
        ]
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64)]
        lib.obj_copy.restype = None
        lib.obj_copy.argtypes = [ctypes.c_void_p, f32p, i64p]
        lib.obj_release.restype = None
        lib.obj_release.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def available() -> bool:
    """Whether the library is in use: not disabled by ``FGC_DISABLE_NATIVE``,
    built and loaded (this builds it at the first call)."""
    try:
        _load()
    except ImportError:
        return False
    return True


def match_one_level_native(
    rr: np.ndarray,
    cc: np.ndarray,
    vv: np.ndarray,
    rid: np.ndarray,
    weights: np.ndarray,
    num_nodes: int,
) -> Tuple[np.ndarray, float]:
    """One pass of greedy heavy-edge matching (``_match_one_level``'s
    semantics, the inverse weights in float64): (cluster id per node, total
    association)."""
    lib = _load()
    rr = np.ascontiguousarray(rr, dtype=np.int64)
    cc = np.ascontiguousarray(cc, dtype=np.int64)
    vv = np.ascontiguousarray(vv, dtype=np.float64)
    rid = np.ascontiguousarray(rid, dtype=np.int64)
    inv_w = np.zeros(num_nodes, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    nz = w != 0
    inv_w[nz] = 1.0 / w[nz]
    cluster_id = np.zeros(num_nodes, dtype=np.int32)
    assoc = lib.match_one_level(rr, cc, vv, rr.shape[0], rid, inv_w, num_nodes, cluster_id)
    return cluster_id, float(assoc)


def parse_obj_native(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file: ``(vertices [V,3] float32, faces [T,3] int64,
    fan-triangulated, 0-indexed)``, the output of the Python line loop in
    ``geometry.obj_io.load_obj``. Raises ``ImportError`` / ``OSError`` so
    that the caller can fall back."""
    lib = _load()
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    handle = lib.obj_parse(path.encode(), ctypes.byref(nv), ctypes.byref(nt))
    if not handle:
        # unreadable, truncated, or a construct the C parser refuses
        # (negative/relative or malformed face indices): the caller falls
        # back to the Python loop, which raises the Pythonic error
        raise OSError(f"obj_parse could not parse {path!r}")
    try:
        verts = np.empty((nv.value, 3), dtype=np.float32)
        tris = np.empty((nt.value, 3), dtype=np.int64)
    except BaseException:
        lib.obj_release(handle)
        raise
    lib.obj_copy(handle, verts, tris)
    return verts, tris


def face_adjacency_native(faces: np.ndarray, num_vertices: int, k: int) -> Tuple[np.ndarray, int]:
    """Vertex-shared facet K-list by the C++ single-pass builder, the output
    of the NumPy path of ``graph.adjacency``: ``(fadj [F,k] int32,
    dropped)``."""
    lib = _load()
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    fnum = faces.shape[0]
    fadj = np.zeros((fnum, k), dtype=np.int32)
    dropped = lib.face_adjacency(faces, fnum, int(num_vertices), k, fadj)
    return fadj, int(dropped)


def grow_patch_native(
    adj: np.ndarray,
    nodes_num: int,
    seed: int,
    mask: Optional[np.ndarray],
    min_size: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Masked BFS patch growth (``graph.patching.grow_graph_patch_masked``'s
    semantics): (local K-list one-indexed, local → global indices, next
    seed)."""
    lib = _load()
    n, k = adj.shape
    adj0 = np.ascontiguousarray(adj.astype(np.int64) - 1)
    mask_arr = (np.ascontiguousarray(mask, dtype=np.int8) if mask is not None
                else np.zeros(n, dtype=np.int8))
    cap = min(max(nodes_num, min_size) + k, n)
    out_adj = np.full((cap, k), -1, dtype=np.int64)
    old_idx = np.full(cap, -1, dtype=np.int64)
    new_idx = np.full(n, -1, dtype=np.int64)
    meta = np.zeros(2, dtype=np.int64)  # [count, next_seed]
    count = int(lib.grow_patch(adj0, n, k, seed, nodes_num, mask_arr, min_size,
                               out_adj, old_idx, new_idx, meta))
    result = (out_adj[:count] + 1).astype(np.int32)
    return result, old_idx[:count].copy(), int(meta[1])
