"""Native (C++) runtime components, bound via ctypes.

The reference keeps its irregular, pointer-heavy runtime in C++ (max-flow
in frame_main/libs/Math/IBFS, CGAL Delaunay walking, VCG mesh ops); the
JAX build does the same for the pieces that XLA cannot express
profitably.  Components:

- maxflow: BK-style s-t min-cut (native/maxflow.cpp) — the graph-cut
  surface extraction solver (ref: SceneReconstruct.cpp:58-101).

Build model: no pybind11 in this image, so each component is a plain
C-ABI shared object compiled on demand with g++ -O3 and cached under
<checkout>/.native_cache keyed by source hash; ctypes binds it.  Everything has
a pure-Python/scipy fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_CACHE_DIR = os.environ.get(
    "HCMVS_NATIVE_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)), ".native_cache"))

_libs = {}
_build_failed = set()


def _build(name: str) -> Optional[ctypes.CDLL]:
    """Compile native/<name>.cpp into a cached .so and dlopen it."""
    if name in _libs:
        return _libs[name]
    if name in _build_failed:
        return None
    src = os.path.join(_SRC_DIR, f"{name}.cpp")
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(_CACHE_DIR, f"{name}-{digest}.so")
        if not os.path.exists(so_path):
            os.makedirs(_CACHE_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
            os.close(fd)
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", "-o", tmp, src]
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _libs[name] = lib
        return lib
    except Exception:
        _build_failed.add(name)
        return None


def _maxflow_lib() -> Optional[ctypes.CDLL]:
    lib = _build("maxflow")
    if lib is None:
        return None
    fn = lib.hcmvs_maxflow
    fn.restype = ctypes.c_double
    fn.argtypes = [
        ctypes.c_int32, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    return lib


def have_native_maxflow() -> bool:
    return _maxflow_lib() is not None


def maxflow(n_nodes: int, eu: np.ndarray, ev: np.ndarray,
            cap_uv: np.ndarray, cap_vu: Optional[np.ndarray],
            cap_src: np.ndarray, cap_snk: np.ndarray
            ) -> Tuple[float, np.ndarray]:
    """s-t max-flow / min-cut.

    Args:
      n_nodes: number of non-terminal nodes.
      eu, ev: (E,) int32 pairwise edge endpoints.
      cap_uv: (E,) float32 capacity u->v.
      cap_vu: (E,) float32 capacity v->u, or None for symmetric.
      cap_src: (n,) float32 source->v terminal capacities.
      cap_snk: (n,) float32 v->sink terminal capacities.

    Returns:
      (flow_value, source_side) with source_side a (n,) bool array — True
      for nodes on the source side of the min cut.
    """
    eu = np.ascontiguousarray(eu, np.int32)
    ev = np.ascontiguousarray(ev, np.int32)
    cap_uv = np.ascontiguousarray(cap_uv, np.float32)
    cap_vu = (cap_uv if cap_vu is None
              else np.ascontiguousarray(cap_vu, np.float32))
    cap_src = np.ascontiguousarray(cap_src, np.float32)
    cap_snk = np.ascontiguousarray(cap_snk, np.float32)
    out = np.zeros(n_nodes, np.uint8)

    lib = _maxflow_lib()
    if lib is not None:
        flow = lib.hcmvs_maxflow(np.int32(n_nodes), np.int64(len(eu)),
                                 eu, ev, cap_uv, cap_vu, cap_src, cap_snk,
                                 out)
        return float(flow), out.astype(bool)
    return _maxflow_scipy(n_nodes, eu, ev, cap_uv, cap_vu, cap_src, cap_snk)


def _maxflow_scipy(n_nodes, eu, ev, cap_uv, cap_vu, cap_src, cap_snk,
                   quantum: float = 1e-3) -> Tuple[float, np.ndarray]:
    """Fallback via scipy's integer max-flow (capacities quantized)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import breadth_first_order, maximum_flow
    S, T = n_nodes, n_nodes + 1
    nz_s = np.nonzero(cap_src > 0)[0]
    nz_t = np.nonzero(cap_snk > 0)[0]
    src = np.concatenate([eu, ev, np.full(len(nz_s), S), nz_t])
    dst = np.concatenate([ev, eu, nz_s, np.full(len(nz_t), T)])
    cap = np.concatenate([cap_uv, cap_vu, cap_src[nz_s], cap_snk[nz_t]])
    icap = np.round(cap / quantum).astype(np.int64)
    # keep strictly-positive caps alive through quantization; true zeros
    # must stay zero (they are non-edges)
    icap = np.where(cap > 0, np.maximum(icap, 1), 0)
    graph = coo_matrix((icap, (src, dst)),
                       shape=(n_nodes + 2, n_nodes + 2)).tocsr()
    graph.sum_duplicates()
    res = maximum_flow(graph, S, T)
    resid = graph - res.flow
    resid.data = (resid.data > 0).astype(np.int64)
    resid.eliminate_zeros()
    order = breadth_first_order(resid, S, directed=True,
                                return_predecessors=False)
    side = np.zeros(n_nodes, bool)
    side[order[order < n_nodes]] = True
    return float(res.flow_value) * quantum, side


def _raster_lib() -> Optional[ctypes.CDLL]:
    lib = _build("raster")
    if lib is None:
        return None
    fn = lib.hcmvs_rasterize
    fn.restype = None
    fn.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    return lib


def have_native_raster() -> bool:
    return _raster_lib() is not None


def rasterize(vertices: np.ndarray, faces: np.ndarray, K: np.ndarray,
              R: np.ndarray, C: np.ndarray, h: int, w: int,
              with_attrs: bool = True):
    """Native z-buffer rasterization (see native/raster.cpp — the
    TRasterMesh analog the Python fallback in mesh/mesh_ops.py mirrors).

    Returns (depth f32 (h, w), face_id i32 (h, w), bary f32 (h, w, 3))
    or None when the toolchain is unavailable."""
    lib = _raster_lib()
    if lib is None:
        return None
    V = np.ascontiguousarray(vertices, np.float64)
    F = np.ascontiguousarray(faces, np.int32)
    depth = np.zeros((h, w), np.float32)
    fid = np.zeros((h, w), np.int32)
    bary = np.zeros((h, w, 3), np.float32)
    lib.hcmvs_rasterize(
        np.int32(len(V)), np.int32(len(F)), V, F,
        np.ascontiguousarray(K, np.float64),
        np.ascontiguousarray(R, np.float64),
        np.ascontiguousarray(C, np.float64),
        np.int32(h), np.int32(w), np.int32(1 if with_attrs else 0),
        depth, fid, bary)
    return depth, fid, bary
