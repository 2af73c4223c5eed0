"""Wavefront OBJ reader and writer (vertices + triangle faces).

``load_obj``, ``save_obj`` and ``save_point_cloud`` of
``wcsph_tpu/utils/objio.py``.  ``load_obj`` parses with the native reader
(``native/objio.cpp``, built by ``native.py``) where it can be built, and
in Python otherwise; the writer is Python.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file.

    Returns (vertices (V,3) float32, faces (F,3) int32 0-based).  Polygons
    with more than 3 vertices are fan-triangulated.  Uses the native C++
    parser when it builds; the Python parser below otherwise.
    """
    native_result = _load_obj_native(path)
    if native_result is not None:
        return native_result
    return _load_obj_python(path)


def _load_obj_python(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(tok.split("/")[0]) - 1 for tok in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, dtype=np.float32) if verts else np.zeros((0, 3), np.float32)
    f_arr = np.asarray(faces, dtype=np.int32) if faces else np.zeros((0, 3), np.int32)
    return v, f_arr


def _load_obj_native(path: str):
    import ctypes

    from . import native

    lib = native.load()
    if lib is None:
        return None
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.obj_parse(path.encode(), ctypes.byref(vp), ctypes.byref(nv),
                       ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        raise IOError(f"obj_parse({path!r}) failed with code {rc}")
    try:
        v = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        f = np.ctypeslib.as_array(fp, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        lib.obj_free(vp)
        lib.obj_free(fp)
    return v.astype(np.float32, copy=False), f.astype(np.int32, copy=False)


def save_obj(path: str, vertices: np.ndarray,
             faces: np.ndarray | None = None) -> None:
    """Write vertices (and optional 0-based triangle faces) to an OBJ file."""
    vertices = np.asarray(vertices, np.float32)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        if faces is not None:
            for tri in np.asarray(faces):
                f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def save_point_cloud(path: str, points: np.ndarray) -> None:
    save_obj(path, points, None)
