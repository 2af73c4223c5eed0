"""Wavefront OBJ reader (vertices + triangle faces), pure numpy.

``load_obj`` of ``wcsph_tpu/utils/objio.py``, without its optional native
parser.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file.

    Returns (vertices (V,3) float32, faces (F,3) int32 0-based).  Polygons
    with more than 3 vertices are fan-triangulated.
    """
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
