"""Marching cubes: dense scalar field -> triangle mesh (port of
``wcsph_tpu/surface/mc.py``).

Classic 256-case marching cubes with linear edge interpolation
(MarchingCubeGrid.py:252-328) over the derived case table (tables.py).
Two extractors with the same output:

* :func:`marching_cubes` — numpy on the host, a copy of the JAX package's;
* :func:`marching_cubes_device` — the fixed-budget twin in torch ops, on
  the field's device (the card in ``reconstruct(on_device=True)``), with
  the JAX package's budgets, triangle order and ``(vertices, n_tris,
  n_dropped)`` result.  It makes no host read: the caller reads the counts.

Sign convention as the reference: corner bit set when value < isolevel
(MarchingCubeGrid.py:272-287), surface at isolevel 0.5.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .tables import CENTROID_TABLE, CORNERS, EDGES, TRI_TABLE

MAX_VERTEX = 3_000_000   # triangle-vertex budget (MarchingCubeGrid.py:8)


def marching_cubes(field: np.ndarray, origin, spacing: float,
                   isolevel: float = 0.5,
                   max_vertices: int = MAX_VERTEX) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a dense (X, Y, Z) field.

    Returns (vertices (V, 3) float32, triangles (T, 3) int32).  Triangles
    beyond ``max_vertices`` total vertices are dropped (with the reference's
    "exceed max tri" contract, MarchingCubeGrid.py:327).
    """
    f = np.asarray(field)
    origin = np.asarray(origin, np.float32)
    nx, ny, nz = f.shape

    # corner values per cube, shape (8, nx-1, ny-1, nz-1)
    def corner(vx, vy, vz):
        return f[vx: nx - 1 + vx, vy: ny - 1 + vy, vz: nz - 1 + vz]

    cv = np.stack([corner(*c) for c in CORNERS])
    config = np.zeros(cv.shape[1:], np.int32)
    for v in range(8):
        config |= (cv[v] < isolevel).astype(np.int32) << v

    active = np.nonzero((config != 0) & (config != 255))
    if active[0].size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    cfg_a = config[active]                      # (A,)
    cv_a = cv[:, active[0], active[1], active[2]]   # (8, A)
    base = np.stack(active, axis=1).astype(np.float32)  # (A, 3) cube coords

    # interpolated vertex on each of the 12 edges, (A, 12, 3)
    verts12 = np.empty((cfg_a.shape[0], 12, 3), np.float32)
    for e, (a, b) in enumerate(EDGES):
        va, vb = cv_a[a], cv_a[b]
        denom = vb - va
        t = np.where(np.abs(denom) > 1e-5, (isolevel - va) / np.where(
            np.abs(denom) > 1e-5, denom, 1.0), 0.0)
        t = np.clip(t, 0.0, 1.0)
        pa = base + CORNERS[a]
        pb = base + CORNERS[b]
        verts12[:, e, :] = pa + t[:, None] * (pb - pa)

    # cycle centroids (vertex ids 12..15): averaging weights over the 12
    # edge vertices per config
    cent = np.einsum("ake,aed->akd", CENTROID_TABLE[cfg_a], verts12)
    verts16 = np.concatenate([verts12, cent], axis=1)         # (A, 16, 3)

    rows = TRI_TABLE[cfg_a]                     # (A, W)
    tri_ids = rows[:, :-1].reshape(cfg_a.shape[0], -1, 3)     # (A, T, 3)
    valid = tri_ids[:, :, 0] >= 0
    a_idx, t_idx = np.nonzero(valid)
    n_tris = a_idx.size
    budget = max_vertices // 3
    if n_tris > budget:
        a_idx, t_idx = a_idx[:budget], t_idx[:budget]
        n_tris = budget
    e3 = tri_ids[a_idx, t_idx]                  # (T, 3) vertex ids (0..15)
    tri_verts = verts16[a_idx[:, None], e3]     # (T, 3, 3)
    vertices = (origin + spacing * tri_verts.reshape(-1, 3)).astype(np.float32)
    triangles = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    return vertices, triangles


def cube_configs(field: torch.Tensor, isolevel: float = 0.5) -> torch.Tensor:
    """(nx-1, ny-1, nz-1) int32 case of every cube of a dense field: bit v
    set where corner v (``CORNERS``) is below ``isolevel``."""
    nx, ny, nz = field.shape
    config = torch.zeros((nx - 1, ny - 1, nz - 1), dtype=torch.int32,
                         device=field.device)
    for v, (vx, vy, vz) in enumerate(CORNERS.tolist()):
        below = field[vx: nx - 1 + vx, vy: ny - 1 + vy, vz: nz - 1 + vz]
        config |= (below < isolevel).to(torch.int32) << v
    return config


def marching_cubes_device(field: torch.Tensor, origin, spacing: float,
                          isolevel: float = 0.5,
                          max_active: int = 262_144,
                          max_vertices: int = MAX_VERTEX):
    """Marching cubes on the field's device with fixed budgets and no host
    read (``marching_cubes_device`` of the JAX package):

      1. every cube's case, elementwise over the (nx-1)(ny-1)(nz-1) cubes;
      2. the active cubes (case not 0 or 255), in row-major order, into
         ``max_active`` seats (a cumsum, then a scatter whose cubes past the
         budget, and the inactive ones, land on one spare seat that is cut
         off: the JAX package's drop-mode scatter);
      3. their 12 edge vertices and cycle centroids, read from the field
         at the active cubes' corners only;
      4. their triangles, in (cube, table slot) order, into a
         ``max_vertices // 3`` buffer the same way.

    Returns ``(vertices (max_tris * 3, 3) float32, n_tris () int64,
    n_dropped () int64)`` on the field's device; the rows from ``3 *
    n_tris`` on are zeros; ``n_dropped`` counts the triangles lost to the
    vertex budget plus the cubes lost to the active budget (each loses 1-12
    triangles).  Triangle i is vertices ``3i .. 3i + 2``, in the host
    extractor's order."""
    f = field.to(torch.float32)
    dev = f.device
    nx, ny, nz = f.shape
    cy, cz = ny - 1, nz - 1
    max_tris = max_vertices // 3
    config = cube_configs(f, isolevel).reshape(-1)

    # --- active-cube compaction (row-major order == np.nonzero order) ---
    active = (config != 0) & (config != 255)
    acs = torch.cumsum(active, 0)
    seat = torch.where(active & (acs <= max_active), acs - 1, max_active)
    act_ids = torch.full((max_active + 1,), -1, dtype=torch.int64, device=dev)
    act_ids.scatter_(0, seat, torch.arange(config.shape[0], device=dev))
    act_ids = act_ids[:max_active]
    n_act = acs[-1]
    a_ok = act_ids >= 0
    ai = torch.clamp(act_ids, min=0)

    cfg_a = torch.where(a_ok, config[ai], 0).to(torch.int64)      # (A,)
    cube = torch.stack([ai // (cy * cz), (ai // cz) % cy, ai % cz])  # (3, A)
    base = cube.T.to(torch.float32)                                # (A, 3)
    flat = f.reshape(-1)
    corner_at = (cube[0] * ny + cube[1]) * nz + cube[2]   # corner 0's index
    cv = torch.stack([flat[corner_at + (vx * ny + vy) * nz + vz]
                      for vx, vy, vz in CORNERS.tolist()])          # (8, A)

    corners_f = torch.as_tensor(CORNERS, dtype=torch.float32, device=dev)
    verts12 = []
    for a, b in EDGES.tolist():
        va, vb = cv[a], cv[b]
        denom = vb - va
        safe = torch.abs(denom) > 1e-5
        t = torch.clamp(torch.where(
            safe, (isolevel - va) / torch.where(safe, denom, 1.0), 0.0),
            0.0, 1.0)
        pa = base + corners_f[a]
        pb = base + corners_f[b]
        verts12.append(pa + t[:, None] * (pb - pa))
    verts12 = torch.stack(verts12, dim=1)                          # (A, 12, 3)
    cen = torch.as_tensor(CENTROID_TABLE, device=dev)[cfg_a]      # (A, 4, 12)
    verts16 = torch.cat([verts12, torch.einsum("ake,aed->akd", cen,
                                               verts12)], dim=1)  # (A, 16, 3)

    # --- triangle compaction (same (cube, slot) order as the host path) ---
    rows = torch.as_tensor(TRI_TABLE, dtype=torch.int64, device=dev)[cfg_a]
    rows = rows[:, :-1].reshape(max_active, -1, 3)                 # (A, T, 3)
    n_slot = rows.shape[1]
    valid = ((rows[:, :, 0] >= 0) & a_ok[:, None]).reshape(-1)
    tri_pts = torch.gather(
        verts16, 1, torch.clamp(rows, min=0).reshape(
            max_active, n_slot * 3, 1).expand(-1, -1, 3)).reshape(-1, 3, 3)
    tcs = torch.cumsum(valid, 0)
    tseat = torch.where(valid & (tcs <= max_tris), tcs - 1, max_tris)
    out = torch.zeros((max_tris + 1, 3, 3), dtype=torch.float32, device=dev)
    out.index_copy_(0, tseat, torch.where(valid[:, None, None], tri_pts, 0.0))
    out = out[:max_tris]
    n_tris = torch.clamp(tcs[-1], max=max_tris)
    n_dropped = (torch.clamp(tcs[-1] - max_tris, min=0)
                 + torch.clamp(n_act - max_active, min=0))
    vertices = (torch.as_tensor(np.asarray(origin, np.float32), device=dev)
                + spacing * out.reshape(-1, 3))
    live = torch.arange(vertices.shape[0], device=dev)[:, None] < 3 * n_tris
    return torch.where(live, vertices, 0.0), n_tris, n_dropped


def weld_vertices(vertices: np.ndarray, triangles: np.ndarray,
                  tol: float = 1e-6) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicate vertices (shared cube edges) into an indexed mesh."""
    key = np.round(vertices / tol).astype(np.int64)
    _, first, inverse = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    return vertices[first], inverse.reshape(-1)[triangles].astype(np.int32)
