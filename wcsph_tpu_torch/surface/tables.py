"""Marching-cubes case table, derived programmatically at import time
(numpy-only copy of ``wcsph_tpu/surface/tables.py``).

The reference ships the classic Lorensen/Cline edge/triangle tables as a data
file (MCData.txt, parsed at MarchingCubeGrid.py:80-101).  Instead of embedding
4096 magic integers, we DERIVE an equivalent table from first principles:

For each of the 256 inside/outside corner configurations:
  1. Find the cut edges (sign change across the edge).
  2. On every cube face, pair its cut edges into contour segments.  A face
     with 4 cut edges is the classic ambiguous case; we resolve it with a
     fixed, face-local rule — pair each cut edge with the cut edge sharing
     its INSIDE corner — which isolates the inside corners.  Because the rule
     depends only on the shared face's own labels, adjacent cubes always
     agree, making the extracted surface watertight (verified exhaustively in
     tests/test_surface.py; tests/test_torch_surface.py holds this copy's
     tables equal to those).
  3. Each cut edge now has exactly one partner on each of its two faces, so
     the partner graph decomposes into disjoint cycles = surface polygons.
  4. Orient each cycle so its normal points from inside (value < isolevel)
     to outside, then triangulate: 3-cycles directly, longer cycles as a fan
     around the cycle CENTROID.  (A fan from a cycle vertex can place an
     interior diagonal exactly on an adjacent cube's contour segment, making
     that segment appear 4x; a centroid is unique to its polygon, so every
     interior edge is unshared and the mesh is watertight by construction.)

The result plays the role of the reference's tritable: TRI_TABLE[config] is a
flat list of vertex ids, 3 per triangle, -1 padded, where ids 0-11 are cut
edges and ids 12-15 are cycle centroids whose averaging weights over the 12
edge vertices live in CENTROID_TABLE[config] (4, 12).  EDGE_TABLE[config] is
the cut-edge bitmask (kept for parity with MarchingCubeGrid.py).

Corner numbering (standard MC):      Edge numbering:
    4-------5        y                 e0=(0,1) e1=(1,2) e2=(2,3)  e3=(3,0)
   /|      /|        |                 e4=(4,5) e5=(5,6) e6=(6,7)  e7=(7,4)
  7-------6 |        o--x              e8=(0,4) e9=(1,5) e10=(2,6) e11=(3,7)
  | 0-----|-1       /
  |/      |/       z
  3-------2
"""

from __future__ import annotations

import numpy as np

# corner coordinates (x, y, z)
CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1),
    (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1),
], dtype=np.int32)

# edges as corner pairs
EDGES = np.array([
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
], dtype=np.int32)

# faces as corner quads (cyclic order), outward normals -y,+y,-x,+x,-z,+z
FACES = [
    (0, 1, 2, 3),
    (4, 7, 6, 5),
    (0, 3, 7, 4),
    (1, 5, 6, 2),
    (0, 4, 5, 1),
    (3, 2, 6, 7),
]

MAX_TRI = 12            # per-config triangle cap (classic MC uses <= 5; the
                        # centroid triangulation can emit a few more)
MAX_CYCLES = 4          # <= 12 cut edges / min cycle length 3
TABLE_WIDTH = 3 * MAX_TRI + 1


def _edge_of(a: int, b: int) -> int:
    for i, (u, v) in enumerate(EDGES):
        if {u, v} == {a, b}:
            return i
    raise KeyError((a, b))


def _face_pairs(face, inside):
    """Pair the cut edges of one face into contour segments.

    Each cut edge of the face is adjacent to exactly one inside corner ON
    THAT FACE (its inside endpoint).  Pair cut edges that share the same
    inside corner; an inside corner with exactly one adjacent cut edge on
    this face pairs with the other such corner's edge (the 2-cut case).
    """
    quad = list(face)
    fe = []  # (edge id, inside corner, outside corner) for cut face edges
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        if inside[a] != inside[b]:
            e = _edge_of(a, b)
            fe.append((e, a if inside[a] else b))
    if not fe:
        return []
    if len(fe) == 2:
        return [(fe[0][0], fe[1][0])]
    # 4 cut edges: two diagonal inside corners (or two diagonal outside).
    by_corner = {}
    for e, c in fe:
        by_corner.setdefault(c, []).append(e)
    if all(len(v) == 2 for v in by_corner.values()):
        # two inside corners, two cut edges each -> isolate inside corners
        return [tuple(v) for v in by_corner.values()]
    # two OUTSIDE corners isolated instead (inside corners adjacent): regroup
    # by outside corner for a consistent complementary rule
    by_out = {}
    for k in range(4):
        a, b = quad[k], quad[(k + 1) % 4]
        if inside[a] != inside[b]:
            e = _edge_of(a, b)
            out = b if inside[a] else a
            by_out.setdefault(out, []).append(e)
    assert all(len(v) == 2 for v in by_out.values())
    return [tuple(v) for v in by_out.values()]


def _config_triangles(config: int):
    inside = [(config >> v) & 1 == 1 for v in range(8)]
    cut = [i for i, (a, b) in enumerate(EDGES) if inside[a] != inside[b]]
    if not cut:
        return [], []

    # partner map: edge -> set of partners (one per adjacent face)
    partners = {e: [] for e in cut}
    for face in FACES:
        for e1, e2 in _face_pairs(face, inside):
            partners[e1].append(e2)
            partners[e2].append(e1)
    assert all(len(v) == 2 for v in partners.values()), (config, partners)

    # extract cycles
    cycles = []
    seen = set()
    for start in cut:
        if start in seen:
            continue
        cyc = [start]
        seen.add(start)
        prev, cur = None, start
        while True:
            nxt = [p for p in partners[cur] if p != prev]
            nxt = nxt[0] if nxt else partners[cur][0]
            if nxt == cyc[0]:
                break
            cyc.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        cycles.append(cyc)

    # orient + triangulate (centroid fan for cycles longer than 3)
    mids = {e: (CORNERS[EDGES[e][0]] + CORNERS[EDGES[e][1]]) / 2.0 for e in cut}
    tris = []
    centroid_weights = []
    for cyc in cycles:
        pts = np.array([mids[e] for e in cyc])
        centroid = pts.mean(axis=0)
        # polygon normal (Newell)
        n = np.zeros(3)
        for k in range(len(cyc)):
            p, q = pts[k], pts[(k + 1) % len(cyc)]
            n += np.cross(p - centroid, q - centroid)
        # outward direction: from mean of inside corners of this cycle's
        # edges toward the centroid
        ins = np.array([CORNERS[EDGES[e][0]] if inside[EDGES[e][0]]
                        else CORNERS[EDGES[e][1]] for e in cyc], dtype=float)
        outward = centroid - ins.mean(axis=0)
        order = cyc if float(n @ outward) >= 0.0 else cyc[::-1]
        if len(order) == 3:
            tris.append(tuple(order))
        else:
            cid = 12 + len(centroid_weights)
            w = np.zeros(12, np.float32)
            for e in order:
                w[e] = 1.0 / len(order)
            centroid_weights.append(w)
            for k in range(len(order)):
                tris.append((cid, order[k], order[(k + 1) % len(order)]))
    return tris, centroid_weights


def _build_tables():
    tri = np.full((256, TABLE_WIDTH), -1, dtype=np.int32)
    cen = np.zeros((256, MAX_CYCLES, 12), dtype=np.float32)
    edge = np.zeros(256, dtype=np.int32)
    for c in range(256):
        ts, cw = _config_triangles(c)
        assert len(ts) <= MAX_TRI, (c, len(ts))
        assert len(cw) <= MAX_CYCLES
        flat = [e for t in ts for e in t]
        tri[c, : len(flat)] = flat
        for k, w in enumerate(cw):
            cen[c, k] = w
        for i, (a, b) in enumerate(EDGES):
            if ((c >> a) & 1) != ((c >> b) & 1):
                edge[c] |= 1 << i
    return tri, cen, edge


TRI_TABLE, CENTROID_TABLE, EDGE_TABLE = _build_tables()
