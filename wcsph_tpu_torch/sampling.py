"""Parallel Poisson-disk surface sampling of triangle meshes (port of
``wcsph_tpu/sampling.py``; reference boundry.py).

Offline boundary generation: a mesh is densely sampled with area-weighted
random surface points (the same numpy draws as the JAX package, so the same
seed gives the same candidates), then thinned so that no two kept samples
are closer than the radius under a geodesic-corrected distance
(boundry.py:342-374), giving the boundary shells that the solvers load.

Cells have size r / sqrt(3) and are tried in 27 colours (3x3x3 cell
parity): cells of one colour are at least 3 cells apart, so all of a
colour's candidates are tested against the points accepted in their 5^3
windows and accepted at once, one phase step a launch of ``poisson_phase``
(``engine.py``; its plain twin on CPU tensors), trials x 27 steps a chunk.

The device holds the candidates, each chunk's sort by cell (``torch.sort``,
stable: rank in a cell is by candidate index) and its accepted points, and
gathers the kept points of every chunk into one buffer; the host reads that
buffer once, at the end.  Large meshes go in z-chunks of at most
``max_cells`` cells with two halo planes each side, the low halo seeded
with the points earlier chunks kept there, exactly as the JAX package
chunks them: the chunking decides which samples survive, and the output
order (slot, then cell, chunk by chunk in z) is the JAX package's.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from . import engine
from .dense_ops import PhaseChunk


def _surface_samples(verts: np.ndarray, faces: np.ndarray, radius: float,
                     density: float, seed: int):
    """Dense initial point set: 40 * area / (pi r^2) barycentric samples
    (boundry.py:223-246) with per-sample face normals."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    cross = np.cross(b - a, c - a)
    area2 = np.linalg.norm(cross, axis=1)
    areas = 0.5 * area2
    normals = cross / np.maximum(area2, 1e-12)[:, None]
    total = float(areas.sum())
    n = int(density * total / (math.pi * radius * radius))
    rng = np.random.default_rng(seed)
    # inverse-CDF area-weighted face choice; float rounding can leave
    # cdf[-1] slightly below 1.0, in which case searchsorted returns an
    # out-of-range index for draws above it — clamp to the last face
    cdf = np.cumsum(areas) / total
    fi = np.minimum(np.searchsorted(cdf, rng.random(n)), len(areas) - 1)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    bc1 = 1.0 - r1
    bc2 = r2 * r1
    bc3 = 1.0 - bc1 - bc2
    pts = (bc1[:, None] * a[fi] + bc2[:, None] * b[fi] + bc3[:, None] * c[fi])
    return pts.astype(np.float32), normals[fi].astype(np.float32), fi.astype(np.int32)


def _cells(p: torch.Tensor, origin: np.ndarray, cell: np.float32,
           res) -> torch.Tensor:
    """Flat cell index (x major, z minor) of the (3, K) points in the grid
    ``res`` at ``origin``: floor((p - origin) / cell) in float32, each axis
    clipped to [0, g - 1] (``_bin_dense``)."""
    org = torch.as_tensor(origin, device=p.device)[:, None]
    c = torch.floor((p - org) / torch.as_tensor(cell, device=p.device))
    c = c.to(torch.int64)
    gx, gy, gz = res
    cx = c[0].clamp(0, gx - 1)
    cy = c[1].clamp(0, gy - 1)
    cz = c[2].clamp(0, gz - 1)
    return (cx * gy + cy) * gz + cz


def _by_cell(key: torch.Tensor, nc: int):
    """(order, start): the rows sorted stably by key, keys in [0, nc] with
    nc for rows left out, and the (nc + 1,) first sorted row of each
    cell (start[nc] = the rows kept)."""
    skey, order = torch.sort(key, stable=True)
    count = torch.zeros((nc + 1,), dtype=torch.int64, device=key.device)
    count.index_add_(0, key, torch.ones_like(key))
    start = torch.zeros_like(count)
    start[1:] = torch.cumsum(count[:nc], 0)
    return skey, order, start


def _plane(z: torch.Tensor, lo2: np.float32, cell: np.float32,
           gz: int) -> torch.Tensor:
    """Global z plane of each position: clip(floor((z - lo_z) / cell),
    0, gz - 1)."""
    dev = z.device
    return torch.clamp(torch.floor((z - torch.as_tensor(lo2, device=dev))
                                   / torch.as_tensor(cell, device=dev)),
                       0, gz - 1).to(torch.int64)


class _Kept:
    """The points kept so far, in output order, on the device: positions,
    normals, face ids and global z planes, with one spare row (index n)
    that masked-out writes go to, and their count as a 0-dim tensor."""

    def __init__(self, n: int, dev):
        self.p = torch.zeros((3, n + 1), dtype=torch.float32, device=dev)
        self.nrm = torch.zeros((3, n + 1), dtype=torch.float32, device=dev)
        self.f = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        self.cz = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.spare = n

    def append(self, ch: PhaseChunk, keep: torch.Tensor, planes):
        """Append the accepted points of ``ch`` where ``keep`` (A, NC),
        slot-major then cell, with their global z planes."""
        flat = keep.reshape(-1)
        pos = self.count + torch.cumsum(flat, 0) - 1
        idx = torch.where(flat, pos, self.spare)
        acc_p = ch.acc_p.reshape(3, -1)
        self.p.index_copy_(1, idx, acc_p)
        self.nrm.index_copy_(1, idx, ch.acc_n.reshape(3, -1))
        self.f.index_copy_(0, idx, ch.acc_f.reshape(-1))
        self.cz.index_copy_(0, idx, planes(acc_p[2]))
        self.count += flat.sum()


def _seed(ch: PhaseChunk, kept: _Kept, za: int, origin, cell) -> None:
    """Seed the chunk's low halo with the points kept in global planes
    za - 2 and za - 1: binned like candidates (in kept order), the k-th of
    a cell into slot k, at most accept_cap a cell (``_run_chunk``)."""
    nc = math.prod(ch.res)
    cap = ch.accept_cap
    rows = torch.arange(kept.p.shape[1], device=kept.p.device)
    halo = (rows < kept.count) & (kept.cz >= za - 2) & (kept.cz < za)
    key = torch.where(halo, _cells(kept.p, origin, cell, ch.res), nc)
    skey, order, start = _by_cell(key, nc)
    rank = torch.arange(key.shape[0], device=key.device) - start[skey]
    ok = (skey < nc) & (rank < cap)
    dst = torch.where(ok, rank * nc + skey, cap * nc)   # cap * nc: spare

    def place(acc, src):
        buf = torch.cat([acc.reshape(-1), acc.new_zeros(1)])
        buf.index_copy_(0, dst, src[order])
        acc.copy_(buf[:-1].reshape(cap, nc))

    for a in range(3):
        place(ch.acc_p[a], kept.p[a])
        place(ch.acc_n[a], kept.nrm[a])
    place(ch.acc_f, kept.f)
    ch.acc_cnt.copy_(torch.clamp(start[1:] - start[:-1], max=cap))


def sample_surface(verts: np.ndarray, faces: np.ndarray, radius: float,
                   trials: int = 10, density: float = 40.0, seed: int = 0,
                   sample_cap: int = 24, accept_cap: int = 4,
                   max_cells: int = 3_000_000, device=None):
    """``poisson_disk_sample`` with the face of each kept point: ((M, 3)
    float32 positions, (M,) int32 face ids)."""
    dev = torch.device("cuda" if device is None else device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    pts, normals, fids = _surface_samples(verts, faces, radius, density, seed)

    cell = radius / math.sqrt(3.0)
    lo = verts.min(axis=0) - 2 * cell
    hi = verts.max(axis=0) + 2 * cell
    res = tuple(int((hi[i] - lo[i]) / cell) + 1 for i in range(3))
    gx, gy, gz = res
    cell32 = np.float32(cell)

    n = pts.shape[0]
    cand_p = torch.as_tensor(np.ascontiguousarray(pts.T)).to(dev)
    cand_n = torch.as_tensor(np.ascontiguousarray(normals.T)).to(dev)
    cand_f = torch.as_tensor(fids).to(dev)
    kept = _Kept(n, dev)
    n_trials = min(trials, sample_cap)

    def planes(z):
        return _plane(z, lo[2], cell32, gz)

    nz_own = max(1, max_cells // max(gx * gy, 1) - 4)
    if gz <= nz_own + 4:
        # one chunk: the whole grid, every candidate its own, every
        # accepted point kept
        chunks = [(0, gz, 0, res, lo.astype(np.float32))]
    else:
        gz_ext = nz_own + 4                   # 2 halo planes each side
        chunks = []
        for za in range(0, gz, nz_own):
            z_org = za - 2                    # local grid origin (global z)
            origin = np.asarray([lo[0], lo[1], lo[2] + z_org * cell],
                                np.float32)
            chunks.append((za, min(za + nz_own, gz), z_org, (gx, gy, gz_ext),
                           origin))
    one = len(chunks) == 1
    cz_all = planes(cand_p[2])
    t0 = time.time()
    for za, zb, z_org, sub, origin in chunks:
        if not one:
            print(f"[sampler] chunk z[{za}:{zb}) of {gz} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
        nc = math.prod(sub)
        own = (cz_all >= za) & (cz_all < zb)
        key = torch.where(own, _cells(cand_p, origin, cell32, sub), nc)
        _, order, start = _by_cell(key, nc)
        ch = PhaseChunk(
            pts=cand_p, nrm=cand_n, fid=cand_f,
            order=order.to(torch.int32), start=start.to(torch.int32),
            res=sub, z0=z_org, radius=radius,
            acc_p=torch.full((3, accept_cap, nc), 1e9, dtype=torch.float32,
                             device=dev),
            acc_n=torch.zeros((3, accept_cap, nc), dtype=torch.float32,
                              device=dev),
            acc_f=torch.full((accept_cap, nc), -1, dtype=torch.int32,
                             device=dev),
            acc_cnt=torch.zeros((nc,), dtype=torch.int32, device=dev))
        if not one:
            _seed(ch, kept, za, origin, cell32)
        for trial in range(n_trials):
            for phase in range(27):
                engine.poisson_phase(ch, phase, trial)
        # keep OWN planes only (local z in [2, 2 + zb - za)); z is the
        # minor axis of the flat cell index
        lz = torch.arange(nc, device=dev) % sub[2]
        keep = (ch.acc_f >= 0) & (lz >= za - z_org) & (lz < zb - z_org)
        kept.append(ch, keep, planes)
        del ch
    m = int(kept.count)
    out = kept.p[:, :m].T.cpu().numpy()
    return (np.ascontiguousarray(out, np.float32),
            kept.f[:m].cpu().numpy())


def poisson_disk_sample(verts: np.ndarray, faces: np.ndarray, radius: float,
                        trials: int = 10, density: float = 40.0,
                        seed: int = 0, sample_cap: int = 24,
                        accept_cap: int = 4, max_cells: int = 3_000_000,
                        device=None) -> np.ndarray:
    """Sample a triangle mesh surface with minimum spacing ``radius``:
    the kept sample positions (M, 3) float32, the boundary particle shell
    (reference output boundry.py:445-453), in the JAX package's order.

    Runs on the card unless ``device`` says otherwise (``"cpu"``: the plain
    twin of the phase kernel); a machine without one raises.  Large meshes
    go in sequential z-chunks of at most ``max_cells`` cells (see the
    module docstring); a one-chunk run is the unchunked algorithm."""
    return sample_surface(verts, faces, radius, trials, density, seed,
                          sample_cap, accept_cap, max_cells, device)[0]


def sample_obj(path_in: str, path_out: str, radius: float = 0.025,
               **kw) -> np.ndarray:
    """boundry.py CLI equivalent: OBJ in -> `<name>_boundry.obj` out."""
    from .utils import objio

    verts, faces = objio.load_obj(path_in)
    pts = poisson_disk_sample(verts, faces, radius, **kw)
    objio.save_point_cloud(path_out, pts)
    return pts
