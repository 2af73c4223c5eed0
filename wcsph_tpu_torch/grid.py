"""Binning: particles sorted by cell, with per-cell start offsets.

Replaces the JAX package's capacity-padded layouts (``wcsph_tpu/grid.py``
and the padded-direct build of ``wcsph_tpu/resident.py``).  Each step the
in-domain particles are sorted by cell id (stable sort, so equal cells keep
particle order); cell ``c`` holds sorted rows ``cell_start[c] ..
cell_start[c + 1]``.  There is no capacity, so no particle is ever dropped:
the JAX package's ``neighbor_overflow`` is always 0 here.

Cell ids are computed exactly as ``grid.cell_of_positions`` does:
``floor((pos - dmin) * (1 / cell_size))`` in float32.  Particles outside the
domain get no row: they take part in no pair, and the step keeps their
velocity and warm-start fields (the JAX package's out-of-box semantics).

Fields move between the per-particle layout and the sorted layout with
``pack`` / ``unpack``.  Only liquid fields are packed; boundary rows hold 0,
so a boundary neighbour contributes a zero velocity, kappa or omega, as the
reference's ``j >= liquid_count`` branches do.

A DFSPH or IISPH step also keeps a neighbour list of its sorted positions
(``NeighborList``, built by ``engine.nbr_list_fill`` right after the
density sweep), which the sweeps after it walk instead of the 27 cells.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .config import SimConfig


SLICE = 32   # rows per slice of the neighbour list: one warp


@dataclasses.dataclass
class NeighborList:
    """The pairs within h of every liquid row, in sliced ELL.

    Slice s holds rows ``SLICE s .. SLICE s + SLICE - 1``; its width is the
    largest neighbour count of its liquid rows (0 for a slice of boundary
    rows).  The k-th neighbour of row i is ``idx[off[s] + SLICE k +
    i % SLICE]``, so the rows of one slice store their k-th neighbours side
    by side; neighbours are in ascending row order, and the slots past a
    row's count, like every slot of a boundary row, hold -1.  About 4 bytes
    x 32 slots per liquid row (118 MiB for the 1M dam break), and a
    16-byte record per row, ``rec[i] = (x, y, z, liquid flag)``, from which
    a walk reads a neighbour's geometry in one load."""

    idx: torch.Tensor   # (off[-1],) int32 neighbour row, or -1
    off: torch.Tensor   # (S + 1,) int32 first slot of each slice
    rec: torch.Tensor   # (M, 4) float32 (x, y, z, liquid flag) of each row

    @property
    def width(self) -> torch.Tensor:
        """(S,) slots per row of each slice."""
        return (self.off[1:] - self.off[:-1]) // SLICE


def slice_offsets(count: torch.Tensor, liquid: torch.Tensor):
    """((S + 1,) int32 first slot of each slice, the number of slots) from
    the neighbour count of each row (the density sweep's count); boundary
    rows take no slots.  Reads the number of slots back to the host."""
    m = count.shape[0]
    s = -(-m // SLICE)
    c = torch.zeros(s * SLICE, dtype=torch.int64, device=count.device)
    c[:m] = torch.where(liquid, count.to(torch.int64), 0)
    off = torch.zeros(s + 1, dtype=torch.int64, device=count.device)
    off[1:] = torch.cumsum(c.view(s, SLICE).amax(1) * SLICE, 0)
    total = int(off[-1])
    if total >= 2 ** 31:
        raise ValueError(f"{total} neighbour slots: the list's slot "
                         "offsets are 32-bit")
    return off.to(torch.int32), total


@dataclasses.dataclass
class Grid:
    """One step's sorted layout (M in-domain particles)."""

    cfg: SimConfig
    order: torch.Tensor        # (M,) int64 particle index of each sorted row
    cell: torch.Tensor         # (M,) int32 cell id of each sorted row
    cell_start: torch.Tensor   # (num_cells + 1,) int32 first row of each cell
    pos: torch.Tensor          # (3, M) float32 sorted positions
    liquid: torch.Tensor       # (M,) bool
    liq: torch.Tensor          # (M,) float32 1.0 at liquid rows, 0.0 else
    liq_rows: torch.Tensor     # (L,) int64 sorted rows holding liquid
    liq_src: torch.Tensor      # (L,) int64 their particle indices
    n_liquid: int              # L: liquid particles inside the domain
    pairs: object = None       # dense_ops.Pairs, built on first plain sweep
    nbr: NeighborList | None = None   # engine.nbr_list_fill, DFSPH, IISPH

    @property
    def n(self) -> int:
        return int(self.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pos.device


def cell_of_positions(pos: torch.Tensor, cfg: SimConfig):
    """(cell ids (N,) int64, in-domain mask) for planar positions (3, N)."""
    gx, gy, gz = cfg.grid_res
    dmin = torch.tensor(cfg.domain_min, dtype=torch.float32, device=pos.device)
    inv = torch.tensor(np.float32(1.0 / cfg.cell_size), device=pos.device)
    c = torch.floor((pos - dmin[:, None]) * inv).to(torch.int64)
    cx, cy, cz = c[0], c[1], c[2]
    inbox = ((cx >= 0) & (cx < gx) & (cy >= 0) & (cy < gy)
             & (cz >= 0) & (cz < gz))
    return (cx * gy + cy) * gz + cz, inbox


def build_grid(pos: torch.Tensor, n_liquid: int, cfg: SimConfig) -> Grid:
    """Sort the in-domain particles by cell and compute the cell offsets."""
    nc = cfg.num_cells
    cell_id, inbox = cell_of_positions(pos, cfg)
    keys = torch.where(inbox, cell_id, nc)
    sorted_keys, order = torch.sort(keys, stable=True)
    m = int(inbox.sum())
    order = order[:m]
    sorted_cell = sorted_keys[:m]
    counts = torch.bincount(sorted_cell, minlength=nc)
    start = torch.zeros(nc + 1, dtype=torch.int64, device=pos.device)
    start[1:] = torch.cumsum(counts, 0)
    liquid = order < n_liquid
    liq_rows = torch.nonzero(liquid).flatten()
    return Grid(cfg=cfg, order=order,
                cell=sorted_cell.to(torch.int32),
                cell_start=start.to(torch.int32),
                pos=pos[:, order].contiguous(),
                liquid=liquid,
                liq=liquid.to(torch.float32),
                liq_rows=liq_rows,
                liq_src=order[liq_rows],
                n_liquid=int(liq_rows.shape[0]))


def pack(grid: Grid, fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-liquid (N_L,) or (k, N_L) fields -> sorted (M,) / (k, M); rows
    that hold no liquid take 0."""
    out = []
    for x in fields:
        p = torch.zeros(x.shape[:-1] + (grid.n,), dtype=x.dtype,
                        device=x.device)
        p[..., grid.liq_rows] = x[..., grid.liq_src]
        out.append(p)
    return out


def unpack(grid: Grid, packed: Sequence[torch.Tensor],
           defaults: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sorted fields -> per-liquid; liquid particles outside the domain
    keep their ``defaults`` entry."""
    out = []
    for p, d in zip(packed, defaults):
        x = d.clone()
        x[..., grid.liq_src] = p[..., grid.liq_rows]
        out.append(x)
    return out
