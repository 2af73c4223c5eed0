"""X-slabs over ranks: the slab config, the slab's planes and ghost rows,
and the communicator of one step (port of what the slab step needs from
``wcsph_tpu/parallel/halo.py``).

The grid's x-planes of cells are split into contiguous slabs, one a rank
(``slab_config`` pads the domain so that the planes divide evenly).  A
rank owns the particles whose cell lies in its planes.  Every neighbour
access is at most one x-plane away (a 27-cell window), so a rank needs one
ghost plane from each ring neighbour: the particles of the neighbour's
boundary plane, its liquid ones sent anew each step (``make_slab_comm``),
its boundary ones fixed (``slab.slab_init``).

The rank's local grid bins its own rows and its ghost rows with the
single-device grid's cell ids (``grid_res``, ``domain_min``): the cells, the
outside test and the sorted order within a cell round exactly as on one
card, so an own row sees the same neighbours in the same order.  So the
JAX package's local and extended configs (``halo._ext_cfg``,
``slab._local_cfg``, which rebase the x-origin of a slab) reduce here to
plane ranges (``SlabGeometry``); the extended grid's cell range is the
whole grid's, of which only the slab's planes and its two ghost planes
hold rows.

Buffers are of fixed size, so that a steady step reads nothing back for
them: ``kghost`` liquid ghosts a side and, in ``slab.py``, ``kmig``
migrants a side and ``ncap`` seats.  A step whose particles would not fit
flags it on the device; the flags, all-reduced, ride on the step's first
host read (``Grid.read``, ``SlabStatus``), which raises ``SlabOverflow``,
and the step runs again with larger buffers (``slab.step_slab``).  Nothing
is dropped.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import SimConfig
from ..grid import HEADROOM, build_grid
from .comm import HaloPlan, SlabComm, Transport

EMPTY_POS = 1.0e9     # the position of an empty seat: outside the domain
MIN_BUFFER = 64       # the least size of a ghost or migration buffer


def slab_config(cfg: SimConfig, n: int) -> SimConfig:
    """Pad the domain so that the grid's x-planes divide among n ranks."""
    gx = cfg.grid_res[0]
    pad_planes = (-gx) % n
    if pad_planes == 0:
        return cfg
    new_max = (cfg.domain_max[0] + pad_planes * cfg.cell_size,
               cfg.domain_max[1], cfg.domain_max[2])
    out = dataclasses.replace(cfg, domain_max=new_max)
    assert out.grid_res[0] % n == 0, (out.grid_res, n)
    return out


def buffer_size(need: int) -> int:
    """A buffer for ``need`` entries with the list's headroom."""
    return max(MIN_BUFFER, math.ceil(need * HEADROOM))


@dataclasses.dataclass(frozen=True)
class SlabGeometry:
    """Rank ``rank``'s planes of the grid of ``cfg`` over ``world`` ranks:
    it owns x-planes [lo, hi), its ghost planes are lo - 1 and hi (none at
    the domain's edges)."""

    cfg: SimConfig
    world: int
    rank: int

    def __post_init__(self):
        if self.cfg.grid_res[0] % self.world:
            raise ValueError(f"{self.cfg.grid_res[0]} x-planes do not divide "
                             f"among {self.world} ranks: use slab_config()")

    @property
    def width(self) -> int:
        return self.cfg.grid_res[0] // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.width

    @property
    def hi(self) -> int:
        return self.lo + self.width

    @property
    def plane(self) -> int:
        """Cells per x-plane."""
        return self.cfg.grid_res[1] * self.cfg.grid_res[2]

    def planes(self, pos: torch.Tensor):
        """((N,) float x-plane of each planar position (3, N), (N,) bool
        inside the domain), with the bin's float32 arithmetic
        (``dense_ops.cell_keys``): floor((pos - dmin) * float32(1 / h))."""
        cfg = self.cfg
        dev = pos.device
        dmin = torch.tensor(cfg.domain_min, dtype=torch.float32, device=dev)
        inv = torch.tensor(np.float32(1.0 / cfg.cell_size), device=dev)
        f = torch.floor((pos - dmin[:, None]) * inv)
        res = torch.tensor(cfg.grid_res, dtype=torch.float32, device=dev)
        inbox = ((f >= 0.0) & (f < res[:, None])).all(0)
        return f[0], inbox

    def owner(self, fx: torch.Tensor) -> torch.Tensor:
        """(N,) int64 owning rank of each x-plane (clamped into the grid: a
        particle outside the domain belongs to the slab nearest to it; a
        NaN position stays with this rank)."""
        fx = torch.nan_to_num(fx, nan=float(self.lo))
        fx = torch.clamp(fx, 0.0, float(self.cfg.grid_res[0] - 1))
        return torch.div(fx, self.width, rounding_mode="floor").long()


@dataclasses.dataclass
class SlabSolids:
    """A rank's boundary particles, which never move: its own, then the
    ghosts of its neighbours' boundary planes (left, right), then one
    empty position (the local grid's last row, where empty ghost entries
    land), as one planar block; with the own ones it sends, as indices
    into its own."""

    pos: torch.Tensor          # (3, n_own + n_left + n_right + 1)
    n_own: int
    n_ghost: tuple             # (from the left, from the right)
    send: tuple                # (int64 to the left, to the right)


def first_k(mask: torch.Tensor, k: int):
    """((k,) int64 indices of the first k True entries of ``mask`` in
    order, 0 past their count; () int64 their count, all of them, on the
    device: no host read."""
    csum = torch.cumsum(mask.to(torch.int64), 0)
    slot = torch.where(mask & (csum <= k), csum - 1, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    count = csum[-1] if mask.shape[0] else csum.new_zeros(())
    return idx[:k], count


class SlabOverflow(Exception):
    """A buffer of the step (ghosts, migrants, seats, or a rank's
    neighbour list) was short on some rank; every rank raises at the same
    read, and the step runs again with the sizes it needs."""

    def __init__(self, ghost: int, mig: int, seats: int, list_need: int):
        super().__init__(f"slab buffers short: {ghost} ghosts, {mig} "
                         f"migrants a side, {seats} seats, list {list_need}")
        self.ghost, self.mig, self.seats = ghost, mig, seats
        self.list_need = list_need


class SlabStatus:
    """A slab step's exchange status, checked at its first host read
    (``Grid.read``) before the list's: the most ghosts, migrants a side
    and seats any rank needed, the particles in the wrong slab or moved
    past a neighbour's (none may be), whether any rank's list was short or
    flagged, and the ranks' own liquid rows summed.  The all-gather runs
    when the read asks for the status (every rank at the same read); the
    check raises on every rank alike."""

    def __init__(self, transport: Transport, grid, local, sizes):
        self._tr = transport
        self._grid = grid
        self._local = local     # [ghosts, migrants, seats, bad, own liquid]
        self._sizes = sizes     # (kghost, kmig, ncap)
        self._status = None
        self.checked = False
        self.n_liquid = None

    @property
    def status(self):
        if self._status is None:
            nbr = self._grid.nbr
            zero = self._local[0].new_zeros(())
            over = zero if nbr is None else (nbr.need > nbr.capacity)
            # a short list flags too; a flag with room is a count below
            # the pairs within h
            flag = zero if nbr is None else (nbr.flag != 0) & ~over
            own = torch.stack([*self._local[:4], over.to(torch.int64),
                               flag.to(torch.int64), self._local[4]])
            every = self._tr.all_gather(own)
            self._status = [*every[:, :6].amax(0), every[:, 6].sum(),
                            zero if nbr is None else nbr.need]
        return self._status

    def check(self, ghost, mig, seats, bad, list_over, list_flag, n_liquid,
              list_need):
        self.checked = True
        self.n_liquid = n_liquid
        if bad or list_flag:
            raise ValueError(f"slab step: {bad} particles in the wrong slab "
                             "or past a neighbour's, or a neighbour count "
                             f"below the pairs within h (flag {list_flag})")
        kghost, kmig, ncap = self._sizes
        if ghost > kghost or mig > kmig or seats > ncap or list_over:
            raise SlabOverflow(ghost, mig, seats, list_need)


def make_slab_comm(fields: torch.Tensor, pid: torch.Tensor,
                   solids: SlabSolids, cfg: SimConfig, transport: Transport,
                   geo: SlabGeometry, kghost: int, kmig: int, migration):
    """The counterpart of the JAX package's ``_make_slab_comm``: one step's
    local grid and its communicator.

    ``fields`` (14, ncap + 2 kghost) holds the rank's liquid seats (pid
    ``pid``, ascending, -1 empty) and, after them, kghost ghost columns from
    each side, whose positions (rows 0-2) are written here: the liquid
    seats of the neighbours' boundary planes, in their seat order.  The
    local particles are those liquid columns (liquid), then ``solids``; the
    bin sorts them with the whole grid's cell ids.  ``migration`` holds
    the migration's device counts (most migrants a side, seats needed,
    arrivals, particles moved past a neighbour's slab), stacked into the
    step's status.

    Returns (the ``SlabComm``, whose grid carries the status in ``checks``;
    (3,) int64 own rows, ghost rows and arrivals, on the device)."""
    ncap = pid.shape[0]
    kg = kghost
    dev = fields.device
    rank, world = geo.rank, geo.world
    pos = fields[0:3, :ncap]
    fx, inbox = geo.planes(pos)
    valid = pid >= 0
    edge = valid & inbox
    go_l, n_l = first_k(edge & (fx == geo.lo), kg)
    go_r, n_r = first_k(edge & (fx == geo.hi - 1), kg)

    def payload(idx, n):
        return torch.where(torch.arange(kg, device=dev) < n,
                           pos[:, idx], EMPTY_POS)

    left, right = transport.ring(
        payload(go_l, n_l) if rank > 0 else None,
        payload(go_r, n_r) if rank < world - 1 else None,
        kg if rank > 0 else 0, kg if rank < world - 1 else 0)
    for k, got in enumerate((left, right)):
        fields[0:3, ncap + k * kg: ncap + (k + 1) * kg] = (
            EMPTY_POS if got is None else got)

    n_liq = ncap + 2 * kg
    grid = build_grid(torch.cat([fields[0:3], solids.pos], dim=1), n_liq,
                      cfg)
    m = grid.n
    rows = torch.where(grid.row_of >= 0, grid.row_of, m - 1).long()
    base = n_liq                         # the first own boundary particle
    g_base = base + solids.n_own         # the first ghost boundary particle
    gl, gr = solids.n_ghost
    ar = torch.arange(kg, device=dev)
    send = [torch.cat([go, base + s]) for go, s in zip(
        (go_l, go_r), solids.send)]
    recv = [torch.cat([ncap + ar, g_base + torch.arange(gl, device=dev)]),
            torch.cat([ncap + kg + ar,
                       g_base + gl + torch.arange(gr, device=dev)])]
    sides = [rank > 0, rank < world - 1]
    send_rows = torch.cat([rows[s] for s, on in zip(send, sides) if on]
                          or [rows[:0]])
    recv_idx = torch.cat([r for r, on in zip(recv, sides) if on]
                         or [rows[:0]])
    order = grid.order
    ghost = (((order >= ncap) & (order < base)) | (order >= g_base))
    plan = HaloPlan(
        send_rows=send_rows, recv_rows=rows[recv_idx],
        recv_empty=grid.row_of[recv_idx] < 0,
        n_send=tuple(len(s) if on else 0 for s, on in zip(send, sides)),
        n_recv=tuple(len(r) if on else 0 for r, on in zip(recv, sides)),
        ghost=ghost)

    # every row inside the domain must lie in the slab's planes (own) or
    # in its ghost planes (ghost): the bin's cells and ``planes`` agree
    px = torch.div(grid.cell, geo.plane, rounding_mode="floor")
    inside = px < geo.cfg.grid_res[0]
    in_slab = (px >= geo.lo) & (px < geo.hi)
    misplaced = (inside & (ghost == in_slab)).sum()
    own = grid.liquid & (order < ncap)
    mig_need, seats, arrivals, jumped = migration
    local = torch.stack([torch.maximum(n_l, n_r), mig_need, seats,
                         misplaced + jumped, own.sum()]).to(torch.int64)
    status = SlabStatus(transport, grid, local, (kg, kmig, ncap))
    grid.checks = (status,)
    counts = torch.stack([valid.sum() + solids.n_own,
                          (inside & ghost).sum(), arrivals]).to(torch.int64)
    return SlabComm(grid, cfg, own, plan, transport, status), counts
