"""X-slabs over ranks: the slab config, the slab's planes and ghost rows,
the communicator of one step, and the global-grid sharded steps (port of
``wcsph_tpu/parallel/halo.py``).

The grid's x-planes of cells are split into contiguous slabs, one a rank
(``slab_config`` pads the domain so that the planes divide evenly).  A
rank owns the particles whose cell lies in its planes.  Every neighbour
access is at most one x-plane away (a 27-cell window), so a rank needs one
ghost plane from each ring neighbour for one sweep: the particles of the
neighbour's boundary plane, its liquid ones sent anew each step
(``make_slab_comm``), its boundary ones fixed (``slab.slab_init``).  The
two-plane front (``slab.step_slab_direct``) takes two planes a side
(``SlabGeometry.ghost``), so that a fused kernel's second sweep reads only
rows its first sweep made exact (``comm.py``).

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
from .comm import DirectSlabComm, HaloPlan, SlabComm, Transport

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
    it owns x-planes [lo, hi), its ghost planes are [lo - ghost, lo) and
    [hi, hi + ghost) (none outside the domain); it sends its ``ghost``
    outermost own planes to each side."""

    cfg: SimConfig
    world: int
    rank: int
    ghost: int = 1

    def __post_init__(self):
        if self.cfg.grid_res[0] % self.world:
            raise ValueError(f"{self.cfg.grid_res[0]} x-planes do not divide "
                             f"among {self.world} ranks: use slab_config()")
        if self.ghost not in (1, 2):
            raise ValueError(f"{self.ghost} ghost planes: 1 or 2")
        if self.width < self.ghost:
            raise ValueError(f"slabs of {self.width} x-planes are thinner "
                             f"than {self.ghost} ghost planes: a ghost plane "
                             "must lie in the ring neighbour's slab")

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

    def edges(self, fx: torch.Tensor, lo) -> torch.Tensor:
        """(2, N) bool: each x-plane ``fx`` among the ``ghost`` first and
        among the ``ghost`` last planes of the slab that starts at ``lo``
        (a plane or an (N,) tensor of them): the planes sent left, right."""
        hi = lo + self.width
        return torch.stack([(fx >= lo) & (fx < lo + self.ghost),
                            (fx >= hi - self.ghost) & (fx < hi)])

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
    into its own, and the own ones' particle ids."""

    pos: torch.Tensor          # (3, n_own + n_left + n_right + 1)
    n_own: int
    n_ghost: tuple             # (from the left, from the right)
    send: tuple                # (int64 to the left, to the right)
    ids: torch.Tensor          # (n_own,) int64 particle ids of the own


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

    Returns (the ``SlabComm``, or at ``geo.ghost`` 2 the
    ``DirectSlabComm``, whose grid carries the status in ``checks``; (3,)
    int64 own rows, ghost rows and arrivals, on the device)."""
    ncap = pid.shape[0]
    kg = kghost
    dev = fields.device
    rank, world = geo.rank, geo.world
    pos = fields[0:3, :ncap]
    fx, inbox = geo.planes(pos)
    valid = pid >= 0
    sent = (valid & inbox) & geo.edges(fx, geo.lo)
    go_l, n_l = first_k(sent[0], kg)
    go_r, n_r = first_k(sent[1], kg)

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
    near = (px >= geo.lo - geo.ghost) & (px < geo.hi + geo.ghost)
    misplaced = (inside & torch.where(ghost, in_slab | ~near,
                                      ~in_slab)).sum()
    own = grid.liquid & (order < ncap)
    mig_need, seats, arrivals, jumped = migration
    local = torch.stack([torch.maximum(n_l, n_r), mig_need, seats,
                         misplaced + jumped, own.sum()]).to(torch.int64)
    status = SlabStatus(transport, grid, local, (kg, kmig, ncap))
    grid.checks = (status,)
    counts = torch.stack([valid.sum() + solids.n_own,
                          (inside & ghost).sum(), arrivals]).to(torch.int64)
    kind = DirectSlabComm if geo.ghost == 2 else SlabComm
    return kind(grid, cfg, own, plan, transport, status), counts


# ---------------------------------------------------------------------------
# The global-grid sharded steps (halo.py:87-291 of the JAX package)
# ---------------------------------------------------------------------------
#
# Every rank holds the whole FluidState on its device.  Each step re-splits
# it (``slab.resplit``: the particles of the rank's planes as seats, the
# liquid ones of its neighbours' boundary planes as ghosts through the
# ring, the boundary's from the state; no migration, since nothing is kept
# from one step to the next), bins them with the whole grid's cell ids and
# runs the solver's middle under the one-plane ``SlabComm``; the own
# seats' outputs are all-gathered back into particle order, so every rank
# ends the step with the same whole state.  The JAX functions take a packed
# grid and a mesh; these take the whole state, its config and a
# ``torch.distributed`` group (None: the default group).

def _whole_comm(state, cfg: SimConfig, group, solver: str):
    """(the split's ``SlabState``, its seat fields, the one-plane
    ``SlabComm`` of one step on the whole ``state``, the ``Transport``)."""
    from . import slab

    sst, fields, migration, tr, geo = slab.resplit(state, cfg, group,
                                                   solver)
    comm, _ = make_slab_comm(fields, sst.pid, sst.solids, cfg, tr, geo,
                             sst.kghost, 0, migration)
    return sst, fields, comm, tr


def density_sharded(state, cfg: SimConfig, group=None) -> torch.Tensor:
    """(N,) the SPH density of every particle of ``state`` (K5's density
    sweep, ``engine.density``) over the x-slabs, in particle order on every
    rank; 0 for a particle outside the domain (it has no row).  The
    counterpart of ``density_sharded`` (wcsph_tpu/parallel/halo.py:87-103),
    which returns the packed grid's densities."""
    from .. import engine

    sst, _, comm, tr = _whole_comm(state, cfg, group, "dfsph")
    grid = comm.grid
    rho, _ = engine.density(grid)
    # the particle id of each local column: the seats', -1 for the liquid
    # ghosts, the own boundary's, -1 for the boundary ghosts
    sol = sst.solids
    none = sst.pid.new_full((1,), -1).long()
    col_id = torch.cat([sst.pid.long(), none.expand(2 * sst.kghost),
                        sol.ids, none.expand(sol.pos.shape[1] - sol.n_own)])
    ids = col_id[grid.order]
    keep = (grid.cell < cfg.num_cells) & (ids >= 0)
    n = state.n_total
    out = torch.zeros(n + 1, dtype=torch.float32, device=rho.device)
    out.scatter_(0, torch.where(keep, ids, n), torch.where(keep, rho, 0.0))
    # each particle is an own row of one rank: the sum adds zeros to it
    return tr.all_reduce(out[:n])


def pressure_solve_sharded(state, cfg: SimConfig, group=None):
    """DFSPH's constant-density solve of ``state`` (its vel, kappa and
    dt) over the x-slabs, after the density sweep (density, alpha and the
    list): ((3, N_L) velocity, (N_L,) kappa, iterations, error), in
    particle order on every rank.  One halo exchange a neighbour-read
    input, an all-reduced error an iteration.  The counterpart of
    ``pressure_solve_sharded`` (wcsph_tpu/parallel/halo.py:106-131), which
    takes the packed grid, the packed fields and their alpha and rho."""
    from ..grid import pack, unpack
    from ..solvers import dfsph
    from . import slab

    sst, fields, comm, tr = _whole_comm(state, cfg, group, "dfsph")
    grid = comm.grid
    seat_vel, seat_k = slab._fields(fields, "vel"), slab._fields(fields,
                                                                 "kappa")
    velp, kp = pack(grid, [seat_vel, seat_k])
    rhop, alphap, _, _ = dfsph.density_and_list(grid, comm.lift(velp),
                                                sst.slots)
    rhop = comm.lift(rhop, 1.0)
    alphap = torch.where(grid.liquid, comm.lower(alphap), 0.0)
    pr = dfsph.pressure_solve(comm, velp, kp, alphap, rhop, state.dt)
    vel, kappa = unpack(grid, [pr.vel, pr.kappa], [seat_vel, seat_k])
    ncap = sst.ncap
    out = slab.gather_rows(tr, torch.cat([vel[:, :ncap], kappa[None, :ncap]]),
                           sst.pid, state.n_liquid)
    return out[:3], out[3], pr.iters, pr.err


def _step_sharded(state, cfg: SimConfig, group, solver: str):
    from . import slab

    return slab.step_resplit(state, cfg, group, solver)


def dfsph_step_sharded(state, cfg: SimConfig, group=None):
    """One DFSPH step of the whole ``state`` with its middle (density and
    alpha, divergence solve, viscosity PCG, vorticity, CFL, pressure
    solve) over the x-slabs, unfused; the new whole state on every rank
    (wcsph_tpu/parallel/halo.py:134-188)."""
    return _step_sharded(state, cfg, group, "dfsph")


def iisph_step_sharded(state, cfg: SimConfig, group=None):
    """One IISPH step with its middle (density, viscosity PCG, advection
    coefficients, relaxed-Jacobi loop, pressure force) over the x-slabs
    (wcsph_tpu/parallel/halo.py:191-228)."""
    return _step_sharded(state, cfg, group, "iisph")


def pcisph_step_sharded(state, cfg: SimConfig, group=None):
    """One PCISPH step with its prediction loop over the x-slabs
    (wcsph_tpu/parallel/halo.py:231-263)."""
    return _step_sharded(state, cfg, group, "pcisph")


def sesph_step_sharded(state, cfg: SimConfig, group=None):
    """One SESPH step with its sweeps over the x-slabs
    (wcsph_tpu/parallel/halo.py:266-291)."""
    return _step_sharded(state, cfg, group, "sesph")
