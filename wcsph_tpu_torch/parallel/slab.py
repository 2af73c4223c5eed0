"""Slab-owned particles: per-slab binning, halo exchange and migration
(port of ``wcsph_tpu/parallel/slab.py``), on two fronts: one ghost plane a
side (``step_slab``), or two (``step_slab_direct``, the JAX package's
default multi-chip step, ``resident_slab.step_slab_direct``); and the
global-grid sharded steps' per-step split of a whole state
(``step_resplit``, ``halo.*_sharded``).

Each rank of a ``torch.distributed`` group owns the particles of its x-slab
(``halo.SlabGeometry``): liquid seats of a fixed capacity (``SlabState``,
``pid`` -1 for an empty seat, whose position lies outside the domain, so
that its row is inert), and its boundary particles, which never move
(``halo.SlabSolids``).  One step (``step_slab``), all of it on the rank's
device:

1. migration: the liquid seats whose cell left the slab at the last
   position update go to the ring neighbour that owns it (``kmig`` a side;
   movement per step is CFL-bounded, so only neighbours exchange, and a
   particle that passed a neighbour's slab is an error); the kept seats
   and the arrivals are sorted by particle id into ``ncap`` seats;
2. ghosts and the local grid (``halo.make_slab_comm``): the liquid seats
   of the neighbours' boundary planes arrive, and the bin sorts own and
   ghost rows with the whole grid's cell ids;
3. the solver's middle (``_MIDDLES``), the same function as on one card,
   under the slab's ``SlabComm``: the lifts refresh ghost rows, the sums
   and maxima are all-reduced, the loops take their unfused forms;
4. unpack and the position update of the own seats.

The two-plane front (``step_slab_direct``; ``slab_init(..., ghost=2)``)
runs the same step with two ghost planes a side under a
``DirectSlabComm``, on which DFSPH's divergence and pressure loops run K2
and K3 on the rank's local rows (the deep-halo argument is in
``comm.py``); SESPH, PCISPH, IISPH, the tension and the viscosity PCG take
their unfused forms, as under the JAX adapter.  Where the port differs
from the JAX front: JAX keeps each slab in a padded plane layout,
``[sentinel | g1 g2 | own | g2' g1' | sentinel]``, with its own local
grid origin, and refreshes whole planes; the port bins own and ghost rows
with the whole grid's cell ids into one sorted layout and exchanges only
the liquid ghost rows (its boundary ghosts are fixed at ``slab_init``).
The JAX front counts dropped particles as ``lost`` and keeps side buffers
for them; the port drops nothing (below).  A CFL-bounded move crosses at
most one slab, on both fronts.

Seats stay sorted by particle id, and ghosts arrive in their sender's seat
order, so within a cell the rows lie in particle order, as on one card:
an own row sums its neighbours in the single-device order, and only the
all-reduced sums round differently.

Nothing is dropped (the JAX package counts dropped arrivals): a ghost,
migration or seat buffer, or a rank's neighbour list, too short on any
rank raises ``halo.SlabOverflow`` at the step's first host read, on every
rank, and the step runs again from its inputs with larger buffers
(``SlabState.replays``).  The seat conventions are the JAX package's: for SESPH,
PCISPH and IISPH ``kappa`` carries the pressure, and ``vel_guess``
IISPH's viscosity warm start.  ``slab_init`` and ``slab_gather`` move a
whole ``FluidState`` in and out (every rank holds it; particle order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..grid import ListSlots, pack, unpack
from ..solvers import dfsph, iisph, pcisph, sesph
from ..solvers.common import vel_max
from ..state import FluidState, StepDiagnostics
from .comm import Transport
from .halo import (EMPTY_POS, MIN_BUFFER, SlabGeometry, SlabOverflow,
                   SlabSolids, buffer_size, first_k, make_slab_comm)

f32 = np.float32

SLACK = 1.35    # seats over the fullest slab's liquid at the start

_ROWS = {"pos": (0, 3), "vel": (3, 6), "omega": (6, 9),
         "vel_guess": (9, 12), "kappa": (12, 13), "kappa_v": (13, 14)}
_NROWS = 14     # the seat fields' rows; the particle id travels beside them
_EMPTY = [EMPTY_POS] * 3 + [0.0] * (_NROWS - 3)
_NO_PID = torch.iinfo(torch.int32).max    # an empty seat's sort key


@dataclasses.dataclass
class SlabState:
    """One rank's particles: ``ncap`` liquid seats in particle-id order
    (empty seats, ``pid`` -1, last), its boundary particles, the step's
    scalars (the same on every rank) and its buffers' sizes."""

    pid: torch.Tensor          # (ncap,) int32 global particle id, -1 empty
    pos: torch.Tensor          # (3, ncap)
    vel: torch.Tensor          # (3, ncap)
    omega: torch.Tensor        # (3, ncap)
    vel_guess: torch.Tensor    # (3, ncap)
    kappa: torch.Tensor        # (ncap,) DFSPH kappa, else the pressure
    kappa_v: torch.Tensor      # (ncap,)
    solids: SlabSolids
    dt: np.float32
    time: np.float32
    last_visc_iters: int
    last_pressure_iters: int
    diag: StepDiagnostics
    n_liquid: int              # liquid particles of the whole state
    n_total: int
    kghost: int                # liquid ghosts a side
    kmig: int                  # migrants a side
    slots: ListSlots           # the rank's neighbour-list buffer
    ghost: int = 1             # ghost planes a side (2: step_slab_direct)
    replays: int = 0           # steps run again with larger buffers
    counts: torch.Tensor | None = None   # (3,) own rows, ghost rows and
                                         # arrivals of the last step

    @property
    def ncap(self) -> int:
        return int(self.pid.shape[0])

    def block(self) -> torch.Tensor:
        """(14, ncap) the seat fields stacked in ``_ROWS`` order."""
        return torch.cat([self.pos, self.vel, self.omega, self.vel_guess,
                          self.kappa[None], self.kappa_v[None]])


def _fields(block: torch.Tensor, name: str) -> torch.Tensor:
    a, b = _ROWS[name]
    return block[a:b] if b - a > 1 else block[a]


def _split(state: FluidState, tr: Transport, geo: SlabGeometry,
           solver: str, work, device, slack: float):
    """This rank's share of the whole ``state`` (every rank holds it),
    worked out on the device ``work`` and put on ``device``: ((14, ncap)
    seat block, (ncap,) int32 ids, ``SlabSolids``, the first ghost buffer).
    Its liquid particles in id order, padded to a capacity common to all
    ranks (the fullest slab x ``slack``, a multiple of 8, as the JAX
    package's), and its boundary particles with the ghosts of
    ``geo.ghost`` planes a side.  One host read brings every size.  For
    the non-DFSPH solvers ``kappa`` carries the pressure."""
    nl = state.n_liquid
    pos = state.pos.detach().to(work, torch.float32)
    fx, inbox = geo.planes(pos)
    owner = geo.owner(fx)
    liq_owner = owner[:nl]
    counts = torch.bincount(liq_owner, minlength=tr.world)
    # the first ghost buffer: the fullest pair of boundary planes of any
    # slab
    sent = inbox[:nl] & geo.edges(fx[:nl], liq_owner * geo.width)
    plane_counts = torch.zeros((2, tr.world), dtype=torch.int64,
                               device=pos.device)
    plane_counts.index_add_(1, liq_owner, sent.long())
    # boundary particles (ids nl .. n - 1, in id order): own, ghosts, sent
    s_fx, s_in, s_owner = fx[nl:], inbox[nl:], owner[nl:]
    own = s_owner == tr.rank
    ghost_l = (s_in & (s_fx >= geo.lo - geo.ghost) & (s_fx < geo.lo)
               & (tr.rank > 0))
    ghost_r = (s_in & (s_fx >= geo.hi) & (s_fx < geo.hi + geo.ghost)
               & (tr.rank < tr.world - 1))
    send = own & s_in & geo.edges(s_fx, geo.lo)
    mine = liq_owner == tr.rank
    masks = (mine, own, ghost_l, ghost_r, send[0], send[1])
    top, pmax, *sizes = torch.stack(
        [counts.max(), plane_counts.max(), *(m.sum() for m in masks)]
    ).tolist()
    ncap = int(-8 * (-(top * slack) // 8))
    mine, own, ghost_l, ghost_r, send_l, send_r = (
        first_k(m, k)[0] for m, k in zip(masks, [ncap, *sizes[1:]]))
    seated = torch.arange(ncap, device=pos.device) < sizes[0]

    def seat(x, fill=0.0):
        x = x.detach().to(work, torch.float32)
        return torch.where(seated, x[..., mine], fill)

    kappa = state.kappa if solver == "dfsph" else state.pressure
    block = torch.cat([seat(pos[:, :nl], EMPTY_POS), seat(state.vel),
                       seat(state.omega), seat(state.vel_guess),
                       seat(kappa)[None], seat(state.kappa_v)[None]])
    pid = torch.where(seated, mine, -1).to(torch.int32)
    own_rank = torch.cumsum(s_owner == tr.rank, 0) - 1
    spos = pos[:, nl:]
    solids = SlabSolids(
        pos=torch.cat([spos[:, own], spos[:, ghost_l], spos[:, ghost_r],
                       torch.full((3, 1), EMPTY_POS, device=pos.device)],
                      dim=1).to(device),
        n_own=sizes[1], n_ghost=(sizes[2], sizes[3]),
        send=tuple(own_rank[idx].to(device) for idx in (send_l, send_r)),
        ids=(nl + own).to(device))
    return block.to(device), pid.to(device), solids, buffer_size(pmax)


def slab_init(state: FluidState, cfg: SimConfig, group=None,
              solver: str = "dfsph", device="cuda",
              ghost: int = 1) -> SlabState:
    """This rank's seats of ``state`` (every rank calls it with the same
    whole state; ``_split`` at ``SLACK``), with ``ghost`` ghost planes a
    side (2 for ``step_slab_direct``).  Host-side work on the state, like
    the JAX package's; the seats go to ``device`` (the card unless the
    caller asks for the CPU)."""
    tr = Transport(group)
    geo = SlabGeometry(cfg, tr.world, tr.rank, ghost)
    block, pid, solids, kghost = _split(state, tr, geo, solver, "cpu",
                                        device, SLACK)
    return SlabState(
        pid=pid, **{k: _fields(block, k) for k in _ROWS},
        solids=solids, dt=state.dt, time=state.time,
        last_visc_iters=state.last_visc_iters,
        last_pressure_iters=state.last_pressure_iters, diag=state.diag,
        n_liquid=state.n_liquid, n_total=state.n_total, kghost=kghost,
        kmig=max(MIN_BUFFER, pid.shape[0] // 16), slots=ListSlots(),
        ghost=ghost)


def gather_rows(tr: Transport, rows: torch.Tensor, pid: torch.Tensor,
                nl: int) -> torch.Tensor:
    """(K, nl) in particle order, on every rank, from every rank's seat
    rows (K, ncap) with ids ``pid`` (-1 empty; every rank holds as many
    seats).  The rows travel as float64 beside the ids (exact).  Raises
    unless every liquid particle holds exactly one seat."""
    k = rows.shape[0]
    blk = torch.cat([rows.double(), pid.double()[None]])
    every = tr.all_gather(blk).transpose(0, 1).reshape(k + 1, -1)
    ids = every[k].long()
    keep = ids >= 0
    got = every[:k, keep].float()
    ids = ids[keep]
    if ids.numel() != nl or torch.unique(ids).numel() != nl:
        raise RuntimeError(f"{ids.numel()} seated liquid particles "
                           f"({torch.unique(ids).numel()} ids) of {nl}")
    out = torch.empty((k, nl), dtype=torch.float32, device=got.device)
    out[:, ids] = got
    return out


def slab_gather(sst: SlabState, proto: FluidState, group=None,
                solver: str = "dfsph") -> FluidState:
    """The whole state in particle order, on every rank, on the seats'
    device: every rank's seats gathered (``gather_rows``), the boundary
    positions and the fields no seat carries from ``proto``.  For the
    non-DFSPH solvers the ``kappa`` seats carry the pressure."""
    out = gather_rows(Transport(group), sst.block(), sst.pid, sst.n_liquid)
    pos = proto.pos.clone()
    pos[:, :sst.n_liquid] = _fields(out, "pos").to(pos.device)
    seated = ("vel", "omega", "vel_guess") + (
        ("kappa", "kappa_v") if solver == "dfsph" else ())
    named = {k: _fields(out, k).to(proto.vel.device) for k in seated}
    if solver != "dfsph":
        named["pressure"] = _fields(out, "kappa").to(proto.vel.device)
    return proto.replace(
        pos=pos, **named, dt=sst.dt, time=sst.time,
        last_visc_iters=sst.last_visc_iters,
        last_pressure_iters=sst.last_pressure_iters, diag=sst.diag)


def _migrate(sst: SlabState, tr: Transport, geo: SlabGeometry, ncap: int,
             kghost: int, kmig: int):
    """The seats after migration: ((14, ncap + 2 kghost) fields, the seats
    then empty ghost columns; (ncap,) int32 ids, ascending, -1 empty;
    (most migrants a side, seats needed, arrivals, seats past a neighbour's
    slab) on the device).  Migrants travel as float64 columns, the
    particle id in the last row (exact)."""
    blk = sst.block()
    pid = sst.pid
    dev = blk.device
    valid = pid >= 0
    fx, _ = geo.planes(blk[0:3])
    owner = geo.owner(fx)
    rank, world = geo.rank, geo.world
    go_l = valid & (owner < rank)
    go_r = valid & (owner > rank)
    jumped = (valid & ((owner < rank - 1) | (owner > rank + 1))).sum()
    empty = torch.tensor(_EMPTY + [-1.0], dtype=torch.float64,
                         device=dev)[:, None]

    def payload(go):
        idx, n = first_k(go, kmig)
        cols = torch.cat([blk[:, idx].double(), pid[idx].double()[None]])
        return torch.where(torch.arange(kmig, device=dev) < n, cols,
                           empty), n

    pay_l, n_l = payload(go_l)
    pay_r, n_r = payload(go_r)
    from_l, from_r = tr.ring(pay_l if rank > 0 else None,
                             pay_r if rank < world - 1 else None,
                             kmig if rank > 0 else 0,
                             kmig if rank < world - 1 else 0)
    gone = go_l | go_r
    stay = torch.where(gone[None], empty[:_NROWS].float(), blk)
    arrived = [a for a in (from_l, from_r) if a is not None]
    arr = torch.cat(arrived, dim=1) if arrived else empty[:, :0]
    cand = torch.cat([stay, arr[:_NROWS].float(),
                      empty[:_NROWS].float()], dim=1)
    cand_pid = torch.cat([torch.where(gone, -1, pid),
                          arr[_NROWS].to(torch.int32),
                          pid.new_full((1,), -1)])
    key = torch.where(cand_pid >= 0, cand_pid, _NO_PID)
    _, order = torch.sort(key, stable=True)
    take = min(ncap, order.shape[0])
    idx = torch.full((ncap + 2 * kghost,), cand.shape[1] - 1,
                     dtype=torch.int64, device=dev)
    idx[:take] = order[:take]
    fields = cand[:, idx]
    new_pid = cand_pid[idx[:ncap]]
    seats = (cand_pid >= 0).sum()
    arrivals = (arr[_NROWS] >= 0).sum()
    return fields, new_pid, (torch.maximum(n_l, n_r), seats, arrivals,
                             jumped)


def _mid_dfsph(comm, cfg, f, sst):
    m = dfsph.step_middle(comm, cfg, f["vel"], f["omega"], f["vel_guess"],
                          f["kappa"], f["kappa_v"], sst.dt,
                          sst.last_pressure_iters, sst.slots)
    return ({"vel": m.vel, "omega": m.omega, "vel_guess": m.vel_guess,
             "kappa": m.kappa, "kappa_v": m.kappa_v}, m.new_dt,
            (m.div_iters, m.pr_iters, m.visc_iters, m.err, m.err_pre),
            f32(np.sqrt(m.vmax_sq)))


def _mid_iisph(comm, cfg, f, sst):
    m = iisph.step_middle(comm, cfg, f["vel"], f["vel_guess"], f["kappa"],
                          sst.dt, sst.slots)
    return ({"vel": m.vel, "vel_guess": m.delta_v, "kappa": m.pressure},
            sst.dt, (0, m.iters, m.visc_iters, m.err, m.err_pre),
            vel_max(comm, m.vel))


def _mid_pcisph(comm, cfg, f, sst):
    m = pcisph.step_middle(comm, cfg, f["vel"], sst.dt, sst.slots)
    return ({"vel": m.vel, "kappa": m.pressure}, sst.dt,
            (0, m.iters, 0, m.err, m.err_pre), vel_max(comm, m.vel))


def _mid_sesph(comm, cfg, f, sst):
    vel, rhop, pp = sesph.step_middle(comm, cfg, f["vel"], sst.dt)
    err = sesph.density_error(comm, cfg, rhop)
    return ({"vel": vel, "kappa": pp}, sst.dt, (0, 0, 0, err, f32(0.0)),
            vel_max(comm, vel))


# solver -> (its middle, the seat fields it packs)
_MIDDLES = {
    "dfsph": (_mid_dfsph, ("vel", "omega", "vel_guess", "kappa",
                           "kappa_v")),
    "iisph": (_mid_iisph, ("vel", "vel_guess", "kappa")),
    "pcisph": (_mid_pcisph, ("vel",)),
    "sesph": (_mid_sesph, ("vel",)),
}


def _step(sst: SlabState, cfg: SimConfig, tr: Transport, geo: SlabGeometry,
          solver: str, ncap: int, kghost: int, kmig: int,
          replays: int) -> SlabState:
    fields, pid, migration = _migrate(sst, tr, geo, ncap, kghost, kmig)
    return _solve(sst, cfg, tr, geo, solver, fields, pid, migration,
                  kghost, kmig, replays)


def _solve(sst: SlabState, cfg: SimConfig, tr: Transport,
           geo: SlabGeometry, solver: str, fields, pid, migration,
           kghost: int, kmig: int, replays: int) -> SlabState:
    """Steps 2-4 on the seats ``fields``, ``pid`` (``_migrate``'s)."""
    middle, names = _MIDDLES[solver]
    ncap = pid.shape[0]
    comm, counts = make_slab_comm(fields, pid, sst.solids, cfg, tr, geo,
                                  kghost, kmig, migration)
    grid = comm.grid
    packed = dict(zip(names, pack(grid, [_fields(fields, k)
                                         for k in names])))
    upd, new_dt, (dv_it, pr_it, vs_it, err, err_pre), vmax = middle(
        comm, cfg, packed, sst)
    out = dict(zip(upd, unpack(grid, list(upd.values()),
                               [_fields(fields, k) for k in upd])))
    seat = {k: (out[k] if k in out else _fields(fields, k))[..., :ncap]
            for k in _ROWS if k != "pos"}
    pos = _fields(fields, "pos")[:, :ncap] + seat["vel"] * float(new_dt)
    diag = StepDiagnostics(
        divergence_iters=dv_it, pressure_iters=pr_it, viscosity_iters=vs_it,
        density_error=f32(err), density_error_pre=f32(err_pre),
        neighbor_overflow=0, vel_max=vmax)
    return dataclasses.replace(
        sst, pid=pid, pos=pos, **seat, dt=f32(new_dt),
        time=f32(sst.time + new_dt),
        last_visc_iters=vs_it if solver == "dfsph" else sst.last_visc_iters,
        last_pressure_iters=(pr_it if solver == "dfsph"
                             else sst.last_pressure_iters),
        diag=diag, kghost=kghost, kmig=kmig, replays=replays, counts=counts)


def _front(sst: SlabState, cfg: SimConfig, comm_group, solver: str,
           ghost: int) -> SlabState:
    """One step at ``ghost`` ghost planes a side; a step whose buffers
    were short on any rank runs again from ``sst`` with the sizes it asked
    for (counted in ``replays``)."""
    if sst.ghost != ghost:
        raise ValueError(f"a state seated with {sst.ghost} ghost plane(s) "
                         f"a side, stepped on the {ghost}-plane front: "
                         f"slab_init(..., ghost={ghost})")
    tr = Transport(comm_group)
    geo = SlabGeometry(cfg, tr.world, tr.rank, ghost)
    ncap, kghost, kmig = sst.ncap, sst.kghost, sst.kmig
    replays = sst.replays
    while True:
        try:
            return _step(sst, cfg, tr, geo, solver, ncap, kghost, kmig,
                         replays)
        except SlabOverflow as e:
            replays += 1
            if e.ghost > kghost:
                kghost = buffer_size(e.ghost)
            if e.mig > kmig:
                kmig = buffer_size(e.mig)
            if e.seats > ncap:
                ncap = -8 * (-buffer_size(e.seats) // 8)
            if e.list_need > (sst.slots.capacity or 0):
                sst.slots.size_for(e.list_need)


def step_slab(sst: SlabState, cfg: SimConfig, comm_group=None,
              solver: str = "dfsph") -> SlabState:
    """One step of ``solver`` on this rank's slab, one ghost plane a side
    (every rank of the group calls it); every loop runs unfused."""
    return _front(sst, cfg, comm_group, solver, 1)


def step_slab_direct(sst: SlabState, cfg: SimConfig, comm_group=None,
                     solver: str = "dfsph") -> SlabState:
    """One step of ``solver`` on this rank's slab, two ghost planes a side
    (``slab_init(..., ghost=2)``), under the ``DirectSlabComm``: DFSPH's
    divergence and pressure loops run K2 and K3, every other loop unfused
    (the counterpart of ``resident_slab.step_slab_direct``,
    ``wcsph_tpu/parallel/resident_slab.py:905-1027``)."""
    return _front(sst, cfg, comm_group, solver, 2)


def resplit(state: FluidState, cfg: SimConfig, group=None,
            solver: str = "dfsph"):
    """The global-grid sharded steps' split of the whole ``state`` (every
    rank holds it, on its device), anew for one step and on that device:
    (this rank's ``SlabState`` at one ghost plane, with seats for exactly
    the fullest slab and a fresh list buffer, for PCISPH one of no slots:
    nothing keeps it to the next step, so the unfused prediction keeps no
    hits rather than take a host read to size them, and its walk scans
    every row again, the cut's bits; (14, ncap + 2 kghost) seat
    fields with empty ghost columns; the migration's counts, all 0: no
    seat moves; the ``Transport``; the ``SlabGeometry``)."""
    tr = Transport(group)
    geo = SlabGeometry(cfg, tr.world, tr.rank)
    dev = state.pos.device
    block, pid, solids, kghost = _split(state, tr, geo, solver, dev, dev,
                                        1.0)
    sst = SlabState(
        pid=pid, **{k: _fields(block, k) for k in _ROWS}, solids=solids,
        dt=state.dt, time=state.time, last_visc_iters=state.last_visc_iters,
        last_pressure_iters=state.last_pressure_iters, diag=state.diag,
        n_liquid=state.n_liquid, n_total=state.n_total, kghost=kghost,
        kmig=0, slots=ListSlots(0) if solver == "pcisph" else ListSlots())
    empty = torch.tensor(_EMPTY, dtype=torch.float32, device=dev)[:, None]
    fields = torch.cat([block, empty.expand(-1, 2 * kghost)], dim=1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return sst, fields, (zero,) * 4, tr, geo


def step_resplit(state: FluidState, cfg: SimConfig, group=None,
                 solver: str = "dfsph") -> FluidState:
    """One step of ``solver`` on the whole ``state`` (``resplit``), its
    middle under the one-plane ``SlabComm``; the own seats' outputs and
    positions gathered back into particle order, the same on every
    rank."""
    sst, fields, migration, tr, geo = resplit(state, cfg, group, solver)
    out = _solve(sst, cfg, tr, geo, solver, fields, sst.pid, migration,
                 sst.kghost, 0, 0)
    return slab_gather(out, state, group, solver)
