"""Slab-owned particles: per-slab binning, halo exchange and migration
(port of ``wcsph_tpu/parallel/slab.py``).

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


def slab_init(state: FluidState, cfg: SimConfig, group=None,
              solver: str = "dfsph", device="cuda") -> SlabState:
    """This rank's seats of ``state`` (every rank calls it with the same
    whole state): its liquid particles in id order, padded to a capacity
    common to all ranks (the fullest slab x ``SLACK``, a multiple of 8,
    as the JAX package's), and its boundary particles with their ghosts.
    Host-side work on the state, like the JAX package's; the seats go to
    ``device`` (the card unless the caller asks for the CPU).  For the
    non-DFSPH solvers ``kappa`` carries the pressure."""
    tr = Transport(group)
    geo = SlabGeometry(cfg, tr.world, tr.rank)
    nl, n = state.n_liquid, state.n_total
    pos = state.pos.detach().to("cpu", torch.float32)
    fx, inbox = geo.planes(pos)
    owner = geo.owner(fx)
    liq_owner = owner[:nl]
    counts = torch.bincount(liq_owner, minlength=tr.world)
    ncap = int(-8 * (-(int(counts.max()) * SLACK) // 8))
    mine = torch.nonzero(liq_owner == tr.rank)[:, 0]
    # the first ghost buffer: the fullest boundary plane of any slab
    edge = inbox[:nl]
    lo = liq_owner * geo.width
    planes = torch.stack([edge & (fx[:nl] == lo),
                          edge & (fx[:nl] == lo + geo.width - 1)])
    plane_counts = torch.zeros((2, tr.world), dtype=torch.int64)
    plane_counts.index_add_(1, liq_owner, planes.long())

    def seat(x, fill=0.0):
        x = x.detach().to("cpu", torch.float32)
        out = torch.full((*x.shape[:-1], ncap), fill, dtype=torch.float32)
        out[..., :len(mine)] = x[..., mine]
        return out

    kappa = state.kappa if solver == "dfsph" else state.pressure
    block = torch.cat([seat(pos[:, :nl], EMPTY_POS), seat(state.vel),
                       seat(state.omega), seat(state.vel_guess),
                       seat(kappa)[None], seat(state.kappa_v)[None]])
    block = block.to(device)
    pid = torch.full((ncap,), -1, dtype=torch.int32)
    pid[:len(mine)] = mine.to(torch.int32)

    # boundary particles (ids nl .. n - 1, in id order): own, ghosts, sent
    s_fx, s_in, s_owner = fx[nl:], inbox[nl:], owner[nl:]
    own = s_owner == tr.rank
    ghost_l = s_in & (s_fx == geo.lo - 1) & (tr.rank > 0)
    ghost_r = s_in & (s_fx == geo.hi) & (tr.rank < tr.world - 1)
    own_idx = torch.nonzero(own)[:, 0]
    own_fx, own_in = s_fx[own_idx], s_in[own_idx]
    spos = pos[:, nl:]
    solids = SlabSolids(
        pos=torch.cat([spos[:, own_idx], spos[:, ghost_l], spos[:, ghost_r],
                       torch.full((3, 1), EMPTY_POS)], dim=1).to(device),
        n_own=len(own_idx),
        n_ghost=(int(ghost_l.sum()), int(ghost_r.sum())),
        send=tuple(torch.nonzero(own_in & (own_fx == p))[:, 0].to(device)
                   for p in (geo.lo, geo.hi - 1)))
    return SlabState(
        pid=pid.to(device), **{k: _fields(block, k) for k in _ROWS},
        solids=solids, dt=state.dt, time=state.time,
        last_visc_iters=state.last_visc_iters,
        last_pressure_iters=state.last_pressure_iters, diag=state.diag,
        n_liquid=nl, n_total=n, kghost=buffer_size(int(plane_counts.max())),
        kmig=max(MIN_BUFFER, ncap // 16), slots=ListSlots())


def slab_gather(sst: SlabState, proto: FluidState, group=None,
                solver: str = "dfsph") -> FluidState:
    """The whole state in particle order, on every rank, on the seats'
    device: every rank's seats gathered (the liquid fields; every rank
    holds as many seats), the boundary positions and the fields no seat
    carries from ``proto``.  For the non-DFSPH solvers the ``kappa`` seats
    carry the pressure.  Raises unless every liquid particle holds exactly
    one seat."""
    tr = Transport(group)
    blk = torch.cat([sst.block().double(), sst.pid.double()[None]])
    every = tr.all_gather(blk).transpose(0, 1).reshape(_NROWS + 1, -1)
    pid = every[_NROWS].long()
    keep = pid >= 0
    rows = every[:_NROWS, keep].float()
    pid = pid[keep]
    nl = sst.n_liquid
    if pid.numel() != nl or torch.unique(pid).numel() != nl:
        raise RuntimeError(f"{pid.numel()} seated liquid particles "
                             f"({torch.unique(pid).numel()} ids) of {nl}")
    out = torch.empty((_NROWS, nl), dtype=torch.float32, device=rows.device)
    out[:, pid] = rows
    pos = proto.pos.clone()
    pos[:, :nl] = _fields(out, "pos").to(pos.device)
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
    middle, names = _MIDDLES[solver]
    fields, pid, migration = _migrate(sst, tr, geo, ncap, kghost, kmig)
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


def step_slab(sst: SlabState, cfg: SimConfig, comm_group=None,
              solver: str = "dfsph") -> SlabState:
    """One step of ``solver`` on this rank's slab (every rank of the group
    calls it).  A step whose buffers were short on any rank runs again
    from ``sst`` with the sizes it asked for (counted in ``replays``)."""
    tr = Transport(comm_group)
    geo = SlabGeometry(cfg, tr.world, tr.rank)
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
