"""Communicators: the same solver code runs on one card or on x-slabs.

Port of ``wcsph_tpu/parallel/comm.py``.  The solvers (``solvers/*.py``,
``viscosity.py``) call the engine through a communicator:

* ``comm.grid`` / ``comm.cfg``: the grid the sweeps run on (the whole grid
  on one card; on a slab, the rank's own rows plus its ghost rows);
* ``comm.lift(q, fill)``: make a sorted field right at the ghost rows
  before a sweep reads it at a neighbour (identity / a halo exchange);
* ``comm.lower(q)``: a sweep's output at the own rows only (identity /
  the ghost rows set to 0 / identity on two ghost planes);
* ``comm.fused``, ``comm.fused_kappa_drho``, ``comm.fused_iter_full``: the
  fused loops it runs, and K2 and K3 with the exchanges they need;
* ``comm.lsum`` / ``comm.lmax``: sums and maxima over the own liquid rows,
  on the device (plain / then ``all_reduce``);
* ``comm.read(x, *more)``: the step's host reads (``Grid.read``: the first
  one brings the liquid count and every status flag of the step);
* ``comm.n_liquid``: the liquid particles inside the domain, all ranks'.

Why one ghost plane is enough.  The port's sweeps are gather-form: one
thread per receiver sums over its neighbours and writes only its own row,
with no Newton mirror write.  A receiver's neighbours lie in its 27-cell
window, at most one x-plane of cells away, so an own row's output is exact
once every input the sweep reads at a neighbour is right on the ghost
plane: that is what ``lift`` guarantees.  A ghost row's window is cut off
at the slab's edge, so its outputs are wrong, and ``lower`` drops them.  The
JAX package needs the longer argument of its mirror sweeps (a pair across
the boundary is recomputed by the neighbour through its halo rows); the
port has no mirror term to argue about.

The slab path keeps the sweeps' inputs as the whole local grid, own and
ghost rows in one sorted layout, so a lift writes the ghost rows in place
and a lower masks them; nothing is sliced.  Counts are read only at the
receiver (``torch.where(count < ..., ...)``), so they are never lifted.

A ``Transport`` carries the slab path's messages over a
``torch.distributed`` process group, ring neighbours only:

* ``nccl``: one rank per card, device buffers;
* ``gloo``: CPU ranks (the tests), and ranks that share one card
  (``chip_smoke.py``); ``ProcessGroupGloo`` has no send or receive of CUDA
  tensors, so every message is staged through host memory.

The caller picks the backend when it creates the group; an init that fails
raises, and nothing falls back to the other backend.

Which loops run fused (``engine.use_fused_iters(comm, method)``, the JAX
engine's test of whether the communicator's engine carries ``method``):
each communicator carries a ``fused`` set of the JAX engine's method names.
``NoComm`` carries all six; the one-plane ``SlabComm`` none (no exchange
can run between a fused kernel's two stencils); the two-plane
``DirectSlabComm`` the two of DFSPH's loops, ``fused_kappa_drho`` (K2) and
``fused_iter_full`` (K3), as the JAX package's ``SlabPaddedEngine`` does
(``wcsph_tpu/parallel/resident_slab.py:262-388``).

Why two ghost planes make K2 and K3 exact at the own rows (the deep-halo
argument of ``resident_slab.py:22-34``).  Call the ghost planes g1 (outer)
and g2 (inner, next to the own planes).  Both kernels run two stencils:
A, a velocity update that reads the kappas (K3: S and A) at the
neighbours, then B, a divergence that reads A's new velocities at the
neighbours.  A at a g2 row reads g1, g2 and own rows, all right after the
refresh, so the new velocity at g2 is exact; B at an own row reads only
g2 and own rows, so it is exact.  A at g1 is cut off at the slab's edge
and wrong, but only g2 reads g1 in B, and B's outputs at ghost rows are
never used: the next refresh overwrites both ghost planes.  So:

* ``lower`` is the identity: the inputs that K2 and K3 read only at the
  receiver (K2's gate ``liq (drho_ws > 0)``, from the density sweep's
  warm-start channel and count) must hold their true values at g2, where
  the density sweep computed them exactly (its window there reaches g1,
  g2 and own rows, whose positions are all present).  A one-plane
  ``lower`` would zero them, K2 would leave the velocity at g2 stale, and
  the divergence at the first own plane would read it;
* before each K3 call one stacked exchange (``lift_many``, the JAX
  ``_refresh``) brings the velocity, S (drho or the advected density) and
  A (alpha / dt or / dt^2) into both ghost planes; before K2, the
  velocity and the kappas.  This is the JAX adapter's set, kept as it is:
  A is constant over a solve and the velocity at g2 stays exact from one
  iteration to the next, but the exchange is one message either way;
* K3's error sums every liquid row, ghost rows too: the loop takes the
  all-reduced sum over the own liquid rows instead (``lsum``, JAX's
  ``_own_err``).  On one card the kernel's own sum stays.

Every other sweep runs as on the one-plane front (each neighbour-read input
lifted, now into both planes; sums over own rows), and the outputs it
leaves at ghost rows are read by no own row before the next lift.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import engine

# the JAX engine's fused loop methods (K2, K3, K4, K6, K7, K8)
FUSED_ALL = frozenset({"fused_kappa_drho", "fused_iter_full",
                       "fused_visc_iter", "fused_tension",
                       "fused_jacobi_iter", "fused_pcisph_iter"})
# those of SlabPaddedEngine: DFSPH's divergence and pressure loops
FUSED_DFSPH = frozenset({"fused_kappa_drho", "fused_iter_full"})


class NoComm:
    """One card: the sweeps see the whole grid; lifts and lowers are
    identities and the reductions run over the grid's liquid rows.
    ``fused``: the loops that may run fused (all of them unless the caller
    asks for fewer, as the reference of the two-plane front does)."""

    def __init__(self, grid, cfg, fused=FUSED_ALL):
        self.grid = grid
        self.cfg = cfg
        self.fused = fused

    def lift(self, q, fill=0.0):
        return q

    def lower(self, q):
        return q

    def lsum(self, x: torch.Tensor) -> torch.Tensor:
        """The 0-dim sum of ``x`` over the liquid rows, on the device."""
        return torch.sum(torch.where(self.grid.liquid, x, 0.0))

    def lmax(self, x: torch.Tensor) -> torch.Tensor:
        """The 0-dim max of ``x`` over the liquid rows (-inf with none)."""
        return torch.max(torch.where(self.grid.liquid, x, -torch.inf))

    def read(self, x: torch.Tensor, *more: torch.Tensor):
        return self.grid.read(x, *more)

    @property
    def n_liquid(self) -> int:
        return self.grid.liquid_count

    def fused_kappa_drho(self, vel, kf, gate, acc):
        """K2 on the grid (see ``engine.k2_fused_kappa_drho``)."""
        return engine.k2_fused_kappa_drho(self.grid, vel, kf, gate, acc)

    def fused_iter_full(self, vel, kv, s, a, paux, dt, mode: int):
        """K3 on the grid, returning the kernel's own error sum
        (``engine.k3_fused_iter_full``)."""
        return engine.k3_fused_iter_full(self.grid, vel, kv, s, a, paux, dt,
                                         mode)


class Transport:
    """Messages between ring neighbours and reductions over a
    ``torch.distributed`` process group (None: the default group).  With
    gloo every CUDA tensor goes through host memory; with NCCL the
    buffers stay on the card."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        self.staged = self.backend == "gloo"

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                  r)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged and t.is_cuda else t

    def ring(self, to_left, to_right, n_left: int, n_right: int):
        """Send ``to_left`` (..., a) to rank - 1 and ``to_right`` to rank +
        1, and receive (..., n_left) from rank - 1 and (..., n_right) from
        rank + 1, on the senders' device and dtype: (from_left,
        from_right), None on a side with no neighbour (the edge ranks get
        nothing from outside the domain)."""
        like = to_left if to_left is not None else to_right
        got = [None, None]
        ops = []
        for side, send, n, peer in ((0, to_left, n_left, self.rank - 1),
                                    (1, to_right, n_right, self.rank + 1)):
            if not 0 <= peer < self.world:
                continue
            wire = self._wire(send.contiguous())
            buf = torch.empty((*like.shape[:-1], n), dtype=like.dtype,
                              device=wire.device)
            ops += [dist.P2POp(dist.isend, wire, self._peer(peer),
                               self.group),
                    dist.P2POp(dist.irecv, buf, self._peer(peer), self.group)]
            got[side] = buf
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(g if g is None else g.to(like.device) for g in got)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """``t`` reduced over the ranks (in place where it stays on its
        device)."""
        wire = self._wire(t)
        dist.all_reduce(wire, op, group=self.group)
        return wire.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's ``t``, in rank order."""
        wire = self._wire(t.contiguous())
        out = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(out, wire, group=self.group)
        return torch.stack(out).to(t.device)


@dataclasses.dataclass
class HaloPlan:
    """Where a lift's values come from and go to in one step's local grid:
    the rows whose values this rank sends to its left neighbour, then to
    its right one, and the ghost rows it fills from its left neighbour,
    then from its right one, entry for entry in the order the neighbour
    sends.  An entry that holds no particle (``recv_empty``) lands on the
    grid's last row, an inert row outside the domain."""

    send_rows: torch.Tensor    # (S_l + S_r,) int64
    recv_rows: torch.Tensor    # (R_l + R_r,) int64
    recv_empty: torch.Tensor   # (R_l + R_r,) bool
    n_send: tuple              # (S_l, S_r)
    n_recv: tuple              # (R_l, R_r)
    ghost: torch.Tensor        # (M,) bool, the ghost rows


class SlabComm:
    """One rank's slab: the sweeps run on its own rows plus the ghost rows
    of its neighbours' boundary planes (``grid``); lifts exchange the ghost
    rows' values, reductions cover the own liquid rows and then every
    rank (``all_reduce``).  Built each step by ``halo.make_slab_comm``;
    one ghost plane a side, on which every loop runs unfused."""

    fused = frozenset()   # no exchange can run between a fused kernel's
                          # phases: the loops take their unfused forms

    def __init__(self, grid, cfg, own: torch.Tensor, plan: HaloPlan,
                 transport: Transport, status):
        self.grid = grid
        self.cfg = cfg
        self._own = own          # (M,) bool: the rank's own liquid rows
        self._plan = plan
        self._tr = transport
        self._status = status    # halo.SlabStatus, checked by Grid.read

    def lift(self, q: torch.Tensor, fill=0.0) -> torch.Tensor:
        """Write the neighbours' values of ``q`` (..., M) into its ghost
        rows, in place, and return it; ``fill`` goes to the rows of empty
        ghost entries (no sweep reads them)."""
        return self.lift_many((q, fill))[0]

    def lift_many(self, *fields):
        """``lift`` of several ``(q, fill)`` fields, (M,) or (k, M), in one
        ring exchange: their ghost rows' values travel as one stacked
        message a side (the JAX package's ``_refresh``).  Returns the
        fields, written in place."""
        p = self._plan
        rows = [q.view(-1, q.shape[-1]) for q, _ in fields]
        out = torch.cat([r.index_select(1, p.send_rows) for r in rows])
        n_l, n_r = p.n_send
        got = [g for g in self._tr.ring(
            out[:, :n_l] if n_l else None,
            out[:, n_l:] if n_r else None, *p.n_recv) if g is not None]
        if got:
            got = torch.cat(got, dim=-1)
            k = 0
            for r, (_, fill) in zip(rows, fields):
                r.index_copy_(1, p.recv_rows, got[k:k + r.shape[0]]
                              .masked_fill_(p.recv_empty, fill))
                k += r.shape[0]
        return [q for q, _ in fields]

    def lower(self, q: torch.Tensor) -> torch.Tensor:
        """``q`` (..., M) with its ghost rows set to 0."""
        return q.masked_fill(self._plan.ghost, 0)

    def lsum(self, x: torch.Tensor) -> torch.Tensor:
        return self._tr.all_reduce(torch.sum(torch.where(self._own, x, 0.0)))

    def lmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._tr.all_reduce(
            torch.max(torch.where(self._own, x, -torch.inf)),
            dist.ReduceOp.MAX)

    def read(self, x: torch.Tensor, *more: torch.Tensor):
        return self.grid.read(x, *more)

    @property
    def n_liquid(self) -> int:
        if not self._status.checked:
            self.read(torch.zeros((), device=self.grid.device))
        return self._status.n_liquid


class DirectSlabComm(SlabComm):
    """One rank's slab with two ghost planes a side (the counterpart of
    the JAX package's ``PaddedSlabComm`` and ``SlabPaddedEngine``,
    ``resident_slab.py:234-388``): ``lower`` is the identity, and DFSPH's
    loops run K2 and K3 on the local rows, each after one stacked refresh
    of the fields it reads at the neighbours (module docstring)."""

    fused = FUSED_DFSPH

    def lower(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def fused_kappa_drho(self, vel, kf, gate, acc):
        """K2 after one refresh of the velocity and the kappas (the gate is
        read at the receiver only); exact at the own rows."""
        self.lift_many((vel, 0.0), (kf, 0.0))
        return engine.k2_fused_kappa_drho(self.grid, vel, kf, gate, acc)

    def fused_iter_full(self, vel, kv, s, a, paux, dt, mode: int):
        """K3 after one refresh of the velocity, S and A; returns the
        all-reduced error over the own liquid rows (the kernel's own sum
        covers the ghost rows too)."""
        self.lift_many((vel, 0.0), (s, 0.0), (a, 0.0))
        engine.k3_fused_iter_full(self.grid, vel, kv, s, a, paux, dt, mode)
        return self.lsum(s - float(mode))
