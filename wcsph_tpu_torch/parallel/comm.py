"""Communicators: the same solver code runs on one card or on x-slabs.

Port of ``wcsph_tpu/parallel/comm.py``.  The solvers (``solvers/*.py``,
``viscosity.py``) call the engine through a communicator:

* ``comm.grid`` / ``comm.cfg``: the grid the sweeps run on (the whole grid
  on one card; on a slab, the rank's own rows plus its ghost rows);
* ``comm.lift(q, fill)``: make a sorted field right at the ghost rows
  before a sweep reads it at a neighbour (identity / a halo exchange);
* ``comm.lower(q)``: a sweep's output at the own rows only (identity /
  the ghost rows set to 0);
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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


class NoComm:
    """One card: the sweeps see the whole grid; lifts and lowers are
    identities and the reductions run over the grid's liquid rows."""

    fused_loops = True    # the fused loop kernels may run (K2-K4, K6-K8)

    def __init__(self, grid, cfg):
        self.grid = grid
        self.cfg = cfg

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
    rank (``all_reduce``).  Built each step by ``halo.make_slab_comm``."""

    fused_loops = False   # no exchange can run between a fused kernel's
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
        p = self._plan
        out = q.index_select(-1, p.send_rows)
        n_l, n_r = p.n_send
        got = [g for g in self._tr.ring(
            out[..., :n_l] if n_l else None,
            out[..., n_l:] if n_r else None, *p.n_recv) if g is not None]
        if got:
            got = torch.cat(got, dim=-1).masked_fill_(p.recv_empty, fill)
            q.index_copy_(q.dim() - 1, p.recv_rows, got)
        return q

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
