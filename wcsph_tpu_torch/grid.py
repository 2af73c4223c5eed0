"""Binning: particles sorted by cell, with per-cell start offsets.

Replaces the JAX package's capacity-padded layouts (``wcsph_tpu/grid.py``
and the padded-direct build of ``wcsph_tpu/resident.py``).  Each step sorts
the particles by cell id (stable: equal cells keep particle order); cell
``c`` holds sorted rows ``cell_start[c] .. cell_start[c + 1]``.  There is no
capacity, so no particle is ever dropped: the JAX package's
``neighbor_overflow`` is always 0 here.

The grid has one row per particle, a shape known before the step runs, so
nothing of the bin is read back to the host.  Cell ids are computed
exactly as ``grid.cell_of_positions`` does: ``floor((pos - dmin) * (1 /
cell_size))`` in float32.  The particles inside the domain take the first
rows; those outside take the rows after ``cell_start[-1]``, in particle
order, and are inert: they lie in no cell's range, so they are nobody's
neighbour; their liquid flag is 0; and their cell id (``outside_cell``) has
no cell of the grid in its 27-cell window, so they find no neighbour either.
The step keeps their velocity and warm-start fields (the JAX package's
out-of-box semantics).  The liquid count inside the domain is a device
scalar (``Grid.n_liquid``, as the JAX package's ``comm.n_liquid()``); the
solvers' first host read of a step brings it along (``Grid.read``).

Fields move between the per-particle layout and the sorted layout with
``pack`` / ``unpack``.  Only liquid fields are packed; boundary rows hold 0,
so a boundary neighbour contributes a zero velocity, kappa or omega, as the
reference's ``j >= liquid_count`` branches do.

The bin, pack and unpack are kernels on the card (``engine.bin_cells``,
``pack_rows``, ``unpack_rows``) with plain twins in ``dense_ops``.  The
bin allocates only its outputs: its scratch is kept in ``engine`` from
call to call, per device and stream.  Pack and unpack each return row
views, in order, of one new block of rows.

A DFSPH or IISPH step also keeps a neighbour list of its sorted positions
(``NeighborList``, built by ``engine.nbr_list_fill`` right after the
density sweep), which the sweeps after it walk instead of the 27 cells.  A
PCISPH iteration keeps its pairs at the moved positions instead
(``StarHits``, written by K8's first sweep and walked by its second; in
the unfused loop ``PredictHits``, written by the first prediction call and
walked by the second).  The slot buffer of each (``ListSlots``) is kept
from step to step.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from .config import SimConfig


SLICE = 32   # rows per slice of the neighbour list: one warp
HEADROOM = 1.25   # slots a list buffer is sized for, over the slots needed
OFFSET_TILES = 1024   # int64 scratch of the offsets' tile sums (kMaxTiles,
                      # csrc/bin.cu; the bin's scan keeps two such sets)


class ListOverflow(Exception):
    """The step's neighbour list, or a PCISPH iteration's hits, needed more
    slots than its buffer holds; the step grows the buffer and runs again
    from its inputs."""

    def __init__(self, need: int, capacity: int):
        super().__init__(f"the neighbour list needs {need} slots, its buffer "
                         f"holds {capacity}")
        self.need = need


class ListSlots:
    """The slot buffer of a solver's neighbour list (DFSPH, IISPH) or of
    its PCISPH iterations' hits (``StarHits``, ``PredictHits``: a uniform
    ``capacity // M`` slots a row), kept from step to step
    (``Simulation.list_slots``), apart from the state.  Unsized, the next fill sizes it from its own need with
    ``HEADROOM`` (one host read; a PCISPH step, from its density sweep's
    largest count); sized, a fill whose list needs more clamps the list to
    it and flags the need, and the step replays after ``size_for`` the
    need.

    It also keeps the list's slice offsets and need (``offsets``), which
    each fill overwrites as it overwrites the slots: a list held across the
    next fill into the same ``ListSlots`` sees its slots and offsets
    change."""

    def __init__(self, capacity: int | None = None):
        self.capacity = None
        self.idx: torch.Tensor | None = None
        self._offsets = None
        self._offsets_key = None
        if capacity is not None:
            self._set(capacity)

    def _set(self, capacity: int) -> None:
        cap = -(-int(capacity) // SLICE) * SLICE   # whole slices
        if cap >= 2 ** 31:
            raise ValueError(f"{capacity} neighbour slots: the list's slot "
                             "offsets are 32-bit")
        self.capacity = cap
        self.idx = None

    def size_for(self, need: int) -> None:
        """Room for ``need`` slots with ``HEADROOM``."""
        self._set(need * HEADROOM)

    @staticmethod
    def sized(slots: "ListSlots | None", need: int) -> "ListSlots":
        """``slots``, sized for ``need`` where it is unsized; where it is
        None (a list built outside a step), a buffer of exactly ``need``."""
        if slots is None:
            return ListSlots(need)
        if slots.capacity is None:
            slots.size_for(need)
        return slots

    def buffer(self, device) -> torch.Tensor:
        """(capacity,) int32, allocated once per size."""
        if self.idx is None or self.idx.device != torch.device(device):
            self.idx = torch.empty((self.capacity,), dtype=torch.int32,
                                   device=device)
        return self.idx

    def offsets(self, m: int, device):
        """The kept (off (S + 1,) int32, need () int64, tile scratch
        (``OFFSET_TILES``,) int64) of a list of M rows, allocated once per
        M and device: each fill's ``engine.nbr_list_offsets`` (or its plain
        twin) writes them."""
        if self._offsets_key != (m, device):
            self._offsets = (
                torch.empty((-(-m // SLICE) + 1,), dtype=torch.int32,
                            device=device),
                torch.empty((), dtype=torch.int64, device=device),
                torch.empty((OFFSET_TILES,), dtype=torch.int64,
                            device=device))
            self._offsets_key = (m, device)
        return self._offsets


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
    a walk reads a neighbour's geometry in one load.

    ``idx`` is the step's slot buffer, of a capacity kept from step to
    step; the slots past ``off[-1]`` are not the list's.  Where the list
    needs more slots than that (``need``), the offsets are clamped to the
    capacity, so that no walk reads past the buffer, and the list is short:
    ``Grid.read`` raises ``ListOverflow`` at the step's first read."""

    idx: torch.Tensor    # (capacity,) int32 neighbour row, or -1
    off: torch.Tensor    # (S + 1,) int32 first slot of each slice
    rec: torch.Tensor    # (M, 4) float32 (x, y, z, liquid flag) of each row
    need: torch.Tensor   # () int64 slots the whole list needs
    flag: torch.Tensor   # () int32 1 where a liquid row found more pairs
                         # than its slots
    checked: bool = False   # need and flag read back (Grid.read)

    @property
    def width(self) -> torch.Tensor:
        """(S,) slots per row of each slice."""
        return (self.off[1:] - self.off[:-1]) // SLICE

    @property
    def capacity(self) -> int:
        return int(self.idx.shape[0])

    @property
    def status(self):
        """What ``check`` reads back."""
        return [self.need, self.flag]

    def check(self, need: int, flag: int) -> None:
        self.checked = True
        if need > self.capacity:
            raise ListOverflow(need, self.capacity)
        if flag:
            raise ValueError("count differs from the pairs within h: a row "
                             "has more neighbours than its slots")


@dataclasses.dataclass
class StarHits:
    """One PCISPH iteration's pairs within h at the moved positions x* = x
    + liq v* dt, as K8's first sweep found them: the candidates of the
    grid's cells, cut at x*, in the cell loop's order.  Hit k of row i is
    ``idx[k M + i]`` for k < ``count[i]``; each row keeps at most ``width``
    = capacity // M of them (a uniform width), and ``rec[i]`` = (x*, liquid
    flag).  A liquid row with more hits than ``width`` sets ``over`` to its
    hit count (the largest such): the iteration's second sweep then walked
    a short list, and ``Grid.read`` raises ``ListOverflow`` at the next
    read, for a buffer of ``over`` x M slots."""

    idx: torch.Tensor    # (capacity,) int32 neighbour row of each kept hit
    count: torch.Tensor  # (M,) int32 hits kept per row, at most width
    rec: torch.Tensor    # (M, 4) float32 (x*, y*, z*, liquid flag)
    width: int           # hits a row keeps
    over: torch.Tensor   # () int32 most hits of a row past width, else 0
    checked: bool = False   # over read back (Grid.read)

    @property
    def status(self):
        """What ``check`` reads back."""
        return [self.over]

    def check(self, over: int) -> None:
        self.checked = True
        if over:
            raise ListOverflow(over * int(self.count.shape[0]),
                               int(self.idx.shape[0]))


@dataclasses.dataclass
class PredictHits:
    """The pairs within h at the moved positions x* that the unfused PCISPH
    prediction's cut found (``engine.k1_pcisph_predict``), for the walk at
    the same x* with another pressure (``engine.k1_pcisph_walk``): as
    ``StarHits``, hit k of row i is ``idx[k M + i]`` in the cell loop's
    order for k < ``width`` = capacity // M, and ``rec[i]`` = (x*, liquid
    flag); but ``count`` is each row's full hit count, and a row with more
    than ``width`` hits is scanned again by the walk, so nothing is flagged
    and nothing is read back.  It stays a type apart from ``StarHits``
    because K8's kernels write and walk a clamped count and flag the rest
    for a replay: one count meaning either would make K8, its twin and
    ``Grid.read`` branch on which sweep made it."""

    idx: torch.Tensor    # (capacity,) int32 neighbour row of each kept hit
    count: torch.Tensor  # (M,) int32 hits of each row (0 at boundary rows)
    rec: torch.Tensor    # (M, 4) float32 (x*, y*, z*, liquid flag)
    width: int           # hits a row keeps


@dataclasses.dataclass
class Grid:
    """One step's sorted layout: one row per particle (M = N), the L liquid
    particles inside the domain among the first ``cell_start[-1]``."""

    cfg: SimConfig
    order: torch.Tensor        # (M,) int64 particle index of each sorted row
    row_of: torch.Tensor       # (N,) int32 row of each particle, -1 outside
    cell: torch.Tensor         # (M,) int32 cell id of each sorted row
    cell_start: torch.Tensor   # (num_cells + 1,) int32 first row of each cell
    pos: torch.Tensor          # (3, M) float32 sorted positions
    liquid: torch.Tensor       # (M,) bool
    liq: torch.Tensor          # (M,) float32 1.0 at liquid rows, 0.0 else
    n_liquid: torch.Tensor     # () int32 L, on the device
    pairs: object = None       # dense_ops.Pairs, built on first plain sweep
    nbr: NeighborList | None = None   # engine.nbr_list_fill, DFSPH, IISPH
    star: StarHits | None = None      # the last K8 call's hits, PCISPH
    checks: tuple = ()         # further statuses a caller adds (each
                               # with status, check, checked), read first
    n_liquid_read: int | None = None  # L, once a read has brought it

    @property
    def n(self) -> int:
        return int(self.order.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def liquid_count(self) -> int:
        """L on the host: from the step's first read, or a read of its own
        where none has run."""
        if self.n_liquid_read is None:
            self.n_liquid_read = int(self.n_liquid)
        return self.n_liquid_read

    def read(self, x: torch.Tensor, *more: torch.Tensor):
        """``x.item()`` for a 0-dim tensor: one host read; with ``more``
        0-dim tensors, the list of all their values, from the same
        transfer.  The grid's first read also brings L and, where the step
        built its list, the list's slot need and overflow flag, and the
        first read after a K8 call that call's overflow flag, stacked into
        the same transfer; it raises ``ListOverflow`` where the list or the
        hits were short, ValueError where a count was below the pairs
        within h.  The statuses of ``checks`` ride on the same first read
        and are checked before the list's."""
        extra = []
        if self.n_liquid_read is None:
            extra.append(self.n_liquid)
        pending = [c for c in (*self.checks, self.nbr, self.star)
                   if c is not None and not c.checked]
        extra += [t for c in pending for t in c.status]
        if not extra and not more:
            return x.item()
        asked = (x, *more)
        vals = torch.stack([t.reshape(()).to(torch.float64)
                            for t in (*asked, *extra)]).tolist()
        values = vals[:len(asked)]
        vals = [int(v) for v in vals[len(asked):]]
        if self.n_liquid_read is None:
            self.n_liquid_read = vals.pop(0)
        for c in pending:
            k = len(c.status)
            c.check(*vals[:k])
            vals = vals[k:]
        return values if more else values[0]


def outside_cell(cfg: SimConfig) -> int:
    """The cell id of the rows outside the domain: two cell planes past the
    grid in x, so no cell of its 27-cell window is in the grid."""
    gx, gy, gz = cfg.grid_res
    return (gx + 2) * gy * gz


def build_grid(pos: torch.Tensor, n_liquid: int, cfg: SimConfig) -> Grid:
    """Sort the particles by cell and compute the cell offsets (the bin
    kernel on the card, its plain twin on the CPU; no host read)."""
    from . import engine     # engine imports this module's types

    return Grid(cfg, *engine.bin_cells(pos, n_liquid, cfg))


def pack(grid: Grid, fields: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-liquid (N_L,) or (k, N_L) fields -> sorted (M,) / (k, M); rows
    that hold no liquid take 0.  The fields are row views, in order, of one
    (K, M) block; one launch for all fields on the card."""
    from . import engine

    return engine.pack_rows(grid, fields)


def unpack(grid: Grid, packed: Sequence[torch.Tensor],
           defaults: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sorted fields -> per-liquid; liquid particles outside the domain
    keep their ``defaults`` entry.  The fields are row views, in order, of
    one (K, N_L) block; one launch for all fields on the card."""
    from . import engine

    return engine.unpack_rows(grid, packed, defaults)
