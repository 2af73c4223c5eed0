"""What the solvers share on the host side of a step."""

from __future__ import annotations

import numpy as np
import torch

from .. import engine
from ..config import SimConfig
from ..grid import Grid, ListOverflow, ListSlots

f32 = np.float32


def gravity_column(cfg: SimConfig, like: torch.Tensor) -> torch.Tensor:
    """(3, 1) gravity on the device of ``like``."""
    return torch.tensor(cfg.gravity, dtype=torch.float32,
                        device=like.device)[:, None]


def liquid_sum(grid: Grid, x: torch.Tensor) -> np.float32:
    """Sum of ``x`` over the liquid rows, read to the host (``Grid.read``)."""
    return f32(grid.read(torch.sum(torch.where(grid.liquid, x, 0.0))))


def liquid_vel_max(grid: Grid, velp: torch.Tensor) -> np.float32:
    """max |v| over the liquid rows, read to the host (0 with no liquid)."""
    if grid.n == 0:
        return f32(0.0)
    v2 = torch.where(grid.liquid, torch.sum(velp * velp, dim=0), -torch.inf)
    return f32(np.sqrt(max(f32(grid.read(v2.max())), f32(0.0))))


def replaying(run, slots: ListSlots):
    """``run()``, a step from its unmodified inputs; where the step's
    neighbour list or a PCISPH iteration's hits outgrew ``slots``
    (``ListOverflow`` at a host read), size the buffer for the slots needed
    and run it again (each run counted in ``engine.LIST_REPLAYS``).  A
    list's need is exact, so it replays once; a later PCISPH iteration may
    need more than the one that raised."""
    while True:
        try:
            return run()
        except ListOverflow as e:
            slots.size_for(e.need)
            engine.LIST_REPLAYS += 1
