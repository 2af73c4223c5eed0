"""What the fixed-dt solvers (SESPH, PCISPH, IISPH) share on the host side
of a step."""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..grid import Grid

f32 = np.float32


def gravity_column(cfg: SimConfig, like: torch.Tensor) -> torch.Tensor:
    """(3, 1) gravity on the device of ``like``."""
    return torch.tensor(cfg.gravity, dtype=torch.float32,
                        device=like.device)[:, None]


def liquid_sum(grid: Grid, x: torch.Tensor) -> np.float32:
    """Sum of ``x`` over the liquid rows, read to the host."""
    return f32(torch.sum(torch.where(grid.liquid, x, 0.0)).item())


def liquid_vel_max(grid: Grid, velp: torch.Tensor) -> np.float32:
    """max |v| over the liquid rows, read to the host (0 with no liquid)."""
    if grid.n_liquid == 0:
        return f32(0.0)
    v2 = torch.where(grid.liquid, torch.sum(velp * velp, dim=0), -torch.inf)
    return f32(np.sqrt(max(f32(v2.max().item()), f32(0.0))))
