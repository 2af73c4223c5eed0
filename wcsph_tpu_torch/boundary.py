"""Boundary-particle effective volume (Akinci et al. 2012).

Port of ``wcsph_tpu/boundary.py``: the Akinci volume of every boundary
particle, V_b = 1 / sum_k W(x_b - x_bk) over its boundary neighbours, is
computed once at scene setup and collapsed to the scalar
``solid_volume_scale`` the sweeps consume: the median over boundary
particles, as a multiple of the liquid rest volume, clipped to [0.75, 3].
"""

from __future__ import annotations

import numpy as np
import torch

from . import dense_ops
from .config import SimConfig
from .grid import build_grid


def akinci_solid_volume_scale(pos_solid: torch.Tensor,
                              cfg: SimConfig) -> float:
    """Median Akinci volume of the boundary shell over V_L0.

    ``pos_solid``: planar (3, Ns) boundary positions.  The W-sum runs over
    boundary neighbours within h (self excluded, as in the JAX package's
    window sweep); boundary particles outside the domain take no part."""
    if pos_solid.shape[1] == 0:
        return float(cfg.solid_volume_scale) or 1.0
    grid = build_grid(pos_solid, 0, cfg)      # n_liquid=0: all boundary
    p = dense_ops.pairs_of(grid)
    acc = torch.zeros(grid.n, dtype=torch.float32, device=pos_solid.device)
    acc.index_add_(0, p.i, p.w)
    s = acc.cpu().numpy()
    s = s[np.isfinite(s) & (s > 0.0)]
    if s.size == 0:
        return float(cfg.solid_volume_scale) or 1.0
    v_b = 1.0 / np.median(s)
    scale = float(v_b / cfg.liquid_volume)
    return float(np.clip(scale, 0.75, 3.0))
