"""Surface scalar field on a dense reconstruction grid (port of
``wcsph_tpu/surface/field.py``).

Reference: MCGrid.cal_surface_point (MarchingCubeGrid.py:182-209).  The
reconstruction points are a regular refinement of the grid's cells,
MC_SUB^3 points per cell, h / MC_SUB apart, so each point's candidates are
the particles of the 27 cells around its own (binned at their positions);
the support of the field kernel is h, as the reference's searchR = 4 gridR
(MarchingCubeGrid.py:25).

phi(x) = sum_liq (m / max(rho_j, 1)) W(x - x_j), with contributions gated to
rho_j above the rest-kernel density m W(0) (MarchingCubeGrid.py:203-205).
The anisotropic variant (cal_surface_point_anistropic, 214-246) evaluates
W(|2 G_j r|) at the smoothed centres of aniso.smoothed_positions.

The field is one kernel (``engine.mc_field``, csrc/surface.cu; its plain
twin on the CPU) that writes the dense (gx MC_SUB, gy MC_SUB, gz MC_SUB)
layout of the JAX package's ``field_to_dense`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import engine, kernels
from ..dense_ops import MC_SUB  # noqa: F401  (re-exported)
from ..grid import Grid


def gated_coefficients(grid: Grid, rho: torch.Tensor) -> torch.Tensor:
    """(M,) m / max(rho_j, 1) at liquid rows with rho_j > m W(0, h), 0
    elsewhere.  (As in the JAX package, the gate takes W0 at h = 4 r, where
    the reference's MC kernel radius is 3.6 r: a slightly more inclusive
    splash filter.)"""
    cfg = grid.cfg
    gate = cfg.liquid_mass * kernels.cubic_w0(cfg.support_radius)
    keep = grid.liquid & (rho > gate)
    return torch.where(keep, cfg.liquid_mass / torch.clamp(rho, min=1.0),
                       0.0).contiguous()


def mc_field(grid: Grid, rho: torch.Tensor, pos_smooth=None,
             g=None, reach=None) -> torch.Tensor:
    """The dense field (gx MC_SUB, gy MC_SUB, gz MC_SUB) from the density
    ``rho`` of the grid's rows; anisotropic with the smoothed centres
    ``pos_smooth`` (3, M), G (9, M) and the reach (M,) of
    ``aniso.compute``."""
    x = grid.pos if pos_smooth is None else pos_smooth.contiguous()
    return engine.mc_field(grid, x, gated_coefficients(grid, rho),
                           None if g is None else g.contiguous(),
                           None if reach is None else reach.contiguous())


def mc_grid_geometry(cfg):
    """(origin (3,), spacing) of the dense reconstruction grid."""
    return np.asarray(cfg.domain_min, np.float32), cfg.cell_size / MC_SUB
