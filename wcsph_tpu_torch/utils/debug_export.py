"""Debug exports (port of ``wcsph_tpu/utils/debug_export.py``; reference
MCGrid.export_vertex MarchingCubeGrid.py:106-120 and
ParticleData.export_kernel ParticleData.py:302-311)."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import dense_ops, engine
from ..config import SimConfig
from ..grid import build_grid, unpack
from ..state import FluidState
from ..surface import field as field_mod
from ..surface.reconstruction import surface_field
from . import objio


def export_field_points(state: FluidState, cfg: SimConfig, path: str,
                        threshold: float = 0.0) -> int:
    """Dump reconstruction-grid points with a field value above
    ``threshold`` as an OBJ point cloud (MCGrid.export_vertex)."""
    dense = surface_field(state, cfg).cpu().numpy()
    origin, spacing = field_mod.mc_grid_geometry(cfg)
    ix, iy, iz = np.nonzero(dense > threshold)
    pts = origin[None, :] + spacing * np.stack([ix, iy, iz], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    objio.save_point_cloud(path, pts.astype(np.float32))
    return pts.shape[0]


def color_field(state: FluidState, cfg: SimConfig):
    """(color (N_L,), normalized gradient (3, N_L)) of the liquid
    particles, in particle order (``dense_ops.color_field``; 0 for a
    particle outside the domain)."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    rho, _ = engine.density(grid)
    color, grad = dense_ops.color_field(grid, rho)
    nl = state.n_liquid
    zeros = torch.zeros((4, nl), dtype=torch.float32, device=grid.device)
    return unpack(grid, [color.contiguous(), grad.contiguous()],
                  [zeros[0], zeros[1:]])


def export_color_field(state: FluidState, cfg: SimConfig, path: str) -> int:
    """Dump liquid positions with the color-gradient surface indicator
    (ParticleData.export_kernel writes 'v x y z r g b ...')."""
    color, grad = (t.cpu().numpy() for t in color_field(state, cfg))
    pos = state.pos[:, : state.n_liquid].T.cpu().numpy()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(pos.shape[0]):
            g = grad[:, i]
            f.write(f"v {pos[i,0]:.6f} {pos[i,1]:.6f} {pos[i,2]:.6f} "
                    f"{g[0]:.6f} {g[1]:.6f} {g[2]:.6f} {color[i]:.6f}\n")
    return pos.shape[0]
