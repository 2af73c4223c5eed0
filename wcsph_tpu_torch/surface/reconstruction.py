"""High-level surface reconstruction (port of
``wcsph_tpu/surface/reconstruction.py``; reference MCGrid.export_surface,
MarchingCubeGrid.py:139-156): density field -> marching cubes -> OBJ."""

from __future__ import annotations

import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from .. import engine
from ..config import SimConfig
from ..grid import build_grid
from ..state import FluidState
from ..utils import objio
from . import aniso as aniso_mod
from . import field as field_mod
from . import mc as mc_mod


def surface_field(state: FluidState, cfg: SimConfig,
                  anisotropic: bool = False) -> torch.Tensor:
    """The dense field of the state's particles, on the state's device:
    the bin, the density sweep (``engine.density``), with
    ``anisotropic`` the estimator's moments and G, and the field kernel."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    rho, _ = engine.density(grid)
    if not anisotropic:
        return field_mod.mc_field(grid, rho)
    an = aniso_mod.compute(grid)
    return field_mod.mc_field(grid, rho,
                              aniso_mod.smoothed_positions(grid, an), an.g,
                              an.reach)


def reconstruct(state: FluidState, cfg: SimConfig, isolevel: float = 0.5,
                anisotropic: bool = False,
                max_vertices: int = mc_mod.MAX_VERTEX,
                on_device: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the fluid surface mesh: (vertices (V, 3), triangles (T, 3)).

    The field is computed on the state's device (the card unless the state
    lies on the CPU) and, by default, copied to the host once for the numpy
    extractor.  With ``on_device=True`` marching cubes runs there too
    (``mc.marching_cubes_device`` with its default budgets) and one host
    read brings the triangle and drop counts, then the vertices.  Both
    extractors keep the JAX package's budgets: triangles past
    ``max_vertices`` are dropped and, on the device, so are the cubes past
    its ``max_active``; the device path warns with the count it dropped."""
    origin, spacing = field_mod.mc_grid_geometry(cfg)
    dense = surface_field(state, cfg, anisotropic)
    if not on_device:
        return mc_mod.marching_cubes(dense.cpu().numpy(), origin, spacing,
                                     isolevel, max_vertices)
    verts, n_tris, n_drop = mc_mod.marching_cubes_device(
        dense, origin, spacing, isolevel, max_vertices=max_vertices)
    n, dropped = torch.stack([n_tris, n_drop]).tolist()
    if dropped:
        warnings.warn(f"marching_cubes_device dropped {dropped} triangles "
                      "and cubes past its budgets", RuntimeWarning,
                      stacklevel=2)
    vertices = verts[: 3 * n].cpu().numpy()
    return vertices, np.arange(3 * n, dtype=np.int32).reshape(-1, 3)


class SurfaceExporter:
    """fps-gated mesh export (MCGrid.export_surface / frame counter,
    MarchingCubeGrid.py:12-14, 139-156)."""

    def __init__(self, cfg: SimConfig, out_dir: str = "out", fps: float = 20.0,
                 anisotropic: bool = False):
        self.cfg = cfg
        self.out_dir = out_dir
        self.fps = fps
        self.frame = 0
        self.anisotropic = anisotropic

    def maybe_export(self, state: FluidState) -> Optional[str]:
        if int(float(state.time) * self.fps) != self.frame:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        verts, tris = reconstruct(state, self.cfg,
                                  anisotropic=self.anisotropic)
        path = f"{self.out_dir}/mc_{self.frame}.obj"
        objio.save_obj(path, verts, tris)
        self.frame += 1
        return path
