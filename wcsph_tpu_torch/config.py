"""Simulation configuration (copy of ``wcsph_tpu/config.py``).

Every field keeps the JAX package's name and default, so one dict builds
both configs (``config_from_dict(dataclasses.asdict(jax_cfg))``).  Fields
that only steer the TPU engine stay as inert fields here: ``cell_capacity*``
(the port never caps a cell), ``resident*``, ``aot_dir``, ``pair_dtype``
and ``use_pallas``.  ``fused_solver_iters`` picks the solver loops' form,
as in the JAX package (``engine.use_fused_iters``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration for one simulation (Python scalars and tuples)."""

    # ---- particle geometry (reference ParticleData.py:18-22, dfsph.py:28) ----
    particle_radius: float = 0.025
    rest_density: float = 1000.0
    # Resolve the boundary volume from the ACTUAL shell sampling at scene
    # setup (Akinci 2012 V_b = 1/sum W over solid neighbors; boundary.py,
    # applied in Simulation.__init__): the reference's constant VS0 is only
    # right for the shell density it was tuned on — 1.0 (dfsph/iisph, dense
    # Poisson shells) under-weights a 2r procedural box enough that liquid
    # drains through the wall.  The per-solver constants below remain the
    # fallback (auto off, or no solids / direct non-Simulation use).
    solid_volume_auto: bool = True
    # VS0 = solid_volume_scale * VL0. The reference uses 2.0 for sesph/pcisph
    # (sesph.py:36) and 1.0 for iisph/dfsph (ParticleData.py:22).
    solid_volume_scale: float = 1.0

    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0)

    # ---- domain AABB (static; grid shapes derive from it) ----
    domain_min: Tuple[float, float, float] = (-1.1, -1.1, -1.1)
    domain_max: Tuple[float, float, float] = (1.1, 1.1, 1.1)

    # ---- neighbor search (replaces reference HashGrid.py) ----
    # Inert here: the port bins by a sort with per-cell offsets and never
    # caps a cell, so no particle is dropped (kept for config parity).
    cell_capacity: int = 16
    cell_capacity_spill: int = 0
    max_neighbors: int = 64

    # ---- time stepping (reference dfsph.py:40-41, 107-129) ----
    dt_init: float = 1e-3
    dt_min: float = 1e-4
    dt_max: float = 5e-3
    cfl_factor: float = 0.5
    adaptive_dt: bool = True  # False => fixed dt_init (sesph/pcisph/iisph mode)

    # ---- viscosity (reference ParticleData.py:60-65) ----
    dim_coff: float = 10.0
    viscosity: float = 10.0
    viscosity_b: float = 10.0
    viscosity_err: float = 0.05   # relative PCG tolerance
    max_cg_iters: int = 100
    # Block-Jacobi preconditioner toggle.  The reference publishes its PCG
    # evidence as a cg-vs-precondition_cg iteration curve over the viscosity
    # factor (image/average_iter_num.png; solver in dfsph.py:95-99); False
    # reproduces the plain-CG branch for that comparison.
    viscosity_precond: bool = True
    # Explicit XSPH-style laplacian viscosity used by sesph/pcisph
    # (sesph.py:60-62, pcisph.py:70-72)
    explicit_viscosity: float = 0.1
    explicit_viscosity_b: float = 0.0

    # ---- surface tension (reference ParticleData.py:80-81) ----
    tension_coff: float = 0.0
    tension_coff_b: float = 0.0
    # Reference dfsph.py:300 hard-codes an adhesion region around (0, 0.5, 0)
    # with radius 0.26; exposed as config here.
    adhesion_center: Tuple[float, float, float] = (0.0, 0.5, 0.0)
    adhesion_radius: float = 0.26

    # ---- micropolar vorticity (reference ParticleData.py:85-87) ----
    viscosity_omega: float = 0.1
    vorticity_coff: float = 0.01
    vorticity_init: float = 0.5
    enable_vorticity: bool = True

    # ---- pressure solvers ----
    stiffness: float = 50000.0            # SESPH Tait EOS k (sesph.py:58)
    sesph_eos_exponent: int = 7           # Tait exponent (sesph.py:165)
    pcisph_tol: float = 0.01              # pcisph.py:153
    pcisph_min_iters: int = 3
    pcisph_max_iters: int = 50
    iisph_tol: float = 1e-3               # iisph.py:135
    iisph_min_iters: int = 2
    iisph_max_iters: int = 100
    iisph_omega: float = 0.5              # relaxed Jacobi (iisph.py:78)
    dfsph_tol: float = 1e-3               # dfsph.py:160
    dfsph_min_iters: int = 2
    dfsph_max_iters: int = 100
    dfsph_div_max_iters: int = 10         # dfsph.py:141-143
    dfsph_div_tol: float = 1e-3           # threshold = tol * n_liquid / dt
    # Suppress divergence correction for near-isolated particles
    # (reference dfsph.py:391-392 uses <20 on its loose neighbor count).
    min_div_neighbors: int = 20
    # The reference's pressure warm start is inert (dfsph.py:491 compares the
    # normalized advected density against rho_L0=1000, which never fires, and
    # kappa is zeroed at begin_pressure_iter before use).  Default matches the
    # reference behavior; set True for the intended SPlisHSPlasH warm start.
    pressure_warm_start: bool = False
    divergence_warm_start: bool = True

    # ---- numerics ----
    eps: float = 1e-5
    # TPU-engine switches, inert in the port (kept for config parity): the
    # port's CUDA tensors always run its hand kernels, CPU tensors their
    # plain twins.
    use_pallas: bool = False
    resident: bool = False
    resident_rebuild_every: int = 64
    resident_mover_frac: float = 0.08
    resident_side_frac: float = 0.02
    resident_host_rebuild: bool = False
    # The solver loops' form: one fused kernel an iteration (K2-K4, K6-K8),
    # or False for the JAX package's unfused forms, K1's emits one sweep a
    # call (engine.use_fused_iters).
    fused_solver_iters: bool = True
    aot_dir: str = ""
    pair_dtype: str = "float32"

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def support_radius(self) -> float:
        """SPH support radius h = 4 * particle radius (HashGrid.py:18)."""
        return 4.0 * self.particle_radius

    @property
    def cell_size(self) -> float:
        """Our grid cell size equals h, so a 3x3x3 cell scan covers the
        support sphere (the reference scans 5x5x5 cells of size h/2,
        HashGrid.py:82-85)."""
        return self.support_radius

    @property
    def liquid_volume(self) -> float:
        """V0 = 0.8 * (2r)^3 (ParticleData.py:20)."""
        r = self.particle_radius
        return r * r * r * 0.8 * 8.0

    @property
    def solid_volume(self) -> float:
        return self.liquid_volume * self.solid_volume_scale

    @property
    def liquid_mass(self) -> float:
        return self.liquid_volume * self.rest_density

    @property
    def grid_res(self) -> Tuple[int, int, int]:
        """Static grid resolution derived from the domain AABB."""
        return tuple(
            int(math.floor((self.domain_max[i] - self.domain_min[i]) / self.cell_size)) + 1
            for i in range(3)
        )

    @property
    def num_cells(self) -> int:
        gx, gy, gz = self.grid_res
        return gx * gy * gz

    def replace(self, **kwargs) -> "SimConfig":
        return dataclasses.replace(self, **kwargs)


def config_from_dict(d: dict) -> SimConfig:
    """SimConfig from ``dataclasses.asdict`` of either package's config
    (tuples may arrive as lists)."""
    names = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SimConfig fields: {sorted(unknown)}")
    return SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})
