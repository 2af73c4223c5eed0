"""SESPH: state-equation (Tait EOS) SPH solver (port of
``wcsph_tpu/solvers/sesph.py``, engine branch).

One step: bin + pack (``bin_and_pack``) -> density (K5 ``_DensityAlpha``)
-> Tait EOS pressure -> explicit viscosity + symmetric pressure force in
one sweep (K5 ``_SesphForce``) -> semi-implicit Euler.  No inner loop;
fixed dt.
"""

from __future__ import annotations

import numpy as np

from .. import engine, ops
from ..config import SimConfig
from ..grid import Grid, ListSlots, build_grid, pack, unpack
from ..state import FluidState, StepDiagnostics
from .common import gravity_column, liquid_sum, liquid_vel_max

f32 = np.float32


def default_config(**overrides) -> SimConfig:
    """Reference sesph defaults (sesph.py:24-62): VS0 = 2*VL0, nu = 0.1."""
    base = dict(
        solid_volume_scale=2.0,
        explicit_viscosity=0.1,
        explicit_viscosity_b=0.0,
        adaptive_dt=False,
        dt_init=1e-3,
    )
    base.update(overrides)
    return SimConfig(**base)


def step_middle(grid: Grid, cfg: SimConfig, velp, dt):
    """Density -> EOS -> forces -> velocity update on the sorted layout."""
    rho_raw, _ = engine.density(grid)
    rhop, pp = ops.tait_pressure(rho_raw, cfg)
    d_vel = gravity_column(cfg, velp) + engine.sesph_force(grid, velp, rhop,
                                                           pp)
    return velp + d_vel * float(dt), rhop, pp           # sesph.py:191-196


def bin_and_pack(state: FluidState, cfg: SimConfig):
    """The step's grid stage: (grid, [packed velocity]); no host read."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    return grid, pack(grid, [state.vel])


def step(state: FluidState, cfg: SimConfig,
         slots: ListSlots | None = None) -> FluidState:
    """One step (``slots`` is unused: this step builds no neighbour
    list)."""
    nl = state.n_liquid
    dt = f32(state.dt)
    grid, (velp,) = bin_and_pack(state, cfg)
    velp, rhop, pp = step_middle(grid, cfg, velp, dt)
    vel, pressure = unpack(grid, [velp, pp], [state.vel, state.pressure])
    pos = state.pos.clone()
    pos[:, :nl] += vel * float(dt)
    rho_sum = liquid_sum(grid, rhop)
    diag = StepDiagnostics(
        density_error=rho_sum / f32(grid.liquid_count)
        / f32(cfg.rest_density) - f32(1.0),
        neighbor_overflow=0,
        vel_max=liquid_vel_max(grid, velp),
    )
    return state.replace(pos=pos, vel=vel, pressure=pressure,
                         time=f32(state.time + dt), diag=diag)
