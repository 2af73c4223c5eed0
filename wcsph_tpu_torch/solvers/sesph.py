"""SESPH: state-equation (Tait EOS) SPH solver (port of
``wcsph_tpu/solvers/sesph.py``, engine branch).

One step: bin + pack (``bin_and_pack``) -> density (K5 ``_DensityAlpha``)
-> Tait EOS pressure -> explicit viscosity + symmetric pressure force in
one sweep (K5 ``_SesphForce``) -> semi-implicit Euler.  No inner loop;
fixed dt.  The middle takes a communicator (``parallel/comm.py``, as in
``solvers/dfsph.py``).
"""

from __future__ import annotations

import numpy as np

from .. import engine, ops
from ..config import SimConfig
from ..grid import ListSlots, build_grid, pack, unpack
from ..parallel.comm import FUSED_ALL, NoComm
from ..state import FluidState, StepDiagnostics
from .common import gravity_column, vel_max

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


def step_middle(comm, cfg: SimConfig, velp, dt):
    """Density -> EOS -> forces -> velocity update on the sorted layout, on
    the communicator's grid.  The EOS is per row, so the lifted density
    gives the pressure at the ghost rows too."""
    grid = comm.grid
    rho_raw, _ = engine.density(grid)
    rhop, pp = ops.tait_pressure(comm.lift(rho_raw, 1.0), cfg)
    d_vel = gravity_column(cfg, velp) + comm.lower(engine.sesph_force(
        grid, comm.lift(velp), rhop, pp))
    return velp + d_vel * float(dt), rhop, pp           # sesph.py:191-196


def density_error(comm, cfg: SimConfig, rhop) -> np.float32:
    """The mean liquid density over rho0, less 1, read to the host."""
    rho_sum = f32(comm.read(comm.lsum(rhop)))
    return rho_sum / f32(comm.n_liquid) / f32(cfg.rest_density) - f32(1.0)


def bin_and_pack(state: FluidState, cfg: SimConfig):
    """The step's grid stage: (grid, [packed velocity]); no host read."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    return grid, pack(grid, [state.vel])


def step(state: FluidState, cfg: SimConfig,
         slots: ListSlots | None = None, fused=FUSED_ALL) -> FluidState:
    """One step (``slots`` and ``fused`` are unused: this step builds no
    neighbour list and runs no loop)."""
    nl = state.n_liquid
    dt = f32(state.dt)
    grid, (velp,) = bin_and_pack(state, cfg)
    comm = NoComm(grid, cfg)
    velp, rhop, pp = step_middle(comm, cfg, velp, dt)
    vel, pressure = unpack(grid, [velp, pp], [state.vel, state.pressure])
    pos = state.pos.clone()
    pos[:, :nl] += vel * float(dt)
    diag = StepDiagnostics(
        density_error=density_error(comm, cfg, rhop),
        neighbor_overflow=0,
        vel_max=vel_max(comm, velp),
    )
    return state.replace(pos=pos, vel=vel, pressure=pressure,
                         time=f32(state.time + dt), diag=diag)
