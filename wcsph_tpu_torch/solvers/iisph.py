"""IISPH: implicit incompressible SPH with a relaxed-Jacobi pressure solve
(port of ``wcsph_tpu/solvers/iisph.py``, engine branch in its fused form).

One step: sort + pack -> density (K5 ``_DensityAlpha``) -> the step's
neighbour list from its counts (one fill kernel; K4 below walks it) ->
implicit viscosity (block-Jacobi PCG: K1 + K4, ``viscosity.py``) -> advection
coefficients d_ii, a_ii, advected density (K5 ``_IisphAdv``, ``_IisphAii``),
pressure warm start 0.5 p -> relaxed-Jacobi loop, one K7 call per iteration
-> pressure force (K5 ``_IisphForce``) -> integrate.  As in the JAX package,
and unlike the Taichi reference, each iteration starts from the pressure of
the one before (omega = 0.5), and d_ii / a_ii use the per-type neighbour
volume.

The loop ends on the host: each iteration's residual sum is read back and
tested there, with the JAX package's loop contract and float32 scalar
arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import engine, viscosity
from ..config import SimConfig
from ..grid import Grid, build_grid, pack, unpack
from ..state import FluidState, StepDiagnostics
from .common import gravity_column, liquid_sum, liquid_vel_max

f32 = np.float32


def default_config(**overrides) -> SimConfig:
    """Reference iisph defaults (iisph.py:24-92): nu = 2.0, nu_b = 3.0."""
    base = dict(
        solid_volume_scale=1.0,
        viscosity=2.0,
        viscosity_b=3.0,
        adaptive_dt=False,
        dt_init=1e-3,
    )
    base.update(overrides)
    return SimConfig(**base)


class MidResult(NamedTuple):
    vel: torch.Tensor         # (3, M)
    pressure: torch.Tensor    # (M,)
    delta_v: torch.Tensor     # (3, M) viscosity warm start
    iters: int
    visc_iters: int
    err: np.float32
    err_pre: np.float32       # advected-density violation before the solve


def step_middle(grid: Grid, cfg: SimConfig, velp, vgp, pp, dt) -> MidResult:
    """The whole IISPH solve on the sorted layout."""
    rho0 = cfg.rest_density
    v0 = cfg.liquid_volume
    dt = f32(dt)
    liq3 = grid.liquid[None]

    rhop, cntp = engine.density(grid)                   # iisph.py:254-268
    # positions stay put until the position update: the viscosity PCG's
    # matvec (K4) walks this list
    engine.nbr_list_fill(grid, cntp)

    # implicit viscosity; velocity updates are liquid-masked so boundary
    # rows keep velocity 0 exactly (they feed (v_i - v_j) pair terms)
    visc = viscosity.solve_dense(grid, velp, vgp, rhop, dt)
    d_vel = gravity_column(cfg, velp) + (visc.vel_new - velp) / float(dt)
    velp = velp + torch.where(liq3, d_vel * float(dt), 0.0)

    # advection coefficients (iisph.py:276-316).  Raw rho, no clamp: rho is
    # bounded away from 0 by the self term rho0 V0 W(0)
    dii_raw, adv_acc, dji_acc = engine.iisph_adv(grid, velp)
    den_i2 = (rhop / rho0) ** 2
    d_ii = dii_raw * ((rho0 / rhop) ** 2)[None]
    adv_rho = rhop / rho0 + float(dt) * adv_acc
    deninv = v0 / den_i2
    a_ii = engine.k5_iisph_aii(grid, d_ii) - deninv * dji_acc

    pp = 0.5 * pp                                       # warm start
    n_liq = f32(grid.n_liquid)
    err_pre = liquid_sum(grid, torch.clamp(adv_rho - 1.0, min=0.0)) / n_liq
    b_rhs = 1.0 - adv_rho

    err, it = f32(0.0), 0
    while ((err > f32(cfg.iisph_tol)) or (it < cfg.iisph_min_iters)) \
            and it < cfg.iisph_max_iters:
        _, _, scal = engine.k7_fused_jacobi_iter(grid, d_ii, deninv, a_ii,
                                                 b_rhs, pp, dt)
        err = f32(scal.item()) / n_liq
        it += 1

    # pressure force + integrate (iisph.py:372-396)
    d_vel_p = engine.k5_iisph_force(grid, pp / den_i2)
    velp = velp + torch.where(liq3, d_vel_p * float(dt), 0.0)
    return MidResult(vel=velp, pressure=pp, delta_v=visc.delta_v, iters=it,
                     visc_iters=visc.iters, err=err, err_pre=err_pre)


def step(state: FluidState, cfg: SimConfig) -> FluidState:
    nl = state.n_liquid
    dt = f32(state.dt)
    grid = build_grid(state.pos, nl, cfg)
    packed = pack(grid, [state.vel, state.vel_guess, state.pressure])
    mid = step_middle(grid, cfg, *packed, dt)
    vel, pressure, vel_guess = unpack(
        grid, [mid.vel, mid.pressure, mid.delta_v],
        [state.vel, state.pressure, state.vel_guess])
    pos = state.pos.clone()
    pos[:, :nl] += vel * float(dt)
    diag = StepDiagnostics(
        pressure_iters=mid.iters,
        viscosity_iters=mid.visc_iters,
        density_error=mid.err,
        density_error_pre=mid.err_pre,
        neighbor_overflow=0,
        vel_max=liquid_vel_max(grid, mid.vel),
    )
    return state.replace(pos=pos, vel=vel, pressure=pressure,
                         vel_guess=vel_guess, time=f32(state.time + dt),
                         diag=diag)
