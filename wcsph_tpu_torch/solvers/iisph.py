"""IISPH: implicit incompressible SPH with a relaxed-Jacobi pressure solve
(port of ``wcsph_tpu/solvers/iisph.py``, engine branch).

One step: bin + pack (``bin_and_pack``) -> density (K5 ``_DensityAlpha``)
-> the step's neighbour list from its counts (its slice offsets and one fill
kernel; every sweep below walks it) -> implicit viscosity (block-Jacobi
PCG: K1 + K4, ``viscosity.py``) -> advection coefficients d_ii, a_ii,
advected density (K5 ``_IisphAdv``, ``_IisphAii``), pressure warm start
0.5 p -> relaxed-Jacobi loop, one K7 call per iteration -> pressure force
(K5 ``_IisphForce``) -> integrate.  With ``fused_solver_iters=False``
(``engine.use_fused_iters``) each Jacobi iteration is the JAX package's
unfused form instead: a dij sweep and an s sweep (``k1_iisph_dij``,
``k1_iisph_s``) and the update in torch ops, and each viscosity PCG
iteration a matvec sweep (``viscosity.py``).  As in the JAX package,
and unlike the Taichi reference, each iteration starts from the pressure of
the one before (omega = 0.5), and d_ii / a_ii use the per-type neighbour
volume.

The loop ends on the host: each iteration's residual sum is read back and
tested there (``Grid.read``), with the JAX package's loop contract and
float32 scalar arithmetic.  From the positions to the filled list the step
makes no host read; its first read (the viscosity PCG's) also brings the
liquid count and the list's status, and a list that outgrew its kept slot
buffer makes the step run again with a larger one (``common.replaying``).
The middle takes a communicator (``parallel/comm.py``, as in
``solvers/dfsph.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import engine, viscosity
from ..config import SimConfig
from ..grid import Grid, ListSlots, build_grid, pack, unpack
from ..parallel.comm import FUSED_ALL, NoComm
from ..state import FluidState, StepDiagnostics
from .common import gravity_column, replaying, vel_max

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


def density_and_list(grid: Grid, slots: ListSlots | None = None):
    """(rho, count) of the density sweep (iisph.py:254-268), then the
    step's neighbour list from its counts, into ``slots``: no host read
    once ``slots`` is sized.  Positions stay put until the position update:
    the viscosity sweeps (K1's visc-init, K4), the advection and a_ii
    sweeps, K7 and the pressure-force sweep walk this list."""
    rhop, cntp = engine.density(grid)
    engine.nbr_list_fill(grid, cntp, slots)
    return rhop, cntp


def step_middle(comm, cfg: SimConfig, velp, vgp, pp, dt,
                slots: ListSlots | None = None) -> MidResult:
    """The whole IISPH solve on the sorted layout, on the communicator's
    grid."""
    grid = comm.grid
    rho0 = cfg.rest_density
    v0 = cfg.liquid_volume
    dt = f32(dt)
    liq3 = grid.liquid[None]

    rhop, cntp = density_and_list(grid, slots)
    # rho, and d_ii and 1 / den^2 formed from it, are read at the neighbour
    rhop = comm.lift(rhop, 1.0)

    # implicit viscosity; velocity updates are liquid-masked so boundary
    # rows keep velocity 0 exactly (they feed (v_i - v_j) pair terms)
    visc = viscosity.solve_dense(comm, velp, vgp, rhop, dt)
    d_vel = gravity_column(cfg, velp) + (visc.vel_new - velp) / float(dt)
    velp = velp + torch.where(liq3, d_vel * float(dt), 0.0)

    # advection coefficients (iisph.py:276-316).  Raw rho, no clamp: rho is
    # bounded away from 0 by the self term rho0 V0 W(0)
    dii_raw, adv_acc, dji_acc = map(comm.lower, engine.iisph_adv(
        grid, comm.lift(velp)))
    den_i2 = (rhop / rho0) ** 2
    d_ii = dii_raw * ((rho0 / rhop) ** 2)[None]
    adv_rho = rhop / rho0 + float(dt) * adv_acc
    deninv = v0 / den_i2
    a_ii = comm.lower(engine.k5_iisph_aii(grid, d_ii)) - deninv * dji_acc

    pp = 0.5 * pp                                       # warm start
    err_sum = f32(comm.read(comm.lsum(torch.clamp(adv_rho - 1.0, min=0.0))))
    n_liq = f32(comm.n_liquid)
    err_pre = err_sum / n_liq
    b_rhs = 1.0 - adv_rho

    fused = engine.use_fused_iters(comm, "fused_jacobi_iter")
    h2 = float(dt * dt)
    liq = grid.liquid

    def jacobi_tail(p_pre, s):
        """The relaxed-Jacobi update and the residual sum
        (wcsph_tpu/solvers/iisph.py:92-104 _jacobi_tail)."""
        denom = a_ii * h2
        ok = torch.abs(denom) > cfg.eps
        p_new = torch.clamp(
            (1.0 - cfg.iisph_omega) * p_pre
            + cfg.iisph_omega / torch.where(ok, denom, 1.0)
            * (b_rhs - h2 * s), min=0.0)
        p_new = torch.where(ok, p_new, 0.0)
        resid = torch.where(p_new != 0.0, (a_ii * p_new + s) * h2 - b_rhs,
                            0.0)
        return p_new, comm.lsum(resid)

    if not fused:
        d_ii = comm.lift(d_ii)      # the s sweep reads d_ii at the neighbour
    err, it = f32(0.0), 0
    while ((err > f32(cfg.iisph_tol)) or (it < cfg.iisph_min_iters)) \
            and it < cfg.iisph_max_iters:
        if fused:
            # the whole iteration in one K7 call, in place on pp
            _, _, resid = engine.k7_fused_jacobi_iter(grid, d_ii, deninv,
                                                      a_ii, b_rhs, pp, dt)
        else:
            # wcsph_tpu/solvers/iisph.py:127-145: the dij sweep, then the
            # s sweep on the finished dij
            dij = comm.lower(engine.k1_iisph_dij(
                grid, comm.lift(torch.where(liq, -v0 * pp / den_i2, 0.0))))
            s = comm.lower(engine.k1_iisph_s(
                grid, d_ii, comm.lift(dij),
                comm.lift(torch.where(liq, pp, 0.0)), v0 * pp / den_i2))
            pp, resid = jacobi_tail(pp, s)
        err = f32(comm.read(resid)) / n_liq
        it += 1

    # pressure force + integrate (iisph.py:372-396)
    d_vel_p = comm.lower(engine.k5_iisph_force(grid,
                                               comm.lift(pp / den_i2)))
    velp = velp + torch.where(liq3, d_vel_p * float(dt), 0.0)
    return MidResult(vel=velp, pressure=pp, delta_v=visc.delta_v, iters=it,
                     visc_iters=visc.iters, err=err, err_pre=err_pre)


def bin_and_pack(state: FluidState, cfg: SimConfig):
    """The step's grid stage: (grid, the three packed fields); no host
    read."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    return grid, pack(grid, [state.vel, state.vel_guess, state.pressure])


def step(state: FluidState, cfg: SimConfig,
         slots: ListSlots | None = None, fused=FUSED_ALL) -> FluidState:
    """One step; ``slots``: the neighbour list's buffer, kept by the caller
    from step to step (a fresh one, sized by this step, where None);
    ``fused``: the loops that may run fused (``NoComm``)."""
    nl = state.n_liquid
    dt = f32(state.dt)
    slots = ListSlots() if slots is None else slots

    def run():
        grid, packed = bin_and_pack(state, cfg)
        comm = NoComm(grid, cfg, fused)
        return comm, step_middle(comm, cfg, *packed, dt, slots)

    comm, mid = replaying(run, slots)
    grid = comm.grid
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
        vel_max=vel_max(comm, mid.vel),
    )
    return state.replace(pos=pos, vel=vel, pressure=pressure,
                         vel_guess=vel_guess, time=f32(state.time + dt),
                         diag=diag)
