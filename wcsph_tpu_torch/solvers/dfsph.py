"""DFSPH: divergence-free SPH, the flagship solver (port of
``wcsph_tpu/solvers/dfsph.py``, fused forms only).

One step: bin + pack (``bin_and_pack``) -> density + DFSPH factor alpha
(+ warm-start drho, one K1 sweep) -> the step's neighbour list (its slice
offsets and one fill kernel; every sweep below walks it: K2, K3, K6, K4,
K1's visc-init, vorticity and advected-density sweeps) -> divergence solve
(warm start K2, iterations K3 mode 0) -> non-pressure forces (gravity,
surface tension when on: K6, implicit-viscosity PCG: K1 + K4, micropolar
vorticity: K1) -> adaptive CFL dt -> velocity update -> constant-density
solve (advected density K1, iterations K3 mode 1) -> unpack + position
update.

The solver loops end on the host: each iteration's error is read back and
tested there (``Grid.read``), with the JAX package's loop contracts and
float32 scalar arithmetic.  From the positions to the filled list the step
makes no host read; its first read, the divergence loop's, also brings the
liquid count and the list's status.  A list that outgrew the slot buffer
kept from step to step (``grid.ListSlots``) makes the step run again from
its inputs with a larger buffer (``common.replaying``).  There is no
communicator layer: the single-device engine is called directly (the
multi-GPU port will add one).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import engine, viscosity
from ..config import SimConfig
from ..grid import Grid, ListSlots, build_grid, pack, unpack
from ..state import FluidState, StepDiagnostics
from .common import liquid_sum, replaying

f32 = np.float32


def default_config(**overrides) -> SimConfig:
    """Reference dfsph defaults (dfsph.py:27-41, ParticleData.py:18-88)."""
    base = dict(
        solid_volume_scale=1.0,
        viscosity=10.0,
        viscosity_b=10.0,
        adaptive_dt=True,
        dt_init=1e-3,
        dt_min=1e-4,
        dt_max=5e-3,
    )
    base.update(overrides)
    return SimConfig(**base)


class _SolveResult(NamedTuple):
    vel: torch.Tensor        # (3, M)
    kappa: torch.Tensor      # (M,)
    iters: int
    err: np.float32
    err_pre: np.float32      # error BEFORE the first correction


def divergence_solve(grid: Grid, velp, kvp, alphap, cntp, dt,
                     drho0=None) -> _SolveResult:
    """Divergence-free velocity solver (reference dfsph.py:131-146,
    415-485).  ``drho0``, if given, is the warm-start drho of the incoming
    velocity (from the density sweep's 7th channel)."""
    cfg = grid.cfg
    rho0 = cfg.rest_density
    dt = f32(dt)
    velp = velp.clone()

    def post_div(acc):
        return torch.where(cntp < cfg.min_div_neighbors, 0.0,
                           torch.clamp(acc, min=0.0))

    if cfg.divergence_warm_start:
        # warmstart_divergence_vel (dfsph.py:415-439): the per-receiver
        # acceptance where(drho_ws > 0, vel_ws, vel) is a gate field
        k_ws = 0.5 * torch.clamp(kvp / float(dt), min=-0.5 * rho0 * rho0)
        drho_ws = (engine.drho_divergence(grid, velp, cntp)
                   if drho0 is None else drho0)
        acc = torch.empty_like(drho_ws)
        velp, acc = engine.k2_fused_kappa_drho(
            grid, velp, (float(dt) * k_ws).contiguous(),
            (grid.liq * (drho_ws > 0.0)).contiguous(), acc)
        drho = post_div(acc)
    else:
        drho = engine.drho_divergence(grid, velp, cntp)

    alpha_dt = (alphap / float(dt)).contiguous()
    kvp = torch.zeros_like(kvp)
    cnt_gate = (cntp >= cfg.min_div_neighbors).to(torch.float32)
    drho = drho.contiguous()
    err, it, threshold = f32(0.0), 0, None
    while it == 0 or (err > threshold and it < cfg.dfsph_div_max_iters):
        e = engine.k3_fused_iter_full(grid, velp, kvp, drho, alpha_dt,
                                      cnt_gate, dt, 0)
        err = f32(grid.read(e))
        if threshold is None:     # the first read brought the liquid count
            threshold = f32(cfg.dfsph_div_tol) * f32(grid.liquid_count) / dt
        it += 1
    # end_divergence_iter (dfsph.py:479-485): kappa_v stored scaled by dt
    return _SolveResult(vel=velp, kappa=kvp * float(dt), iters=it, err=err,
                        err_pre=f32(0.0))


def pressure_solve(grid: Grid, velp, kp, alphap, rhop, dt) -> _SolveResult:
    """Constant-density solver (reference dfsph.py:150-164, 487-552)."""
    cfg = grid.cfg
    rho0 = cfg.rest_density
    dt = f32(dt)
    dt2 = dt * dt
    velp = velp.clone()
    rr0 = (rhop / rho0).contiguous()

    def post_adv(acc):
        return torch.clamp(rr0 + float(dt) * acc, min=1.0)

    if cfg.pressure_warm_start:
        # the intended SPlisHSPlasH warm start (the reference's is inert)
        k_ws = torch.clamp(kp / float(dt2), min=-0.5 * rho0 * rho0)
        adv_ws = engine.advected_density(grid, velp, rhop, dt)
        acc = torch.empty_like(adv_ws)
        velp, acc = engine.k2_fused_kappa_drho(
            grid, velp, (float(dt) * k_ws).contiguous(),
            (grid.liq * (adv_ws > 1.0)).contiguous(), acc)
        adv = post_adv(acc)
    else:
        adv = engine.advected_density(grid, velp, rhop, float(dt))

    alpha_dt2 = (alphap / float(dt2)).contiguous()
    kp = torch.zeros_like(kp)
    adv = adv.contiguous()
    err_sum = liquid_sum(grid, adv - 1.0)
    n_liq = f32(grid.liquid_count)
    err_pre = err_sum / n_liq
    err, it = f32(0.0), 0
    while ((err > f32(cfg.dfsph_tol)) or (it < cfg.dfsph_min_iters)) \
            and it < cfg.dfsph_max_iters:
        e = engine.k3_fused_iter_full(grid, velp, kp, adv, alpha_dt2, rr0,
                                      dt, 1)
        err = f32(grid.read(e)) / n_liq
        it += 1
    # end_pressure_iter (dfsph.py:549-552): kappa stored scaled by dt^2
    return _SolveResult(vel=velp, kappa=kp * float(dt) * float(dt),
                        iters=it, err=err,
                        err_pre=err_pre)


class MidResult(NamedTuple):
    """Everything the sorted middle of the step produces."""

    vel: torch.Tensor
    omega: torch.Tensor
    vel_guess: torch.Tensor
    kappa: torch.Tensor
    kappa_v: torch.Tensor
    new_dt: np.float32
    div_iters: int
    pr_iters: int
    visc_iters: int
    err: np.float32
    err_pre: np.float32
    vmax_sq: np.float32


def density_and_list(grid: Grid, velp, slots: ListSlots | None = None):
    """(rho, alpha, count, warm-start divergence sum) of the density sweep,
    then the step's neighbour list from its counts, into ``slots``: no
    host read once ``slots`` is sized.  Positions stay put until the
    position update: one list serves every solver sweep of the step."""
    out = engine.density_alpha(grid, velp)
    engine.nbr_list_fill(grid, out[2], slots)
    return out


def step_middle(grid: Grid, cfg: SimConfig, velp, omegap, vgp, kp, kvp, dt,
                last_pressure_iters: int,
                slots: ListSlots | None = None) -> MidResult:
    """The whole per-step solve on the sorted layout (everything between
    bin/pack and unpack/position update)."""
    dt = f32(dt)
    liq = grid.liquid
    rhop, alphap, cntp, div_acc = density_and_list(grid, velp, slots)
    drho0 = None
    if cfg.divergence_warm_start:
        drho0 = torch.where(cntp < cfg.min_div_neighbors, 0.0,
                            torch.clamp(div_acc, min=0.0))
    # alpha is a LIQUID quantity: the kappas k = drho alpha / dt must stay
    # exactly 0 at boundary rows (reference dfsph.py:449-477)
    alphap = torch.where(liq, alphap, 0.0)

    div = divergence_solve(grid, velp, kvp, alphap, cntp, dt, drho0=drho0)
    velp = div.vel

    # non-pressure forces (dfsph.py:84-103), liquid rows only: boundary
    # rows keep d_vel = 0 (they feed (v_i - v_j) pair terms)
    g = torch.tensor(cfg.gravity, dtype=torch.float32, device=velp.device)
    d_vel = torch.where(liq[None], g[:, None], 0.0)
    if cfg.tension_coff != 0.0 or cfg.tension_coff_b != 0.0:
        # surface normals + cohesion, curvature and adhesion: one K6 call
        _, dv_t = engine.fused_tension(grid, rhop)
        d_vel = d_vel + torch.where(liq[None], dv_t, 0.0)
    visc = viscosity.solve_dense(grid, velp, vgp, rhop, dt)
    d_vel = d_vel + (visc.vel_new - velp) / float(dt)    # end_viscosity
    if cfg.enable_vorticity:
        dv_vort, omegap = engine.vorticity(grid, velp, omegap, rhop, cntp,
                                           dt)
        d_vel = d_vel + torch.where(liq[None], dv_vort, 0.0)

    # adaptive dt (dfsph.py:107-129): CFL from the old dt, iteration
    # feedback from this frame's viscosity and LAST frame's pressure iters
    vnew = velp + d_vel * float(dt)
    vmax = torch.max(torch.where(liq, torch.sum(vnew * vnew, dim=0),
                                 -torch.inf)) if grid.n else None
    vmax_sq = max(f32(grid.read(vmax)) if vmax is not None
                  else f32(-np.inf), f32(0.1))
    if cfg.adaptive_dt:
        feedback = max(visc.iters, last_pressure_iters)
        time_step = np.clip(
            f32(cfg.cfl_factor * 0.4 * 2.0 * cfg.particle_radius)
            / np.sqrt(vmax_sq), f32(cfg.dt_min), f32(cfg.dt_max))
        if feedback > 10:
            new_dt = dt * f32(0.9)
        elif feedback < 5:
            new_dt = dt * f32(1.1)
        else:
            new_dt = dt
        new_dt = min(new_dt, time_step)
    else:
        new_dt = dt
    new_dt = f32(new_dt)

    velp = velp + d_vel * float(new_dt)                   # update_vel
    pr = pressure_solve(grid, velp, kp, alphap, rhop, new_dt)
    return MidResult(vel=pr.vel, omega=omegap, vel_guess=visc.delta_v,
                     kappa=pr.kappa, kappa_v=div.kappa, new_dt=new_dt,
                     div_iters=div.iters, pr_iters=pr.iters,
                     visc_iters=visc.iters, err=pr.err, err_pre=pr.err_pre,
                     vmax_sq=vmax_sq)


def bin_and_pack(state: FluidState, cfg: SimConfig):
    """The step's grid stage: (grid, the five packed fields); no host read."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    return grid, pack(grid, [state.vel, state.omega, state.vel_guess,
                             state.kappa, state.kappa_v])


def step(state: FluidState, cfg: SimConfig,
         slots: ListSlots | None = None) -> FluidState:
    """One step; ``slots``: the neighbour list's buffer, kept by the caller
    from step to step (a fresh one, sized by this step, where None)."""
    slots = ListSlots() if slots is None else slots

    def run():
        grid, packed = bin_and_pack(state, cfg)
        return grid, step_middle(grid, cfg, *packed, state.dt,
                                 state.last_pressure_iters, slots)

    nl = state.n_liquid
    grid, mid = replaying(run, slots)
    # unpack + position update (liquid outside the domain keeps its state)
    vel, omega, vel_guess, kappa, kappa_v = unpack(
        grid, [mid.vel, mid.omega, mid.vel_guess, mid.kappa, mid.kappa_v],
        [state.vel, state.omega, state.vel_guess, state.kappa,
         state.kappa_v])
    pos = state.pos.clone()
    pos[:, :nl] += vel * float(mid.new_dt)                # update_pos
    diag = StepDiagnostics(
        divergence_iters=mid.div_iters,
        pressure_iters=mid.pr_iters,
        viscosity_iters=mid.visc_iters,
        density_error=mid.err,
        density_error_pre=mid.err_pre,
        neighbor_overflow=0,
        vel_max=f32(np.sqrt(mid.vmax_sq)),
    )
    return state.replace(
        pos=pos, vel=vel, omega=omega, vel_guess=vel_guess, kappa=kappa,
        kappa_v=kappa_v, dt=mid.new_dt, time=f32(state.time + mid.new_dt),
        last_visc_iters=mid.visc_iters,
        last_pressure_iters=mid.pr_iters, diag=diag)
