"""DFSPH: divergence-free SPH, the flagship solver (port of
``wcsph_tpu/solvers/dfsph.py``).

One step: bin + pack (``bin_and_pack``) -> density + DFSPH factor alpha
(+ warm-start drho, one K1 sweep) -> the step's neighbour list (its slice
offsets and one fill kernel; every sweep below walks it: K2, K3, K6, K4,
K1's visc-init, vorticity and advected-density sweeps) -> divergence solve
(warm start K2, iterations K3 mode 0) -> non-pressure forces (gravity,
surface tension when on: K6, implicit-viscosity PCG: K1 + K4, micropolar
vorticity: K1) -> adaptive CFL dt -> velocity update -> constant-density
solve (advected density K1, iterations K3 mode 1) -> unpack + position
update.  With ``fused_solver_iters=False`` (``engine.use_fused_iters``)
the loops and the tension take the JAX package's unfused forms: each
iteration a kappa sweep (``k1_kappa_acc``) and a divergence sweep
(``k1_div_acc``), the tension a normals sweep and a tension sweep
(``k1_surface_normals``, ``k1_tension_accel``), the viscosity PCG a
matvec sweep (``k1_visc_acc``) and torch ops; every sweep walks the list.

The solver loops end on the host: each iteration's error is read back and
tested there (``Grid.read``), with the JAX package's loop contracts and
float32 scalar arithmetic.  From the positions to the filled list the step
makes no host read; its first read, the divergence loop's, also brings the
liquid count and the list's status.  A list that outgrew the slot buffer
kept from step to step (``grid.ListSlots``) makes the step run again from
its inputs with a larger buffer (``common.replaying``).

Every function of the step's middle takes a communicator
(``parallel/comm.py``), as the JAX package's do: ``step`` builds a
``NoComm`` (one card: lifts and lowers are identities, the reductions run
over the grid's liquid rows); the slab steps (``parallel/slab.py``) pass
a ``SlabComm`` or a ``DirectSlabComm``, under which each sweep's
neighbour-read inputs are lifted (their ghost rows exchanged), each
sweep's outputs lowered, and every liquid sum and max all-reduced.  The
one-plane ``SlabComm`` runs every loop unfused; the two-plane
``DirectSlabComm`` runs the divergence and pressure loops fused, K2 and K3
through the communicator (``comm.fused_kappa_drho``,
``comm.fused_iter_full``: refresh, kernel, own-row error), and the
tension and the viscosity PCG unfused (``engine.use_fused_iters``).
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
from .common import replaying

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


def _kappa_update(comm, velp, k, dt):
    """The unfused loops' velocity update by the kappas ``k`` (read at the
    neighbour: lifted)."""
    return comm.lower(engine.kappa_velocity_update(comm.grid, velp,
                                                   comm.lift(k), dt))


def divergence_solve(comm, velp, kvp, alphap, cntp, dt,
                     drho0=None) -> _SolveResult:
    """Divergence-free velocity solver (reference dfsph.py:131-146,
    415-485): the warm start, then iterations of the kappa velocity update
    and the divergence of the new velocity, in the fused form (K2, then one
    K3 an iteration) or the unfused one (``engine.use_fused_iters``: a
    kappa sweep and a divergence sweep each).  ``drho0``, if given, is the
    warm-start drho of the incoming velocity (from the density sweep's 7th
    channel).  ``err_pre`` is the liquid sum of drho before the first
    iteration; it rides on the first iteration's read."""
    grid, cfg = comm.grid, comm.cfg
    rho0 = cfg.rest_density
    dt = f32(dt)
    fused = engine.use_fused_iters(comm, "fused_kappa_drho")
    alpha_dt = (alphap / float(dt)).contiguous()

    def drho_of(velp):
        return comm.lower(engine.drho_divergence(grid, comm.lift(velp),
                                                 cntp))

    if fused:
        velp = velp.clone()
        cnt_gate = (cntp >= cfg.min_div_neighbors).to(torch.float32)

        def iterate(velp, kvp, drho):
            # the whole iteration in one K3 call, in place
            return velp, kvp, drho, comm.fused_iter_full(
                velp, kvp, drho, alpha_dt, cnt_gate, dt, 0)
    else:
        def iterate(velp, kvp, drho):
            k = drho * alpha_dt
            velp = _kappa_update(comm, velp, k, dt)
            drho = drho_of(velp)
            return velp, kvp + k, drho, comm.lsum(drho)

    drho = None
    if cfg.divergence_warm_start:
        # warmstart_divergence_vel (dfsph.py:415-439): the per-receiver
        # acceptance where(drho_ws > 0, vel_ws, vel); fused, a gate field
        # of K2, whose second sweep gives the new velocity's drho
        k_ws = 0.5 * torch.clamp(kvp / float(dt), min=-0.5 * rho0 * rho0)
        drho_ws = drho_of(velp) if drho0 is None else drho0
        if fused:
            acc = torch.empty_like(drho_ws)
            velp, acc = comm.fused_kappa_drho(
                velp, (float(dt) * k_ws).contiguous(),
                (grid.liq * (drho_ws > 0.0)).contiguous(), acc)
            drho = torch.where(cntp < cfg.min_div_neighbors, 0.0,
                               torch.clamp(acc, min=0.0))
        else:
            vel_ws = _kappa_update(comm, velp, k_ws, dt)
            velp = torch.where((drho_ws > 0.0)[None], vel_ws, velp)
    if drho is None:
        drho = drho_of(velp)          # begin_divergence_iter (dfsph.py:441)

    kvp = torch.zeros_like(kvp)
    drho = drho.contiguous()
    err_pre_sum = comm.lsum(drho)
    err, err_pre, it, threshold = f32(0.0), f32(0.0), 0, None
    while it == 0 or (err > threshold and it < cfg.dfsph_div_max_iters):
        velp, kvp, drho, e = iterate(velp, kvp, drho)
        if threshold is None:
            # the first read brings err_pre and the liquid count
            err, err_pre = map(f32, comm.read(e, err_pre_sum))
            threshold = f32(cfg.dfsph_div_tol) * f32(comm.n_liquid) / dt
        else:
            err = f32(comm.read(e))
        it += 1
    # end_divergence_iter (dfsph.py:479-485): kappa_v stored scaled by dt
    return _SolveResult(vel=velp, kappa=kvp * float(dt), iters=it, err=err,
                        err_pre=err_pre)


def pressure_solve(comm, velp, kp, alphap, rhop, dt) -> _SolveResult:
    """Constant-density solver (reference dfsph.py:150-164, 487-552),
    fused (K2, then one K3 an iteration) or unfused (a kappa sweep and a
    divergence sweep an iteration), as ``divergence_solve``."""
    grid, cfg = comm.grid, comm.cfg
    rho0 = cfg.rest_density
    dt = f32(dt)
    dt2 = dt * dt
    fused = engine.use_fused_iters(comm, "fused_kappa_drho")
    alpha_dt2 = (alphap / float(dt2)).contiguous()

    def adv_of(velp):
        return comm.lower(engine.advected_density(grid, comm.lift(velp),
                                                  rhop, float(dt)))

    if fused:
        velp = velp.clone()
        rr0 = (rhop / rho0).contiguous()

        def iterate(velp, kp, adv):
            # the whole iteration in one K3 call (mode 1), in place
            return velp, kp, adv, comm.fused_iter_full(
                velp, kp, adv, alpha_dt2, rr0, dt, 1)
    else:
        def iterate(velp, kp, adv):
            k = (adv - 1.0) * alpha_dt2
            velp = _kappa_update(comm, velp, k, dt)
            adv = adv_of(velp)
            return velp, kp + k, adv, comm.lsum(adv - 1.0)

    adv = None
    if cfg.pressure_warm_start:
        # the intended SPlisHSPlasH warm start (the reference's is inert)
        k_ws = torch.clamp(kp / float(dt2), min=-0.5 * rho0 * rho0)
        adv_ws = adv_of(velp)
        if fused:
            acc = torch.empty_like(adv_ws)
            velp, acc = comm.fused_kappa_drho(
                velp, (float(dt) * k_ws).contiguous(),
                (grid.liq * (adv_ws > 1.0)).contiguous(), acc)
            adv = torch.clamp(rr0 + float(dt) * acc, min=1.0)
        else:
            vel_ws = _kappa_update(comm, velp, k_ws, dt)
            velp = torch.where((adv_ws > 1.0)[None], vel_ws, velp)
    if adv is None:
        adv = adv_of(velp)           # begin_pressure_iter (dfsph.py:510)

    kp = torch.zeros_like(kp)
    adv = adv.contiguous()
    err_sum = f32(comm.read(comm.lsum(adv - 1.0)))
    n_liq = f32(comm.n_liquid)
    err_pre = err_sum / n_liq
    err, it = f32(0.0), 0
    while ((err > f32(cfg.dfsph_tol)) or (it < cfg.dfsph_min_iters)) \
            and it < cfg.dfsph_max_iters:
        velp, kp, adv, e = iterate(velp, kp, adv)
        err = f32(comm.read(e)) / n_liq
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


def step_middle(comm, cfg: SimConfig, velp, omegap, vgp, kp, kvp, dt,
                last_pressure_iters: int,
                slots: ListSlots | None = None) -> MidResult:
    """The whole per-step solve on the sorted layout (everything between
    bin/pack and unpack/position update), on the communicator's grid."""
    grid = comm.grid
    dt = f32(dt)
    liq = grid.liquid
    rhop, alphap, cntp, div_acc = density_and_list(grid, comm.lift(velp),
                                                   slots)
    # rho is read at the neighbour by the viscosity, vorticity and tension
    # sweeps
    rhop = comm.lift(rhop, 1.0)
    alphap, cntp, div_acc = map(comm.lower, (alphap, cntp, div_acc))
    drho0 = None
    if cfg.divergence_warm_start:
        drho0 = torch.where(cntp < cfg.min_div_neighbors, 0.0,
                            torch.clamp(div_acc, min=0.0))
    # alpha is a LIQUID quantity: the kappas k = drho alpha / dt must stay
    # exactly 0 at boundary rows (reference dfsph.py:449-477)
    alphap = torch.where(liq, alphap, 0.0)

    div = divergence_solve(comm, velp, kvp, alphap, cntp, dt, drho0=drho0)
    velp = div.vel

    # non-pressure forces (dfsph.py:84-103), liquid rows only: boundary
    # rows keep d_vel = 0 (they feed (v_i - v_j) pair terms)
    g = torch.tensor(cfg.gravity, dtype=torch.float32, device=velp.device)
    d_vel = torch.where(liq[None], g[:, None], 0.0)
    if cfg.tension_coff != 0.0 or cfg.tension_coff_b != 0.0:
        # surface normals + cohesion, curvature and adhesion: one K6 call,
        # or unfused a normals sweep and a tension sweep
        if engine.use_fused_iters(comm, "fused_tension"):
            _, dv_t = engine.fused_tension(grid, rhop)
        else:
            normals = comm.lower(engine.surface_normals(grid, rhop))
            dv_t = comm.lower(engine.k1_tension_accel(
                grid, rhop, comm.lift(normals)))
        d_vel = d_vel + torch.where(liq[None], dv_t, 0.0)
    visc = viscosity.solve_dense(comm, velp, vgp, rhop, dt)
    d_vel = d_vel + (visc.vel_new - velp) / float(dt)    # end_viscosity
    if cfg.enable_vorticity:
        dv_vort, omegap = map(comm.lower, engine.vorticity(
            grid, comm.lift(velp), comm.lift(omegap), rhop, cntp, dt))
        d_vel = d_vel + torch.where(liq[None], dv_vort, 0.0)

    # adaptive dt (dfsph.py:107-129): CFL from the old dt, iteration
    # feedback from this frame's viscosity and LAST frame's pressure iters
    vnew = velp + d_vel * float(dt)
    vmax = comm.lmax(torch.sum(vnew * vnew, dim=0)) if grid.n else None
    vmax_sq = max(f32(comm.read(vmax)) if vmax is not None
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
    pr = pressure_solve(comm, velp, kp, alphap, rhop, new_dt)
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
         slots: ListSlots | None = None, fused=FUSED_ALL) -> FluidState:
    """One step; ``slots``: the neighbour list's buffer, kept by the caller
    from step to step (a fresh one, sized by this step, where None);
    ``fused``: the loops that may run fused (``NoComm``)."""
    slots = ListSlots() if slots is None else slots

    def run():
        grid, packed = bin_and_pack(state, cfg)
        return grid, step_middle(NoComm(grid, cfg, fused), cfg, *packed,
                                 state.dt, state.last_pressure_iters, slots)

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
