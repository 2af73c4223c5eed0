"""PCISPH: predictive-corrective incompressible SPH (port of
``wcsph_tpu/solvers/pcisph.py``).

One step: bin + pack (``bin_and_pack``) -> density (K5 ``_DensityAlpha``)
-> explicit viscosity (K5 ``_SesphForce`` with zero pressure) -> prediction
loop, one K8 call per iteration (predicted density at the advected
positions, pressure update, pressure acceleration) -> integrate.  As in the JAX package, and
unlike the Taichi reference, the density is predicted at the ADVECTED
positions and the pressure accumulates across iterations; the binning stays
that of the original positions.

The loop ends on the host: each iteration's error sum is read back and
tested there (``Grid.read``), with the JAX package's loop contract and
float32 scalar arithmetic.  K8 keeps each iteration's pairs at the advected
positions in a hit buffer of a uniform width per row (``grid.StarHits``),
the step's ``slots``, kept from step to step (sized by the first step from
its density sweep's largest count: one host read).  The read after each
iteration also brings its overflow flag; an iteration with a row of more
hits than the width makes the step run again with a wider buffer
(``common.replaying``).

With ``fused_solver_iters=False`` (``engine.use_fused_iters``) each
iteration is the JAX package's unfused form instead: the moved positions
x* = x + liq v* dt in torch ops, a prediction sweep at x* with the old
pressure, the pressure update, and a second one with the new pressure for
the acceleration.  The first call cuts the cells' candidates at x*
(``k1_pcisph_predict``) and keeps its hits (``grid.PredictHits``) in the
same ``slots``, sized as the fused form's; the second walks them
(``k1_pcisph_walk``), scanning again any row with more hits than the
buffer's width, so nothing is flagged or replayed.  The middle takes a
communicator (``parallel/comm.py``, as in ``solvers/dfsph.py``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import engine, kernels
from ..config import SimConfig
from ..grid import ListSlots, build_grid, pack, unpack
from ..parallel.comm import FUSED_ALL, NoComm
from ..state import FluidState, StepDiagnostics
from .common import gravity_column, replaying, vel_max

f32 = np.float32


def default_config(**overrides) -> SimConfig:
    """Reference pcisph defaults (pcisph.py:23-72): VS0 = 2*VL0, nu = 0.05."""
    base = dict(
        solid_volume_scale=2.0,
        explicit_viscosity=0.05,
        explicit_viscosity_b=0.0,
        adaptive_dt=False,
        dt_init=1e-3,
    )
    base.update(overrides)
    return SimConfig(**base)


@functools.lru_cache(maxsize=8)
def pci_coefficient(particle_radius: float) -> float:
    """Prototype-neighborhood stiffness (pcisph.py:87-115).

    Integrates gradW over a filled lattice of spacing 2r inside the support
    sphere: coff = 1 / (2 V0^2 (|sum gradW|^2 + sum |gradW|^2)).
    """
    h = 4.0 * particle_radius
    diam = 2.0 * particle_radius
    v0 = particle_radius**3 * 0.8 * 8.0
    m_l = 48.0 / (math.pi * h**3)

    coords = np.arange(-h, h + 1e-9, diam)
    g = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"), -1).reshape(-1, 3)
    r = -g  # xi - xj with xi at origin
    dist = np.linalg.norm(r, axis=1)
    inside = (dist < h) & (dist > 1e-5)
    r, dist = r[inside], dist[inside]
    q = dist / h
    mag = np.where(q <= 0.5, m_l * q * (3.0 * q - 2.0), -m_l * (1.0 - q) ** 2)
    grads = mag[:, None] * r / (dist * h)[:, None]
    sum_grad = grads.sum(axis=0)
    sum_sq = float((grads**2).sum())
    beta = 2.0 * v0 * v0
    return 1.0 / (beta * (float(sum_grad @ sum_grad) + sum_sq))


class MidResult(NamedTuple):
    vel: torch.Tensor         # (3, M)
    pressure: torch.Tensor    # (M,)
    iters: int
    err: np.float32
    err_pre: np.float32       # predicted density error before any pressure


def step_middle(comm, cfg: SimConfig, velp, dt,
                slots: ListSlots | None = None) -> MidResult:
    """The whole PCISPH solve on the sorted layout, on the communicator's
    grid; ``slots``: the iterations' hit buffer, K8's or the unfused
    prediction's (sized here where it is unsized or None)."""
    grid = comm.grid
    coff = pci_coefficient(cfg.particle_radius)
    dt = f32(dt)

    # non-pressure forces + density (pcisph.py:199-218); the SESPH force
    # sweep with zero pressure is the pure explicit viscosity
    rhop, cntp = engine.density(grid)
    fused = engine.use_fused_iters(comm, "fused_pcisph_iter")
    slots = ListSlots() if slots is None else slots
    if slots.capacity is None:      # the first step's one host read
        slots.size_for(grid.n * int(cntp.max()))
    d_vel = gravity_column(cfg, velp) + comm.lower(engine.sesph_force(
        grid, comm.lift(velp), comm.lift(rhop, 1.0), torch.zeros_like(rhop)))
    w0 = cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius)
    liq = grid.liquid

    d_vel_pre = torch.zeros_like(velp)
    pp = torch.zeros_like(velp[0])
    err, err_pre, it = f32(1.0), f32(0.0), 0
    while ((err > f32(cfg.pcisph_tol)) or (it < cfg.pcisph_min_iters)) \
            and it < cfg.pcisph_max_iters:
        vel_star = velp + (d_vel + d_vel_pre) * float(dt)  # pcisph.py:228-235
        if fused:
            # K8: the prediction, the pressure update and the acceleration
            _, d_vel_pre, scal = engine.fused_pcisph_iter(
                grid, vel_star, pp, dt, coff, slots)
        else:
            # wcsph_tpu/solvers/pcisph.py:183-216: predict at x*, update
            # p, predict again at x* for the acceleration, walking the
            # first call's hits (the first prediction's acceleration is
            # not used: its pressure needs no lift)
            xstar = comm.lift(grid.pos + torch.where(
                liq[None], vel_star * float(dt), 0.0), 1e9)
            adv_raw, _, hits = engine.pcisph_predict(grid, xstar, pp, slots)
            adv = torch.clamp(w0 + comm.lower(adv_raw), min=1.0)
            pp = pp + coff * (adv - 1.0) / float(dt * dt)   # pcisph.py:255
            d_vel_pre = comm.lower(engine.k1_pcisph_walk(
                grid, xstar, comm.lift(pp), hits)[1:4])
            scal = comm.lsum(adv - 1.0)
        # each read brings the liquid count the first time, and K8's
        # overflow flag
        err = f32(comm.read(scal)) / f32(comm.n_liquid)
        # the first iteration predicts with p == 0: its error IS the
        # pre-solve violation
        if it == 0:
            err_pre = err
        it += 1

    velp = velp + (d_vel + d_vel_pre) * float(dt)           # pcisph.py:281-285
    return MidResult(vel=velp, pressure=pp, iters=it, err=err,
                     err_pre=err_pre)


def bin_and_pack(state: FluidState, cfg: SimConfig):
    """The step's grid stage: (grid, [packed velocity]); no host read."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    return grid, pack(grid, [state.vel])


def step(state: FluidState, cfg: SimConfig,
         slots: ListSlots | None = None, fused=FUSED_ALL) -> FluidState:
    """One step; ``slots``: the iterations' hit buffer, kept by the caller
    from step to step (a fresh one, sized by this step, where None);
    ``fused``: the loops that may run fused (``NoComm``)."""
    nl = state.n_liquid
    dt = f32(state.dt)
    slots = ListSlots() if slots is None else slots

    def run():
        grid, (velp,) = bin_and_pack(state, cfg)
        comm = NoComm(grid, cfg, fused)
        return comm, step_middle(comm, cfg, velp, dt, slots)

    comm, mid = replaying(run, slots)
    grid = comm.grid
    vel, pressure = unpack(grid, [mid.vel, mid.pressure],
                           [state.vel, state.pressure])
    pos = state.pos.clone()
    pos[:, :nl] += vel * float(dt)
    diag = StepDiagnostics(
        pressure_iters=mid.iters,
        density_error=mid.err,
        density_error_pre=mid.err_pre,
        neighbor_overflow=0,
        vel_max=vel_max(comm, mid.vel),
    )
    return state.replace(pos=pos, vel=vel, pressure=pressure,
                         time=f32(state.time + dt), diag=diag)
