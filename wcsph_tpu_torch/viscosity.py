"""Implicit viscosity: matrix-free block-Jacobi preconditioned CG.

Port of ``wcsph_tpu/viscosity.py:solve_dense``: Weiler 2018 implicit
viscosity, (I - dt/rho L_visc) v' = v, with a 3x3 block-Jacobi
preconditioner (Sym3 components).  The setup (preconditioner sums + A x0)
is one K1 sweep; each PCG iteration is one K4 call in the fused form, or
in the unfused one (``engine.use_fused_iters``) a matvec sweep
(``engine.visc_matvec``) and torch ops; either way the two global dots
stay on the device.  The setup sweep and the matvec walk the step's
neighbour list (built by the solver before it calls here; on the card they
raise without one).  The loop ends on the host: it reads delta' after each
iteration (``Grid.read``).  Like the JAX package's, the solve takes a
communicator (``parallel/comm.py``): on a slab each sweep's
neighbour-read input is lifted, its output lowered, and both dots are
all-reduced.

Warm start: the previous frame's delta-v lives in vel_guess and the
initial guess is vel_guess + vel; on return vel_guess holds the new
delta-v (reference dfsph.py:199-200, 340-343).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import engine
from .utils import mat3


class ViscositySolution(NamedTuple):
    vel_new: torch.Tensor    # (3, M) solved velocity v'
    delta_v: torch.Tensor    # (3, M) v' - v (next frame's warm start)
    iters: int               # PCG iterations performed


def _identity_precond(minv: mat3.Sym3) -> mat3.Sym3:
    """Plain-CG mode (cfg.viscosity_precond=False)."""
    one = torch.ones_like(minv.xx)
    zero = torch.zeros_like(minv.xx)
    return mat3.Sym3(xx=one, xy=zero, xz=zero, yy=one, yz=zero, zz=one)


def solve_dense(comm, velp: torch.Tensor, vel_guessp: torch.Tensor,
                rhop: torch.Tensor, dt) -> ViscositySolution:
    """``rhop`` is read at the neighbour: on a slab the caller has lifted
    it."""
    grid, cfg = comm.grid, comm.cfg
    liq3 = grid.liquid[None]
    fused = engine.use_fused_iters(comm, "fused_visc_iter")

    def ldot(a, b):
        return comm.lsum(torch.sum(a * b, dim=0))

    x = vel_guessp + velp
    minv, ax0 = engine.visc_init(grid, comm.lift(x), rhop, dt)
    minv = type(minv)(*map(comm.lower, minv))
    ax0 = comm.lower(ax0)
    if not cfg.viscosity_precond:
        minv = _identity_precond(minv)
    r = torch.where(liq3, velp - ax0, 0.0)
    d = minv.matvec(r)
    delta = ldot(r, d)
    if fused:
        rinv = engine.rho_inv(rhop)
        minv6 = torch.stack(list(minv)).contiguous()
    delta0 = np.float32(comm.read(delta))
    delta_h = delta0
    it = 0
    # (it == 0) | (it < max & delta > err * delta0 & delta0 >= eps)
    while it == 0 or (it < cfg.max_cg_iters
                      and delta_h > np.float32(cfg.viscosity_err) * delta0
                      and delta0 >= np.float32(cfg.eps)):
        if fused:
            # the whole iteration in one K4 call, in place on x, r, d
            delta = engine.k4_fused_visc_iter(grid, x, r, d, delta, rinv,
                                              minv6, dt)[1]
        else:
            # wcsph_tpu/viscosity.py:202-217
            ad = torch.where(liq3, comm.lower(engine.visc_matvec(
                grid, comm.lift(d), rhop, dt)), 0.0)
            alpha = delta / (cfg.eps + ldot(d, ad))
            x = x + alpha * d
            r = r - alpha * ad
            s = minv.matvec(r)
            delta_new = ldot(r, s)
            d = s + (delta_new / delta) * d
            delta = delta_new
        delta_h = np.float32(comm.read(delta))
        it += 1
    return ViscositySolution(vel_new=x, delta_v=x - velp, iters=it)
