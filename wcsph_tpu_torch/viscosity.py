"""Implicit viscosity: matrix-free block-Jacobi preconditioned CG.

Port of ``wcsph_tpu/viscosity.py:solve_dense`` in its fused form: Weiler
2018 implicit viscosity, (I - dt/rho L_visc) v' = v, with a 3x3
block-Jacobi preconditioner (Sym3 components).  The setup (preconditioner
sums + A x0) is one K1 sweep; each PCG iteration is one K4 call, whose two
global dots stay on the device.  Both the setup sweep and K4's matvec walk
the step's neighbour list (built by the solver before it calls here; on
the card both raise without one).  The loop ends on the host: it reads
delta' after each iteration (``Grid.read``).

Warm start: the previous frame's delta-v lives in vel_guess and the
initial guess is vel_guess + vel; on return vel_guess holds the new
delta-v (reference dfsph.py:199-200, 340-343).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import engine
from .grid import Grid
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


def solve_dense(grid: Grid, velp: torch.Tensor, vel_guessp: torch.Tensor,
                rhop: torch.Tensor, dt) -> ViscositySolution:
    cfg = grid.cfg
    liq = grid.liquid
    x = vel_guessp + velp
    minv, ax0 = engine.visc_init(grid, x, rhop, dt)
    if not cfg.viscosity_precond:
        minv = _identity_precond(minv)
    r = torch.where(liq[None], velp - ax0, 0.0)
    d = minv.matvec(r)
    delta = torch.sum(torch.where(liq, torch.sum(r * d, dim=0), 0.0))
    rinv = engine.rho_inv(rhop)
    minv6 = torch.stack(list(minv)).contiguous()
    delta0 = np.float32(grid.read(delta))
    delta_h = delta0
    it = 0
    # (it == 0) | (it < max & delta > err * delta0 & delta0 >= eps)
    while it == 0 or (it < cfg.max_cg_iters
                      and delta_h > np.float32(cfg.viscosity_err) * delta0
                      and delta0 >= np.float32(cfg.eps)):
        scal = engine.k4_fused_visc_iter(grid, x, r, d, delta, rinv, minv6,
                                         dt)
        delta = scal[1]
        delta_h = np.float32(grid.read(delta))
        it += 1
    return ViscositySolution(vel_new=x, delta_v=x - velp, iters=it)
