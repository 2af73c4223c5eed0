"""Plain PyTorch versions of the pair sweeps on the DFSPH main path.

Each function here is the twin of one hand kernel in ``csrc/sweeps.cu``
(same arguments, same outputs; ``engine.py`` picks between them by the
tensors' device).  They run on an explicit pair list: for every particle,
the candidates in its 27 neighbour cells cut to d^2 <= h^2, self excluded.
Per-receiver sums are ``index_add_`` over the pair list.  The per-receiver
formulas are the one-sided bodies of the TPU engine's emits
(``wcsph_tpu/pallas/engine.py``: ``_DensityAlphaDrho`` 1981, ``_KappaAcc``
2005, ``_DivAcc`` 2029, ``_ViscAcc`` 2053, ``_ViscInit`` 2099,
``_Vorticity`` 2145); r = x_i - x_j points from the neighbour j to the
receiver i.

Receivers: the density sweep runs at every in-domain particle; every other
sweep at liquid receivers only (0 at boundary rows), since its outputs are
consumed only there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels
from .grid import Grid


@dataclasses.dataclass
class Pairs:
    """Directed pair list (i receives from j), with per-pair geometry."""

    i: torch.Tensor      # (P,) int64 receiver row
    j: torch.Tensor      # (P,) int64 neighbour row
    r: torch.Tensor      # (3, P) x_i - x_j
    d2: torch.Tensor     # (P,)
    w: torch.Tensor      # (P,) cubic W
    gs: torch.Tensor     # (P,) gradW = gs * r
    liq_j: torch.Tensor  # (P,) float 1.0 if j is liquid
    vol_j: torch.Tensor  # (P,) rest volume of j


def build_pairs(grid: Grid) -> Pairs:
    """All pairs with d^2 <= h^2 (self excluded).  The z-neighbours of a
    cell are consecutive cell ids, so each (dx, dy) column is one
    contiguous row range: 9 ranges per particle."""
    cfg = grid.cfg
    gx, gy, gz = cfg.grid_res
    dev = grid.device
    m = grid.n
    h = cfg.support_radius
    h2 = float(np.float32(h * h))
    cell = grid.cell.to(torch.int64)
    start = grid.cell_start.to(torch.int64)
    cz = cell % gz
    cy = (cell // gz) % gy
    cx = cell // (gy * gz)
    z0 = torch.clamp(cz - 1, min=0)
    z1 = torch.clamp(cz + 1, max=gz - 1)
    rows = torch.arange(m, device=dev)
    ii, jj = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx, ny = cx + dx, cy + dy
            ok = (nx >= 0) & (nx < gx) & (ny >= 0) & (ny < gy)
            base = (nx.clamp(0, gx - 1) * gy + ny.clamp(0, gy - 1)) * gz
            jb = start[base + z0]
            cnt = torch.where(ok, start[base + z1 + 1] - jb, 0)
            total = int(cnt.sum())
            i = torch.repeat_interleave(rows, cnt, output_size=total)
            first = torch.cumsum(cnt, 0) - cnt
            k = torch.arange(total, device=dev)
            j = (torch.repeat_interleave(jb - first, cnt, output_size=total)
                 + k)
            r = grid.pos[:, i] - grid.pos[:, j]
            d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
            keep = (d2 <= h2) & (i != j)
            ii.append(i[keep])
            jj.append(j[keep])
    i = torch.cat(ii)
    j = torch.cat(jj)
    r = grid.pos[:, i] - grid.pos[:, j]
    d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    liq_j = grid.liq[j]
    vol_j = torch.where(grid.liquid[j], cfg.liquid_volume, cfg.solid_volume)
    return Pairs(i=i, j=j, r=r, d2=d2, w=kernels.cubic_w_scalar(dist, h),
                 gs=kernels.cubic_grad_scale(dist, h), liq_j=liq_j,
                 vol_j=vol_j)


def pairs_of(grid: Grid) -> Pairs:
    if grid.pairs is None:
        grid.pairs = build_pairs(grid)
    return grid.pairs


def _sum(p: Pairs, m: int, vals: torch.Tensor) -> torch.Tensor:
    """Per-receiver sums of per-pair values (P,) or (k, P)."""
    out = torch.zeros(vals.shape[:-1] + (m,), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(-1, p.i, vals)


def _dot_r(p: Pairs, a: torch.Tensor) -> torch.Tensor:
    """(a_i - a_j) . r per pair for a planar (3, M) field."""
    da = a[:, p.i] - a[:, p.j]
    return da[0] * p.r[0] + da[1] * p.r[1] + da[2] * p.r[2]


# ---------------------------------------------------------------------------
# K1: the pair sweep, four emits
# ---------------------------------------------------------------------------

def density_alpha_drho(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    """(7, M) raw channels at every receiver: [sum V_j W, count,
    sum V_j gs r (3), sum_liq (V0 gs)^2 d2, sum V_j gs (v_i - v_j).r]."""
    p = pairs_of(grid)
    cfg = grid.cfg
    vgs = p.vol_j * p.gs
    lgs = cfg.liquid_volume * p.gs
    vals = torch.stack([
        p.vol_j * p.w,
        torch.ones_like(p.w),
        vgs * p.r[0], vgs * p.r[1], vgs * p.r[2],
        p.liq_j * (lgs * lgs) * p.d2,
        vgs * _dot_r(p, vel),
    ])
    return _sum(p, grid.n, vals)


def div_acc(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    """(M,) sum V_j gs (v_i - v_j).r at liquid receivers."""
    p = pairs_of(grid)
    return _sum(p, grid.n, p.vol_j * p.gs * _dot_r(p, vel)) * grid.liq


def visc_consts(cfg):
    """(a_liq, b_sol): the Weiler coefficient's liquid and boundary
    numerators, dim nu m and dim nu_b rho0 V_b."""
    a_liq = cfg.dim_coff * cfg.viscosity * cfg.liquid_mass
    b_sol = (cfg.dim_coff * cfg.viscosity_b * cfg.rest_density
             * cfg.solid_volume)
    return a_liq, b_sol


def _visc_coeff(grid: Grid, p: Pairs, rinv: torch.Tensor) -> torch.Tensor:
    """Weiler pair coefficient seen from the receiver: liquid neighbour
    a_liq / rho_j, boundary neighbour b_sol / rho_i, over |r|^2 + 0.01 h^2
    (``rinv`` = 1 / max(rho, 1))."""
    h = grid.cfg.support_radius
    a_liq, b_sol = visc_consts(grid.cfg)
    c = (p.liq_j * a_liq * rinv[p.j]
         + (1.0 - p.liq_j) * b_sol * rinv[p.i])
    return c / (p.d2 + 0.01 * h * h)


def visc_init(grid: Grid, x: torch.Tensor, rinv: torch.Tensor) -> torch.Tensor:
    """(9, M) at liquid receivers: the six block-Jacobi sums
    sum c gs r_a r_b (xx, xy, xz, yy, yz, zz) and sum c gs (x_i - x_j).r r."""
    p = pairs_of(grid)
    coeff = _visc_coeff(grid, p, rinv)
    cg = coeff * p.gs
    r = p.r
    cfac = coeff * _dot_r(p, x) * p.gs
    vals = torch.stack(
        [cg * r[a] * r[b]
         for (a, b) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
        + [cfac * r[c] for c in range(3)])
    return _sum(p, grid.n, vals) * grid.liq


def vorticity(grid: Grid, vel: torch.Tensor, om: torch.Tensor,
              rinv: torch.Tensor) -> torch.Tensor:
    """(9, M) at liquid receivers: [sum mass_like_j (d_om x r) gs (3),
    sum liq_j W / rho_j d_om (3), sum stretch_j (d_vel x r) gs (3)], with
    d_q = q_i - liq_j q_j."""
    p = pairs_of(grid)
    cfg = grid.cfg
    m = cfg.liquid_mass
    lj = p.liq_j
    sj = 1.0 - lj
    d_om = om[:, p.i] - lj * om[:, p.j]
    d_ve = vel[:, p.i] - lj * vel[:, p.j]
    mass_j = m * lj + cfg.rest_density * cfg.solid_volume * sj
    str_j = m * lj + cfg.rest_density * cfg.liquid_volume * sj
    r = p.r
    vals = []
    for c in range(3):
        c0, c1 = (c + 1) % 3, (c + 2) % 3
        vals.append(mass_j * ((d_om[c0] * r[c1] - d_om[c1] * r[c0]) * p.gs))
    tw = lj * p.w * rinv[p.j]
    for c in range(3):
        vals.append(tw * d_om[c])
    for c in range(3):
        c0, c1 = (c + 1) % 3, (c + 2) % 3
        vals.append(str_j * ((d_ve[c0] * r[c1] - d_ve[c1] * r[c0]) * p.gs))
    return _sum(p, grid.n, torch.stack(vals)) * grid.liq


# ---------------------------------------------------------------------------
# K2-K4: the fused solver iterations (in place, like the kernels)
# ---------------------------------------------------------------------------

def _kappa_acc(grid: Grid, p: Pairs, kf: torch.Tensor) -> torch.Tensor:
    """(3, M) sum V_j (k'_i + k'_j) gs r."""
    c = p.vol_j * (kf[p.i] + kf[p.j]) * p.gs
    return _sum(p, grid.n, c * p.r)


def fused_kappa_drho(grid: Grid, vel: torch.Tensor, kf: torch.Tensor,
                     gate: torch.Tensor, acc: torch.Tensor):
    """vel += gate * sum V_j (k'_i + k'_j) gs r, then acc = the divergence
    sum of the updated vel (``kf`` is kappa pre-scaled by dt)."""
    p = pairs_of(grid)
    vel += gate * _kappa_acc(grid, p, kf)
    acc.copy_(div_acc(grid, vel))
    return vel, acc


def fused_iter_full(grid: Grid, vel: torch.Tensor, kv: torch.Tensor,
                    s: torch.Tensor, a: torch.Tensor, paux: torch.Tensor,
                    dt, mode: int) -> torch.Tensor:
    """One DFSPH iteration, mode 0 (divergence) or 1 (pressure):
    k = (S - mode) A; kv += k; vel += liq sum V_j (k'_i + k'_j) gs r with
    k' = dt k; S' = max(paux acc, 0) (mode 0) or max(paux + dt acc, 1)
    (mode 1) from the divergence sum acc of the new vel.  Updates vel, kv
    and S in place; returns the 0-dim error sum liq (S' - mode)."""
    p = pairs_of(grid)
    dt = float(dt)
    bias = -float(mode)
    kf = dt * (s + bias) * a
    kv += (s + bias) * a
    vel += grid.liq * _kappa_acc(grid, p, kf)
    acc = div_acc(grid, vel)
    if mode == 0:
        s.copy_(torch.clamp(paux * acc, min=0.0))
    else:
        s.copy_(torch.clamp(paux + dt * acc, min=1.0))
    return torch.sum(grid.liq * (s - float(mode)))


def fused_visc_iter(grid: Grid, x: torch.Tensor, r: torch.Tensor,
                    d: torch.Tensor, delta: torch.Tensor, rinv: torch.Tensor,
                    minv6: torch.Tensor, dt) -> torch.Tensor:
    """One block-Jacobi PCG iteration: ad = A d; alpha = delta / (eps +
    d.ad); x += alpha d; r = liq (r - alpha ad); s = Minv r;
    delta' = r.s; d = liq (s + (delta' / delta) d).  Updates x, r, d in
    place; returns (2,) [eps + d.ad, delta']."""
    p = pairs_of(grid)
    liq = grid.liq
    coeff = _visc_coeff(grid, p, rinv)
    acc = _sum(p, grid.n, coeff * _dot_r(p, d) * p.gs * p.r) * liq
    ad = d - acc * (float(dt) * rinv)
    d_ad = grid.cfg.eps + torch.sum(liq * (d[0] * ad[0] + d[1] * ad[1]
                                  + d[2] * ad[2]))
    alpha = delta / d_ad
    x += alpha * d
    r.copy_(liq * (r - alpha * ad))
    m = minv6
    s = torch.stack([m[0] * r[0] + m[1] * r[1] + m[2] * r[2],
                     m[1] * r[0] + m[3] * r[1] + m[4] * r[2],
                     m[2] * r[0] + m[4] * r[1] + m[5] * r[2]])
    delta_new = torch.sum(liq * (r[0] * s[0] + r[1] * s[1] + r[2] * s[2]))
    d.copy_(liq * (s + (delta_new / delta) * d))
    return torch.stack([d_ad, delta_new])
