"""Plain PyTorch versions of the pair sweeps of the four solvers.

Each function here is the twin of one hand kernel in ``csrc/``
(same arguments, same outputs; ``engine.py`` picks between them by the
tensors' device).  They run on an explicit pair list: for every particle,
the candidates in its 27 neighbour cells cut to d^2 <= h^2, self excluded.
Per-receiver sums are ``index_add_`` over the pair list.  The per-receiver
formulas are the one-sided bodies of the TPU engine's emits
(``wcsph_tpu/pallas/engine.py``: ``_DensityAlphaDrho`` 1981, ``_KappaAcc``
2005, ``_DivAcc`` 2029, ``_ViscAcc`` 2053, ``_ViscInit`` 2099,
``_Vorticity`` 2145, and for K5-K8 the emits named at each twin below);
r = x_i - x_j points from the neighbour j to the receiver i.

Receivers: the density sweep runs at every in-domain particle; every other
sweep at liquid receivers only (0 at boundary rows), since its outputs are
consumed only there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import kernels
from .grid import SLICE, Grid, NeighborList, slice_offsets


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


def build_pairs(grid: Grid, pos: torch.Tensor | None = None) -> Pairs:
    """All pairs with d^2 <= h^2 (self excluded).  The z-neighbours of a
    cell are consecutive cell ids, so each (dx, dy) column is one
    contiguous row range: 9 ranges per particle.

    With ``pos`` (3, M), moved positions of the same rows: the candidates
    stay those of the grid's cells (the binning of ``grid.pos``), while the
    cut and the pair geometry are taken at ``pos``.  A pair that comes within
    h only at ``pos`` but whose cells are not adjacent is not found; one
    within h at ``grid.pos`` but beyond h at ``pos`` is cut."""
    cfg = grid.cfg
    pos = grid.pos if pos is None else pos
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
            r = pos[:, i] - pos[:, j]
            d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
            keep = (d2 <= h2) & (i != j)
            ii.append(i[keep])
            jj.append(j[keep])
    return _pairs_at(grid, torch.cat(ii), torch.cat(jj), pos)


def pairs_of(grid: Grid) -> Pairs:
    if grid.pairs is None:
        grid.pairs = build_pairs(grid)
    return grid.pairs


def _pairs_at(grid: Grid, i: torch.Tensor, j: torch.Tensor,
              pos: torch.Tensor | None = None) -> Pairs:
    """The pairs (i, j) in the given order, with their geometry at ``pos``
    (default ``grid.pos``)."""
    cfg = grid.cfg
    h = cfg.support_radius
    pos = grid.pos if pos is None else pos
    r = pos[:, i] - pos[:, j]
    d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    return Pairs(i=i, j=j, r=r, d2=d2, w=kernels.cubic_w_scalar(dist, h),
                 gs=kernels.cubic_grad_scale(dist, h), liq_j=grid.liq[j],
                 vol_j=torch.where(grid.liquid[j], cfg.liquid_volume,
                                   cfg.solid_volume))


# ---------------------------------------------------------------------------
# The step's neighbour list (twin of the fill kernel, nbr_list_fill)
# ---------------------------------------------------------------------------

def neighbor_list(grid: Grid, count: torch.Tensor) -> NeighborList:
    """The sliced-ELL list (``grid.NeighborList``) of the pairs within h of
    each liquid row, from the pair list: sorted by receiver, then neighbour
    (the kernels' order), each pair written to slot ``off[i // 32] + 32 k +
    i % 32`` with k its rank among its receiver's pairs.  ``count`` is the
    density sweep's count per row; the widths follow from it, and it must
    equal the pairs found at every liquid row.  ``rec`` holds each row's
    position and liquid flag."""
    p = pairs_of(grid)
    m = grid.n
    off, total = slice_offsets(count, grid.liquid)
    keep = grid.liquid[p.i]
    order = torch.argsort(p.i[keep] * m + p.j[keep])
    i, j = p.i[keep][order], p.j[keep][order]
    n_i = torch.bincount(i, minlength=m)
    if not torch.equal(n_i[grid.liquid],
                       count[grid.liquid].to(n_i.dtype)):
        raise ValueError("count differs from the pairs within h")
    k = torch.arange(i.shape[0], device=i.device) - (torch.cumsum(n_i, 0)
                                                     - n_i)[i]
    idx = torch.full((total,), -1, dtype=torch.int32, device=grid.device)
    idx[off[i // SLICE].to(torch.int64) + SLICE * k + i % SLICE] = (
        j.to(torch.int32))
    rec = torch.cat([grid.pos.T, grid.liq[:, None]], dim=1).contiguous()
    return NeighborList(idx=idx, off=off, rec=rec)


def list_pairs(grid: Grid, nl: NeighborList) -> Pairs:
    """The plain walk of the list: every listed pair, with its geometry, in
    the order a kernel's receiver adds them (slot k ascending; padding
    skipped).  A twin run on these pairs (``grid.pairs``) sums each
    receiver's terms in that order."""
    m = grid.n
    rows = torch.arange(m, device=grid.device)
    s = rows // SLICE
    width = nl.width[s].to(torch.int64)
    base = nl.off[s].to(torch.int64) + rows % SLICE
    ii, jj = [], []
    for k in range(int(width.max()) if m else 0):
        live = rows[k < width]
        j = nl.idx[base[live] + SLICE * k].to(torch.int64)
        ii.append(live[j >= 0])
        jj.append(j[j >= 0])
    empty = torch.zeros(0, dtype=torch.int64, device=grid.device)
    return _pairs_at(grid, torch.cat(ii) if ii else empty,
                     torch.cat(jj) if jj else empty)


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


# ---------------------------------------------------------------------------
# K5: the one-sided sweep, five emits
# ---------------------------------------------------------------------------

def density_alpha(grid: Grid) -> torch.Tensor:
    """(2, M) at every receiver: [sum V_j W, count] (``_DensityAlpha`` 1920
    without the alpha sums)."""
    p = pairs_of(grid)
    return _sum(p, grid.n, torch.stack([p.vol_j * p.w, torch.ones_like(p.w)]))


def explicit_visc_consts(cfg):
    """(a_liq, b_sol) of the explicit viscosity: dim nu m and dim nu_b V_b."""
    return (cfg.dim_coff * cfg.explicit_viscosity * cfg.liquid_mass,
            cfg.dim_coff * cfg.explicit_viscosity_b * cfg.solid_volume)


def sesph_force(grid: Grid, vel: torch.Tensor, rinv: torch.Tensor,
                rr: torch.Tensor, pi: torch.Tensor,
                pr: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: explicit viscosity + symmetric
    Tait-pressure acceleration (``_SesphForce`` 2214), with
    rinv = 1 / max(rho, 1), rr = rho / rho0, pi = p rinv^2 prepared by the
    caller and ``pr`` the pressure."""
    p = pairs_of(grid)
    cfg = grid.cfg
    rho0 = cfg.rest_density
    h = cfg.support_radius
    a_liq, b_sol = explicit_visc_consts(cfg)
    lj = p.liq_j
    sj = 1.0 - lj
    rd = 1.0 / (p.d2 + 0.01 * h * h)
    vi = vel[:, p.i]
    vh_dot = vi[0] * p.r[0] + vi[1] * p.r[1] + vi[2] * p.r[2]
    rj = rinv[p.j]
    pi_i = pi[p.i]
    visc = (lj * a_liq * rj * _dot_r(p, vel)
            + sj * b_sol * rr[p.i] * vh_dot) * rd
    pres = -rho0 * (cfg.liquid_volume * lj * (pi_i + pr[p.j] * rj * rj)
                    + cfg.solid_volume * sj
                    * (pi_i + pr[p.i] / (rho0 * rho0)))
    return _sum(p, grid.n, (visc + pres) * p.gs * p.r) * grid.liq


def iisph_adv(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    """(5, M) at liquid receivers: [-sum V_j gs r (3),
    sum V_j gs (v_i - v_j).r, sum V_j gs^2 d2] (``_IisphAdv`` 2337)."""
    p = pairs_of(grid)
    vgs = p.vol_j * p.gs
    vals = torch.cat([-(vgs * p.r),
                      torch.stack([vgs * _dot_r(p, vel), vgs * p.gs * p.d2])])
    return _sum(p, grid.n, vals) * grid.liq


def _dot_own(p: Pairs, a: torch.Tensor) -> torch.Tensor:
    """a_i . r per pair for a planar (3, M) field."""
    ai = a[:, p.i]
    return ai[0] * p.r[0] + ai[1] * p.r[1] + ai[2] * p.r[2]


def _dot_nbr(p: Pairs, a: torch.Tensor) -> torch.Tensor:
    """a_j . r per pair for a planar (3, M) field."""
    aj = a[:, p.j]
    return aj[0] * p.r[0] + aj[1] * p.r[1] + aj[2] * p.r[2]


def iisph_aii(grid: Grid, dii: torch.Tensor) -> torch.Tensor:
    """(M,) at liquid receivers: sum V_j gs (d_ii_i . r), the receiver's own
    d_ii (``_IisphAii`` 2374)."""
    p = pairs_of(grid)
    return _sum(p, grid.n, p.vol_j * (p.gs * _dot_own(p, dii))) * grid.liq


def iisph_force(grid: Grid, dpi: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: -sum c gs r with c = V0 (dpi_i + dpi_j)
    for a liquid neighbour and Vs dpi_i for a boundary one
    (``_IisphForce`` 2466); dpi = p / den^2."""
    p = pairs_of(grid)
    cfg = grid.cfg
    di = dpi[p.i]
    c = (p.liq_j * (cfg.liquid_volume * (di + dpi[p.j]))
         + (1.0 - p.liq_j) * cfg.solid_volume * di)
    return -_sum(p, grid.n, c * p.gs * p.r) * grid.liq


# ---------------------------------------------------------------------------
# K6-K8: surface tension and the fused IISPH / PCISPH iterations
# ---------------------------------------------------------------------------

def tension_consts(cfg) -> dict:
    """Constants of the tension sweep (``_TensionAccel._shared`` 2526)."""
    h = cfg.support_radius
    return dict(coh=-cfg.tension_coff * cfg.liquid_mass,
                adh=-cfg.tension_coff_b * cfg.rest_density * cfg.solid_volume,
                curv=-cfg.tension_coff, rho0x2=2.0 * cfg.rest_density,
                coh_k=32.0 / (np.pi * h ** 9), coh_c=h ** 6 / 64.0,
                adh_k=0.007 / h ** 3.25)


def fused_tension(grid: Grid, ril: torch.Tensor, rho: torch.Tensor):
    """(normals, acc), both (3, M) at liquid receivers.
    normals_i = h sum_j m ril_j gs r with ril = liq / max(rho, 1)
    (``_SurfaceNormals`` 2498, h-scaled); acc is Akinci cohesion, curvature
    and boundary adhesion on those normals (``_TensionAccel`` 2519): the
    cohesion and curvature gates need a liquid neighbour and d^2 > eps, the
    adhesion gate a boundary neighbour whose own position lies within
    adhesion_radius of adhesion_center."""
    p = pairs_of(grid)
    cfg = grid.cfg
    h = cfg.support_radius
    t = tension_consts(cfg)
    liq = grid.liq
    n = h * _sum(p, grid.n, cfg.liquid_mass * ril[p.j] * p.gs * p.r) * liq

    dist = torch.sqrt(torch.clamp(p.d2, min=1e-12))
    inv_dist = 1.0 / torch.clamp(dist, min=cfg.eps)
    pair_ok = p.d2 > cfg.eps
    k_ij = t["rho0x2"] / torch.clamp(rho[p.i] + rho[p.j], min=1.0)
    gate = torch.where(pair_ok, p.liq_j * k_ij, 0.0)
    w_coh = kernels.cohesion_w_scalar(dist, h)
    w_adh = kernels.adhesion_w_scalar(dist, h)
    centre = torch.tensor(cfg.adhesion_center, dtype=torch.float32,
                          device=grid.device)
    e = grid.pos[:, p.j] - centre[:, None]
    in_region = (e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
                 < cfg.adhesion_radius ** 2)
    adh_gate = torch.where(pair_ok & in_region, 1.0 - p.liq_j, 0.0)
    c_rad = (t["coh"] * w_coh * inv_dist * gate
             + t["adh"] * w_adh * inv_dist * adh_gate)
    vals = c_rad * p.r + gate * t["curv"] * (n[:, p.i] - n[:, p.j])
    return n, _sum(p, grid.n, vals) * liq


def fused_jacobi_iter(grid: Grid, dii: torch.Tensor, deninv: torch.Tensor,
                      aii: torch.Tensor, b: torch.Tensor, pr: torch.Tensor,
                      dt):
    """One relaxed-Jacobi iteration of IISPH (``_IisphDij`` 2397,
    ``_IisphS`` 2417, the update of solvers/iisph.py ``_jacobi_tail``):
    dij_i = sum_j fac_j gs r with fac = -liq deninv p; s_i from the finished
    dij with p_liq = liq p and g = deninv p; then
    p' = ok ? max((1 - w) p + w / (a_ii dt^2) (b - dt^2 s), 0) : 0 with
    ok = |a_ii dt^2| > eps.  Updates ``pr`` in place; returns (dij (3, M),
    s (M,), the 0-dim residual sum of liq ((a_ii p' + s) dt^2 - b) over the
    rows with p' != 0)."""
    p = pairs_of(grid)
    cfg = grid.cfg
    liq = grid.liq
    lj = p.liq_j
    fac = -liq * deninv * pr
    dij = _sum(p, grid.n, fac[p.j] * p.gs * p.r) * liq

    gs = p.gs
    dij_dot_i = gs * _dot_own(p, dij)
    dii_j_dot = gs * (lj * pr[p.j]) * _dot_nbr(p, dii)
    dij_j_dot = gs * _dot_nbr(p, dij)
    dji_pi_dot = (deninv * pr)[p.i] * gs * gs * p.d2
    term_liq = cfg.liquid_volume * (dij_dot_i - dii_j_dot - dij_j_dot
                                    + dji_pi_dot)
    term_sol = cfg.solid_volume * dij_dot_i
    s = _sum(p, grid.n, lj * term_liq + (1.0 - lj) * term_sol) * liq

    h2 = float(np.float32(dt) * np.float32(dt))
    omega = cfg.iisph_omega
    denom = aii * h2
    ok = torch.abs(denom) > cfg.eps
    p_new = torch.clamp((1.0 - omega) * pr
                        + omega / torch.where(ok, denom, 1.0) * (b - h2 * s),
                        min=0.0)
    p_new = torch.where(ok, p_new, 0.0)
    resid = torch.where(p_new != 0.0, (aii * p_new + s) * h2 - b, 0.0)
    pr.copy_(p_new)
    return dij, s, torch.sum(liq * resid)


def fused_pcisph_iter(grid: Grid, vel_star: torch.Tensor, pr: torch.Tensor,
                      dt, factor):
    """One PCISPH prediction iteration at the starred positions
    x* = x + liq v* dt (``_PcisphAdvPart`` 2310, ``_PcisphAccPart`` 2323).
    The pair candidates are those of the ORIGINAL binning; a pair is cut by
    its distance at x* (``build_pairs`` with ``pos``).
    adv_i = sum_j V_j W at x*; p' = p + factor (max(w0 + adv, 1) - 1) with
    factor = pci_coff / dt^2 and w0 = V0 W(0); acc = -sum c gs r at x* with
    c = V0 (p'_i + p'_j) for a liquid neighbour, Vs p'_i for a boundary
    one.  Updates ``pr`` in place; returns (adv (M,), acc (3, M), the 0-dim
    error sum of liq (max(w0 + adv, 1) - 1))."""
    cfg = grid.cfg
    liq = grid.liq
    xs = torch.where(grid.liquid[None], grid.pos + vel_star * float(dt),
                     grid.pos)
    p = build_pairs(grid, xs)
    adv = _sum(p, grid.n, p.vol_j * p.w) * liq
    w0 = cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius)
    over = torch.clamp(w0 + adv, min=1.0) - 1.0
    pr += float(factor) * over
    pi = pr[p.i]
    c = (p.liq_j * cfg.liquid_volume * (pi + pr[p.j])
         + (1.0 - p.liq_j) * cfg.solid_volume * pi)
    acc = -_sum(p, grid.n, c * p.gs * p.r) * liq
    return adv, acc, torch.sum(liq * over)
