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
from .config import SimConfig
from .grid import (SLICE, Grid, ListSlots, NeighborList, PredictHits,
                   StarHits, outside_cell)


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
# The grid stage (twins of bin_cells, pack_rows, unpack_rows in csrc/bin.cu)
# ---------------------------------------------------------------------------

def cell_keys(pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(N,) int64 cell id of each planar position (3, N), ``num_cells``
    outside the domain: floor((pos - dmin) * float32(1 / cell size))."""
    nc = cfg.num_cells
    gx, gy, gz = cfg.grid_res
    dev = pos.device
    dmin = torch.tensor(cfg.domain_min, dtype=torch.float32, device=dev)
    inv = torch.tensor(np.float32(1.0 / cfg.cell_size), device=dev)
    f = torch.floor((pos - dmin[:, None]) * inv)
    res = torch.tensor([gx, gy, gz], dtype=torch.float32, device=dev)
    # float compares: a NaN or infinite position falls outside
    inbox = ((f >= 0.0) & (f < res[:, None])).all(0)
    c = torch.where(inbox[None], f, 0.0).to(torch.int64)
    return torch.where(inbox, (c[0] * gy + c[1]) * gz + c[2], nc)


def bin_cells(pos: torch.Tensor, n_liquid: int, cfg: SimConfig):
    """The sorted layout of ``grid.Grid`` for planar positions (3, N):
    (order, row_of, cell, cell_start, sorted positions, liquid, liq, L).
    A stable sort of the cell ids, the particles outside the domain keyed
    ``num_cells`` (last, in particle order, cell id ``outside_cell``)."""
    nc = cfg.num_cells
    dev = pos.device
    n = pos.shape[1]
    keys = cell_keys(pos, cfg)
    sorted_keys, order = torch.sort(keys, stable=True)
    start = torch.zeros(nc + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(torch.bincount(keys, minlength=nc + 1)[:nc], 0)
    inside = sorted_keys < nc
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    row_of = torch.empty(n, dtype=torch.int32, device=dev)
    row_of[order] = torch.where(inside, rows, -1)
    liquid = inside & (order < n_liquid)
    cell = torch.where(inside, sorted_keys, outside_cell(cfg))
    return (order, row_of, cell.to(torch.int32), start.to(torch.int32),
            pos[:, order].contiguous(), liquid, liquid.to(torch.float32),
            liquid.sum().to(torch.int32))


def row_views(block: torch.Tensor, fields):
    """The rows of a (K, W) block as one tensor per field, in order: (W,)
    for a one-dimensional field, (k, W) for a (k, ...) one."""
    two = [x.dim() == 2 for x in fields]
    parts = block.split_with_sizes([x.shape[0] if t else 1
                                    for x, t in zip(fields, two)])
    return [p if t else p[0] for p, t in zip(parts, two)]


def pack_rows(grid: Grid, fields):
    """Per-liquid (N_L,) or (k, N_L) fields -> sorted (M,) / (k, M), row
    views of one (K, M) block; rows that hold no liquid take 0."""
    stacked = torch.cat([x.reshape(-1, x.shape[-1]) for x in fields])
    block = stacked.new_zeros((stacked.shape[0], grid.n))
    if stacked.shape[-1]:
        src = torch.where(grid.liquid, grid.order, 0)
        block[:] = torch.where(grid.liquid, stacked[:, src], 0.0)
    return row_views(block, fields)


def unpack_rows(grid: Grid, packed, defaults):
    """Sorted fields -> per-liquid, row views of one (K, N_L) block; a
    liquid particle outside the domain (row -1) keeps its ``defaults``
    entry."""
    nl = defaults[0].shape[-1]
    stacked = torch.cat([p if p.dim() == 2 else p[None] for p in packed])
    dflt = torch.cat([d if d.dim() == 2 else d[None] for d in defaults])
    rows = grid.row_of[:nl].to(torch.int64)
    block = torch.where(rows >= 0, stacked[:, rows.clamp(min=0)], dflt)
    return row_views(block, defaults)


# ---------------------------------------------------------------------------
# The step's neighbour list (twins of nbr_list_offsets and the fill kernel,
# nbr_list_fill)
# ---------------------------------------------------------------------------

def list_offsets(count: torch.Tensor, liquid: torch.Tensor,
                 capacity: int = 2 ** 31 - 1, slots: ListSlots | None = None):
    """((S + 1,) int32 first slot of each slice, clamped to ``capacity``;
    () int64 slots the list needs) from the neighbour count of each row (the
    density sweep's count) and the rows' liquid flags (bool or 0/1 float);
    boundary rows take no slots.  Both are written into the kept tensors
    of ``slots`` (``ListSlots.offsets``; a new one where None) and those
    are returned."""
    liquid = liquid.bool()
    m = count.shape[0]
    s = -(-m // SLICE)
    c = torch.zeros(s * SLICE, dtype=torch.int64, device=count.device)
    c[:m] = torch.where(liquid, count.to(torch.int64), 0)
    off = torch.zeros(s + 1, dtype=torch.int64, device=count.device)
    off[1:] = torch.cumsum(c.view(s, SLICE).amax(1) * SLICE, 0)
    slots = ListSlots() if slots is None else slots
    kept_off, kept_need, _ = slots.offsets(m, count.device)
    kept_off.copy_(torch.clamp(off, max=capacity))
    kept_need.copy_(off[-1])
    return kept_off, kept_need


def neighbor_list(grid: Grid, count: torch.Tensor,
                  slots: ListSlots | None = None) -> NeighborList:
    """The sliced-ELL list (``grid.NeighborList``) of the pairs within h of
    each liquid row, from the pair list: sorted by receiver, then neighbour
    (the kernels' order), each pair written to slot ``off[i // 32] + 32 k +
    i % 32`` with k its rank among its receiver's pairs.  ``count`` is the
    density sweep's count per row; the widths follow from it, and it must
    equal the pairs found at every liquid row.  ``rec`` holds each row's
    position and liquid flag.  The slots honour the capacity of ``slots``
    (sized here from this list's need where it is unsized): a list that
    needs more is clamped to it, as the fill kernel's, its pairs past a
    row's slots are dropped and its flag is set.  Its offsets and need are
    the kept tensors of ``slots`` (``ListSlots.offsets``), as the
    kernel's."""
    p = pairs_of(grid)
    m = grid.n
    need = int(list_offsets(count, grid.liquid)[1])
    slots = ListSlots.sized(slots, need)
    off, need_t = list_offsets(count, grid.liquid, slots.capacity, slots)
    keep = grid.liquid[p.i]
    order = torch.argsort(p.i[keep] * m + p.j[keep])
    i, j = p.i[keep][order], p.j[keep][order]
    n_i = torch.bincount(i, minlength=m)
    if need <= slots.capacity and not torch.equal(
            n_i[grid.liquid], count[grid.liquid].to(n_i.dtype)):
        raise ValueError("count differs from the pairs within h")
    k = torch.arange(i.shape[0], device=i.device) - (torch.cumsum(n_i, 0)
                                                     - n_i)[i]
    s = i // SLICE
    fits = k < ((off[s + 1] - off[s]) // SLICE).to(torch.int64)
    idx = torch.full((slots.capacity,), -1, dtype=torch.int32,
                     device=grid.device)
    idx[(off[s].to(torch.int64) + SLICE * k + i % SLICE)[fits]] = (
        j[fits].to(torch.int32))
    rec = torch.cat([grid.pos.T, grid.liq[:, None]], dim=1).contiguous()
    flag = (~fits).any().to(torch.int32)
    return NeighborList(idx=idx, off=off, rec=rec, need=need_t, flag=flag)


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

def kappa_acc(grid: Grid, k: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: sum V_j (k_i + k_j) gs r (``_KappaAcc``
    1998)."""
    p = pairs_of(grid)
    c = p.vol_j * (k[p.i] + k[p.j]) * p.gs
    return _sum(p, grid.n, c * p.r) * grid.liq


def fused_kappa_drho(grid: Grid, vel: torch.Tensor, kf: torch.Tensor,
                     gate: torch.Tensor, acc: torch.Tensor):
    """vel += gate * sum V_j (k'_i + k'_j) gs r, then acc = the divergence
    sum of the updated vel (``kf`` is kappa pre-scaled by dt)."""
    vel += gate * kappa_acc(grid, kf)
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
    dt = float(dt)
    bias = -float(mode)
    kf = dt * (s + bias) * a
    kv += (s + bias) * a
    vel += grid.liq * kappa_acc(grid, kf)
    acc = div_acc(grid, vel)
    if mode == 0:
        s.copy_(torch.clamp(paux * acc, min=0.0))
    else:
        s.copy_(torch.clamp(paux + dt * acc, min=1.0))
    return torch.sum(grid.liq * (s - float(mode)))


def visc_acc(grid: Grid, x: torch.Tensor, rinv: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: the viscosity matvec's sum
    sum c (x_i - x_j).r gs r (``_ViscAcc`` 2044; ``rinv`` = 1 / max(rho,
    1))."""
    p = pairs_of(grid)
    coeff = _visc_coeff(grid, p, rinv)
    return _sum(p, grid.n, coeff * _dot_r(p, x) * p.gs * p.r) * grid.liq


def fused_visc_iter(grid: Grid, x: torch.Tensor, r: torch.Tensor,
                    d: torch.Tensor, delta: torch.Tensor, rinv: torch.Tensor,
                    minv6: torch.Tensor, dt) -> torch.Tensor:
    """One block-Jacobi PCG iteration: ad = A d; alpha = delta / (eps +
    d.ad); x += alpha d; r = liq (r - alpha ad); s = Minv r;
    delta' = r.s; d = liq (s + (delta' / delta) d).  Updates x, r, d in
    place; returns (2,) [eps + d.ad, delta']."""
    liq = grid.liq
    ad = d - visc_acc(grid, d, rinv) * (float(dt) * rinv)
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


def surface_normals(grid: Grid, ril: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: sum_j m ril_j gs r with ril = liq /
    max(rho, 1) (``_SurfaceNormals`` 2498; the caller scales by h)."""
    p = pairs_of(grid)
    m = grid.cfg.liquid_mass
    return _sum(p, grid.n, m * ril[p.j] * p.gs * p.r) * grid.liq


def tension_accel(grid: Grid, rho: torch.Tensor,
                  n: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: Akinci cohesion, curvature and boundary
    adhesion on the h-scaled normals ``n`` (``_TensionAccel`` 2519): the
    cohesion and curvature gates need a liquid neighbour and d^2 > eps, the
    adhesion gate a boundary neighbour whose own position lies within
    adhesion_radius of adhesion_center."""
    p = pairs_of(grid)
    cfg = grid.cfg
    h = cfg.support_radius
    t = tension_consts(cfg)
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
    return _sum(p, grid.n, vals) * grid.liq


def fused_tension(grid: Grid, ril: torch.Tensor, rho: torch.Tensor):
    """(normals, acc), both (3, M) at liquid receivers: the h-scaled
    ``surface_normals`` and ``tension_accel`` on them."""
    n = grid.cfg.support_radius * surface_normals(grid, ril)
    return n, tension_accel(grid, rho, n)


def iisph_dij(grid: Grid, fac: torch.Tensor) -> torch.Tensor:
    """(3, M) at liquid receivers: dij_i = sum_j fac_j gs r with the
    caller's fac = -liq deninv p (``_IisphDij`` 2397)."""
    p = pairs_of(grid)
    return _sum(p, grid.n, fac[p.j] * p.gs * p.r) * grid.liq


def iisph_s(grid: Grid, dii: torch.Tensor, dij: torch.Tensor,
            p_liq: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(M,) at liquid receivers: the s_i sweep of the relaxed Jacobi
    iteration (``_IisphS`` 2417) from the finished dij, with the caller's
    p_liq = liq p and g = deninv p."""
    p = pairs_of(grid)
    cfg = grid.cfg
    lj = p.liq_j
    gs = p.gs
    dij_dot_i = gs * _dot_own(p, dij)
    dii_j_dot = gs * p_liq[p.j] * _dot_nbr(p, dii)
    dij_j_dot = gs * _dot_nbr(p, dij)
    dji_pi_dot = g[p.i] * gs * gs * p.d2
    term_liq = cfg.liquid_volume * (dij_dot_i - dii_j_dot - dij_j_dot
                                    + dji_pi_dot)
    term_sol = cfg.solid_volume * dij_dot_i
    return _sum(p, grid.n, lj * term_liq + (1.0 - lj) * term_sol) * grid.liq


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
    liq = grid.liq
    dij = iisph_dij(grid, -liq * deninv * pr)
    s = iisph_s(grid, dii, dij, liq * pr, deninv * pr)

    cfg = grid.cfg
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
                      dt, factor, slots: ListSlots | None = None):
    """One PCISPH prediction iteration at the starred positions
    x* = x + liq v* dt (``_PcisphAdvPart`` 2310, ``_PcisphAccPart`` 2323).
    The pair candidates are those of the ORIGINAL binning; a pair is cut by
    its distance at x* (``build_pairs`` with ``pos``).
    adv_i = sum_j V_j W at x*; p' = p + factor (max(w0 + adv, 1) - 1) with
    factor = pci_coff / dt^2 and w0 = V0 W(0); acc = -sum c gs r at x* with
    c = V0 (p'_i + p'_j) for a liquid neighbour, Vs p'_i for a boundary
    one.  Updates ``pr`` in place; returns (adv (M,), acc (3, M), the 0-dim
    error sum of liq (max(w0 + adv, 1) - 1)).

    As the kernel, it keeps the hits as ``grid.star`` (``grid.StarHits``):
    each liquid row's pairs in the cell loop's order, at most
    ``slots.capacity // M`` of them (every one where ``slots`` is None).
    acc sums the kept hits only, adv every hit; a row with more hits than
    it keeps sets ``over``."""
    cfg = grid.cfg
    liq = grid.liq
    m = grid.n
    xs = torch.where(grid.liquid[None], grid.pos + vel_star * float(dt),
                     grid.pos)
    p = _star_pairs(grid, xs)
    n_i, width, keep, idx = _hit_buffer(grid, p, slots)
    grid.star = StarHits(
        idx=idx, count=torch.clamp(n_i, max=width).to(torch.int32),
        rec=torch.cat([xs.T, liq[:, None]], dim=1).contiguous(), width=width,
        over=torch.where(n_i > width, n_i, 0).max().to(torch.int32))

    adv = _sum(p, m, p.vol_j * p.w)
    w0 = cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius)
    excess = torch.clamp(w0 + adv, min=1.0) - 1.0
    pr += float(factor) * excess
    vals = _pressure_terms(grid, p, pr)[:, keep]
    acc = -torch.zeros((3, m), dtype=vals.dtype,
                       device=vals.device).index_add_(-1, p.i[keep], vals)
    return adv, acc, torch.sum(liq * excess)


def _star_pairs(grid: Grid, xs: torch.Tensor) -> Pairs:
    """The pairs of the liquid receivers at the moved positions ``xs``: the
    candidates of the grid's cells, cut at ``xs`` (``build_pairs``)."""
    p = build_pairs(grid, xs)
    live = grid.liquid[p.i]
    return Pairs(**{f.name: getattr(p, f.name)[..., live]
                    for f in dataclasses.fields(p)})


def _hit_buffer(grid: Grid, p: Pairs, slots: ListSlots | None):
    """(hits of each row (M,) int64, width, kept (P,) bool, idx): the pairs
    ``p``, each receiver's in the cell loop's order, as a hit buffer of a
    uniform width (K8's layout): pair k of row i at ``idx[k M + i]`` for
    k < width = ``slots.capacity // M`` (the widest row's hits where
    ``slots`` is None), -1 elsewhere."""
    m = grid.n
    # each pair's rank among its receiver's pairs
    n_i = torch.bincount(p.i, minlength=m)
    by_i = torch.argsort(p.i, stable=True)
    rank = torch.empty_like(by_i)
    rank[by_i] = (torch.arange(by_i.shape[0], device=by_i.device)
                  - (torch.cumsum(n_i, 0) - n_i)[p.i[by_i]])
    if slots is None:
        width = int(n_i.max()) if m else 0
        capacity = width * m
    elif slots.capacity is None:
        raise ValueError("the hits are kept in a sized buffer: pass a "
                         "grid.ListSlots with a capacity")
    else:
        capacity = slots.capacity
        width = capacity // m
    keep = rank < width
    idx = torch.full((capacity,), -1, dtype=torch.int32, device=grid.device)
    idx[rank[keep] * m + p.i[keep]] = p.j[keep].to(torch.int32)
    return n_i, width, keep, idx


def _pressure_terms(grid: Grid, p: Pairs, pr: torch.Tensor) -> torch.Tensor:
    """(3, P) c gs r per pair with c = V0 (p_i + p_j) for a liquid
    neighbour and Vs p_i for a boundary one."""
    cfg = grid.cfg
    pi = pr[p.i]
    c = (p.liq_j * cfg.liquid_volume * (pi + pr[p.j])
         + (1.0 - p.liq_j) * cfg.solid_volume * pi)
    return c * p.gs * p.r


def _predict_sums(grid: Grid, p: Pairs, pr: torch.Tensor) -> torch.Tensor:
    """(4, M) [sum V_j W, -sum c gs r] over the pairs ``p``."""
    return torch.cat([_sum(p, grid.n, p.vol_j * p.w)[None],
                      -_sum(p, grid.n, _pressure_terms(grid, p, pr))])


def pcisph_predict(grid: Grid, xs: torch.Tensor, pr: torch.Tensor,
                   slots: ListSlots | None = None):
    """The cut of the unfused PCISPH prediction (``_PcisphPredict`` 2270):
    ((4, M) at liquid receivers, at the moved positions ``xs`` with the
    pressure ``pr``: [sum V_j W, -sum c gs r] (see ``_pressure_terms``),
    over the pairs of ``_star_pairs``; its hits, ``grid.PredictHits``).  A
    receiver moved out of its cell's window still sees only that window.
    The hits keep each liquid row's pairs in the cell loop's order, at most
    ``slots.capacity // M`` of them (every one where ``slots`` is None),
    and each row's full count."""
    p = _star_pairs(grid, xs)
    n_i, width, _, idx = _hit_buffer(grid, p, slots)
    hits = PredictHits(
        idx=idx, count=n_i.to(torch.int32),
        rec=torch.cat([xs.T, grid.liq[:, None]], dim=1).contiguous(),
        width=width)
    return _predict_sums(grid, p, pr), hits


def pcisph_walk(grid: Grid, xs: torch.Tensor, pr: torch.Tensor,
                hits: PredictHits) -> torch.Tensor:
    """The walk of the unfused PCISPH prediction: ``pcisph_predict``'s
    (4, M) at the same moved positions ``xs`` with the pressure ``pr``,
    over the hits of its cut at ``xs``: a row of at most ``hits.width``
    hits sums its kept hits (slot k ascending), a row of more its pairs at
    ``xs`` again, each in the cut's order (so the cut's bits)."""
    m = grid.n
    rows = torch.arange(m, device=grid.device)
    count = hits.count.to(torch.int64)
    walked = count <= hits.width
    ii, jj = [], []
    for k in range(min(hits.width, int(count.max()) if m else 0)):
        live = rows[walked & (k < count)]
        ii.append(live)
        jj.append(hits.idx[k * m + live].to(torch.int64))
    if bool((~walked).any()):
        p = _star_pairs(grid, xs)
        again = ~walked[p.i]
        ii.append(p.i[again])
        jj.append(p.j[again])
    empty = torch.zeros(0, dtype=torch.int64, device=grid.device)
    p = _pairs_at(grid, torch.cat(ii) if ii else empty,
                  torch.cat(jj) if jj else empty, xs)
    return _predict_sums(grid, p, pr)


# ---------------------------------------------------------------------------
# Surface reconstruction (twins of mc_field and aniso_moments in
# csrc/surface.cu) and the debug color field
# ---------------------------------------------------------------------------

MC_SUB = 4    # reconstruction points per grid cell and axis
FIELD_TERMS = 1 << 26   # (point, candidate) terms the plain field holds at
                        # once: points are taken in chunks of this size


def field_offsets(cfg: SimConfig) -> np.ndarray:
    """(MC_SUB,) float32 offsets of the reconstruction points along one
    axis of a cell: k h / MC_SUB, rounded once (``_point_offsets`` of
    ``wcsph_tpu/surface/field.py``).  Point p = (a, b, c), p = 16 a + 4 b +
    c, of cell (cx, cy, cz) lies at dmin + c_axis h + offset."""
    return (np.arange(MC_SUB) * (cfg.cell_size / MC_SUB)).astype(np.float32)


def _field_terms(grid: Grid, x: torch.Tensor, coeff: torch.Tensor,
                 g: torch.Tensor | None):
    """Yields (p0, p1, cell (Q,), candidate (Q,), r (3, p1 - p0, Q), terms
    (p1 - p0, Q)): the terms coeff_j W of points p0 .. p1 - 1 of every
    cell, over the (cell, candidate) pairs of the cells' 27-cell windows
    (the binning of ``grid``) whose candidate has coeff != 0, evaluated at
    ``x`` (r = p - x_j) and, with ``g`` (9, M) row-major, at |2 G_j r|."""
    cfg = grid.cfg
    gx, gy, gz = cfg.grid_res
    nc = cfg.num_cells
    dev = grid.device
    start = grid.cell_start.to(torch.int64)
    cells = torch.arange(nc, device=dev)
    cz = cells % gz
    cy = (cells // gz) % gy
    cx = cells // (gy * gz)
    z0 = torch.clamp(cz - 1, min=0)
    z1 = torch.clamp(cz + 1, max=gz - 1)
    cc, jj = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx, ny = cx + dx, cy + dy
            ok = (nx >= 0) & (nx < gx) & (ny >= 0) & (ny < gy)
            base = (nx.clamp(0, gx - 1) * gy + ny.clamp(0, gy - 1)) * gz
            jb = start[base + z0]
            cnt = torch.where(ok, start[base + z1 + 1] - jb, 0)
            total = int(cnt.sum())
            c = torch.repeat_interleave(cells, cnt, output_size=total)
            first = torch.cumsum(cnt, 0) - cnt
            j = (torch.repeat_interleave(jb - first, cnt, output_size=total)
                 + torch.arange(total, device=dev))
            keep = coeff[j] != 0.0
            cc.append(c[keep])
            jj.append(j[keep])
    c, j = torch.cat(cc), torch.cat(jj)
    dmin = torch.tensor(cfg.domain_min, dtype=torch.float32, device=dev)
    step = torch.tensor(np.float32(cfg.cell_size), device=dev)
    origin = (dmin[:, None] + torch.stack([cx, cy, cz]).to(torch.float32)
              * step)[:, c]                                    # (3, Q)
    off = torch.as_tensor(field_offsets(cfg), device=dev)
    xj, cj = x[:, j], coeff[j]
    gj = None if g is None else g[:, j]
    n_pt = MC_SUB ** 3
    chunk = max(1, min(n_pt, FIELD_TERMS // max(int(c.shape[0]), 1)))
    for p0 in range(0, n_pt, chunk):
        p = torch.arange(p0, min(p0 + chunk, n_pt), device=dev)
        pts = torch.stack([off[p // (MC_SUB * MC_SUB)],
                           off[(p // MC_SUB) % MC_SUB], off[p % MC_SUB]])
        r = origin[:, None, :] + pts[:, :, None] - xj[:, None, :]  # (3, P, Q)
        if gj is None:
            d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
        else:
            gr = [2.0 * (gj[3 * a][None] * r[0] + gj[3 * a + 1][None] * r[1]
                         + gj[3 * a + 2][None] * r[2]) for a in range(3)]
            d2 = gr[0] * gr[0] + gr[1] * gr[1] + gr[2] * gr[2]
        w = kernels.cubic_w_scalar(torch.sqrt(torch.clamp(d2, min=0.0)),
                                   cfg.support_radius)
        yield p0, p0 + p.shape[0], c, j, r, cj[None] * w


def mc_field(grid: Grid, x: torch.Tensor, coeff: torch.Tensor,
             g: torch.Tensor | None = None,
             reach: torch.Tensor | None = None) -> torch.Tensor:
    """The scalar field phi = sum_j coeff_j W(|p - x_j|, h) (with ``g``:
    W(|2 G_j (p - x_j)|, h)) at the MC_SUB^3 points of every grid cell,
    over the candidates of the cell's 27-cell window, in the dense layout
    (gx MC_SUB, gy MC_SUB, gz MC_SUB) of ``field_to_dense``
    (``mc_field_packed`` of ``wcsph_tpu/surface/field.py``).  ``reach``
    (``aniso_g``'s) only lets the kernel skip terms that are exactly 0;
    this twin sums every term of the window."""
    gx, gy, gz = grid.cfg.grid_res
    s = MC_SUB
    phi = torch.zeros((s ** 3, grid.cfg.num_cells), dtype=torch.float32,
                      device=grid.device)
    for p0, p1, c, _, _, terms in _field_terms(grid, x, coeff, g):
        phi[p0:p1].index_add_(1, c, terms)
    return (phi.reshape(s, s, s, gx, gy, gz).permute(3, 0, 4, 1, 5, 2)
            .reshape(gx * s, gy * s, gz * s))


def mc_field_terms(grid: Grid, x: torch.Tensor, coeff: torch.Tensor,
                   g: torch.Tensor | None = None) -> int:
    """The terms of ``mc_field`` that are not zero: (point, particle)
    pairs within the kernel's support, with coeff != 0."""
    return sum(int((t != 0.0).sum()) for *_, t in _field_terms(
        grid, x, coeff, g))


def field_reach_ratio(grid: Grid, x: torch.Tensor, coeff: torch.Tensor,
                      g: torch.Tensor, reach: torch.Tensor) -> float:
    """The largest |r| / reach_j over the anisotropic field's terms that
    are not zero (0 where there is none): at most 1 where every such term
    lies within its candidate's reach, as ``mc_field``'s kernel assumes."""
    most = torch.zeros((), dtype=torch.float32, device=grid.device)
    for *_, j, r, t in _field_terms(grid, x, coeff, g):
        dist = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
        ratio = torch.where(t != 0.0, dist / reach[j][None], 0.0)
        most = torch.maximum(most, ratio.max())
    return float(most)


def aniso_moments(grid: Grid) -> torch.Tensor:
    """(11, M) at liquid receivers (0 elsewhere), over the pairs within h
    (self excluded): [sum w, sum w x_j (3), sum w d_a d_b (xx, xy, xz, yy,
    yz, zz), count], w = liq_j (1 - (|r| / 2h)^3), d = x_j - mean_i about
    the weighted mean mean_i = sum w x_j / max(sum w, 1e-12) (x_i where
    sum w = 0), count = the pairs, boundary neighbours too
    (``compute`` of ``wcsph_tpu/surface/aniso.py``, its two passes)."""
    p = pairs_of(grid)
    m = grid.n
    dist = torch.sqrt(torch.clamp(p.d2, min=0.0))
    q = dist / (2.0 * grid.cfg.support_radius)
    liq_i = grid.liq[p.i]
    w = liq_i * p.liq_j * (1.0 - q * q * q)
    xj = grid.pos[:, p.j]
    first = _sum(p, m, torch.cat([w[None], w * xj]))
    sw = first[0]
    mean = torch.where(sw > 0.0, first[1:4] / torch.clamp(sw, min=1e-12),
                       grid.pos)
    d = xj - mean[:, p.i]
    second = _sum(p, m, torch.stack(
        [w * d[a] * d[b]
         for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
        + [liq_i]))
    return torch.cat([first, second])


EIG_CHUNK = 16384   # matrices a torch.linalg.eigh call takes here: on the
                    # card its batched cuSOLVER call refuses the flagship's
                    # 1.1M at once (CUSOLVER_STATUS_INVALID_VALUE)


REACH_CAP = 5.0    # aniso_g's reach at most this many h: no candidate of
                   # a cell's window lies farther from its points (2 sqrt 3
                   # h binned, plus a smoothed centre's move below 0.95 h)


def aniso_g(grid: Grid, mom: torch.Tensor, kr: float, ks: float, kn: float,
            min_neighbors: int):
    """((9, M) row-major G, (M,) reach) from ``aniso_moments``' sums (the
    spectral clamp of ``wcsph_tpu/surface/aniso.py``, ParticleData.py:
    246-278): the covariance c = sums / max(sum w, 1e-12), its eigenvalues
    ascending, s0 the largest, the others clamped from below to s0 / kr,
    G = R diag(1 / (ks s~)) R^T; kn I where the row is not liquid, has at
    most ``min_neighbors`` neighbours, or s0 <= 0.  The reach is where
    |2 G r| passes h: G's least eigenvalue is 1 / (ks s0) (kn for kn I), so
    h ks s0 / 2 (h / (2 kn)), capped at REACH_CAP h."""
    xx, xy, xz, yy, yz, zz = mom[4:10] / torch.clamp(mom[0], min=1e-12)
    cov = torch.stack([torch.stack([xx, xy, xz], -1),
                       torch.stack([xy, yy, yz], -1),
                       torch.stack([xz, yz, zz], -1)], -2)      # (M, 3, 3)
    parts = [torch.linalg.eigh(c) for c in torch.split(cov, EIG_CHUNK)]
    eigval = torch.cat([p[0] for p in parts])
    eigvec = torch.cat([p[1] for p in parts])
    s0 = eigval[:, 2]
    s1 = torch.maximum(eigval[:, 1], s0 / kr)
    s2 = torch.maximum(eigval[:, 0], s0 / kr)
    inv = torch.stack([1.0 / (ks * torch.clamp(s2, min=1e-20)),
                       1.0 / (ks * torch.clamp(s1, min=1e-20)),
                       1.0 / (ks * torch.clamp(s0, min=1e-20))], -1)
    gm = torch.einsum("mij,mj,mkj->mik", eigvec, inv, eigvec)
    ok = (mom[10] > min_neighbors) & (s0 > 0.0) & grid.liquid
    eye = torch.eye(3, dtype=torch.float32, device=mom.device) * kn
    h = grid.cfg.support_radius
    reach = torch.where(ok, 0.5 * h * ks * torch.clamp(s0, min=1e-20),
                        0.5 * h / kn).clamp(max=REACH_CAP * h)
    return torch.where(ok[:, None, None], gm, eye).reshape(-1, 9).T, reach


def color_field(grid: Grid, rho: torch.Tensor):
    """Smoothed color function c_i and its normalized gradient, a surface
    indicator, at every row: (color (M,), grad (3, M)) (``color_field`` of
    ``wcsph_tpu/dense_ops.py``, ParticleData.compute_color_map).  A liquid
    neighbour weighs m / max(rho_j, 1), a boundary one its Akinci volume;
    the gradient sums liquid neighbours only."""
    cfg = grid.cfg
    p = pairs_of(grid)
    m = cfg.liquid_mass
    rinv = m / torch.clamp(rho, min=1.0)
    coeff = torch.where(p.liq_j != 0.0, rinv[p.j], cfg.solid_volume)
    color = (rinv * kernels.cubic_w0(cfg.support_radius)
             + _sum(p, grid.n, coeff * p.w))
    c = p.liq_j * rinv[p.j] * color[p.j] * p.gs
    grad = _sum(p, grid.n, c * p.r) / torch.clamp(color, min=1e-12)[None]
    return color, grad


# ---------------------------------------------------------------------------
# Poisson-disk sampling (twin of poisson_phase in csrc/sampling.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhaseChunk:
    """One z-chunk of the Poisson-disk sampler (``sampling.py``): every
    candidate of the mesh, the chunk's own candidates sorted by cell, and
    the points accepted so far per cell, updated in place by each phase.

    Cell c = (cx gy + cy) gz + cz of the chunk's (gx, gy, gz) cells holds
    candidates ``order[start[c]] .. order[start[c + 1] - 1]`` in candidate
    order (a stable sort: rank in a cell is by candidate index), and the
    points accepted into it in slots 0 .. acc_cnt[c] - 1 of the (3, A, NC)
    and (A, NC) arrays."""

    pts: torch.Tensor       # (3, N) float32 candidate positions
    nrm: torch.Tensor       # (3, N) float32 their face normals
    fid: torch.Tensor       # (N,) int32 their face ids
    order: torch.Tensor     # (N,) int32 candidates by cell, own ones first
    start: torch.Tensor     # (NC + 1,) int32 first sorted candidate a cell
    res: tuple              # (gx, gy, gz) cells of the chunk
    z0: int                 # the chunk's first cell plane in global z
    radius: float           # minimum spacing r (compared in float32)
    acc_p: torch.Tensor     # (3, A, NC) float32 accepted positions
    acc_n: torch.Tensor     # (3, A, NC) float32 their normals
    acc_f: torch.Tensor     # (A, NC) int32 their face ids, -1 in a free slot
    acc_cnt: torch.Tensor   # (NC,) int32 points accepted a cell

    @property
    def accept_cap(self) -> int:
        return self.acc_f.shape[0]


# fdlibm's float atanf (atanhi / atanlo of atan(0.5) and atan(1), and the
# odd and even coefficients aT), as float32 values
_ATAN_HI = tuple(float(np.float32(v)) for v in (4.6364760399e-01,
                                                7.8539812565e-01))
_ATAN_LO = tuple(float(np.float32(v)) for v in (5.0121582440e-09,
                                                3.7748947079e-08))
_ATAN_T = tuple(float(np.float32(v)) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
    -3.6531571299e-02, 1.6285819933e-02))


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded correctly (through float64): the CPU's
    float32 torch.sqrt is off by an ulp for some inputs, where the card's
    sqrtf and XLA's are not."""
    return torch.sqrt(x.double()).float()


def asin_f32(x: torch.Tensor) -> torch.Tensor:
    """arcsin of float32 x in [-1, 1] with the bits of the JAX package's
    on the CPU: XLA computes asin(x) = 2 atan2(x, 1 + sqrt((1 - x)(1 + x)))
    and its atan2f is fdlibm's (glibc), whose steps for a quotient
    q = |x| / den in [0, 1] are repeated here, one float32 operation at a
    time (``asin_f32`` in csrc/sampling.cu is the same sequence)."""
    t_ = _ATAN_T
    den = sqrt_f32((1.0 - x) * (1.0 + x)) + 1.0
    a = x.abs() / den
    low = a < 0.4375                  # |q| < 7/16: no reduction
    mid = a < 0.6875                  # 7/16 <= q < 11/16: about atan(0.5)
    t = torch.where(low, a, torch.where(mid, (2.0 * a - 1.0) / (2.0 + a),
                                        (a - 1.0) / (a + 1.0)))
    z = t * t
    w = z * z
    s1 = z * (t_[0] + w * (t_[2] + w * (t_[4] + w * (t_[6] + w * (
        t_[8] + w * t_[10])))))
    s2 = w * (t_[1] + w * (t_[3] + w * (t_[5] + w * (t_[7] + w * t_[9]))))
    hi = torch.where(mid, _ATAN_HI[0], _ATAN_HI[1])
    lo = torch.where(mid, _ATAN_LO[0], _ATAN_LO[1])
    r = torch.where(low, t - t * (s1 + s2), hi - ((t * (s1 + s2) - lo) - t))
    r = torch.where(x < 0.0, -r, r)
    r = torch.where(x == 0.0, x, r)
    return r + r


# the 5^3 window of a cell, dx outer and dz inner (the JAX package's _OFF5)
OFF5 = np.stack(np.meshgrid(*([np.arange(-2, 3)] * 3), indexing="ij"),
                -1).reshape(-1, 3)


def phase_window(ch: PhaseChunk, phase: int, trial: int):
    """The cells of colour ``phase`` whose ``trial``-th candidate is tried
    (it exists and the cell has a free slot), that candidate, and the
    geodesic test against every point accepted in the cell's in-box 5^3
    window: (cells (K,), candidate index (K,), in-window pairs (A, 125, K),
    hits (A, 125, K), the accepted slot of each pair, slot * NC + cell,
    (A, 125, K))."""
    gx, gy, gz = ch.res
    nc = gx * gy * gz
    cap = ch.accept_cap
    dev = ch.acc_cnt.device
    cx = torch.arange(phase % 3, gx, 3, device=dev)
    cy = torch.arange((phase // 3) % 3, gy, 3, device=dev)
    cz = torch.arange((phase // 9 - ch.z0) % 3, gz, 3, device=dev)
    cells = ((cx[:, None, None] * gy + cy[None, :, None]) * gz
             + cz[None, None, :]).reshape(-1)
    start = ch.start.to(torch.int64)
    s = start[cells] + trial
    tried = (s < start[cells + 1]) & (ch.acc_cnt[cells] < cap)
    cells, s = cells[tried], s[tried]
    q = ch.order[s].to(torch.int64)
    cp, cn, cf = ch.pts[:, q], ch.nrm[:, q], ch.fid[q]
    off = torch.as_tensor(OFF5, device=dev)
    nx = (cells // (gy * gz))[None] + off[:, 0:1]            # (125, K)
    ny = ((cells // gz) % gy)[None] + off[:, 1:2]
    nz = (cells % gz)[None] + off[:, 2:3]
    inbox = ((nx >= 0) & (nx < gx) & (ny >= 0) & (ny < gy) & (nz >= 0)
             & (nz < gz))
    nb = torch.where(inbox, (nx * gy + ny) * gz + nz, 0)
    slot = torch.arange(cap, device=dev)[:, None, None]
    pair = inbox[None] & (slot < ch.acc_cnt[nb][None])     # (A, 125, K)
    flat = slot * nc + nb[None]
    ap = ch.acc_p.reshape(3, -1)[:, flat]                   # (3, A, 125, K)
    an = ch.acc_n.reshape(3, -1)[:, flat]
    af = ch.acc_f.reshape(-1)[flat]
    d = cp[:, None, None, :] - ap
    dist = sqrt_f32(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                min=1e-18))
    v = d / dist
    c1 = cn[0, None, None] * v[0] + cn[1, None, None] * v[1] \
        + cn[2, None, None] * v[2]
    c2 = an[0] * v[0] + an[1] * v[1] + an[2] * v[2]
    c1 = torch.clamp(c1, -1.0, 1.0)
    c2 = torch.clamp(c2, -1.0, 1.0)
    diff = (c1 - c2).abs() > 1e-5
    corr = torch.where(
        diff, (asin_f32(c1) - asin_f32(c2)) / torch.where(diff, c1 - c2, 1.0),
        1.0 / sqrt_f32(torch.clamp(1.0 - c1 * c1, min=1e-6)))
    gdist = torch.where(af == cf[None, None], dist, dist * corr)
    hit = pair & (gdist < float(np.float32(ch.radius)))
    return cells, q, pair, hit, flat


def poisson_phase(ch: PhaseChunk, phase: int, trial: int) -> None:
    """One phase step of the sampler, in place (``_phase_step`` of
    ``wcsph_tpu/sampling.py``): every cell of colour ``phase`` ((cx % 3) +
    3 (cy % 3) + 9 ((cz + z0) % 3)) with a ``trial``-th candidate and a
    free slot accepts it into slot acc_cnt unless it lies within r of a
    point accepted in the in-box 5^3 window under the geodesic-corrected
    distance (boundry.py:342-374): d = |x_c - x_a| (d^2 floored at 1e-18),
    c1, c2 the two normals against the unit direction, clipped to [-1, 1];
    across faces d (asin c1 - asin c2) / (c1 - c2) where |c1 - c2| > 1e-5,
    else d / sqrt(max(1 - c1^2, 1e-6)); hit where that is < r.  Cells of
    one colour are at least 3 cells apart, so none reads another's
    write."""
    cells, q, _, hit, _ = phase_window(ch, phase, trial)
    ok = ~hit.any(dim=(0, 1))
    cells, q = cells[ok], q[ok]
    slot = ch.acc_cnt[cells].to(torch.int64)
    ch.acc_p[:, slot, cells] = ch.pts[:, q]
    ch.acc_n[:, slot, cells] = ch.nrm[:, q]
    ch.acc_f[slot, cells] = ch.fid[q]
    ch.acc_cnt[cells] += 1


# ---------------------------------------------------------------------------
# Point rasterizer (twin of splat_points in csrc/render.cu)
# ---------------------------------------------------------------------------

BACKGROUND_KEY = 0xFFFFFFFF   # a pixel channel no splat reached
INV_255 = float(np.float32(1.0 / 255.0))   # XLA divides by 255 as a
                                           # product with this
PIXEL_CLAMP = float(1 << 20)  # rounded pixel centres are clamped to +-this
                              # before the int conversion (far off-frame)


def disk_stencil(radius_px: int) -> np.ndarray:
    """(S, 2) int32 pixel offsets (i, j) with i^2 + j^2 <= radius_px^2, i
    outer (``_disk_stencil`` of ``wcsph_tpu/render.py``)."""
    r = radius_px
    ij = [(i, j) for i in range(-r, r + 1) for j in range(-r, r + 1)
          if i * i + j * j <= r * r]
    return np.asarray(ij, np.int32)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a b + c rounded once (a fused multiply-add, CUDA's fmaf):
    the product is exact in float64, the sum's error is recovered exactly
    (TwoSum), an inexact sum is rounded to odd, and that float64 rounds to
    the float32 nearest to the exact a b + c."""
    p = a.double() * b
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, float("inf"), float("-inf")).to(s.dtype)
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def splat_keys(points: torch.Tensor, colors: torch.Tensor,
               radii: torch.Tensor, pv: np.ndarray, width: int, height: int,
               radius_px: int):
    """The splat's writes: (pixel (S N,) int64, keys (3, S N) int64) for
    the S stencil offsets of every point, pixel = width * height where the
    write falls outside the frame, the disk or NDC z in [0, 1]; see
    ``splat_points``."""
    dev = points.device
    x, y, z = points[0], points[1], points[2]
    p = [float(v) for v in np.asarray(pv, np.float32).reshape(-1)]
    clip = [fma_f32(z, p[4 * r + 2], fma_f32(y, p[4 * r + 1], p[4 * r] * x))
            + p[4 * r + 3] for r in range(4)]
    zn = clip[2] / clip[3]
    sx = (clip[0] / clip[3] + 1.0) * 0.5 * width
    sy = (clip[1] / clip[3] + 1.0) * 0.5 * height
    st = torch.as_tensor(disk_stencil(radius_px), device=dev)
    r2 = (st[:, 0] * st[:, 0] + st[:, 1] * st[:, 1])[:, None]

    def centre(s):
        return torch.clamp(torch.round(s), -PIXEL_CLAMP,
                           PIXEL_CLAMP).to(torch.int64)[None]

    px = centre(sx) + st[:, 0:1]
    py = centre(sy) + st[:, 1:2]
    inside = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
              & ((zn >= 0.0) & (zn <= 1.0))[None]
              & (r2 <= (radii.to(torch.int64) ** 2)[None]))
    flat = torch.where(inside, py * width + px, width * height).reshape(-1)
    zbits = (torch.clamp(zn, 0.0, 1.0) * 4.19e6).to(torch.int64) << 8
    cb = torch.clamp(colors * 255.0, 0.0, 255.0).to(torch.int64)
    keys = (zbits[None] | (255 - cb))[:, None].expand(3, st.shape[0], -1)
    return flat, keys.reshape(3, -1)


def splat_points(points: torch.Tensor, colors: torch.Tensor,
                 radii: torch.Tensor, pv: np.ndarray, width: int,
                 height: int, radius_px: int,
                 background: float) -> torch.Tensor:
    """(H, W, 3) float32 image of the (3, N) points (``_rasterize`` of
    ``wcsph_tpu/render.py``): clip = pv (x, y, z, 1), each row as XLA's
    dot forms it on the CPU, fma(p2, z, fma(p1, y, p0 x)) + p3; a point
    with NDC z in [0, 1] splats the pixels of its disk stencil (radius_px,
    and i^2 + j^2 <= radii^2) around its rounded screen position (half to
    even); each channel keeps the least key (uint32(z 4.19e6) << 8) |
    (255 - c), so the nearest point wins and, at equal depth, the
    brightest; the image is (255 - key's low byte) times float32(1 / 255)
    (XLA's form of the division), or ``background`` where nothing landed.
    The keys are held in int64 and reduced with scatter_reduce_('amin')."""
    flat, keys = splat_keys(points, colors, radii, pv, width, height,
                            radius_px)
    n_pix = width * height
    img = torch.full((3, n_pix + 1), BACKGROUND_KEY, dtype=torch.int64,
                     device=points.device)
    for c in range(3):
        img[c].scatter_reduce_(0, flat, keys[c], "amin")
    img = img[:, :n_pix].T
    color = (255 - (img & 0xFF)).to(torch.float32) * INV_255
    out = torch.where(img != BACKGROUND_KEY, color, float(background))
    return out.reshape(height, width, 3)
