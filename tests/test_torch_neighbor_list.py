"""The DFSPH step's neighbour list (wcsph_tpu_torch, CPU plain versions).

K2, K3, K4 and K1's advected-density, visc-init and vorticity sweeps walk
a per-step neighbour list in sliced ELL (``grid.NeighborList``) on the
card.  The fill kernel cannot run
here, so these cases hold its plain twin (``dense_ops.neighbor_list``) and
the plain walk of the layout (``dense_ops.list_pairs``) on the pressurized
side-8 scene of tests/test_torch_step.py:

* the list holds, for each liquid receiver, exactly the j with d2 <= h2,
  j != i, in ascending order (against an O(L M) brute force), and each
  row's record (position, liquid flag);
* the slice widths and offsets follow from the density sweep's counts;
* padding is never walked;
* the twins of K3 (modes 0 and 1), K2, the visc-init and vorticity
  sweeps and K4 run on the walked pairs give the bits of the same twins on
  the cell-loop pair list;
* an IISPH step builds the list from its density sweep's counts, and the
  twins of its K5 advection, a_ii and pressure-force sweeps give the same
  bits over the walked pairs.
"""

import numpy as np
import pytest

torch = wt = dense_ops = engine = grid_mod = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, dense_ops, engine, grid_mod
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch import dense_ops, engine, grid as grid_mod
    torch.set_num_threads(1)


R = 0.025


def _pressurized(solver):
    """The pressurized side-8 scene (dam break squeezed by 0.92) with the
    solver's default config, on the CPU."""
    sc = wt.dam_break(particle_radius=R, fluid_dims=(8, 8, 8),
                      box_extent=0.9)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * 0.92
    lo, hi = sc.domain(pad=4 * R)
    sim = wt.Simulation(sc, wt.default_config(
        solver, particle_radius=R, domain_min=lo, domain_max=hi),
        solver=solver, device="cpu")
    return sc, sim


@pytest.fixture(scope="module")
def case(_port):
    """The pressurized side-8 scene (converging velocity), sorted, with the
    density sweep's counts and its list."""
    sc, sim = _pressurized("dfsph")
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    g = grid_mod.build_grid(sim.state.pos, sc.n_liquid, sim.cfg)
    vel = grid_mod.pack(g, [torch.as_tensor(
        (-10.0 * (liq - centre)).T.astype(np.float32))])[0]
    count = dense_ops.density_alpha_drho(g, vel)[1].to(torch.int32)
    nl = dense_ops.neighbor_list(g, count)
    return g, vel, count, nl


def _rows_of(nl, i):
    """Row i's slots, in order."""
    s = i // grid_mod.SLICE
    w = int(nl.width[s])
    base = int(nl.off[s]) + i % grid_mod.SLICE
    return nl.idx[base + grid_mod.SLICE * torch.arange(w)].tolist()


def test_list_holds_the_pairs_within_h_in_ascending_order(case):
    g, _, count, nl = case
    h2 = float(np.float32(g.cfg.support_radius ** 2))
    rows = torch.nonzero(g.liquid).flatten()
    r = g.pos[:, rows, None] - g.pos[:, None, :]
    d2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    near = (d2 <= h2) & (rows[:, None] != torch.arange(g.n)[None, :])
    for n, i in enumerate(rows.tolist()):
        want = torch.nonzero(near[n]).flatten().tolist()
        slots = _rows_of(nl, i)
        assert slots[: len(want)] == want
        assert all(j == -1 for j in slots[len(want):])
    assert int(near.sum()) > 20 * len(rows)      # a real neighbourhood


def test_records_hold_each_rows_position_and_flag(case):
    g, _, _, nl = case
    assert nl.rec.dtype == torch.float32 and nl.rec.shape == (g.n, 4)
    assert nl.rec.is_contiguous()
    assert torch.equal(nl.rec[:, :3], g.pos.T)
    assert torch.equal(nl.rec[:, 3], g.liq)
    assert bool((nl.rec[:, 3] == 0).any()) and bool((nl.rec[:, 3] == 1).any())


def test_slices_follow_the_density_counts(case):
    g, _, count, nl = case
    s = grid_mod.SLICE
    m = g.n
    nsl = -(-m // s)
    c = torch.zeros(nsl * s, dtype=torch.int64)
    c[:m] = torch.where(g.liquid, count.to(torch.int64), 0)
    width = c.view(nsl, s).amax(1)
    assert torch.equal(nl.width.to(torch.int64), width)
    assert int(nl.off[0]) == 0
    assert torch.equal(nl.off[1:].to(torch.int64), torch.cumsum(width * s, 0))
    assert nl.idx.shape == (int(nl.off[-1]),) and nl.idx.dtype == torch.int32
    # a slice of boundary rows alone takes no slots; slices with liquid do
    only_solid = ~torch.nn.functional.pad(g.liquid, (0, nsl * s - m)).view(
        nsl, s).any(1)
    assert bool(only_solid.any()) and bool((~only_solid).any())
    assert bool((width[only_solid] == 0).all())
    assert bool((width[~only_solid] > 0).all())
    # the density sweep's count must match the pairs, or the build refuses
    bad = count.clone()
    bad[torch.nonzero(g.liquid)[0]] += 1
    with pytest.raises(ValueError, match="count differs"):
        dense_ops.neighbor_list(g, bad)


def test_padding_is_never_walked(case):
    g, _, count, nl = case
    walked = dense_ops.list_pairs(g, nl)
    n_pairs = int(count[g.liquid].sum())
    assert walked.i.shape == (n_pairs,)
    assert bool((walked.j >= 0).all())
    assert int((nl.idx == -1).sum()) == nl.idx.shape[0] - n_pairs > 0
    # each liquid row is walked count times, a boundary row never
    per_row = torch.bincount(walked.i, minlength=g.n)
    assert torch.equal(per_row, torch.where(g.liquid, count, 0).to(
        per_row.dtype))
    # the walked pairs are those of the cell loop at liquid receivers
    p = dense_ops.pairs_of(g)
    keep = g.liquid[p.i]
    assert (sorted(zip(walked.i.tolist(), walked.j.tolist()))
            == sorted(zip(p.i[keep].tolist(), p.j[keep].tolist())))


# The walk adds each receiver's terms in slot order, which is ascending j,
# the order of the cell loop's pair list too, and index_add_ on the CPU
# adds in pair order: so the same float32 terms in the same order, and the
# twins must give the same bits on either list.  (On the card the plain
# twin's index_add_ adds in no fixed order: chip_smoke.py compares there
# within TOL_FUSED.)
@pytest.mark.parametrize("which",
                         ["k3-mode0", "k3-mode1", "k2", "visc_init",
                          "vorticity", "k4"])
def test_walk_reproduces_the_fused_sweeps(case, which):
    import dataclasses

    from wcsph_tpu_torch.kernels import cubic_w0

    g, vel, count, nl = case
    walked = dataclasses.replace(g, pairs=dense_ops.list_pairs(g, nl))
    cfg = g.cfg
    liq = g.liq
    rng = np.random.RandomState(3)

    def seeded(scale):
        return torch.as_tensor(rng.randn(g.n).astype(np.float32)) * scale

    def seeded3(scale):
        return torch.as_tensor(rng.randn(3, g.n).astype(np.float32)) * scale

    dt = np.float32(1e-3)
    raw = dense_ops.density_alpha_drho(g, vel)
    rho = cfg.rest_density * (cfg.liquid_volume * cubic_w0(
        cfg.support_radius) + raw[0])
    rinv = engine.rho_inv(rho)
    if which == "visc_init":
        x = vel + seeded3(0.01) * liq
        outs = [[dense_ops.visc_init(grid, x, rinv)] for grid in (walked, g)]
    elif which == "vorticity":
        om = seeded3(0.1) * liq
        outs = [[dense_ops.vorticity(grid, vel, om, rinv)]
                for grid in (walked, g)]
    elif which == "k4":
        x = vel + seeded3(0.01) * liq
        minv, _ = engine.visc_init(g, x, rho, dt)
        minv6 = torch.stack(list(minv)).contiguous()
        r0, d0 = seeded3(1.0) * liq, seeded3(1.0) * liq
        delta = torch.sum(r0 * minv.matvec(r0))
        outs = []
        for grid in (walked, g):
            xs, r, d = x.clone(), r0.clone(), d0.clone()
            scal = dense_ops.fused_visc_iter(grid, xs, r, d, delta, rinv,
                                             minv6, dt)
            outs.append([xs, r, d, scal])
    elif which == "k2":
        kf = seeded(1e-2) * liq
        gate = liq * torch.as_tensor(rng.rand(g.n) > 0.3)
        outs = []
        for grid in (walked, g):
            v, acc = dense_ops.fused_kappa_drho(
                grid, vel.clone(), kf, gate, torch.empty(g.n))
            outs.append([v, acc])
    else:
        mode = int(which[-1])
        den = raw[5] + raw[2] ** 2 + raw[3] ** 2 + raw[4] ** 2
        alpha = torch.where(den > cfg.eps, -1.0 / den, 0.0) * liq
        a = alpha / float(dt) ** (mode + 1)
        s0 = (torch.clamp(raw[6], min=0.0) + seeded(0.1).abs() * liq
              if mode == 0 else 1.0 + seeded(1e-3).abs() * liq)
        paux = ((count >= cfg.min_div_neighbors).float() if mode == 0
                else 1.0 + seeded(1e-2).abs() * liq)
        kv0 = seeded(1.0) * liq
        outs = []
        for grid in (walked, g):
            v, kv, s = vel.clone(), kv0.clone(), s0.clone()
            err = dense_ops.fused_iter_full(grid, v, kv, s, a, paux, dt,
                                            mode)
            outs.append([v, kv, s, err.reshape(1)])
    for got, want in zip(*outs):
        assert float(want.abs().max()) > 0
        assert torch.equal(got, want)


def test_iisph_step_builds_the_list_from_its_density_counts(_port):
    """IISPH's viscosity PCG (K4), its advection, a_ii and pressure-force
    sweeps (K5) and K7 walk the list on the card: its step builds it right
    after the density sweep, from that sweep's counts; the twins of the K5
    sweeps give the same bits over the listed pairs as over the cell
    loop's."""
    import dataclasses

    from wcsph_tpu_torch.solvers import iisph

    sc, sim = _pressurized("iisph")
    st = sim.state
    g = grid_mod.build_grid(st.pos, st.n_liquid, sim.cfg)
    packed = grid_mod.pack(g, [st.vel, st.vel_guess, st.pressure])
    assert g.nbr is None
    mid = iisph.step_middle(g, sim.cfg, *packed, st.dt)
    assert mid.visc_iters > 0
    _, count = engine.density(g)
    want = dense_ops.neighbor_list(g, count)
    for field in ("idx", "off", "rec"):
        assert torch.equal(getattr(g.nbr, field), getattr(want, field))
    assert int((g.nbr.idx >= 0).sum()) == int(count[g.liquid].sum()) > 0
    walked = dataclasses.replace(g, pairs=dense_ops.list_pairs(g, g.nbr))
    rng = np.random.RandomState(4)
    liq = g.liq
    vel = torch.as_tensor(rng.randn(3, g.n).astype(np.float32)) * liq
    dii = torch.as_tensor(rng.randn(3, g.n).astype(np.float32)) * liq
    dpi = torch.as_tensor(rng.rand(g.n).astype(np.float32)) * liq
    for fn, arg in ((dense_ops.iisph_adv, vel), (dense_ops.iisph_aii, dii),
                    (dense_ops.iisph_force, dpi)):
        got, want = fn(walked, arg), fn(g, arg)
        assert float(want.abs().max()) > 0, fn.__name__
        assert torch.equal(got, want), fn.__name__
