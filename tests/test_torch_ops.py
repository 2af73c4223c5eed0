"""The port's plain pair sweeps (wcsph_tpu_torch, CPU) against their XLA
twins in wcsph_tpu/dense_ops.py, on the jittered side-6 scene of
tests/test_engine.py at capacity 16 and 24, with numpy-seeded velocity,
kappa and omega.

The JAX side holds particles in capacity-padded (C, NC) slots, the port in
rows sorted by cell; both are mapped back to particle order (JAX through
``grid.pid``, the port through ``grid.order``) before comparing.  Tolerance:
``_close`` of tests/test_engine.py, rtol 3e-5 of max(max|ref|, 1), over the
receivers each op is defined at; neighbour counts exact.  The SESPH force
and the tension sweeps take that file's rtol 2e-4 (their XLA twins divide
where the engine forms multiply by a reciprocal), on the same scene squeezed
by 0.92 so that the Tait pressure is not zero.  The IISPH and PCISPH sweeps
have closures of the JAX solvers as their XLA twins and are compared through
whole steps in tests/test_torch_solver_steps.py; here the PCISPH pair list
(candidates of the original cells, cut at the moved positions) is held
against a brute-force count, and the unfused PCISPH prediction sweep
against the JAX solver's ``_predicted_density_and_accel`` at the moved
positions.  The other emits that only the unfused solver loops run alone
(``kappa_velocity_update``, ``visc_matvec``, ``surface_normals``,
``tension_accel``) are held against their XLA twins beside the fused
kernels built on them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from wcsph_tpu import dam_break, dense_ops
from wcsph_tpu.config import SimConfig
from wcsph_tpu.grid import build_grid, pack_liquid

torch = tdense = engine = tgrid = config_from_dict = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, tdense, engine, tgrid, config_from_dict
    import torch
    import wcsph_tpu_torch.dense_ops as tdense
    from wcsph_tpu_torch import engine, grid as tgrid
    from wcsph_tpu_torch.config import config_from_dict
    torch.set_num_threads(1)


DT = np.float32(1e-3)


class _Case:
    """One scene in both layouts, with seeded per-particle fields."""

    def __init__(self, cap, jitter, seed=0, squeeze=1.0, **cfg_over):
        import dataclasses

        r = 0.025
        side = 6
        sc = dam_break(particle_radius=r, fluid_dims=(side,) * 3,
                       box_extent=side * 2 * r * 1.5)
        lo, hi = sc.domain(pad=6 * r)
        self.cfg = SimConfig(particle_radius=r, domain_min=lo, domain_max=hi,
                             cell_capacity=cap, **cfg_over)
        rng = np.random.RandomState(seed)
        liq = sc.positions[: sc.n_liquid]
        centre = liq.mean(axis=0, keepdims=True)
        sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
        pos = sc.positions.T.copy()
        if jitter:
            pos += rng.randn(*pos.shape).astype(np.float32) * jitter
        nl = sc.n_liquid
        self.nl, self.n = nl, pos.shape[1]
        self.grid = build_grid(jnp.asarray(pos), nl, self.cfg)
        assert int(self.grid.overflow) == 0
        self.tcfg = config_from_dict(dataclasses.asdict(self.cfg))
        self.tg = tgrid.build_grid(torch.as_tensor(pos), nl, self.tcfg)
        self.pid = np.asarray(self.grid.pid)
        self.liquid = np.arange(self.n) < nl
        self.vel = rng.randn(3, nl).astype(np.float32)
        self.k = rng.randn(nl).astype(np.float32)
        self.om = (0.1 * rng.randn(3, nl)).astype(np.float32)

    # -- layouts -----------------------------------------------------------
    def jpack(self, x):
        return pack_liquid(self.grid, jnp.asarray(x))

    def tpack(self, x):
        return tgrid.pack(self.tg, [torch.as_tensor(x)])[0].contiguous()

    def jparticles(self, a):
        """Packed (…, C, NC) -> per particle (…, N)."""
        a = np.asarray(a)
        a = a.reshape(a.shape[:-2] + (-1,))
        pid = self.pid.ravel()
        ok = pid >= 0
        out = np.zeros(a.shape[:-1] + (self.n,), a.dtype)
        out[..., pid[ok]] = a[..., ok]
        return out

    def tparticles(self, a):
        """Sorted rows (…, M) -> per particle (…, N)."""
        a = a.detach().numpy()
        out = np.zeros(a.shape[:-1] + (self.n,), a.dtype)
        out[..., self.tg.order.numpy()] = a
        return out


def _close(ref, got, where, rtol=3e-5):
    """test_engine._close: max|d| <= rtol * max(max|ref|, 1) over where."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    d = np.where(where, np.abs(ref - got), 0.0)
    scale = max(float(np.max(np.where(where, np.abs(ref), 0.0))), 1.0)
    assert float(d.max()) <= rtol * scale, (float(d.max()), scale)


CASES = [(16, 0.0), (24, 0.004)]


@pytest.fixture(scope="module", params=CASES, ids=["C16", "C24-jitter"])
def case(request):
    return _Case(*request.param)


def test_density_and_divergence_sweeps(case):
    """K1's _DensityAlphaDrho and _DivAcc emits (plain twins): rho, alpha,
    exact counts, the warm-start divergence channel, and the divergence
    sums behind drho_divergence and advected_density."""
    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=True)
    rho, alpha, cnt, div = engine.density_alpha(case.tg,
                                                case.tpack(case.vel))
    allp = np.ones(case.n, bool)
    _close(case.jparticles(stats.rho), case.tparticles(rho), allp)
    _close(case.jparticles(stats.alpha), case.tparticles(alpha), allp)
    np.testing.assert_array_equal(case.jparticles(stats.count),
                                  case.tparticles(cnt))
    # 7th channel: the warm-start divergence sum of the incoming velocity
    acc = dense_ops._div_accum(case.grid, case.cfg, case.jpack(case.vel))
    _close(case.jparticles(acc), case.tparticles(div), case.liquid)

    velj, velt = case.jpack(case.vel), case.tpack(case.vel)
    rho = torch.as_tensor(case.jparticles(stats.rho))[case.tg.order]
    _close(case.jparticles(dense_ops._div_accum(case.grid, case.cfg, velj)),
           case.tparticles(engine.k1_div_acc(case.tg, velt)), case.liquid)
    _close(case.jparticles(dense_ops.drho_divergence(
               case.grid, case.cfg, velj, stats.count)),
           case.tparticles(engine.drho_divergence(case.tg, velt, cnt)),
           case.liquid)
    _close(case.jparticles(dense_ops.advected_density(
               case.grid, case.cfg, velj, stats.rho, DT)),
           case.tparticles(engine.advected_density(case.tg, velt, rho, DT)),
           case.liquid)


def test_fused_kappa_iterations(case):
    """K2's plain twin (gate = liquid) == kappa_velocity_update followed by
    the divergence sum of the updated velocity; K3's plain twin, modes 0
    and 1, == the XLA two-sweep iteration body of solvers/dfsph.py (k, kv,
    kappa update, drho / advected density, error)."""
    velj, kj = case.jpack(case.vel), case.jpack(case.k)
    v1 = dense_ops.kappa_velocity_update(case.grid, case.cfg, velj, kj, DT)
    acc1 = dense_ops._div_accum(case.grid, case.cfg, v1)
    vel = case.tpack(case.vel)
    acc = torch.empty(case.tg.n)
    kf = (float(DT) * case.tpack(case.k)).contiguous()
    engine.k2_fused_kappa_drho(case.tg, vel, kf, case.tg.liq.clone(), acc)
    _close(case.jparticles(v1), case.tparticles(vel), case.liquid)
    _close(case.jparticles(acc1), case.tparticles(acc), case.liquid)
    # the unfused loops' kappa update (_KappaAcc alone, k not pre-scaled)
    v2 = engine.kappa_velocity_update(case.tg, case.tpack(case.vel),
                                      case.tpack(case.k), DT)
    _close(case.jparticles(v1), case.tparticles(v2), case.liquid)

    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=True)
    alpha = jnp.where(case.grid.liquid, stats.alpha, 0.0)
    velj = case.jpack(case.vel)
    rng = np.random.RandomState(5)
    kv0 = (0.1 * rng.randn(case.nl)).astype(np.float32)
    for mode in (0, 1):
        if mode == 0:
            s = dense_ops.drho_divergence(case.grid, case.cfg, velj,
                                          stats.count)
            a = alpha / DT
            paux = (stats.count >= case.cfg.min_div_neighbors).astype(
                jnp.float32)
        else:
            s = dense_ops.advected_density(case.grid, case.cfg, velj,
                                           stats.rho, DT)
            a = alpha / (DT * DT)
            paux = stats.rho / case.cfg.rest_density
        kvj = case.jpack(kv0)
        k = (s - mode) * a
        kv1 = kvj + k
        v1 = dense_ops.kappa_velocity_update(case.grid, case.cfg, velj, k, DT)
        acc = dense_ops._div_accum(case.grid, case.cfg, v1)
        s1 = (jnp.maximum(paux * acc, 0.0) if mode == 0
              else jnp.maximum(paux + DT * acc, 1.0))
        err1 = float(jnp.sum(jnp.where(case.grid.liquid, s1 - mode, 0.0)))

        def rows(x):
            return torch.as_tensor(case.jparticles(x))[
                ..., case.tg.order].contiguous()

        vel, kv, st = case.tpack(case.vel), case.tpack(kv0), rows(s)
        err = engine.k3_fused_iter_full(case.tg, vel, kv, st, rows(a),
                                        rows(paux), DT, mode)
        _close(case.jparticles(v1), case.tparticles(vel), case.liquid)
        _close(case.jparticles(kv1), case.tparticles(kv), case.liquid)
        _close(case.jparticles(s1), case.tparticles(st), case.liquid)
        assert abs(float(err) - err1) <= 3e-5 * max(abs(err1), 1.0)


def test_viscosity_sweeps(case):
    """K1's _ViscInit emit (block-Jacobi sums + A x0) and K4's plain twin
    == one XLA PCG iteration built on dense_ops.visc_matvec
    (viscosity.solve_dense body)."""
    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=False)
    rho_pad = dense_ops.WindowLoop(case.grid, case.cfg).pad(stats.rho, 1.0)
    x0 = case.jpack(case.vel)
    minv1, ax1 = dense_ops.visc_init(case.grid, case.cfg, x0, stats.rho,
                                     rho_pad, DT)
    rho = torch.as_tensor(case.jparticles(stats.rho))[case.tg.order]
    minv2, ax2 = engine.visc_init(case.tg, case.tpack(case.vel), rho, DT)
    for a, b in zip(minv1, minv2):
        _close(case.jparticles(a), case.tparticles(b), case.liquid)
    _close(case.jparticles(ax1), case.tparticles(ax2), case.liquid)

    cfg = case.cfg
    minv = minv1                 # the preconditioner of the PCG iteration
    rng = np.random.RandomState(9)
    x0, r0, d0 = (rng.randn(3, case.nl).astype(np.float32)
                  for _ in range(3))
    liq3 = case.grid.liquid[None]
    x, r, d = case.jpack(x0), case.jpack(r0), case.jpack(d0)
    delta = jnp.sum(jnp.where(liq3, r * minv_matvec(minv, r), 0.0))
    ad = jnp.where(liq3, dense_ops.visc_matvec(case.grid, cfg, d, stats.rho,
                                               rho_pad, DT), 0.0)
    # the unfused PCG's matvec (_ViscAcc alone)
    _close(case.jparticles(ad), case.tparticles(engine.visc_matvec(
        case.tg, case.tpack(d0), rho, DT)), case.liquid)
    d_ad = cfg.eps + jnp.sum(jnp.where(liq3, d * ad, 0.0))
    alpha = delta / d_ad
    x1 = x + alpha * d
    r1 = r - alpha * ad
    s = minv_matvec(minv, r1)
    delta1 = jnp.sum(jnp.where(liq3, r1 * s, 0.0))
    d1 = s + delta1 / delta * d

    def rows(a):
        return torch.as_tensor(case.jparticles(a))[..., case.tg.order]

    rho = rows(stats.rho)
    minv6 = torch.stack([rows(c) for c in minv]).contiguous()
    xt, rt, dt_ = case.tpack(x0), case.tpack(r0), case.tpack(d0)
    scal = engine.k4_fused_visc_iter(case.tg, xt, rt, dt_,
                                     torch.tensor(float(delta)),
                                     engine.rho_inv(rho), minv6, DT)
    for a, b in ((x1, xt), (r1, rt), (d1, dt_)):
        _close(case.jparticles(a), case.tparticles(b), case.liquid)
    np.testing.assert_allclose(scal.numpy(), [float(d_ad), float(delta1)],
                               rtol=3e-5)


def minv_matvec(minv, v):
    """Sym3.matvec on packed (3, C, NC)."""
    return jnp.stack([
        minv.xx * v[0] + minv.xy * v[1] + minv.xz * v[2],
        minv.xy * v[0] + minv.yy * v[1] + minv.yz * v[2],
        minv.xz * v[0] + minv.yz * v[1] + minv.zz * v[2]])


def test_vorticity_and_pair_list(case):
    """K1's _Vorticity emit; and the plain twins' pair list holds exactly
    the pairs of the JAX window sweep: d^2 <= h^2, self excluded, both
    directions."""
    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=False)
    velj, omj = case.jpack(case.vel), case.jpack(case.om)
    dv1, om1 = dense_ops.vorticity(case.grid, case.cfg, velj, omj, stats.rho,
                                   DT)
    rho = torch.as_tensor(case.jparticles(stats.rho))[case.tg.order]
    cnt = torch.as_tensor(case.jparticles(stats.count))[case.tg.order]
    dv2, om2 = engine.vorticity(case.tg, case.tpack(case.vel),
                                case.tpack(case.om), rho, cnt, DT)
    _close(case.jparticles(dv1), case.tparticles(dv2), case.liquid)
    _close(case.jparticles(om1), case.tparticles(om2), case.liquid)

    p = tdense.pairs_of(case.tg)
    order = case.tg.order.numpy()
    got = set(zip(order[p.i.numpy()], order[p.j.numpy()]))
    pos = np.asarray(case.grid.xp).reshape(3, -1)
    pid = case.pid.ravel()
    ok = pid >= 0
    x = np.zeros((3, case.n), np.float32)
    x[:, pid[ok]] = pos[:, ok]
    h2 = np.float32(case.cfg.support_radius ** 2)
    rr = x[:, :, None] - x[:, None, :]
    d2 = rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2]
    want = {(a, b) for a, b in zip(*np.nonzero(d2 <= h2)) if a != b}
    assert got == want
    valid = np.asarray(case.grid.valid)
    assert len(p.i) == int(np.asarray(stats.count)[valid].sum())


@pytest.fixture(scope="module")
def squeezed():
    """The jittered scene squeezed by 0.92, with the tension config of
    tests/test_engine.py:143-144 (cohesion and adhesion gates both on)."""
    return _Case(16, 0.003, squeeze=0.92, tension_coff=0.25,
                 tension_coff_b=0.4, adhesion_center=(0.0, -0.2, 0.0),
                 adhesion_radius=0.2)


def test_density_and_sesph_force(squeezed):
    """K5's _DensityAlpha and _SesphForce emits (plain twins): rho and exact
    counts against density_stats(with_alpha=False); the fused force against
    explicit_viscosity_accel + pressure_accel_symmetric, with a non-zero
    Tait pressure; and with zero pressure, PCISPH's pure viscosity."""
    from wcsph_tpu import ops as wops

    case = squeezed
    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=False)
    rho, cnt = engine.density(case.tg)
    allp = np.ones(case.n, bool)
    _close(case.jparticles(stats.rho), case.tparticles(rho), allp)
    np.testing.assert_array_equal(case.jparticles(stats.count),
                                  case.tparticles(cnt))

    rhoj, pj = wops.tait_pressure(stats.rho, case.cfg)
    from wcsph_tpu_torch import ops as tops
    rhot, pt = tops.tait_pressure(rho, case.tcfg)
    _close(case.jparticles(pj), case.tparticles(pt), case.liquid)
    assert float(np.abs(case.jparticles(pj))[case.liquid].max()) > 1e3
    velj, velt = case.jpack(case.vel), case.tpack(case.vel)
    for pjx, ptx in ((pj, pt), (jnp.zeros_like(pj), torch.zeros_like(pt))):
        acc_x = (dense_ops.explicit_viscosity_accel(case.grid, case.cfg, velj,
                                                    rhoj)
                 + dense_ops.pressure_accel_symmetric(case.grid, case.cfg,
                                                      rhoj, pjx))
        acc_t = engine.sesph_force(case.tg, velt, rhot, ptx)
        assert float(np.abs(case.jparticles(acc_x)).max()) > 0.0
        _close(case.jparticles(acc_x), case.tparticles(acc_t), case.liquid,
               rtol=2e-4)


def test_fused_tension(squeezed):
    """K6's plain twin == surface_normals + tension_accel, with the cohesion
    and the boundary-adhesion gates both active (asserted); and, over the
    pairs of the step's neighbour list, which K6 walks on the card, the
    twin gives the bits it gives over the cell loop's pairs."""
    case = squeezed
    stats = dense_ops.density_stats(case.grid, case.cfg, with_alpha=False)
    n1 = dense_ops.surface_normals(case.grid, case.cfg, stats.rho)
    t1 = dense_ops.tension_accel(case.grid, case.cfg, stats.rho, n1)
    rho = torch.as_tensor(case.jparticles(stats.rho))[case.tg.order]
    n2, t2 = engine.fused_tension(case.tg, rho)
    _close(case.jparticles(n1), case.tparticles(n2), case.liquid)
    _close(case.jparticles(t1), case.tparticles(t2), case.liquid, rtol=2e-4)
    # the unfused tension: the normals sweep, then the tension sweep
    n3 = engine.surface_normals(case.tg, rho)
    _close(case.jparticles(n1), case.tparticles(n3), case.liquid)
    _close(case.jparticles(t1),
           case.tparticles(engine.k1_tension_accel(case.tg, rho, n3)),
           case.liquid, rtol=2e-4)
    assert float(np.abs(case.tparticles(t2)).max()) > 0.0
    import dataclasses
    tg_na = dataclasses.replace(
        case.tg, cfg=case.tcfg.replace(tension_coff_b=0.0))
    _, t3 = engine.fused_tension(tg_na, rho)
    assert float((t2 - t3).abs().max()) > 0.0
    # the list's pairs: each liquid receiver's neighbours in the cell loop's
    # order, so the same float32 terms summed in the same order
    nl = tdense.neighbor_list(case.tg, engine.density(case.tg)[1])
    walked = dataclasses.replace(case.tg,
                                 pairs=tdense.list_pairs(case.tg, nl))
    ril = torch.where(case.tg.liquid, engine.rho_inv(rho), 0.0)
    for got, want in zip(tdense.fused_tension(walked, ril, rho),
                         tdense.fused_tension(case.tg, ril, rho)):
        assert float(want.abs().max()) > 0.0
        assert torch.equal(got, want)


def test_starred_pair_list(case):
    """build_pairs with moved positions: the candidates are those of the
    ORIGINAL cells, the cut is taken at the moved positions; the unfused
    PCISPH prediction there, its cut and the walk of the cut's hits."""
    rng = np.random.RandomState(11)
    tg = case.tg
    h = case.cfg.support_radius
    shift = (0.3 * h * rng.randn(3, tg.n)).astype(np.float32)
    xs = tg.pos + torch.as_tensor(shift) * tg.liq
    p = tdense.build_pairs(tg, xs)
    got = set(zip(p.i.tolist(), p.j.tolist()))

    gx, gy, gz = case.cfg.grid_res
    cell = tg.cell.numpy().astype(np.int64)
    c3 = np.stack([cell // (gy * gz), (cell // gz) % gy, cell % gz])
    adjacent = (np.abs(c3[:, :, None] - c3[:, None, :]) <= 1).all(axis=0)
    x = xs.numpy()
    rr = x[:, :, None] - x[:, None, :]
    d2 = rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2]
    near = d2 <= np.float32(h * h)
    want = {(a, b) for a, b in zip(*np.nonzero(near & adjacent)) if a != b}
    assert got == want
    # the moved positions do change the list, both ways, and some pair
    # within h at the moved positions is missed for its cells
    orig = set(zip(tdense.pairs_of(tg).i.tolist(),
                   tdense.pairs_of(tg).j.tolist()))
    assert got - orig and orig - got
    assert int((near & ~adjacent).sum()) > 0
    np.testing.assert_array_equal(p.r.numpy(),
                                  x[:, p.i.numpy()] - x[:, p.j.numpy()])

    # the unfused PCISPH prediction sweep at moved positions (liquid rows
    # moved, a seeded pressure) against the JAX solver's XLA twin
    from wcsph_tpu.kernels import cubic_w0
    from wcsph_tpu.solvers.pcisph import _predicted_density_and_accel

    move = (0.3 * h * rng.randn(3, case.nl)).astype(np.float32)
    press = (1e3 * rng.rand(case.nl)).astype(np.float32)
    adv1, acc1 = _predicted_density_and_accel(
        case.grid, case.cfg, case.grid.xp + case.jpack(move),
        case.jpack(press))
    xs2 = tg.pos + case.tpack(move)
    adv2, acc2, hits = engine.pcisph_predict(tg, xs2, case.tpack(press))
    w0 = case.cfg.liquid_volume * cubic_w0(h)
    assert float(np.abs(case.jparticles(acc1)).max()) > 0.0
    _close(case.jparticles(adv1),
           case.tparticles(torch.clamp(w0 + adv2, min=1.0)), case.liquid)
    _close(case.jparticles(acc1), case.tparticles(acc2), case.liquid)

    # the unfused loop's second call at the same x*, a second seeded
    # pressure: the walk over the cut's hits equals a cut there bit for
    # bit, with a width that holds every row's hits and with 4, where the
    # rows of more hits are scanned again; both within the tolerance above
    # of the JAX twin at that pressure
    from wcsph_tpu_torch.grid import ListSlots

    press2 = (1e3 * rng.rand(case.nl)).astype(np.float32)
    p2 = case.tpack(press2)
    want = engine.k1_pcisph_predict(tg, xs2, p2)[0]
    short = engine.k1_pcisph_predict(tg, xs2, case.tpack(press),
                                     ListSlots(4 * tg.n))[1]
    assert hits.width == int(hits.count.max()) and short.width == 4
    assert torch.equal(short.count, hits.count)
    assert int((short.count > 4).sum()) > 0
    adv3, acc3 = _predicted_density_and_accel(
        case.grid, case.cfg, case.grid.xp + case.jpack(move),
        case.jpack(press2))
    for kept in (hits, short):
        got = engine.k1_pcisph_walk(tg, xs2, p2, kept)
        assert torch.equal(got, want)
        _close(case.jparticles(adv3),
               case.tparticles(torch.clamp(w0 + got[0], min=1.0)),
               case.liquid)
        _close(case.jparticles(acc3), case.tparticles(got[1:4]),
               case.liquid)
