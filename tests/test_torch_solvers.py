"""The port's DFSPH solver loops (wcsph_tpu_torch, CPU plain twins) against
the JAX package's (NoComm, XLA path, use_pallas=False) on the pressurized
scene: the side-8 dam break of tests/test_engine.py squeezed by 0.92, with a
converging velocity v = -10 (x - centroid) and numpy-seeded warm starts.

Both sides get the same inputs (the JAX packed fields mapped to the port's
sorted rows).  Iteration counts must be equal; fields agree within
1e-3 max|ref| over liquid particles, with max|ref| > 0 asserted.  Each
port loop runs in both of its forms, fused and unfused
(``fused_solver_iters``), against the one JAX run (the XLA path is the
JAX package's unfused form).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from wcsph_tpu import dense_ops, viscosity
from wcsph_tpu.grid import build_grid, pack_liquid
from wcsph_tpu.parallel.comm import NoComm
from wcsph_tpu.simulation import Simulation, default_config
from wcsph_tpu.solvers import dfsph

torch = tgrid = tvisc = config_from_dict = tdfsph = TNoComm = None  # by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, tgrid, tvisc, config_from_dict, tdfsph, TNoComm
    import torch
    from wcsph_tpu_torch import grid as tgrid, viscosity as tvisc
    from wcsph_tpu_torch.config import config_from_dict
    from wcsph_tpu_torch.parallel.comm import NoComm as TNoComm
    from wcsph_tpu_torch.solvers import dfsph as tdfsph
    torch.set_num_threads(1)


DT = np.float32(1e-3)


def _squeezed_dam_break(r=0.025, side=8, box_extent=0.9, squeeze=0.92):
    from wcsph_tpu import dam_break

    sc = dam_break(particle_radius=r, fluid_dims=(side,) * 3,
                   box_extent=box_extent)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
    return sc


class _Scene:
    def __init__(self, **cfg_over):
        r = 0.025
        sc = _squeezed_dam_break(r=r)
        lo, hi = sc.domain(pad=4 * r)
        # Simulation resolves the boundary volume; both sides share its cfg
        cfg = Simulation(sc, default_config(
            "dfsph", particle_radius=r, domain_min=lo, domain_max=hi)).cfg
        self.cfg = cfg.replace(**cfg_over)
        self.tcfg = config_from_dict(dataclasses.asdict(self.cfg))
        pos = sc.positions.T.copy()
        self.nl, self.n = sc.n_liquid, pos.shape[1]
        self.grid = build_grid(jnp.asarray(pos), self.nl, self.cfg)
        assert int(self.grid.overflow) == 0
        self.comm = NoComm(self.grid, self.cfg)
        self.tg = tgrid.build_grid(torch.as_tensor(pos), self.nl, self.tcfg)
        self.pid = np.asarray(self.grid.pid).ravel()
        self.stats = dense_ops.density_stats(self.grid, self.cfg, True)
        self.alpha = jnp.where(self.grid.liquid, self.stats.alpha, 0.0)
        liq = sc.positions[: sc.n_liquid]
        self.vel = (-10.0 * (liq - liq.mean(0, keepdims=True))).T.astype(
            np.float32)
        self.liquid = np.arange(self.n) < self.nl

    def jpack(self, x):
        return pack_liquid(self.grid, jnp.asarray(x))

    def particles(self, a):
        a = np.asarray(a)
        a = a.reshape(a.shape[:-2] + (-1,))
        ok = self.pid >= 0
        out = np.zeros(a.shape[:-1] + (self.n,), np.float32)
        out[..., self.pid[ok]] = a[..., ok]
        return out

    def rows(self, a):
        """JAX packed -> the port's sorted rows (same values)."""
        p = torch.as_tensor(self.particles(a))
        return p[..., self.tg.order].contiguous()

    def grids(self):
        """The port's grid with its config in each solver-loop form."""
        return [dataclasses.replace(self.tg, cfg=self.tcfg.replace(
            fused_solver_iters=fused)) for fused in (True, False)]

    def tparticles(self, a):
        out = np.zeros(a.shape[:-1] + (self.n,), np.float32)
        out[..., self.tg.order.numpy()] = a.numpy()
        return out

    def close(self, ref_packed, got_rows):
        ref = self.particles(ref_packed)[..., self.liquid]
        got = self.tparticles(got_rows)[..., self.liquid]
        scale = float(np.abs(ref).max())
        assert scale > 0.0
        assert float(np.abs(ref - got).max()) <= 1e-3 * scale, (
            float(np.abs(ref - got).max()), scale)


@pytest.fixture(scope="module")
def scene():
    return _Scene()


def test_divergence_solve(scene):
    rng = np.random.RandomState(1)
    kv = (0.2 * rng.randn(scene.nl)).astype(np.float32)
    j = dfsph.divergence_solve(scene.comm, scene.jpack(scene.vel),
                               scene.jpack(kv), scene.alpha,
                               scene.stats.count, jnp.float32(DT))
    assert float(j.err_pre) > 0.0
    for tg in scene.grids():
        t = tdfsph.divergence_solve(
            TNoComm(tg, tg.cfg), scene.rows(scene.jpack(scene.vel)),
            scene.rows(scene.jpack(kv)), scene.rows(scene.alpha),
            scene.rows(scene.stats.count).to(torch.int32), DT)
        assert t.iters == int(j.iters) and t.iters > 1
        np.testing.assert_allclose(t.err_pre, float(j.err_pre), rtol=1e-3)
        scene.close(j.vel, t.vel)
        scene.close(j.kappa, t.kappa)


@pytest.mark.parametrize("warm", [False, True])
def test_pressure_solve(warm):
    sc = _Scene(pressure_warm_start=warm)
    rng = np.random.RandomState(2)
    kp = (1e-4 * rng.randn(sc.nl)).astype(np.float32)
    j = dfsph.pressure_solve(sc.comm, sc.jpack(sc.vel), sc.jpack(kp),
                             sc.alpha, sc.stats.rho, jnp.float32(DT))
    assert float(j.err_pre) > 0.0
    for tg in sc.grids():
        t = tdfsph.pressure_solve(
            TNoComm(tg, tg.cfg), sc.rows(sc.jpack(sc.vel)),
            sc.rows(sc.jpack(kp)), sc.rows(sc.alpha), sc.rows(sc.stats.rho),
            DT)
        assert t.iters == int(j.iters)
        np.testing.assert_allclose(t.err_pre, float(j.err_pre), rtol=1e-3)
        sc.close(j.vel, t.vel)
        sc.close(j.kappa, t.kappa)


@pytest.mark.parametrize("precond", [True, False])
def test_viscosity_solve(precond):
    # block Jacobi meets the default 5% tolerance in one iteration here; a
    # tighter one makes the loop run on (same config on both sides).
    # precond=False is the plain-CG mode (identity preconditioner).
    scene = _Scene(viscosity_err=1e-5, viscosity_precond=precond)
    rng = np.random.RandomState(3)
    vg = (0.05 * rng.randn(3, scene.nl)).astype(np.float32)
    j = viscosity.solve_dense(scene.comm, scene.jpack(scene.vel),
                              scene.jpack(vg), scene.stats.rho,
                              jnp.float32(DT))
    for tg in scene.grids():
        t = tvisc.solve_dense(TNoComm(tg, tg.cfg),
                              scene.rows(scene.jpack(scene.vel)),
                              scene.rows(scene.jpack(vg)),
                              scene.rows(scene.stats.rho), DT)
        assert t.iters == int(j.iters) and t.iters > 1
        scene.close(j.vel_new, t.vel_new)
        scene.close(j.delta_v, t.delta_v)
