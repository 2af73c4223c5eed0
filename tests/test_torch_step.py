"""The port's whole DFSPH step (wcsph_tpu_torch, CPU plain twins).

* 3 steps of the pressurized scene (side-8 dam break squeezed by 0.92,
  converging velocity, one liquid particle outside the domain) from the
  SAME state, loaded into the port through
  state_from_numpy: per step, the divergence / pressure / viscosity
  iteration counts and dt equal the JAX package's (XLA path); pos and vel
  within the golden tolerances; kappa and kappa_v within 1e-3 max|ref|,
  with non-vacuity asserted; the port's step in both solver-loop forms,
  fused and unfused (``fused_solver_iters``).
* the 20-step golden scene against tests/golden/dfsph_golden.npz at the
  tolerances of tests/test_golden.py (needs no JAX).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = wt = TSim = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, TSim
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch.simulation import Simulation as TSim
    torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "dfsph_golden.npz")


def _squeezed_dam_break(r=0.025, side=8, box_extent=0.9, squeeze=0.92):
    sc = wt.dam_break(particle_radius=r, fluid_dims=(side,) * 3,
                      box_extent=box_extent)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
    return sc


def test_pressurized_steps_match_jax():
    import jax.numpy as jnp

    from wcsph_tpu.simulation import Simulation, default_config
    from wcsph_tpu.state import state_to_numpy

    r = 0.025
    sc = _squeezed_dam_break(r=r)
    lo, hi = sc.domain(pad=4 * r)
    js = Simulation(sc, default_config("dfsph", particle_radius=r,
                                       domain_min=lo, domain_max=hi))
    liq = sc.positions[: sc.n_liquid]
    vel = (-10.0 * (liq - liq.mean(0, keepdims=True))).T.astype(np.float32)
    # liquid particle 0 leaves the domain: it takes part in no pair and
    # keeps its velocity (no gravity), while its position still advances
    pos = np.asarray(js.state.pos).copy()
    pos[:, 0] = np.asarray(hi, np.float32) + 0.5
    js.state = js.state.replace(vel=jnp.asarray(vel), pos=jnp.asarray(pos))
    tcfg = wt.config_from_dict(dataclasses.asdict(js.cfg))
    tss = [TSim(sc, tcfg.replace(fused_solver_iters=fused), device="cpu")
           for fused in (True, False)]
    for ts in tss:
        ts.state = wt.state_from_numpy(state_to_numpy(js.state), "cpu")

    iters, kmax, kvmax = [], 0.0, 0.0
    for _ in range(3):
        js.step()
        jd = js.state.diag
        want = (int(jd.divergence_iters), int(jd.pressure_iters),
                int(jd.viscosity_iters))
        assert int(jd.neighbor_overflow) == 0
        iters.append(want)
        for ts in tss:
            ts.step()
            td = ts.state.diag
            assert (td.divergence_iters, td.pressure_iters,
                    td.viscosity_iters) == want
            assert float(ts.state.dt) == float(js.state.dt)
            np.testing.assert_allclose(ts.state.pos.numpy(),
                                       np.asarray(js.state.pos),
                                       rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(ts.state.vel.numpy(),
                                       np.asarray(js.state.vel),
                                       rtol=2e-3, atol=2e-4)
            for f in ("kappa", "kappa_v"):
                ref = np.asarray(getattr(js.state, f))
                got = getattr(ts.state, f).numpy()
                scale = float(np.abs(ref).max())
                assert float(np.abs(got - ref).max()) <= 1e-3 * scale
        kmax = max(kmax, float(np.abs(np.asarray(js.state.kappa)).max()))
        kvmax = max(kvmax, float(np.abs(np.asarray(js.state.kappa_v)).max()))
    for ts in tss:
        np.testing.assert_array_equal(ts.state.vel.numpy()[:, 0], vel[:, 0])
        assert float(ts.state.pos[0, 0]) > hi[0] + 0.5
    # non-vacuous: the solvers iterate past their minimum at step 0 and do
    # real pressure and divergence work
    assert iters == [(2, 2, 1), (1, 2, 1), (1, 2, 1)], iters
    assert kmax > 0.0 and kvmax > 0.0


def test_golden_trajectory():
    r = 0.025
    sc = wt.dam_break(particle_radius=r, fluid_dims=(5, 5, 5),
                      box_extent=0.55)
    lo, hi = sc.domain(pad=4 * r)
    sim = TSim(sc, wt.default_config("dfsph", particle_radius=r,
                                     domain_min=lo, domain_max=hi),
               device="cpu")
    sim.run(20)
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(sim.state.pos.numpy(), ref["pos"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sim.state.vel.numpy(), ref["vel"],
                               rtol=2e-3, atol=2e-4)
    assert abs(float(sim.state.dt) - float(ref["dt"])) < 1e-6
    assert sim.state.diag.pressure_iters == int(ref["pressure_iters"])
    sim.check_health()
