"""Whole steps of the port's SESPH, PCISPH and IISPH solvers and of DFSPH
with surface tension (wcsph_tpu_torch, CPU plain twins).

* 3 steps of the pressurized scene of tests/test_engine.py (side-8 dam
  break in a 0.9 box, squeezed by 0.92, or 0.90 for PCISPH) from the SAME
  initial state, carried across with state_to_numpy -> state_from_numpy:
  per step the pressure and viscosity iteration counts equal the JAX
  package's (XLA path, use_pallas=False); pos rtol 2e-4 atol 2e-5, vel
  rtol 2e-3 atol 2e-4 (the golden tolerances: both sides sum a receiver's
  pair terms in their own order); pressure within 1e-3 of max|ref|.  The
  whole step is the unit for the IISPH and PCISPH sweeps (K5's IISPH emits,
  K7, K8): their XLA twins are closures of the JAX solvers.
  Non-vacuity is asserted with the JAX side's own numbers.
* DFSPH with tension and adhesion on, the same way.
* the port's PCISPH, IISPH and DFSPH-with-tension steps in both
  solver-loop forms, fused and unfused (``fused_solver_iters``), against
  the one JAX run.
* the 20-step golden scenes against tests/golden/<solver>_golden.npz at
  the tolerances of tests/test_golden.py (needs no JAX).
* ``Simulation(scene, cfg)`` with no device asks for the card, and raises
  where there is none.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = wt = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt
    import torch
    import wcsph_tpu_torch as wt
    torch.set_num_threads(1)


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
R = 0.025


def _squeezed_dam_break(squeeze, side=8, box_extent=0.9):
    sc = wt.dam_break(particle_radius=R, fluid_dims=(side,) * 3,
                      box_extent=box_extent)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
    return sc


def _both(solver, squeeze, forms=(True,), **cfg_over):
    """The JAX simulation (XLA path) and the port's, on the CPU, from the
    same scene, config and initial state: (scene, the JAX simulation, a list
    of the port's, one for each solver-loop form in ``forms``, True for the
    fused loops and False for the unfused)."""
    from wcsph_tpu.simulation import Simulation, default_config
    from wcsph_tpu.state import state_to_numpy

    sc = _squeezed_dam_break(squeeze)
    lo, hi = sc.domain(pad=4 * R)
    js = Simulation(sc, default_config(solver, particle_radius=R,
                                       domain_min=lo, domain_max=hi,
                                       **cfg_over), solver=solver)
    tcfg = wt.config_from_dict(dataclasses.asdict(js.cfg))
    tss = [wt.Simulation(sc, tcfg.replace(fused_solver_iters=fused),
                         solver=solver, device="cpu") for fused in forms]
    for ts in tss:
        ts.state = wt.state_from_numpy(state_to_numpy(js.state), "cpu")
    return sc, js, tss


def _step_both(js, tss, fields):
    """One step on the JAX side and on each port simulation of ``tss``;
    iteration counts equal, fields close.  Returns the JAX side's
    (divergence, pressure, viscosity iters)."""
    js.step()
    jd = js.state.diag
    assert int(jd.neighbor_overflow) == 0
    want = (int(jd.divergence_iters), int(jd.pressure_iters),
            int(jd.viscosity_iters))
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
        for f in fields:
            ref = np.asarray(getattr(js.state, f))
            got = getattr(ts.state, f).numpy()
            assert float(np.abs(got - ref).max()) <= 1e-3 * float(
                np.abs(ref).max()), f
        for f in ("density_error", "density_error_pre", "vel_max"):
            np.testing.assert_allclose(float(getattr(td, f)),
                                       float(getattr(jd, f)), rtol=1e-3,
                                       atol=1e-6, err_msg=f)
    return want


# the JAX side's own numbers on this scene (XLA path, CPU): pressure
# iterations per step, viscosity iterations per step, and a floor under
# max|p| after step 0
EXPECT = {
    "sesph": ((0, 0, 0), 0, 1.0e4),
    "pcisph": ((4, 3, 3), 0, 1.5e3),
    "iisph": ((4, 2, 2), 1, 2.0e2),
}


@pytest.mark.parametrize("solver", ["sesph", "pcisph", "iisph"])
def test_pressurized_steps_match_jax(solver):
    # SESPH has no solver loop: no unfused form
    _, js, tss = _both(solver, 0.90 if solver == "pcisph" else 0.92,
                       forms=(True,) if solver == "sesph" else (True, False))
    iters, pmax0 = [], None
    for _ in range(3):
        iters.append(_step_both(js, tss, ["pressure"]))
        if pmax0 is None:
            pmax0 = float(np.abs(np.asarray(js.state.pressure)).max())
    want_pr, want_visc, p_floor = EXPECT[solver]
    # non-vacuous: real pressures, and the loops leave their minimum
    assert tuple(i[1] for i in iters) == want_pr, iters
    assert all(i[2] == want_visc for i in iters), iters
    assert pmax0 > p_floor, pmax0
    for ts in tss:
        ts.check_health()
    if solver == "pcisph":
        # both forms keep their iterations' hits in the step's buffer,
        # sized by the first step: K8's, and the unfused prediction's cut
        # for its walk
        assert all(ts.list_slots.capacity for ts in tss)


def test_dfsph_tension_steps_match_jax():
    """DFSPH with cohesion, curvature and boundary adhesion (K6's twin)
    against the JAX XLA path; the adhesion region covers part of the floor
    under the block."""
    adh = dict(adhesion_center=(0.0, -0.45, 0.0), adhesion_radius=0.3)
    sc, js, tss = _both("dfsph", 0.92, forms=(True, False), tension_coff=0.25,
                        tension_coff_b=0.4, **adh)
    ts = tss[0]
    centre = np.asarray(js.cfg.adhesion_center, np.float32)
    d2 = ((sc.positions - centre) ** 2).sum(axis=1)
    near = d2 < js.cfg.adhesion_radius ** 2
    assert near[sc.n_liquid:].any() and near[: sc.n_liquid].any()
    iters = [_step_both(js, tss, ["kappa_v"]) for _ in range(3)]
    assert all(i[1] >= 2 for i in iters), iters

    # non-vacuous: the same 3 steps without tension, and with cohesion but
    # no adhesion, end elsewhere
    for over, floor in ((dict(), 1e-3),
                        (dict(tension_coff=0.25, **adh), 1e-5)):
        other = _both("dfsph", 0.92, **over)[2][0]
        other.run(3)
        assert float((ts.state.vel - other.state.vel).abs().max()) > floor


@pytest.mark.parametrize("solver", ["sesph", "pcisph", "iisph"])
def test_golden_trajectory(solver):
    sc = wt.dam_break(particle_radius=R, fluid_dims=(5, 5, 5),
                      box_extent=0.55)
    lo, hi = sc.domain(pad=4 * R)
    sim = wt.Simulation(sc, wt.default_config(
        solver, particle_radius=R, domain_min=lo, domain_max=hi),
        solver=solver, device="cpu")
    sim.run(20)
    ref = np.load(os.path.join(GOLDEN_DIR, f"{solver}_golden.npz"))
    np.testing.assert_allclose(sim.state.pos.numpy(), ref["pos"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sim.state.vel.numpy(), ref["vel"],
                               rtol=2e-3, atol=2e-4)
    assert abs(float(sim.state.dt) - float(ref["dt"])) < 1e-6
    if solver != "sesph":
        assert sim.state.diag.pressure_iters == int(ref["pressure_iters"])
    sim.check_health()


def test_default_device_is_the_card():
    """No entry point of the port defaults to the CPU: without a device the
    simulation asks for CUDA, and where there is none that raises."""
    if torch.cuda.is_available():
        pytest.skip("this test shows the failure on a machine with no card")
    sc = wt.dam_break(particle_radius=R, fluid_dims=(3, 3, 3),
                      box_extent=0.3)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        wt.Simulation(sc, wt.default_config("dfsph"))
    from wcsph_tpu_torch import bench
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        bench.build_sim(3)
    with pytest.raises(ValueError, match="unknown solver"):
        wt.Simulation(sc, wt.default_config("dfsph"), solver="wcsph",
                      device="cpu")
