"""The port's slab decomposition (wcsph_tpu_torch/parallel, CPU, gloo).

* the communicators on a one-rank gloo group in this process: NoComm's
  lifts, lowers and sums are the single-device ones; a SlabComm lifts the
  neighbour's values into its ghost rows (fill where a ghost entry is
  empty), lowers the ghost rows to 0, sums and maxima cover the own liquid
  rows only; an edge rank's halo is empty; a stacked lift equals the lifts
  one by one; each communicator's fused set routes the loops
  (engine.use_fused_iters: all six on NoComm, none on the one-plane
  SlabComm, K2 and K3 on the two-plane DirectSlabComm, whose lower is the
  identity); at two ghost planes a rank sends the seats of its two
  outermost planes a side, and a slab thinner than its ghost depth
  raises;
* one spawned 3-rank gloo run (3 is the smallest world with an inner
  slab) of ``wcsph_tpu_torch.parallel.dryrun.run_jobs``: the golden scene
  (5^3, 20 steps) of each solver against tests/golden/*.npz at the
  tolerances of tests/test_golden.py, with the goldens' pressure
  iterations; the 6^3 scene of tests/test_slab.py, kicked in x (3 m/s),
  8 DFSPH steps and
  4 of SESPH, PCISPH, IISPH and DFSPH with tension, against the port's own
  single-device step (unfused) at tests/test_slab.py's tolerances, with the
  same iterations each step, every particle in exactly one seat and seats
  crossing slabs; every job's slab_init -> slab_gather round trip returns
  its state bit for bit (checked in the ranks);
* from the same run, the kicked DFSPH job with a migration buffer of one
  seat and a ghost buffer of one entry: a step whose buffer is short
  raises at its first read and replays with a larger one (at least twice
  in the run: the ghosts at the first step, the migrants later), and the
  run ends in the same bits as the unforced job;
* from the same run, the two-plane direct front (step_slab_direct): the
  goldens as above; the kicked scene of the four solvers and DFSPH with
  tension (fused loops asked for), and a pressurized DFSPH scene (side 8
  squeezed to 0.92, converging at 10/s, whose loops run past their
  minimum, so K2's warm start and K3's iterations meet the slab
  boundaries), against the single-device step in the same loop forms
  (dryrun.reference: K2 and K3 fused, the rest unfused): the same
  iterations each step, pos within 1e-5 m, vel within 1e-4 m/s, SESPH and
  PCISPH bit for bit;
* from the same run, the global-grid sharded steps (halo.*_step_sharded)
  of the four solvers on the kicked scene against the single-device
  unfused step, at the same limits and bits, every rank holding the same
  state after each step; halo.density_sharded equal to the single-device
  density bit for bit, and halo.pressure_solve_sharded to the
  single-device unfused solve.

No JAX runs here: the goldens are the JAX package's record, and the port's
single-device step is held against JAX by test_torch_step.py and
test_torch_solver_steps.py.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = wt = comm_mod = dryrun = halo = None   # bound by _port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SOLVERS = ["dfsph", "sesph", "pcisph", "iisph"]
R = 0.025
WORLD = 3
KICKED_STEPS = {"dfsph": 8, "sesph": 4, "pcisph": 4, "iisph": 4,
                "dfsph+tension": 4}
# the single-device step against the direct front and the sharded steps:
# only the all-reduced sums round differently (chip_smoke.py's limits)
POS_TOL = dict(rtol=0, atol=1e-5)
VEL_TOL = dict(rtol=0, atol=1e-4)
BIT_EQUAL = ("sesph", "pcisph")


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, comm_mod, dryrun, halo
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch.parallel import comm as comm_mod, dryrun, halo
    torch.set_num_threads(1)


class _Wire:
    """A transport whose ring returns what the neighbours would send."""

    def __init__(self, left, right):
        self.got = (left, right)

    def ring(self, to_left, to_right, n_left, n_right):
        return self.got


class _Mirror:
    """A transport whose right neighbour answers each row of what it was
    sent, its entries ``pick``ed and scaled: its values, row for row."""

    def __init__(self, pick):
        self.pick = pick

    def ring(self, to_left, to_right, n_left, n_right):
        return None, to_right[..., self.pick] * 2.0 + 1.0


class _Record:
    """A transport that keeps what the ring sends and answers with empty
    ghost entries."""

    def ring(self, to_left, to_right, n_left, n_right):
        self.sent = (to_left, to_right)
        return tuple(torch.full((3, n), halo.EMPTY_POS) if n else None
                     for n in (n_left, n_right))


def test_communicators_on_one_rank(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        sc = wt.dam_break(particle_radius=R, fluid_dims=(4, 4, 4),
                          box_extent=0.5)
        lo, hi = sc.domain(pad=4 * R)
        cfg = wt.default_config("dfsph", particle_radius=R, domain_min=lo,
                                domain_max=hi)
        state = wt.init_state(sc, "cpu")
        grid = wt.grid.build_grid(state.pos, state.n_liquid, cfg)
        rng = np.random.RandomState(0)
        x = torch.as_tensor(rng.rand(grid.n).astype(np.float32))

        nc = comm_mod.NoComm(grid, cfg)
        assert nc.lift(x, 1.0) is x and nc.lower(x) is x
        assert torch.equal(nc.lsum(x), torch.where(grid.liquid, x, 0.0).sum())
        assert float(nc.lmax(x)) == float(x[grid.liquid].max())
        assert nc.n_liquid == state.n_liquid

        # a hand-built two-slab split of this grid: rows of x-plane < 4
        # are this rank's, the plane 4 next to them its ghost plane (its
        # right neighbour's), filled from the neighbour's values
        gx = cfg.grid_res[0]
        px = torch.div(grid.cell, cfg.grid_res[1] * cfg.grid_res[2],
                       rounding_mode="floor")
        ghost = (px == 4)
        own_rows = (px < 4)
        ghost_rows = torch.nonzero(ghost)[:, 0]
        n_g = int(ghost_rows.shape[0])
        assert n_g > 0 and bool(own_rows.any()) and gx > 5
        recv_rows = torch.cat([ghost_rows, torch.tensor([grid.n - 1])])
        recv_empty = torch.zeros(n_g + 1, dtype=torch.bool)
        recv_empty[-1] = True
        sent = torch.as_tensor(rng.rand(3, n_g + 1).astype(np.float32))
        plan = comm_mod.HaloPlan(
            send_rows=torch.nonzero(px == 3)[:, 0],
            recv_rows=recv_rows, recv_empty=recv_empty,
            n_send=(0, int((px == 3).sum())), n_recv=(0, n_g + 1),
            ghost=ghost | (px >= 5))
        own = grid.liquid & own_rows
        tr = comm_mod.Transport()
        assert tr.staged and tr.world == 1
        # an edge rank gets no halo from outside the domain
        assert tr.ring(None, torch.ones(3, 2), 0, 0) == (None, None)

        class _Status:
            checked, n_liquid = True, int(own.sum())

        sl = comm_mod.SlabComm(grid, cfg, own, plan, _Wire(None, sent),
                               _Status())
        q = torch.as_tensor(rng.rand(3, grid.n).astype(np.float32))
        before = q.clone()
        assert sl.lift(q, 7.0) is q
        assert torch.equal(q[:, ghost_rows], sent[:, :n_g])
        assert torch.equal(q[:, -1], torch.full((3,), 7.0))
        keep = ~ghost
        keep[-1] = False
        assert torch.equal(q[:, keep], before[:, keep])
        low = sl.lower(q)
        assert torch.equal(low[:, ghost | (px >= 5)],
                           torch.zeros_like(low[:, ghost | (px >= 5)]))
        assert torch.equal(low[:, own_rows], q[:, own_rows])

        sl._tr = tr          # the reductions over the one-rank group
        assert torch.equal(sl.lsum(x), torch.where(own, x, 0.0).sum())
        assert float(sl.lsum(x)) < float(nc.lsum(x))
        assert float(sl.lmax(x)) == float(x[own].max())
        assert sl.n_liquid == int(own.sum()) < state.n_liquid

        # one stacked exchange of several fields equals their lifts one by
        # one, fills included
        n_s = int((px == 3).sum())
        mirror = comm_mod.SlabComm(grid, cfg, own, plan,
                                   _Mirror(torch.arange(n_g + 1) % n_s),
                                   _Status())
        a = torch.as_tensor(rng.rand(3, grid.n).astype(np.float32))
        b = torch.as_tensor(rng.rand(grid.n).astype(np.float32))
        one = [mirror.lift(a.clone(), 7.0), mirror.lift(b.clone(), 1.0)]
        both = mirror.lift_many((a.clone(), 7.0), (b.clone(), 1.0))
        for got, want in zip(both, one):
            assert torch.equal(got, want)
        assert float(both[1][-1]) == 1.0 and not torch.equal(both[1], b)

        # the loops each communicator runs fused
        ds = comm_mod.DirectSlabComm(grid, cfg, own, plan, _Wire(None, sent),
                                     _Status())
        assert ds.lower(q) is q and cfg.fused_solver_iters
        unfused = dataclasses.replace(cfg, fused_solver_iters=False)
        for method in sorted(comm_mod.FUSED_ALL):
            use = wt.engine.use_fused_iters
            assert use(nc, method) and not use(sl, method)
            assert use(ds, method) == (method in ("fused_kappa_drho",
                                                  "fused_iter_full"))
            assert not use(comm_mod.NoComm(grid, unfused), method)
            assert not use(comm_mod.NoComm(grid, cfg, frozenset()), method)

        # two ghost planes: rank 1 of 3 sends the liquid seats of its two
        # outermost planes a side, in seat order
        cfg3 = halo.slab_config(cfg, 3)
        geo = halo.SlabGeometry(cfg3, 3, 1, ghost=2)
        assert geo.width >= 2
        planes = torch.arange(cfg3.grid_res[0], dtype=torch.float32)
        sides = geo.edges(planes, geo.lo)
        assert torch.nonzero(sides[0])[:, 0].tolist() == [geo.lo,
                                                          geo.lo + 1]
        assert torch.nonzero(sides[1])[:, 0].tolist() == [geo.hi - 2,
                                                          geo.hi - 1]
        liq = state.pos[:, :state.n_liquid]
        fx, _ = geo.planes(liq)
        shift = (geo.lo + 1 - fx.min()) * cfg3.cell_size
        liq = liq + torch.tensor([[float(shift)], [0.0], [0.0]])
        fx, _ = geo.planes(liq)         # the block straddles rank 1's slab
        mine = torch.nonzero(geo.owner(fx) == 1)[:, 0]
        kg, ncap = 64, int(mine.shape[0])
        fields = torch.zeros(14, ncap + 2 * kg)
        fields[0:3, :ncap] = liq[:, mine]
        solids = halo.SlabSolids(
            pos=torch.full((3, 1), halo.EMPTY_POS), n_own=0, n_ghost=(0, 0),
            send=(torch.zeros(0, dtype=torch.int64),) * 2,
            ids=torch.zeros(0, dtype=torch.int64))
        rec = _Record()
        zero = torch.zeros((), dtype=torch.int64)
        got, _ = halo.make_slab_comm(fields, mine.to(torch.int32), solids,
                                     cfg3, rec, geo, kg, 1, (zero,) * 4)
        assert isinstance(got, comm_mod.DirectSlabComm)
        fm = fx[mine]
        for k, want in enumerate((fm < geo.lo + 2, fm >= geo.hi - 2)):
            cols = liq[:, mine[want]]
            assert cols.shape[1] > 0
            assert torch.equal(rec.sent[k][:, :cols.shape[1]], cols)
            assert bool((rec.sent[k][:, cols.shape[1]:]
                         == halo.EMPTY_POS).all())
        # a slab thinner than its ghost depth
        thin = cfg3.grid_res[0]
        halo.SlabGeometry(cfg3, thin, 0, ghost=1)
        with pytest.raises(ValueError, match="thinner"):
            halo.SlabGeometry(cfg3, thin, 0, ghost=2)
    finally:
        dist.destroy_process_group()


def _kicked(solver, over=(), fused=False):
    """tests/test_slab.py's scene: 6^3 liquid, fixed dt 3 ms, an x-kick,
    the unfused loops (the only form the one-plane slab runs; ``fused``:
    the fused ones asked for, for the direct front).  The kick is 3 m/s,
    not that file's 2.2: over 3 ranks the block's last column sits 25 mm
    short of a slab boundary, a seat migrates at the step after it
    crosses, and 4 steps of 2.2 m/s bring no seat across before the
    last."""
    sc = wt.dam_break(particle_radius=R, fluid_dims=(6, 6, 6),
                      box_extent=0.7)
    lo, hi = sc.domain(pad=4 * R)
    cfg = wt.default_config(solver, particle_radius=R, domain_min=lo,
                            domain_max=hi, adaptive_dt=False, dt_init=3e-3,
                            fused_solver_iters=fused, **dict(over))
    sim = wt.Simulation(sc, halo.slab_config(cfg, WORLD), solver=solver,
                        device="cpu")
    vel = sim.state.vel.clone()
    vel[0] += 3.0
    return sim.state.replace(vel=vel), sim.cfg


def _golden(solver):
    sc = wt.dam_break(particle_radius=R, fluid_dims=(5, 5, 5),
                      box_extent=0.55)
    lo, hi = sc.domain(pad=4 * R)
    sim = wt.Simulation(sc, wt.default_config(
        solver, particle_radius=R, domain_min=lo, domain_max=hi),
        solver=solver, device="cpu")
    return sim.state, halo.slab_config(sim.cfg, WORLD)


def _pressurized():
    """tests/test_engine.py's squeezed scene (side 8 at 0.92 in a 0.9 m
    box) with v = -10 (x - centroid): DFSPH's loops run past their
    minimum."""
    sc = wt.dam_break(particle_radius=R, fluid_dims=(8, 8, 8),
                      box_extent=0.9)
    liq = sc.positions[:sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[:sc.n_liquid] = centre + (liq - centre) * 0.92
    lo, hi = sc.domain(pad=4 * R)
    sim = wt.Simulation(sc, halo.slab_config(wt.default_config(
        "dfsph", particle_radius=R, domain_min=lo, domain_max=hi), WORLD),
        solver="dfsph", device="cpu")
    liq = sim.state.pos[:, :sc.n_liquid]
    vel = -10.0 * (liq - liq.mean(dim=1, keepdim=True))
    return sim.state.replace(vel=vel.contiguous()), sim.cfg


TENSION = dict(tension_coff=0.5, tension_coff_b=0.25,
               adhesion_center=(0.0, -0.35, 0.0), adhesion_radius=0.175)
PRESSURIZED_STEPS = 3


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One 3-rank gloo run of every job; the parent's references."""
    where = str(tmp_path_factory.mktemp("slab"))
    jobs, refs = [], {}
    for solver in SOLVERS:
        state, cfg = _golden(solver)
        jobs.append(dryrun.save_job(f"golden-{solver}", solver, state, cfg,
                                    20, where))
    for name, steps in KICKED_STEPS.items():
        solver = name.split("+")[0]
        state, cfg = _kicked(solver, TENSION if "+" in name else ())
        jobs.append(dryrun.save_job(f"kicked-{name}", solver, state, cfg,
                                    steps, where))
        refs[name] = (state, cfg, solver, steps)
    forced = dataclasses.replace(jobs[len(SOLVERS)], name="forced",
                                 kmig=1, kghost=1)
    jobs.append(forced)
    # the direct front: goldens, kicked (fused loops asked for), pressurized
    direct = {}
    for solver in SOLVERS:
        state, cfg = _golden(solver)
        jobs.append(dryrun.save_job(f"direct-golden-{solver}", solver, state,
                                    cfg, 20, where, front="direct"))
    for name, steps in KICKED_STEPS.items():
        solver = name.split("+")[0]
        state, cfg = _kicked(solver, TENSION if "+" in name else (), True)
        jobs.append(dryrun.save_job(f"direct-kicked-{name}", solver, state,
                                    cfg, steps, where, front="direct"))
        direct[f"kicked-{name}"] = (state, cfg, solver, steps)
    state, cfg = _pressurized()
    jobs.append(dryrun.save_job("direct-pressurized", "dfsph", state, cfg,
                                PRESSURIZED_STEPS, where, front="direct"))
    direct["pressurized"] = (state, cfg, "dfsph", PRESSURIZED_STEPS)
    # the sharded steps on the kicked scene (the one-plane references)
    for solver in SOLVERS:
        state, cfg, _, steps = refs[solver]
        jobs.append(dryrun.save_job(f"sharded-{solver}", solver, state, cfg,
                                    steps, where, front="sharded"))
    dryrun.spawn(dryrun.run_jobs, WORLD,
                 (os.path.join(where, "store"), jobs, where, "cpu", "gloo",
                  True), timeout=240)
    done = {name: dryrun.reference(*ref) for name, ref in refs.items()}
    done.update({f"direct-{name}": dryrun.reference(*ref, front="direct")
                 for name, ref in direct.items()})
    for solver in SOLVERS:
        state, cfg, _, _ = refs[solver]
        done[f"density-{solver}"] = dryrun.reference_density(state, cfg)
    state, cfg, _, _ = refs["dfsph"]
    done["solve"] = dryrun.reference_pressure_solve(state, cfg)
    return where, done


def _result(where, name):
    import json

    got = dict(np.load(os.path.join(where, f"{name}.npz")))
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(where, f"{name}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    return got, ranks


def _goldens(where, prefix):
    """The golden jobs' end states against tests/golden/*.npz."""
    for solver in SOLVERS:
        got, ranks = _result(where, f"{prefix}golden-{solver}")
        ref = np.load(os.path.join(GOLDEN_DIR, f"{solver}_golden.npz"))
        np.testing.assert_allclose(got["pos"], ref["pos"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(got["vel"], ref["vel"], rtol=2e-3,
                                   atol=2e-4)
        assert abs(float(got["dt"]) - float(ref["dt"])) < 1e-6
        if solver != "sesph":
            assert int(got["iters"][-1][1]) == int(ref["pressure_iters"])
        assert all(r["replays"] == 0 for r in ranks), solver


def _same_as_one_device(got, state, iters, name, solver):
    """A run's end state and iterations against the single-device step
    in the same loop forms: SESPH and PCISPH bit for bit."""
    assert [tuple(i) for i in got["iters"]] == iters, name
    assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()
    if solver in BIT_EQUAL:
        np.testing.assert_array_equal(got["pos"], state.pos.numpy())
        np.testing.assert_array_equal(got["vel"], state.vel.numpy())
    np.testing.assert_allclose(got["pos"], state.pos.numpy(), **POS_TOL)
    np.testing.assert_allclose(got["vel"], state.vel.numpy(), **VEL_TOL)
    assert float(got["dt"]) == float(state.dt), name


def test_slab_steps_match_goldens_and_single_device(spawned):
    where, refs = spawned
    _goldens(where, "")
    for name in KICKED_STEPS:
        state, iters = refs[name]
        got, ranks = _result(where, f"kicked-{name}")
        assert [tuple(i) for i in got["iters"]] == iters, name
        np.testing.assert_allclose(got["pos"], state.pos.numpy(), rtol=2e-3,
                                   atol=5e-4)
        np.testing.assert_allclose(got["vel"], state.vel.numpy(), rtol=5e-3,
                                   atol=5e-2)
        assert float(got["dt"]) == float(state.dt)
        assert np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()
        # seats crossed slabs: arrivals on some rank and step
        arrived = sum(c[2] for r in ranks for c in r["counts"])
        assert arrived > 0, name
        # every particle in exactly one seat: the gather checks the ids
        # (slab_gather raises otherwise); own rows add up to the scene
        own = sum(r["counts"][-1][0] for r in ranks)
        assert own == state.n_total, name


def test_short_buffers_replay_to_the_same_bits(spawned):
    where, _ = spawned
    got, ranks = _result(where, "forced")
    want, _ = _result(where, "kicked-dfsph")
    # every rank replays alike
    assert len({r["replays"] for r in ranks}) == 1
    assert ranks[0]["replays"] >= 2
    assert all(r["kmig"] > 1 and r["kghost"] > 1 for r in ranks)
    for f in ("pos", "vel", "omega", "vel_guess", "kappa", "kappa_v",
              "iters"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_direct_front_matches_goldens_and_single_device(spawned):
    where, refs = spawned
    _goldens(where, "direct-")
    for name, steps in [*KICKED_STEPS.items(),
                        ("pressurized", PRESSURIZED_STEPS)]:
        key = name if name == "pressurized" else f"kicked-{name}"
        got, ranks = _result(where, f"direct-{key}")
        state, iters = refs[f"direct-{key}"]
        solver = name.split("+")[0] if name != "pressurized" else "dfsph"
        _same_as_one_device(got, state, iters, name, solver)
        own = sum(r["counts"][-1][0] for r in ranks)
        assert own == state.n_total, name
        fused = {k for r in ranks for k in r["launches"]}
        assert not fused & {"k4_fused_visc_iter", "k6_fused_tension",
                            "k7_fused_jacobi_iter", "k8_fused_pcisph_iter"}
    # the pressurized divergence loop ran past its minimum of one
    # iteration ((2, 2, 1) on one card at the first step)
    _, iters = refs["direct-pressurized"]
    assert iters[0][0] > 1, iters


def test_sharded_steps_match_single_device(spawned):
    where, refs = spawned
    for solver in SOLVERS:
        got, ranks = _result(where, f"sharded-{solver}")
        state, iters = refs[solver]
        _same_as_one_device(got, state, iters, solver, solver)
        assert all(all(r["same_on_every_rank"]) for r in ranks), solver
        np.testing.assert_array_equal(got["rho"],
                                      refs[f"density-{solver}"].numpy())
    got, _ = _result(where, "sharded-dfsph")
    vel, kappa, it, err = refs["solve"]
    assert int(got["solve_iters"]) == it
    np.testing.assert_allclose(got["solve_vel"], vel.numpy(), **VEL_TOL)
    np.testing.assert_allclose(got["solve_kappa"], kappa.numpy(), rtol=2e-4,
                               atol=1e-7)
