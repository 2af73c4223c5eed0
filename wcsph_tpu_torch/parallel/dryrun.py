"""The port's multi-rank dry run, and the rank function that the tests and
``chip_smoke.py`` spawn.

    python -m wcsph_tpu_torch.parallel.dryrun 3

spawns 3 CPU ranks over gloo (``torch.multiprocessing``, a ``FileStore``,
``GLOO_SOCKET_IFNAME=lo``); each runs one step of each of the four solvers
on a tiny dam break on each front and prints one line a front and solver:
the global-grid sharded steps (``halo.*_step_sharded``), the one-plane
slab (``slab.step_slab``) and the two-plane direct front
(``slab.step_slab_direct``).  (The counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``, its paths 2, 3 and 4b.)

``run_jobs`` is the rank function of every spawn: it joins the group,
runs each job (a saved ``FluidState``, a config, a solver, a front, a
number of steps) and writes what it saw under the job's name: rank 0 the
gathered state and the iterations of each step, every rank its own
counts, times, launches and replays (on the sharded front, whether every
rank held the same state after each step).  A spawned child imports only
this package.  ``spawn`` joins with a deadline: a rank that fails raises
in the caller, and a rank that hangs is killed and raises there too.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import bench, engine
from ..config import SimConfig, config_from_dict
from ..grid import ListSlots, build_grid, pack, unpack
from ..scene import dam_break
from ..simulation import Simulation, default_config, get_solver
from ..state import state_from_numpy, state_to_numpy
from . import halo, slab
from ..solvers import dfsph
from .comm import FUSED_DFSPH, NoComm, Transport
from .halo import slab_config

SOLVERS = ("dfsph", "sesph", "pcisph", "iisph")
INIT_SECONDS = 120      # init_process_group's timeout, and each collective's
# the fronts, in the JAX dry run's order (paths 2, 3, 4b), and the loops
# each runs fused: none on one ghost plane, DFSPH's two on two
FRONTS = ("sharded", "slab", "direct")
FRONT_FUSED = {"sharded": frozenset(), "slab": frozenset(),
               "direct": FUSED_DFSPH}
SHARDED = {"dfsph": halo.dfsph_step_sharded,
           "iisph": halo.iisph_step_sharded,
           "pcisph": halo.pcisph_step_sharded,
           "sesph": halo.sesph_step_sharded}
_FIELDS = ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
           "kappa_v")


def spawn(fn, world: int, args=(), timeout: float = 600.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes and
    join them within ``timeout`` seconds; a child that raises or exits
    non-zero raises here (the others are stopped), and so does the
    deadline."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world} ranks did not end in {timeout} s")


def init_rank(rank: int, world: int, store: str, backend: str = "gloo"):
    """Join the group of ``world`` ranks of this host through the file
    ``store`` (gloo over the loopback device unless GLOO_SOCKET_IFNAME
    says otherwise)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        backend, store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=INIT_SECONDS))


@dataclasses.dataclass
class Job:
    """One run of ``steps`` steps (the first ``warmup`` untimed) of
    ``solver`` on the front ``front`` (``FRONTS``) from the state saved at
    ``state`` (``state_to_numpy``) under the config ``cfg``
    (``dataclasses.asdict``); ``kmig`` and ``kghost``, where set, the first
    sizes of the migration and ghost buffers in place of ``slab_init``'s
    (a short buffer makes its step run again)."""

    name: str
    solver: str
    state: str
    cfg: dict
    steps: int
    warmup: int = 0
    kmig: int | None = None
    kghost: int | None = None
    front: str = "slab"


def save_job(name: str, solver: str, state, cfg: SimConfig, steps: int,
             where: str, warmup: int = 0, front: str = "slab") -> Job:
    """A job whose state is saved under ``where``."""
    path = os.path.join(where, f"{name}.state.npz")
    np.savez(path, **state_to_numpy(state))
    return Job(name, solver, path, dataclasses.asdict(cfg), steps, warmup,
               front=front)


def run_jobs(rank: int, world: int, store: str, jobs, out: str,
             device: str = "cuda", backend: str = "gloo",
             quiet: bool = False) -> None:
    """A rank's part of each job in ``jobs``; see the module docstring.
    ``device`` "cuda" puts every rank on the current card (gloo: ranks that
    share it), "cuda:rank" one card a rank (NCCL), "cpu" the CPU."""
    torch.set_num_threads(1)
    if device == "cuda:rank":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    init_rank(rank, world, store, backend)
    try:
        for job in jobs:
            _run_job(rank, world, job, out, torch.device(device), quiet)
    finally:
        dist.destroy_process_group()


def _same_everywhere(state) -> bool:
    """Whether every rank holds this rank's ``state`` bit for bit."""
    blob = torch.cat([getattr(state, f).reshape(-1) for f in _FIELDS])
    every = Transport().all_gather(blob)
    return all(torch.equal(e, every[0]) for e in every)


def _run_job(rank, world, job: Job, out: str, dev, quiet: bool) -> None:
    cfg = config_from_dict(job.cfg)
    with np.load(job.state) as d:
        state = state_from_numpy(dict(d), dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sharded = job.front == "sharded"
    extra = {}
    if sharded:
        # every rank holds the whole state; each step splits it anew.
        # Before the steps: the density of the first state, and for DFSPH
        # its pressure solve, over the slabs
        step, cur = SHARDED[job.solver], state
        extra["rho"] = halo.density_sharded(state, cfg)
        if job.solver == "dfsph":
            vel, kappa, it, err = halo.pressure_solve_sharded(state, cfg)
            extra.update(solve_vel=vel, solve_kappa=kappa,
                         solve_iters=torch.tensor(it))
    else:
        ghost = 2 if job.front == "direct" else 1
        front = slab.step_slab_direct if ghost == 2 else slab.step_slab
        step = functools.partial(front, solver=job.solver)
        cur = slab.slab_init(state, cfg, solver=job.solver, device=dev,
                             ghost=ghost)
        cur = dataclasses.replace(cur, kmig=job.kmig or cur.kmig,
                                  kghost=job.kghost or cur.kghost)
        # the round trip with no step returns the state bit for bit
        back = slab.slab_gather(cur, state, solver=job.solver)
        for f in _FIELDS:
            if not torch.equal(getattr(back, f), getattr(state, f)):
                raise AssertionError(f"slab_init -> slab_gather changed {f}")
    iters, counts, same, step_ms = [], [], [], []
    replays0 = 0
    for k in range(job.steps):
        if k == job.warmup:
            engine.reset_launch_counts()
            replays0 = 0 if sharded else cur.replays
        sync()
        t0 = time.perf_counter()
        cur = step(cur, cfg)
        sync()
        if k >= job.warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        d = cur.diag
        iters.append((d.divergence_iters, d.pressure_iters,
                      d.viscosity_iters))
        if sharded:
            same.append(_same_everywhere(cur))
        else:
            counts.append(cur.counts)
    launches = {k: v for k, v in engine.LAUNCHES.items() if v}
    got = cur if sharded else slab.slab_gather(cur, state,
                                               solver=job.solver)
    counts = torch.stack(counts).cpu().tolist() if counts else []
    record = {"rank": rank, "world": world, "front": job.front,
              "counts": counts, "step_ms": step_ms, "launches": launches,
              "iters": iters, "dt": float(cur.dt)}
    if sharded:
        record["same_on_every_rank"] = same
    else:
        record.update(ncap=cur.ncap, kghost=cur.kghost, kmig=cur.kmig,
                      replays=cur.replays,
                      timed_replays=cur.replays - replays0)
    if on_card:
        # one more step with its host synchronizations counted
        record["host_syncs"] = bench.host_syncs(lambda: step(cur, cfg))
    with open(os.path.join(out, f"{job.name}.rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if rank == 0:
        np.savez(os.path.join(out, f"{job.name}.npz"),
                 iters=np.asarray(iters, np.int64),
                 **state_to_numpy(got),
                 **{k: v.cpu().numpy() for k, v in extra.items()})
    if not quiet:
        ms = statistics.median(step_ms) if step_ms else 0.0
        if sharded:
            rows = f"the same state on every rank: {all(same)}"
        else:
            own, ghost, arrived = (sum(c[i] for c in counts) / len(counts)
                                   for i in range(3))
            rows = (f"own rows {own:.0f}, ghost rows {ghost:.0f}, arrivals "
                    f"{arrived:.1f} a step; replays {record['replays']}")
        print(f"[dryrun] rank {rank}/{world} {job.name}: {job.steps} "
              f"step(s), {rows}; (div, pressure, visc) {iters[-1]}; dt "
              f"{float(cur.dt):.3e}; vel_max {float(cur.diag.vel_max):.4f}; "
              f"median step {ms:.1f} ms", flush=True)


def reference(state, cfg: SimConfig, solver: str, steps: int,
              front: str = "slab"):
    """The single-device port's run of the same job, its loops in the
    front's forms (``FRONT_FUSED``: unfused on one ghost plane, DFSPH's
    two loops fused on two): (the state after ``steps`` steps, the (div,
    pressure, visc) iterations of each)."""
    step = get_solver(solver).step
    slots = ListSlots()
    iters = []
    for _ in range(steps):
        state = step(state, cfg, slots, FRONT_FUSED[front])
        d = state.diag
        iters.append((d.divergence_iters, d.pressure_iters,
                      d.viscosity_iters))
    return state, iters


def reference_density(state, cfg: SimConfig) -> torch.Tensor:
    """The single-device port's ``halo.density_sharded``: (N,) K5's
    density of each particle, 0 outside the domain."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    rho, _ = engine.density(grid)
    row = grid.row_of.long()
    return torch.where(row >= 0, rho[row.clamp(min=0)], 0.0)


def reference_pressure_solve(state, cfg: SimConfig):
    """The single-device port's ``halo.pressure_solve_sharded``, its loop
    unfused as on one ghost plane: ((3, N_L) vel, (N_L,) kappa,
    iterations, error)."""
    grid = build_grid(state.pos, state.n_liquid, cfg)
    velp, kp = pack(grid, [state.vel, state.kappa])
    rhop, alphap, _, _ = dfsph.density_and_list(grid, velp, ListSlots())
    alphap = torch.where(grid.liquid, alphap, 0.0)
    pr = dfsph.pressure_solve(NoComm(grid, cfg, frozenset()), velp, kp,
                              alphap, rhop, state.dt)
    vel, kappa = unpack(grid, [pr.vel, pr.kappa], [state.vel, state.kappa])
    return vel, kappa, pr.iters, pr.err


def tiny_jobs(world: int, where: str, steps: int = 1):
    """One job a front and solver: the golden scene's dam break (5^3), on
    the CPU."""
    r = 0.025
    sc = dam_break(particle_radius=r, fluid_dims=(5, 5, 5), box_extent=0.55)
    lo, hi = sc.domain(pad=4 * r)
    jobs = []
    for solver in SOLVERS:
        sim = Simulation(sc, default_config(solver, particle_radius=r,
                                            domain_min=lo, domain_max=hi),
                         solver=solver, device="cpu")
        cfg = slab_config(sim.cfg, world)
        jobs += [save_job(f"{front}-{solver}", solver, sim.state, cfg, steps,
                          where, front=front) for front in FRONTS]
    return sorted(jobs, key=lambda j: FRONTS.index(j.front))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    world = int(argv[0]) if argv else 3
    with tempfile.TemporaryDirectory() as where:
        jobs = tiny_jobs(world, where)
        spawn(run_jobs, world,
              (os.path.join(where, "store"), jobs, where, "cpu"))


if __name__ == "__main__":
    main()
