"""The port's multi-rank dry run, and the rank function that the tests and
``chip_smoke.py`` spawn.

    python -m wcsph_tpu_torch.parallel.dryrun 3

spawns 3 CPU ranks over gloo (``torch.multiprocessing``, a ``FileStore``,
``GLOO_SOCKET_IFNAME=lo``); each runs one ``step_slab`` of each of the four
solvers on a tiny dam break and prints one line.  (The counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip``, its slab path.)

``run_jobs`` is the rank function of every spawn: it joins the group,
runs each job (a saved ``FluidState``, a config, a solver, a number of
steps) on the rank's slab and writes what it saw under the job's name:
rank 0 the gathered state and the iterations of each step, every rank its
own counts, times, launches and replays.  A spawned child imports only
this package.  ``spawn`` joins with a deadline: a rank that fails raises
in the caller, and a rank that hangs is killed and raises there too.
"""

from __future__ import annotations

import dataclasses
import datetime
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
from ..grid import ListSlots
from ..scene import dam_break
from ..simulation import Simulation, default_config, get_solver
from ..state import state_from_numpy, state_to_numpy
from . import slab
from .halo import slab_config

SOLVERS = ("dfsph", "sesph", "pcisph", "iisph")
INIT_SECONDS = 120      # init_process_group's timeout, and each collective's


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
    """One run of ``steps`` slab steps (the first ``warmup`` untimed) of
    ``solver`` from the state saved at ``state`` (``state_to_numpy``) under
    the config ``cfg`` (``dataclasses.asdict``); ``kmig`` and ``kghost``,
    where set, the first sizes of the migration and ghost buffers in place
    of ``slab_init``'s (a short buffer makes its step run again)."""

    name: str
    solver: str
    state: str
    cfg: dict
    steps: int
    warmup: int = 0
    kmig: int | None = None
    kghost: int | None = None


def save_job(name: str, solver: str, state, cfg: SimConfig, steps: int,
             where: str, warmup: int = 0) -> Job:
    """A job whose state is saved under ``where``."""
    path = os.path.join(where, f"{name}.state.npz")
    np.savez(path, **state_to_numpy(state))
    return Job(name, solver, path, dataclasses.asdict(cfg), steps, warmup)


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


def _run_job(rank, world, job: Job, out: str, dev, quiet: bool) -> None:
    cfg = config_from_dict(job.cfg)
    with np.load(job.state) as d:
        state = state_from_numpy(dict(d), dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sst = slab.slab_init(state, cfg, solver=job.solver, device=dev)
    sst = dataclasses.replace(sst, kmig=job.kmig or sst.kmig,
                              kghost=job.kghost or sst.kghost)
    # the round trip with no step returns the state bit for bit
    back = slab.slab_gather(sst, state, solver=job.solver)
    for f in ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
              "kappa_v"):
        if not torch.equal(getattr(back, f), getattr(state, f)):
            raise AssertionError(f"slab_init -> slab_gather changed {f}")
    iters, counts, step_ms = [], [], []
    for k in range(job.steps):
        if k == job.warmup:
            engine.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        sst = slab.step_slab(sst, cfg, solver=job.solver)
        sync()
        if k >= job.warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        d = sst.diag
        iters.append((d.divergence_iters, d.pressure_iters,
                      d.viscosity_iters))
        counts.append(sst.counts)
    launches = {k: v for k, v in engine.LAUNCHES.items() if v}
    got = slab.slab_gather(sst, state, solver=job.solver)
    counts = torch.stack(counts).cpu().tolist()
    record = {"rank": rank, "world": world, "ncap": sst.ncap,
              "kghost": sst.kghost, "kmig": sst.kmig,
              "replays": sst.replays, "counts": counts,
              "step_ms": step_ms, "launches": launches, "iters": iters,
              "dt": float(sst.dt)}
    if on_card:
        # one more step with its host synchronizations counted
        record["host_syncs"] = bench.host_syncs(
            lambda: slab.step_slab(sst, cfg, solver=job.solver))
    with open(os.path.join(out, f"{job.name}.rank{rank}.json"), "w") as f:
        json.dump(record, f)
    if rank == 0:
        np.savez(os.path.join(out, f"{job.name}.npz"),
                 iters=np.asarray(iters, np.int64),
                 **state_to_numpy(got))
    if not quiet:
        own, ghost, arrived = (sum(c[i] for c in counts) / len(counts)
                               for i in range(3))
        ms = statistics.median(step_ms) if step_ms else 0.0
        print(f"[dryrun] rank {rank}/{world} {job.name}: {job.steps} "
              f"step(s), own rows {own:.0f}, ghost rows {ghost:.0f}, "
              f"arrivals {arrived:.1f} a step; (div, pressure, visc) "
              f"{iters[-1]}; dt {float(sst.dt):.3e}; vel_max "
              f"{float(sst.diag.vel_max):.4f}; replays "
              f"{record['replays']}; median step {ms:.1f} ms", flush=True)


def reference(state, cfg: SimConfig, solver: str, steps: int):
    """The single-device port's run of the same job: (the state after
    ``steps`` steps, the (div, pressure, visc) iterations of each)."""
    step = get_solver(solver).step
    slots = ListSlots()
    iters = []
    for _ in range(steps):
        state = step(state, cfg, slots)
        d = state.diag
        iters.append((d.divergence_iters, d.pressure_iters,
                      d.viscosity_iters))
    return state, iters


def tiny_jobs(world: int, where: str, steps: int = 1):
    """One job a solver: the golden scene's dam break (5^3), on the CPU."""
    r = 0.025
    sc = dam_break(particle_radius=r, fluid_dims=(5, 5, 5), box_extent=0.55)
    lo, hi = sc.domain(pad=4 * r)
    jobs = []
    for solver in SOLVERS:
        sim = Simulation(sc, default_config(solver, particle_radius=r,
                                            domain_min=lo, domain_max=hi),
                         solver=solver, device="cpu")
        jobs.append(save_job(solver, solver, sim.state,
                             slab_config(sim.cfg, world), steps, where))
    return jobs


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    world = int(argv[0]) if argv else 3
    with tempfile.TemporaryDirectory() as where:
        jobs = tiny_jobs(world, where)
        spawn(run_jobs, world,
              (os.path.join(where, "store"), jobs, where, "cpu"))


if __name__ == "__main__":
    main()
