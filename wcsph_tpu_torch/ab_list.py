"""A/B of the step's redesigned wrappers against an older tree, on one
card.

    python -m wcsph_tpu_torch.ab_list --old out/old

``--old`` is an unpacked copy of an older commit of this repository
(``git archive <commit> | tar -x -C out/old``).  Its package is imported
beside this one under another name, so that its own wrappers of
``AB_KERNELS`` build and launch its own ``csrc/`` (into its own
``_build/``); ``OLD_NAMES`` names the old wrapper where this tree split
one, and ``OLD_ARGS`` turns a call of this tree's wrapper into the
arguments of the old one where the signature changed.  Run from the
repository root.  In one process on one card:

1. kernels: for each path of ``AB_SOLVERS`` (``bench.flagship_paths``) the
   flagship dam break (side 100) runs 4 steps from rest; then one more step
   from that state runs with the wrappers of ``AB_KERNELS`` recording the
   arguments the solver gives them, at the positions at rest and with every
   liquid position jittered by a numpy-seeded uniform +-0.3 r.  Each
   recorded call (the first of each wrapper) is replayed through the old
   tree's wrapper and this tree's, timed in turns (old, new, new, old) with
   CUDA events, beside ``LIBRARY``'s PyTorch call of the same function
   where there is one, and compared bit for bit (their tensors: a list's
   slots, offsets, records, need and flag; not a cut's hits, which the old
   tree did not keep), each side with a slot buffer of its own; each
   side's device time and device kernels a call (torch.profiler), and
   where its host time goes (``host_profile``); ``step_calls`` sums each
   side's times over the calls that the recorded step made.  Where the
   step built a list, each tree's fill kernel is also timed alone, in
   turns;
2. steps: the paths of ``bench.flagship_paths``, 3 warm-up and 10
   timed steps each, in child processes of the old tree and of this one, in
   turns (old, new, new, old), with each step's (divergence, pressure,
   viscosity) iterations, the list replays in the timed window (this tree),
   the grid stage (``build_grid`` and the pack of the velocity: CUDA
   events, and its host synchronizations) and the host synchronizations of
   one more step, counted under ``torch.cuda.set_sync_debug_mode("warn")``;
   the state after the 13 steps
   of each tree's first turn is compared field by field (bit-equal, largest
   absolute difference).

One JSON line per measurement on stdout, after a first line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import bench, engine
from .grid import ListSlots, PredictHits

# the wrappers a change measured: the unfused kappa sum and viscosity
# matvec, their list walks
AB_KERNELS = ("k1_kappa_acc", "k1_visc_acc")
# the paths of bench.flagship_paths whose steps call them
AB_SOLVERS = ("dfsph-unfused", "iisph-unfused")
# The older wrapper of a wrapper that this tree split off (none here).
OLD_NAMES = {}
# The older wrappers' arguments, from this tree's, where a signature
# changed (none here).
OLD_ARGS = {}
# name -> (arguments of a recorded call -> the one PyTorch call that
# computes the same function's core, as chip_smoke.py times it); none
# computes a sweep over a cell list
LIBRARY = {}
SIDE = 100         # the flagship dam break, 1M liquid particles
REPS = 20          # timed calls per turn
JITTER = 0.3       # of the particle radius
SEED = 0

# One tree's steps: run with that tree's root as the working directory,
# so that its own wcsph_tpu_torch is imported.  argv: side, and a directory
# for the state after the timed steps (or "-").
_STEPS = """
import json, os, statistics, sys, warnings
import numpy as np, torch
from wcsph_tpu_torch import bench, engine
from wcsph_tpu_torch.grid import build_grid, pack
from wcsph_tpu_torch.state import state_to_numpy
side, keep = int(sys.argv[1]), sys.argv[2]

{host_syncs}
for name, (solver, over) in bench.flagship_paths(side).items():
    sim = bench.build_sim(side, "cuda", solver, **over)
    res = bench.measure(sim, 3, 10)
    replays = getattr(engine, "LIST_REPLAYS", None)
    st = sim.state
    if keep != "-":
        np.savez(os.path.join(keep, name + ".npz"), **{
            k: v for k, v in state_to_numpy(st).items()
            if isinstance(v, np.ndarray)})
    def stage():
        return pack(build_grid(st.pos, st.n_liquid, sim.cfg), [st.vel])

    stage_ms = bench.time_call(stage, tuple, 20)
    stage_syncs = host_syncs(stage)
    print(json.dumps({"path": name,
                      "particle_steps_per_s": res["particle_steps_per_s"],
                      "step_ms_median": statistics.median(res["step_ms"]),
                      "step_ms": res["step_ms"], "iters": res["iters"],
                      "replays": replays, "bin_pack_ms": stage_ms,
                      "bin_pack_host_syncs": stage_syncs,
                      "host_syncs_per_step": host_syncs(sim.step)}), flush=True)
    del sim, st
    torch.cuda.empty_cache()
"""
# bench.host_syncs goes into the script as source: an older tree's bench
# may not have it
_STEPS = _STEPS.replace("{host_syncs}", inspect.getsource(bench.host_syncs))


def compare_states(old_dir: Path, new_dir: Path) -> dict:
    """path -> {field: (bit-equal, largest absolute difference)} of the
    two trees' states after the timed steps, for the paths both trees
    ran."""
    out = {}
    for f in sorted(new_dir.glob("*.npz")):
        if not (old_dir / f.name).exists():
            continue
        a, b = np.load(old_dir / f.name), np.load(f)
        out[f.stem] = {k: (bool(np.array_equal(a[k], b[k])),
                           float(np.abs(a[k].astype(np.float64)
                                        - b[k].astype(np.float64)).max()))
                       for k in b.files}
    return out


def old_engine(old_root: Path):
    """The old tree's ``engine`` module: its package imported under another
    name, with its own wrappers, launch counters and library (built from
    its own ``csrc/`` at first use)."""
    name = "_ab_old_wcsph_tpu_torch"
    pkg_dir = old_root / "wcsph_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(name + ".engine")


def _fresh(args):
    """The arguments with every tensor copied (the calls update some of
    their operands in place)."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _recorded(args):
    """``_fresh``, and a cut's hits copied too: the step's next cut
    overwrites its buffer."""
    return tuple(dataclasses.replace(a, idx=a.idx.clone(),
                                     count=a.count.clone(),
                                     rec=a.rec.clone())
                 if isinstance(a, PredictHits) else a for a in _fresh(args))


def _own(args):
    """The arguments with a slot buffer of their own in place of a
    ``ListSlots``, of the same capacity: the old and the new side of a
    fill or a cut must not write one buffer."""
    return tuple(ListSlots(a.capacity) if isinstance(a, ListSlots) else a
                 for a in args)


def record_step(sim):
    """Run one step with the wrappers of ``AB_KERNELS`` and the fill
    recording what the solver passes them: ({wrapper name: arguments of its
    first call}, {wrapper name: calls in the step})."""
    first, count = {}, {}
    wrappers = {n: getattr(engine, n) for n in (*AB_KERNELS, "nbr_list_fill")}

    def recording(name):
        def call(*args):
            first.setdefault(name, _recorded(args))
            count[name] = count.get(name, 0) + 1
            return wrappers[name](*args)
        return call

    for name in wrappers:
        setattr(engine, name, recording(name))
    try:
        sim.step()
    finally:
        for name, fn in wrappers.items():
            setattr(engine, name, fn)
    return first, count


def _tensors(ret):
    """The tensors a wrapper returned (one, or a tuple or list of them; a
    neighbour list's slots in use, offsets, records, need and flag, of
    either tree's ``NeighborList``); other values (a cut's hits) are left
    out."""
    if all(hasattr(ret, f) for f in ("idx", "off", "rec", "need", "flag")):
        return [ret.idx[: int(ret.off[-1])], ret.off, ret.rec, ret.need,
                ret.flag]
    if isinstance(ret, (tuple, list)):
        return [t for r in ret for t in _tensors(r)]
    return [ret] if isinstance(ret, torch.Tensor) else []


def host_profile(fn, make_args, eng, reps: int = REPS) -> dict:
    """Where one call's host time goes: microseconds a call on the host
    clock (``reps`` calls enqueued back to back, operands made before);
    microseconds a call of each C entry it launches, on its own with the
    same arguments (the ctypes call and the launch; ``eng`` is the engine
    module whose ``_launch`` the wrapper calls); torch.profiler's CPU
    events a call (op, calls, self microseconds), the largest first."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn(*make_args())
    calls = [make_args() for _ in range(reps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in calls:
        fn(*args)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    calls = [make_args() for _ in range(reps)]
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        for args in calls:
            fn(*args)
    torch.cuda.synchronize()
    ops = sorted(((e.key, e.count / reps, e.self_cpu_time_total / reps)
                  for e in prof.key_averages()), key=lambda o: -o[2])
    seen, launch = [], eng._launch
    eng._launch = lambda name, *args: (seen.append((name, args)),
                                       launch(name, *args))[1]
    try:
        kept = fn(*make_args())     # its outputs stay alive for the calls
    finally:
        eng._launch = launch
    c_us = {}
    # a wrapper's own scratch, freed at its return, stays in PyTorch's pool
    # (nothing allocates in this loop), so its pointers stay valid here
    for name, args in seen:
        entry = eng.library()[name]
        t0 = time.perf_counter()
        for _ in range(reps):
            entry(*args)
        c_us[name] = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    del kept
    return {"host_us": host_us, "c_entry_us": c_us, "cpu_events": ops[:8]}


def _device_ms(fn, make_args):
    """``bench.device_ms`` of REPS calls, or why it is not measured: the
    profiler now and then drops device events from every trace of a run."""
    try:
        return bench.device_ms(fn, make_args, REPS)
    except RuntimeError as e:
        return {"not measured": str(e)}


def kernels_ab(first, count, old) -> dict:
    """Old and new wrapper on every recorded call, in turns, beside the
    library call, the bits compared; each side's device time, device
    kernels a call and host profile; ``step_calls`` sums each side's times
    over the step's calls; then, where the step built its list, each
    tree's fill kernel alone, in turns."""
    out = {}
    for name in AB_KERNELS:
        if name not in first:
            continue
        adapt = OLD_ARGS.get(name, lambda *a: a)
        mine = {s: _own(first[name]) for s in ("old", "new")}
        sides = {"old": (getattr(old, OLD_NAMES.get(name, name)),
                         lambda: adapt(*_fresh(mine["old"]))),
                 "new": (getattr(engine, name),
                         lambda: _fresh(mine["new"]))}
        args = mine["new"]
        res = {s: _tensors(fn(*make())) for s, (fn, make) in sides.items()}
        torch.cuda.synchronize()
        library = LIBRARY[name](*args) if name in LIBRARY else None
        times = {"old": [], "new": []}
        if library is not None:
            times["library"] = []
        for s in ("old", "new", "new", "old"):
            times[s].append(bench.time_call(*sides[s], REPS))
            if library is not None:
                times["library"].append(bench.time_call(library, tuple,
                                                        REPS))
        out[name] = {
            **{f"{s}_ms": sum(v) / len(v) for s, v in times.items()},
            "turns_ms": times,
            **{f"{s}_device": _device_ms(*sides[s]) for s in sides},
            **{f"{s}_host": host_profile(*sides[s], eng)
               for s, eng in (("old", old), ("new", engine))},
            "bit_equal": len(res["old"]) == len(res["new"]) and all(
                torch.equal(a, b) for a, b in zip(res["old"], res["new"])),
            "max_abs_diff": max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(res["old"], res["new"]))}
    calls = {k: n for k, n in count.items() if k in out}
    out["step_calls"] = {
        "calls": calls,
        **{f"{side}_ms": sum(n * out[k][f"{side}_ms"]
                             for k, n in calls.items())
           for side in ("old", "new")}}
    if "nbr_list_fill" not in first:
        return out
    grid, cnt, slots = first["nbr_list_fill"]
    alone = {}
    for side, eng in (("old", old), ("new", engine)):
        nl = eng.nbr_list_fill(grid, cnt, ListSlots(slots.capacity))
        geom = eng._geom(grid)

        def fill(eng=eng, geom=geom, nl=nl):
            eng._launch("nbr_list_fill", ctypes.byref(geom),
                        nl.off.data_ptr(), nl.idx.data_ptr(),
                        nl.rec.data_ptr(), nl.flag.data_ptr(), eng._stream())

        alone[side] = fill
    times = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        times[side].append(bench.time_call(alone[side], tuple, REPS))
    out["nbr_list_fill_alone"] = {
        **{f"{s}_ms": sum(v) / len(v) for s, v in times.items()},
        "turns_ms": times, "slots": int(nl.need),
        "capacity": slots.capacity}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path,
                    help="root of an unpacked older tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wcsph_tpu_torch.ab_list measures the CUDA device; "
                         "torch.cuda.is_available() is False")
    card = bench.card_info()
    print(json.dumps({"card": card}), flush=True)
    old = old_engine(args.old.resolve())

    paths = bench.flagship_paths(SIDE)
    for path in AB_SOLVERS:
        solver, over = paths[path]
        sim = bench.build_sim(SIDE, "cuda", solver, **over)
        for _ in range(4):
            sim.step()
        state = sim.state
        nl = state.n_liquid
        r = sim.cfg.particle_radius
        jitter = np.random.RandomState(SEED).uniform(-JITTER * r, JITTER * r,
                                                     (3, nl))
        jittered = state.pos.clone()
        jittered[:, :nl] += torch.as_tensor(jitter.astype(np.float32),
                                            device=state.pos.device)
        for scene, pos in (("at rest", state.pos), ("jittered", jittered)):
            sim.state = state.replace(pos=pos)
            first, count = record_step(sim)
            # every recorded wrapper takes the step's grid first
            grid = next(iter(first.values()))[0]
            if int(grid.cell_start[-1]) != state.n_total:
                raise AssertionError(f"{scene}: a particle left the domain")
            fill = first.get("nbr_list_fill")
            walk = first.get("k1_pcisph_walk")
            hits = walk[3] if walk else None
            # the list's pairs, or the first iteration's pairs at x*, or
            # the step's last K8 hits, or none
            pairs = (int(fill[1][grid.liquid].sum()) if fill
                     else int(hits.count.sum()) if hits
                     else int(grid.star.count.sum()) if grid.star is not None
                     else None)
            res = kernels_ab(first, count, old)
            print(json.dumps({
                "solver": path, "scene": scene, "rows": grid.n,
                "pairs": pairs, "card": card, "kernels": res,
                # the first iteration's walk: its width, the most hits of
                # a row, the rows it scans again
                "walk": None if hits is None else {
                    "width": hits.width, "most_hits": int(hits.count.max()),
                    "rows_scanned_again": int(
                        ((hits.count > hits.width) & grid.liquid).sum())}}),
                flush=True)
            del first, grid, fill, walk, hits
        del sim, state
        torch.cuda.empty_cache()

    # each child imports the package of its own working directory
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with tempfile.TemporaryDirectory() as tmp:
        kept = {"old": Path(tmp) / "old", "new": Path(tmp) / "new"}
        for tree, root in (("old", args.old), ("new", Path.cwd()),
                           ("new", Path.cwd()), ("old", args.old)):
            keep = kept[tree]
            keep_arg = "-" if keep.exists() else str(keep)
            keep.mkdir(exist_ok=True)
            run = subprocess.run(
                [sys.executable, "-c", _STEPS, str(SIDE), keep_arg],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=900)
            if run.returncode != 0:
                raise RuntimeError(
                    f"{tree} steps failed:\n{run.stderr[-4000:]}")
            for line in run.stdout.splitlines():
                print(json.dumps({"tree": tree, "card": card,
                                  **json.loads(line)}), flush=True)
        print(json.dumps({"states_after_13_steps": compare_states(
            kept["old"], kept["new"])}), flush=True)

if __name__ == "__main__":
    main()
