"""A/B of the steps' sweeps against an older tree, on one card.

    python -m wcsph_tpu_torch.ab_list --old out/old

``--old`` is an unpacked copy of an older commit of this repository
(``git archive <commit> | tar -x -C out/old``).  Its ``csrc/sweeps.cu`` and
``csrc/solver_sweeps.cu`` must define the entries of ``AB_KERNELS`` with
this tree's C signatures, but K8, which must have the signature of
``OLD_K8_ARGS`` (the K8 that scanned the cells in both sweeps); its
``Geom`` must be this tree's or a leading part of it: this tree's ``Geom``
is passed to the old kernels.  Run from the repository root.  In one
process on one card:

1. kernels: the old tree's two sources are built as second libraries
   (into ``<old>/_ab_build``).  For each solver of ``AB_SOLVERS`` the
   flagship dam break (side 100) runs 4 steps from rest; then one more step
   from that state runs with the wrappers of ``AB_KERNELS`` recording the
   operands the solver gives them, at the positions at rest and with every
   liquid position jittered by a numpy-seeded uniform +-0.3 r.  Each
   recorded call (the first of each wrapper, and of each K3 mode) is
   replayed through its wrapper with the old and with the new library,
   timed in turns (old, new, new, old) with CUDA events and compared bit
   for bit; where the step built a list, the fill is timed alone, its slice
   offsets alone, and both as its whole wrapper; ``step_calls`` sums each
   side's times over the calls that the recorded step made;
2. steps: the five paths of ``bench.flagship_paths``, 3 warm-up and 10
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
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import bench, engine

AB_KERNELS = ("k1_density_alpha_drho", "k1_div_acc", "k1_visc_init",
              "k1_vorticity", "k2_fused_kappa_drho", "k3_fused_iter_full",
              "k4_fused_visc_iter", "k7_fused_jacobi_iter",
              "k8_fused_pcisph_iter")
AB_SOLVERS = ("dfsph", "iisph", "pcisph")   # the steps that call them
# The older K8's C signature: no hit buffer (geometry, v*, p, dt, factor,
# w0, adv, acc, partials, err, stream).
OLD_K8_ARGS = [engine._G, *[ctypes.c_void_p] * 2, *[ctypes.c_float] * 3,
               *[ctypes.c_void_p] * 5]
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

def syncs(run):
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)

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
    stage_syncs = syncs(stage)
    print(json.dumps({"path": name,
                      "particle_steps_per_s": res["particle_steps_per_s"],
                      "step_ms_median": statistics.median(res["step_ms"]),
                      "step_ms": res["step_ms"], "iters": res["iters"],
                      "replays": replays, "bin_pack_ms": stage_ms,
                      "bin_pack_host_syncs": stage_syncs,
                      "host_syncs_per_step": syncs(sim.step)}), flush=True)
    del sim, st
    torch.cuda.empty_cache()
"""


def compare_states(old_dir: Path, new_dir: Path) -> dict:
    """path -> {field: (bit-equal, largest absolute difference)} of the
    two trees' states after the timed steps."""
    out = {}
    for f in sorted(new_dir.glob("*.npz")):
        a, b = np.load(old_dir / f.name), np.load(f)
        out[f.stem] = {k: (bool(np.array_equal(a[k], b[k])),
                           float(np.abs(a[k].astype(np.float64)
                                        - b[k].astype(np.float64)).max()))
                       for k in b.files}
    return out


def old_library(old_root: Path) -> dict:
    """The old tree's ``AB_KERNELS`` entries, built from its csrc/sweeps.cu
    and csrc/solver_sweeps.cu with this tree's nvcc flags (both nvcc
    started together) and bound with this tree's signatures; the old K8
    with ``OLD_K8_ARGS``, behind a function that takes the new K8's
    arguments and passes it those it has."""
    out = old_root / "_ab_build"
    out.mkdir(exist_ok=True)
    nvcc = engine._nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    running = []
    for stem in ("sweeps", "solver_sweeps"):
        lib_path = out / f"libold_{stem}.so"
        log = open(out / f"old_{stem}.ptxas.txt", "w")
        running.append((lib_path, log, subprocess.Popen(
            [nvcc, *engine.NVCC_FLAGS, "-o", str(lib_path),
             str(old_root / "wcsph_tpu_torch" / "csrc" / f"{stem}.cu")],
            stdout=log, stderr=subprocess.STDOUT)))
    fns = {}
    for lib_path, log, proc in running:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the old tree: {log.name}")
        log.close()
        lib = ctypes.CDLL(str(lib_path))
        for name in AB_KERNELS:
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = (OLD_K8_ARGS if name == "k8_fused_pcisph_iter"
                               else engine._SIGNATURES[name])
                fn.restype = ctypes.c_int
                fns[name] = fn
    k8 = fns["k8_fused_pcisph_iter"]

    def old_k8(g, vel_star, p, dt, factor, w0, width, hits, nhit, rec, over,
               adv, acc, partials, err, stream):
        return k8(g, vel_star, p, dt, factor, w0, adv, acc, partials, err,
                  stream)

    fns["k8_fused_pcisph_iter"] = old_k8
    return fns


@contextlib.contextmanager
def using(fns: dict):
    """The engine's wrappers launch ``fns`` in place of their own entries."""
    own = engine.library()
    engine._lib = {**own, **fns}
    try:
        yield
    finally:
        engine._lib = own


def _fresh(args):
    """The arguments with every tensor copied (the calls update some of
    their operands in place)."""
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def record_step(sim):
    """Run one step with the wrappers of ``AB_KERNELS`` and the fill
    recording what the solver passes them: ({label: (wrapper name,
    arguments of its first call)}, {label: calls in the step}).  The label
    is the wrapper's name, with K3's mode."""
    first, count = {}, {}
    wrappers = {n: getattr(engine, n) for n in (*AB_KERNELS, "nbr_list_fill")}

    def recording(name):
        def call(*args):
            label = " ".join([name, *(str(a) for a in args
                                      if type(a) is int)])
            first.setdefault(label, (name, _fresh(args)))
            count[label] = count.get(label, 0) + 1
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


def _outputs(name, args):
    """Every tensor that a call of the wrapper writes or returns."""
    a = _fresh(args)
    ret = getattr(engine, name)(*a)
    ret = ret if isinstance(ret, tuple) else (ret,)
    return [t for t in (*a, *ret) if isinstance(t, torch.Tensor)]


def kernels_ab(first, count, old) -> dict:
    """Old and new library on every recorded call, in turns, the bits
    compared; ``step_calls`` sums each side's times over the step's calls;
    then, where the step built its list, the fill, alone and as its whole
    wrapper."""
    new = engine.library()
    out = {}
    for label, (name, args) in first.items():
        if name == "nbr_list_fill":
            continue
        res = []
        for fns in (old, new):
            with using(fns):
                res.append(_outputs(name, args))
        torch.cuda.synchronize()
        times = []
        for fns in (old, new, new, old):
            with using(fns):
                times.append(bench.time_call(
                    getattr(engine, name), lambda: _fresh(args), REPS))
        out[label] = {
            "old_ms": (times[0] + times[3]) / 2,
            "new_ms": (times[1] + times[2]) / 2,
            "turns_ms": times,
            "bit_equal": all(torch.equal(a, b) for a, b in zip(*res)),
            "max_abs_diff": max(float((a.double() - b.double()).abs().max())
                                for a, b in zip(*res))}
    calls = {k: n for k, n in count.items() if k in out}
    out["step_calls"] = {
        "calls": calls,
        **{f"{side}_ms": sum(n * out[k][f"{side}_ms"]
                             for k, n in calls.items())
           for side in ("old", "new")}}
    if "nbr_list_fill" not in first:
        return out
    grid, cnt, slots = first["nbr_list_fill"][1]
    nl = engine.nbr_list_fill(grid, cnt, slots)
    geom = engine._geom(grid)

    def fill():
        engine._launch("nbr_list_fill", ctypes.byref(geom), nl.off.data_ptr(),
                       nl.idx.data_ptr(), nl.rec.data_ptr(),
                       nl.flag.data_ptr(), engine._stream())

    out["nbr_list_fill"] = {
        "kernel_ms": bench.time_call(fill, tuple, REPS),
        "offsets_ms": bench.time_call(
            engine.nbr_list_offsets, lambda: (cnt, grid.liq, slots.capacity),
            REPS),
        "wrapper_ms": bench.time_call(engine.nbr_list_fill,
                                      lambda: (grid, cnt, slots), REPS),
        "slots": int(nl.need), "capacity": slots.capacity}
    out["step_calls"]["new_plus_fill_ms"] = (
        out["step_calls"]["new_ms"]
        + count["nbr_list_fill"] * out["nbr_list_fill"]["wrapper_ms"])
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
    old = old_library(args.old.resolve())

    for solver in AB_SOLVERS:
        sim = bench.build_sim(SIDE, "cuda", solver)
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
            grid = next(iter(first.values()))[1][0]
            if int(grid.cell_start[-1]) != state.n_total:
                raise AssertionError(f"{scene}: a particle left the domain")
            fill = first.get("nbr_list_fill")
            # the list's pairs, or the step's last K8 hits
            pairs = (int(fill[1][1][grid.liquid].sum()) if fill
                     else int(grid.star.count.sum()))
            res = kernels_ab(first, count, old)
            print(json.dumps({"solver": solver, "scene": scene,
                              "rows": grid.n, "pairs": pairs, "card": card,
                              "kernels": res}), flush=True)
            del first, grid, fill
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
