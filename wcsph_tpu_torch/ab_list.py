"""A/B of the list-walking sweeps against an older tree, on one card.

    python -m wcsph_tpu_torch.ab_list --old out/old

``--old`` is an unpacked copy of an older commit of this repository
(``git archive <commit> | tar -x -C out/old``).  Its ``csrc/sweeps.cu``
must define the entries of ``AB_KERNELS`` with this tree's C signatures,
and its ``Geom`` must be this tree's or a leading part of it: this tree's
``Geom`` is passed to the old kernels.  Run from the repository root.  In
one process on one card:

1. kernels: the old tree's ``csrc/sweeps.cu`` is built as a second library
   (into ``<old>/_ab_build``).  The flagship dam break (side 100) runs 4
   DFSPH steps from rest; then one more step from that state runs with the
   wrappers of ``AB_KERNELS`` recording the operands the solver gives
   them, at the positions at rest and with every liquid position jittered
   by a numpy-seeded uniform +-0.3 r.  Each recorded call (the first of
   each wrapper, and of each K3 mode) is replayed through its wrapper with
   the old and with the new library, timed in turns (old, new, new, old)
   with CUDA events and compared bit for bit; the list fill is timed alone
   and as its whole wrapper; ``step_calls`` sums each side's times over
   the calls that the recorded step made;
2. steps: the DFSPH, DFSPH-with-tension and IISPH paths of
   ``bench.flagship_paths``, 3 warm-up and 10 timed steps each, in child
   processes of the old tree and of this one, in turns (old, new, new,
   old), with each step's (divergence, pressure, viscosity) iterations.

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
from pathlib import Path

import numpy as np
import torch

from . import bench, engine
from .grid import slice_offsets

AB_KERNELS = ("k1_div_acc", "k1_vorticity", "k2_fused_kappa_drho",
              "k3_fused_iter_full", "k4_fused_visc_iter")
SIDE = 100         # the flagship dam break, 1M liquid particles
REPS = 20          # timed calls per turn
JITTER = 0.3       # of the particle radius
SEED = 0

# One tree's steps: run with that tree's root as the working directory,
# so that its own wcsph_tpu_torch is imported.
_STEPS = """
import json, statistics, sys, torch
from wcsph_tpu_torch import bench
side = int(sys.argv[1])
for name in ("dfsph", "dfsph+tension", "iisph"):
    solver, over = bench.flagship_paths(side)[name]
    res = bench.measure(bench.build_sim(side, "cuda", solver, **over), 3, 10)
    print(json.dumps({"path": name,
                      "particle_steps_per_s": res["particle_steps_per_s"],
                      "step_ms_median": statistics.median(res["step_ms"]),
                      "iters": res["iters"]}), flush=True)
    torch.cuda.empty_cache()
"""


def old_library(old_root: Path) -> dict:
    """The old tree's ``AB_KERNELS`` entries, built from its csrc/sweeps.cu
    with this tree's nvcc flags and bound with this tree's signatures."""
    src = old_root / "wcsph_tpu_torch" / "csrc" / "sweeps.cu"
    out = old_root / "_ab_build"
    out.mkdir(exist_ok=True)
    lib_path = out / "libold_sweeps.so"
    nvcc = engine._nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with open(out / "old_sweeps.ptxas.txt", "w") as f:
        subprocess.run([nvcc, *engine.NVCC_FLAGS, "-o", str(lib_path),
                        str(src)], stdout=f, stderr=subprocess.STDOUT,
                       check=True)
    lib = ctypes.CDLL(str(lib_path))
    fns = {}
    for name in AB_KERNELS:
        fn = getattr(lib, name)
        fn.argtypes = engine._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
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
    compared; then the fill, alone and as its whole wrapper."""
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
    grid, cnt = first["nbr_list_fill"][1]
    off, total = slice_offsets(cnt, grid.liquid)
    idx = torch.empty((total,), dtype=torch.int32, device=grid.device)
    rec = torch.empty((grid.n, 4), dtype=torch.float32, device=grid.device)
    flag = torch.zeros((), dtype=torch.int32, device=grid.device)
    geom = engine._geom(grid)

    def fill():
        engine._launch("nbr_list_fill", ctypes.byref(geom), off.data_ptr(),
                       idx.data_ptr(), rec.data_ptr(), flag.data_ptr(),
                       engine._stream())

    out["nbr_list_fill"] = {
        "kernel_ms": bench.time_call(fill, tuple, REPS),
        "wrapper_ms": bench.time_call(engine.nbr_list_fill,
                                      lambda: (grid, cnt), REPS),
        "slots": total}
    calls = {k: n for k, n in count.items()
             if k in out and k != "nbr_list_fill"}
    out["step_calls"] = {
        "calls": calls,
        **{f"{side}_ms": sum(n * out[k][f"{side}_ms"]
                             for k, n in calls.items())
           for side in ("old", "new")}}
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

    sim = bench.build_sim(SIDE, "cuda", "dfsph")
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
        grid, cnt = first["nbr_list_fill"][1]
        if grid.n != state.n_total:
            raise AssertionError(f"{scene}: a particle left the domain")
        res = kernels_ab(first, count, old)
        print(json.dumps({"scene": scene, "rows": grid.n,
                          "pairs": int(cnt[grid.liquid].sum()),
                          "card": card, "kernels": res}), flush=True)
        del first, grid, cnt
    del sim, state
    torch.cuda.empty_cache()

    # each child imports the package of its own working directory
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for tree, root in (("old", args.old), ("new", Path.cwd()),
                       ("new", Path.cwd()), ("old", args.old)):
        run = subprocess.run([sys.executable, "-c", _STEPS, str(SIDE)],
                             cwd=root, env=env, capture_output=True,
                             text=True, timeout=900)
        if run.returncode != 0:
            raise RuntimeError(f"{tree} steps failed:\n{run.stderr[-4000:]}")
        for line in run.stdout.splitlines():
            print(json.dumps({"tree": tree, "card": card,
                              **json.loads(line)}), flush=True)


if __name__ == "__main__":
    main()
