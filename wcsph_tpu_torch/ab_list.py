"""A/B of the step's redesigned wrappers against an older tree, on one
card.

    python -m wcsph_tpu_torch.ab_list --old out/old [--variant out/v ...]
    python -m wcsph_tpu_torch.ab_list --old out/old --surface [...]

``--old`` is an unpacked copy of an older commit of this repository
(``git archive <commit> | tar -x -C out/old``).  Its package is imported
beside this one under another name, so that its own wrappers of
``AB_KERNELS`` build and launch its own ``csrc/`` (into its own
``_build/``); ``OLD_NAMES`` names the old wrapper where this tree split
one, and ``OLD_ARGS`` turns a call of this tree's wrapper into the
arguments of the old one where the signature changed.  Each
``--variant`` is another tree (its root, or a directory holding just its
``wcsph_tpu_torch/``) with this tree's wrappers and other kernel sources,
named by its directory: its ``AB_KERNELS`` are timed and compared beside
the old tree's and this one's in step 1, so that several designs of a
kernel meet in one call.  Run from the repository root.  In one process
on one card:

0. code: each tree's registers, local (spill) bytes and resident blocks
   an SM of the kernels of ``AB_KERNELS`` (``OCCUPANCY``: a probe built
   with the tree's own source and flags asks ``cudaFuncGetAttributes``
   and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and the kernels
   of the libraries whose machine code (``cuobjdump -sass``) differs
   between the old tree and this one;

1. kernels: for each path of ``AB_SOLVERS`` (``bench.flagship_paths``) the
   flagship dam break (side 100) runs 4 steps from rest; then one more step
   from that state runs with the wrappers of ``AB_KERNELS`` recording the
   arguments the solver gives them, at the positions at rest and with every
   liquid position jittered by a numpy-seeded uniform +-0.3 r.  Each
   recorded call (the first of each wrapper) is replayed through the old
   tree's wrapper, this tree's and each variant's, timed in turns (old,
   new, the variants, then the same backwards) with
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

# the wrappers a change measured: the unfused DFSPH step's two tension
# walks (the tension's with the pack launch of its rows before it)
AB_KERNELS = ("k1_surface_normals", "k1_tension_accel")
# the paths of bench.flagship_paths whose steps call them
AB_SOLVERS = ("dfsph+tension-unfused",)
# --surface: the surface reconstruction's recorded calls, by case; a case
# that is not a wrapper's name names its wrapper in CASE_WRAPPERS
SURFACE_CASES = ("mc_field", "mc_field (anisotropic)", "aniso_moments",
                 "aniso_g")
SURFACE_PATH = "dfsph"
CASE_WRAPPERS = {"mc_field (anisotropic)": "mc_field"}
# The older wrapper of a wrapper that this tree split off (none here).
OLD_NAMES = {}
# The older wrappers' arguments, from this tree's, where a signature
# changed: the field's reach is newer than the old tree.
OLD_ARGS = {"mc_field": lambda grid, x, coeff, g=None, reach=None: (
    grid, x, coeff, g)}
# The outputs an older wrapper had, where this tree's returns more (the
# first ones compared): aniso_g's reach is newer than the old tree.
OLD_OUTPUTS = {"aniso_g": 1}
# case -> (csrc source, the __global__ kernel it launches, its threads a
# block: a name of the source, kBlock where left out) of the cases measured,
# for the occupancy probe (a template's instance by the name this tree and
# the variants give it) ...
OCCUPANCY = {"k1_surface_normals": ("solver_sweeps.cu",
                                    "k5_list_kernel<SurfaceNormalsK1>"),
             "k1_tension_accel": ("solver_sweeps.cu",
                                  "k5_list_kernel<TensionAccelK1>")}
# ... and the same for the old tree, whose entries walked K6's emits
OLD_OCCUPANCY = {"k1_surface_normals": ("solver_sweeps.cu",
                                        "k5_list_kernel<SurfaceNormals>"),
                 "k1_tension_accel": ("solver_sweeps.cu",
                                      "k5_list_kernel<TensionAccel>")}
# the same with --surface: the field's block of kFieldThreads (the old
# tree's of kPoints, one cell), the moments in one launch (the old tree's
# two passes)
SURFACE_OCCUPANCY = {
    "mc_field": ("surface.cu", "mc_field_kernel<false>", "kFieldThreads"),
    "mc_field (anisotropic)": ("surface.cu", "mc_field_kernel<true>",
                               "kFieldThreads"),
    "aniso_moments": ("surface.cu", "aniso_moments_kernel"),
    "aniso_g": ("surface.cu", "aniso_g_kernel")}
SURFACE_OLD_OCCUPANCY = {
    "mc_field": ("surface.cu", "mc_field_kernel<false>", "kPoints"),
    "mc_field (anisotropic)": ("surface.cu", "mc_field_kernel<true>",
                               "kPoints"),
    "aniso_moments (pass 1)": ("surface.cu", "aniso_moments_kernel<1>"),
    "aniso_moments (pass 2)": ("surface.cu", "aniso_moments_kernel<2>"),
    "aniso_g": ("surface.cu", "aniso_g_kernel")}
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


def old_engine(old_root: Path, name: str = "_ab_old_wcsph_tpu_torch"):
    """An older (or variant) tree's ``engine`` module: its package imported
    under the name ``name``, with its own wrappers, launch counters and
    library (built from its own ``csrc/`` at first use)."""
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


def record_surface(state, cfg):
    """``surface_field`` of the state, plain then anisotropic, with the
    surface wrappers recording what it passes them: ({case: arguments of
    its first call}, {case: calls}); the field's case names its form."""
    from .surface.reconstruction import surface_field

    first, count = {}, {}
    names = ("mc_field", "aniso_moments", "aniso_g")
    wrappers = {n: getattr(engine, n) for n in names}

    def recording(name):
        def call(*args):
            case = (name + " (anisotropic)"
                    if name == "mc_field" and len(args) > 3
                    and args[3] is not None else name)
            first.setdefault(case, _recorded(args))
            count[case] = count.get(case, 0) + 1
            return wrappers[name](*args)
        return call

    for name in names:
        setattr(engine, name, recording(name))
    try:
        for anisotropic in (False, True):
            surface_field(state, cfg, anisotropic)
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


def _same(a, b):
    """(bit-equal, largest absolute difference) of two sides' tensors."""
    return (len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)),
            max(float((x.double() - y.double()).abs().max())
                for x, y in zip(a, b)))


def kernels_ab(first, count, old, variants=None, cases=AB_KERNELS) -> dict:
    """Old, new and each variant's wrapper (``variants``: name -> engine
    module, this tree's wrappers) on every recorded call of ``cases``, in
    turns, beside the library call, each side's bits compared with the old
    tree's (the outputs it had, ``OLD_OUTPUTS``); each side's device time,
    device kernels a call and host profile; ``step_calls`` sums each side's
    times over the step's calls; then, where the step built its list, each
    tree's fill kernel alone, in turns."""
    out = {}
    engines = {"old": old, "new": engine, **(variants or {})}
    for name in cases:
        if name not in first:
            continue
        wrapper = CASE_WRAPPERS.get(name, name)
        adapt = OLD_ARGS.get(wrapper, lambda *a: a)
        mine = {s: _own(first[name]) for s in engines}
        sides = {"old": (getattr(old, OLD_NAMES.get(wrapper, wrapper)),
                         lambda: adapt(*_fresh(mine["old"])))}
        for s, eng in engines.items():
            if s != "old":
                sides[s] = (getattr(eng, wrapper),
                            lambda s=s: _fresh(mine[s]))
        args = mine["new"]
        res = {s: _tensors(fn(*make())) for s, (fn, make) in sides.items()}
        if wrapper in OLD_OUTPUTS:
            res = {s: r[:OLD_OUTPUTS[wrapper]] for s, r in res.items()}
        torch.cuda.synchronize()
        library = LIBRARY[name](*args) if name in LIBRARY else None
        times = {s: [] for s in sides}
        if library is not None:
            times["library"] = []
        for s in [*sides, *reversed(sides)]:
            times[s].append(bench.time_call(*sides[s], REPS))
            if library is not None:
                times["library"].append(bench.time_call(library, tuple,
                                                        REPS))
        same = {s: _same(res["old"], res[s]) for s in sides if s != "old"}
        out[name] = {
            **{f"{s}_ms": sum(v) / len(v) for s, v in times.items()},
            "turns_ms": times,
            **{f"{s}_device": _device_ms(*sides[s]) for s in sides},
            **{f"{s}_host": host_profile(*sides[s], engines[s])
               for s in sides},
            "bit_equal": same["new"][0], "max_abs_diff": same["new"][1],
            "bit_equal_to_old": {s: v[0] for s, v in same.items()}}
    calls = {k: n for k, n in count.items() if k in out}
    out["step_calls"] = {
        "calls": calls,
        **{f"{side}_ms": sum(n * out[k][f"{side}_ms"]
                             for k, n in calls.items())
           for side in engines}}
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


_PROBE = """
#include "{src}"
extern "C" int ab_occupancy(int which, int* regs, int* local, int* blocks,
                            int* smem) {{
  const void* fns[] = {{{fns}}};
  const int threads[] = {{{threads}}};
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fns[which]);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fns[which],
                                                    threads[which], 0));
}}
"""


def occupancy(eng, kernels) -> dict:
    """case -> {registers, local_bytes, blocks_per_sm, shared_bytes} of the
    kernel of each case of ``kernels`` (``OCCUPANCY``, ``OLD_OCCUPANCY`` or
    their ``--surface`` forms), for the tree of the engine module ``eng``:
    a probe that includes the tree's own source, built with its own flags
    (the same machine code as its library), asks the runtime at the
    kernel's threads a block.  A probe that does not build gives its error
    instead."""
    names = list(kernels)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted({kernels[n][0] for n in names}):
            mine = [n for n in names if kernels[n][0] == src]
            cu, lib = Path(tmp) / f"probe_{src}", Path(tmp) / f"{src}.so"
            cu.write_text(_PROBE.format(
                src=eng.SRC_DIR / src, fns=", ".join(
                    f"(const void*){kernels[n][1]}" for n in mine),
                threads=", ".join((kernels[n] + ("kBlock",))[2]
                                  for n in mine)))
            run = subprocess.run([eng._nvcc(), *eng.NVCC_FLAGS, "-o",
                                  str(lib), str(cu)], capture_output=True,
                                 text=True)
            if run.returncode != 0:
                out.update({n: {"not measured": run.stderr[-2000:]}
                            for n in mine})
                continue
            probe = ctypes.CDLL(str(lib))
            for k, n in enumerate(mine):
                v = [ctypes.c_int(-1) for _ in range(4)]
                rc = probe.ab_occupancy(k, *map(ctypes.byref, v))
                out[n] = ({"registers": v[0].value, "local_bytes": v[1].value,
                           "blocks_per_sm": v[2].value,
                           "shared_bytes": v[3].value} if rc == 0
                          else {"not measured": f"CUDA error {rc}"})
    return out


def _sass(lib: Path) -> dict:
    """function name -> its machine code (``cuobjdump -sass``, the
    addresses and encodings stripped)."""
    text = subprocess.run(["cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            out[name] = []
        elif name is not None and "/*" in line:
            code = line.split("*/", 1)[-1].split("/*", 1)[0].strip()
            if code:
                out[name].append(code)
    return out


def sass_changes(old, new) -> dict:
    """Per kernel source of this tree (``libwcsph_<source>_*.so``, each
    tree's newest build of it): the kernels whose machine code differs
    between the two trees, and how many are the same; or why it is not
    measured."""
    def newest(eng, stem):
        libs = sorted(eng.BUILD_DIR.glob(f"{stem}_*.so"),
                      key=lambda p: p.stat().st_mtime)
        if not libs:
            raise FileNotFoundError(f"no {stem} in {eng.BUILD_DIR}")
        return libs[-1]

    out = {}
    for src in sorted(new.SRC_DIR.glob("*.cu")):
        stem = f"libwcsph_{src.stem}"
        try:
            a, b = _sass(newest(old, stem)), _sass(newest(new, stem))
        except (OSError, subprocess.CalledProcessError) as e:
            out[stem] = {"not measured": str(e)}
            continue
        out[stem] = {"differ": sorted(k for k in a.keys() | b.keys()
                                      if a.get(k) != b.get(k)),
                     "same": sum(a.get(k) == b.get(k) for k in b)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path,
                    help="root of an unpacked older tree")
    ap.add_argument("--variant", action="append", default=[], type=Path,
                    help="root of another tree whose AB_KERNELS are timed "
                         "beside (kernels only); repeat for more")
    ap.add_argument("--surface", action="store_true",
                    help="measure the surface reconstruction's kernels "
                         "(SURFACE_CASES) in place of AB_KERNELS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wcsph_tpu_torch.ab_list measures the CUDA device; "
                         "torch.cuda.is_available() is False")
    card = bench.card_info()
    print(json.dumps({"card": card}), flush=True)
    old = old_engine(args.old.resolve())
    variants = {v.resolve().name: old_engine(
        v.resolve(), f"_ab_{k}_wcsph_tpu_torch")
        for k, v in enumerate(args.variant)}
    trees = {"old": old, "new": engine, **variants}
    for eng in trees.values():
        eng.library()
    probes = ((SURFACE_OLD_OCCUPANCY, SURFACE_OCCUPANCY) if args.surface
              else (OLD_OCCUPANCY, OCCUPANCY))
    print(json.dumps({"card": card, "occupancy": {
        s: occupancy(eng, probes[0] if s == "old" else probes[1])
        for s, eng in trees.items()},
        "sass_changes": sass_changes(old, engine)}), flush=True)

    paths = bench.flagship_paths(SIDE)
    (surface_ab if args.surface else solvers_ab)(paths, old, variants, card)
    steps_ab(args.old, card)


def jittered_positions(state, r):
    """The state's positions with every liquid one moved by a numpy-seeded
    uniform +-JITTER r."""
    nl = state.n_liquid
    jitter = np.random.RandomState(SEED).uniform(-JITTER * r, JITTER * r,
                                                 (3, nl))
    pos = state.pos.clone()
    pos[:, :nl] += torch.as_tensor(jitter.astype(np.float32),
                                   device=state.pos.device)
    return pos


def solvers_ab(paths, old, variants, card):
    """Step 1: the wrappers of ``AB_KERNELS`` on the calls one step of each
    path of ``AB_SOLVERS`` makes, after 4 steps, at rest and jittered,
    through ``kernels_ab``."""
    for path in AB_SOLVERS:
        solver, over = paths[path]
        sim = bench.build_sim(SIDE, "cuda", solver, **over)
        for _ in range(4):
            sim.step()
        state = sim.state
        jittered = jittered_positions(state, sim.cfg.particle_radius)
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
            res = kernels_ab(first, count, old, variants)
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


def surface_field_ms(state, cfg, engines, reps: int = 10) -> dict:
    """Each tree's whole ``surface_field`` of the state, plain and
    anisotropic (the bin, the density sweep, the anisotropy, the field,
    and whatever host work and reads its tree does between them), ms a
    call between CUDA events, in turns (the trees, then backwards)."""
    fns = {s: importlib.import_module(eng.__name__.rsplit(".", 1)[0]
                                      + ".surface.reconstruction"
                                      ).surface_field
           for s, eng in engines.items()}
    out = {s: {"plain": [], "anisotropic": []} for s in fns}
    for s in [*fns, *reversed(fns)]:
        for label, aniso in (("plain", False), ("anisotropic", True)):
            out[s][label].append(bench.time_call(
                fns[s], lambda aniso=aniso: (state, cfg, aniso), reps))
    return out


def surface_ab(paths, old, variants, card):
    """Step 1 with ``--surface``: the surface wrappers' recorded calls on
    the ``SURFACE_PATH`` state after 4 steps, at rest and jittered, through
    ``kernels_ab``; each tree's whole ``surface_field`` in turns; then each
    tree's neighbour list of the moments' grid (offsets and fill from the
    density sweep's count), device time."""
    solver, over = paths[SURFACE_PATH]
    sim = bench.build_sim(SIDE, "cuda", solver, **over)
    for _ in range(4):
        sim.step()
    state, cfg = sim.state, sim.cfg
    for scene, pos in (("at rest", state.pos),
                       ("jittered", jittered_positions(
                           state, cfg.particle_radius))):
        st = state.replace(pos=pos)
        first, count = record_surface(st, cfg)
        grid = first["aniso_moments"][0]
        if int(grid.cell_start[-1]) != st.n_total:
            raise AssertionError(f"{scene}: a particle left the domain")
        res = kernels_ab(first, count, old, variants, SURFACE_CASES)
        stage = surface_field_ms(st, cfg, {"old": old, "new": engine,
                                           **variants})
        _, cnt = engine.density(grid)
        need = int(engine.nbr_list_fill(grid, cnt).need)
        lists = {"slots": need}
        for side, eng in (("old", old), ("new", engine)):
            slots = ListSlots(need)
            lists[f"{side}_device"] = _device_ms(
                eng.nbr_list_fill, lambda eng=eng, slots=slots: (
                    grid, cnt, slots))
        print(json.dumps({
            "surface": SURFACE_PATH, "scene": scene, "rows": grid.n,
            "cells": cfg.num_cells, "card": card, "kernels": res,
            "surface_field_ms": stage,
            # a list walk of the moments would add at least this
            "list_of_this_grid": lists}), flush=True)
        del first, grid
    del sim, state
    torch.cuda.empty_cache()


def steps_ab(old_root: Path, card):
    """Step 2: both trees' paths in child processes, in turns."""
    # each child imports the package of its own working directory
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with tempfile.TemporaryDirectory() as tmp:
        kept = {"old": Path(tmp) / "old", "new": Path(tmp) / "new"}
        for tree, root in (("old", old_root), ("new", Path.cwd()),
                           ("new", Path.cwd()), ("old", old_root)):
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
