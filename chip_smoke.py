#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wcsph_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  Imports
torch, numpy and ``wcsph_tpu_torch`` only (no JAX).  Phases, each printing
its own lines and raising on failure:

0. device: torch.cuda must be available; the card's name and power limit
   (nvidia-smi), torch and CUDA versions;
1. build: compile the kernels of ``wcsph_tpu_torch/csrc`` with nvcc (one
   nvcc per source, in parallel);
2. each kernel (K1-K8, every entry point) against its plain PyTorch twin on
   the card, at the shapes of a squeezed side-24 dam break with a
   converging velocity, numpy-seeded k / S / pressure fields, tension and
   adhesion on; first the neighbour list that K2, K3, K4, ``k1_div_acc``
   and ``k1_vorticity`` walk: the fill kernel's list and its per-row
   records equal the plain build bit for bit, and those five raise on a
   grid without one;
3. whole steps: the 20-step golden scene of each of the four solvers on
   CUDA against ``tests/golden/<solver>_golden.npz``, and 3 steps of the
   pressurized side-8 scene, per solver and for DFSPH with tension, with
   the kernels against the plain twins on the card (per-step iteration
   counts equal);
4. the paths at full width, a dam break at side 100 (1M liquid particles):
   DFSPH (the first slice's main path), then SESPH, PCISPH, IISPH and DFSPH
   with surface tension; for each, warm-up steps, launch counters reset,
   timed steps, health check, overflow 0, every kernel of the path
   launched (the list fill once per DFSPH and IISPH step); then the list
   and each kernel against its plain twin again and timed beside it at
   those shapes, with the least time the card could take for the same work
   (``bound_ms``).

The line before the last is one JSON object with the per-kernel record;
the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before those lines are printed.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "golden")
SOLVERS = ("dfsph", "sesph", "pcisph", "iisph")

# The paths at full width: bench.py's flagship dam break (side 100 = 1M
# liquid particles), warm-up steps, then the timed steps.
MAIN_SIDE = 100
MAIN_WARMUP = 3
MAIN_STEPS = 10

# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory
# rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

# Tolerances of the kernel-vs-plain checks, as max|kernel - plain| /
# max|plain| per output field (a vector field counts as one: a component
# whose exact value is ~0, such as the stretch term of a converging velocity
# field, is rounding noise of the size of its neighbours' terms).  Every
# pair term rounds the same way in both (same formulas, the library is
# built with -fmad=false); only the summation order differs: the kernel
# adds a receiver's ~40 terms in neighbour order, the plain twin's
# index_add_ on the card in arbitrary (atomic) order.
TOL_SWEEP = 1e-5     # one sweep: a few float32 ulps of the largest term
TOL_FUSED = 1e-4     # K2-K4 and K6-K8 chain a second sweep / global sums
                     # on the first sweep's order-dependent rounding


def log(*a):
    print(*a, flush=True)


def squeezed_dam_break(side, squeeze, box_extent, r=0.025):
    """Dam break with the liquid block squeezed toward its centroid
    (tests/test_engine.py:_squeezed_dam_break)."""
    from wcsph_tpu_torch import dam_break

    sc = dam_break(particle_radius=r, fluid_dims=(side,) * 3,
                   box_extent=box_extent)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
    return sc


def converging_velocity(liq_pos):
    """v = -10 (x - centroid) for (n_liquid, 3) positions, planar (3, n)."""
    return (-10.0 * (liq_pos - liq_pos.mean(axis=0, keepdims=True))).T.astype(
        np.float32)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain twin
# ---------------------------------------------------------------------------

class KernelCheck:
    def __init__(self):
        self.max_abs = {}

    def close(self, name, got, want, tol, what=""):
        got = got.float()
        want = want.float()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 0.0
        rel = err / scale if scale > 0 else err
        log(f"  {name}{what}: max|d|={err:.3e} max|plain|={scale:.3e} "
            f"rel={rel:.3e} (tol {tol:g})")
        if not np.isfinite(rel) or rel > tol:
            raise AssertionError(f"{name}{what}: kernel disagrees with its "
                                 f"plain twin, rel {rel:.3e} > {tol:g}")
        self.max_abs[name] = max(self.max_abs.get(name, 0.0), err)
        return scale


def kernel_inputs(grid, liq_pos, rng):
    """Realistic operands at the grid's shapes: the converging velocity
    around ``liq_pos``, the density sweep's rho / alpha / count, seeded
    k, S and pressure fields, IISPH's advection coefficients of that
    velocity, and a compressed right-hand side (so that the Jacobi update
    leaves positive pressures and its residual sum does not cancel)."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import pack
    from wcsph_tpu_torch.kernels import cubic_w0

    dev = grid.device
    cfg = grid.cfg
    m = grid.n
    liq = grid.liq

    def seeded(*shape, scale=1.0):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32) * scale,
                               device=dev)

    vel = pack(grid, [torch.as_tensor(converging_velocity(liq_pos),
                                      device=dev)])[0]
    raw = dense_ops.density_alpha_drho(grid, vel)
    rho = cfg.rest_density * (cfg.liquid_volume * cubic_w0(
        cfg.support_radius) + raw[0])
    den = raw[5] + raw[2] ** 2 + raw[3] ** 2 + raw[4] ** 2
    alpha = torch.where(den > cfg.eps, -1.0 / den, 0.0) * liq
    cnt = raw[1]
    dt = np.float32(1e-3)
    drho = torch.where(cnt < cfg.min_div_neighbors, 0.0,
                       torch.clamp(raw[6], min=0.0))
    adv = torch.clamp(rho / cfg.rest_density + float(dt) * raw[6], min=1.0)
    press = (seeded(m, scale=1e3).abs() * liq).contiguous()
    rinv = engine.rho_inv(rho).contiguous()
    ia = dense_ops.iisph_adv(grid, vel)
    den_i2 = (rho / cfg.rest_density) ** 2
    dii = (ia[0:3] * ((cfg.rest_density / rho) ** 2)[None]).contiguous()
    deninv = (cfg.liquid_volume / den_i2).contiguous()
    return dict(
        p=press, rr=(rho / cfg.rest_density).contiguous(),
        pi=(press * rinv * rinv).contiguous(),
        ril=(liq * rinv).contiguous(),
        dii=dii, deninv=deninv,
        aii=(dense_ops.iisph_aii(grid, dii) - deninv * ia[4]).contiguous(),
        b=(-(0.01 + 0.01 * seeded(m).abs()) * liq).contiguous(),
        dpi=(press / den_i2).contiguous(),
        factor=np.float32(1e5),
        dt=dt, vel=vel.contiguous(), rho=rho.contiguous(), rinv=rinv,
        om=(seeded(3, m, scale=0.1) * liq).contiguous(),
        kf=(seeded(m, scale=1e-2) * liq).contiguous(),
        gate=(liq * torch.as_tensor(rng.rand(m) > 0.3, device=dev)).float()
        .contiguous(),
        s0=(drho + seeded(m, scale=0.1).abs() * liq).contiguous(),
        s1=(adv + seeded(m, scale=1e-3).abs() * liq).contiguous(),
        a0=(alpha / float(dt)).contiguous(),
        a1=(alpha / float(dt * dt)).contiguous(),
        paux0=(cnt >= cfg.min_div_neighbors).float().contiguous(),
        # seeded compression, so the mode-1 clamp at 1 is not everywhere
        paux1=(rho / cfg.rest_density
               + seeded(m, scale=1e-2).abs() * liq).contiguous(),
        kv=(seeded(m) * liq).contiguous(),
        r=(seeded(3, m) * liq).contiguous(),
        d=(seeded(3, m) * liq).contiguous(),
    )


def kernel_cases(grid, inp):
    """(wrapper name, label, make operands, outputs of (operands, return
    value), tolerance) for every kernel entry, K3 in both modes.
    ``make`` returns fresh copies of what a call updates in place."""
    import torch

    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.utils import mat3

    dt = inp["dt"]
    x = (inp["vel"] + inp["r"] * 0.01).contiguous()
    minv, _ = engine.visc_init(grid, x, inp["rho"], dt)
    minv6 = torch.stack(list(minv)).contiguous()
    delta = torch.sum(inp["r"] * mat3.Sym3(*minv6).matvec(inp["r"]))

    def fields(*sizes):
        """Split a sweep's (k, M) output into its fields (scalars and
        3- or 6-component vectors); each is compared as a whole."""
        return lambda a, r: list(torch.split(r, sizes))

    def k3(mode):
        return ("k3_fused_iter_full", f"mode {mode}",
                lambda: (grid, inp["vel"].clone(), inp["kv"].clone(),
                         inp[f"s{mode}"].clone(), inp[f"a{mode}"],
                         inp[f"paux{mode}"], dt, mode),
                lambda a, r: [a[1], a[2], a[3], r.reshape(1)], TOL_FUSED)

    return [
        ("k1_density_alpha_drho", "", lambda: (grid, inp["vel"]),
         fields(1, 1, 3, 1, 1), TOL_SWEEP),
        ("k1_div_acc", "", lambda: (grid, inp["vel"]),
         lambda a, r: [r], TOL_SWEEP),
        ("k1_visc_init", "", lambda: (grid, x, inp["rinv"]), fields(6, 3),
         TOL_SWEEP),
        ("k1_vorticity", "", lambda: (grid, inp["vel"], inp["om"],
                                      inp["rinv"]), fields(3, 3, 3),
         TOL_SWEEP),
        ("k2_fused_kappa_drho", "",
         lambda: (grid, inp["vel"].clone(), inp["kf"], inp["gate"],
                  torch.empty(grid.n, device=grid.device)),
         lambda a, r: [a[1], a[4]], TOL_FUSED),
        k3(0),
        k3(1),
        ("k4_fused_visc_iter", "",
         lambda: (grid, x.clone(), inp["r"].clone(), inp["d"].clone(),
                  delta, inp["rinv"], minv6, dt),
         lambda a, r: [a[1], a[2], a[3], r], TOL_FUSED),
        ("k5_density_alpha", "", lambda: (grid,), fields(1, 1), TOL_SWEEP),
        ("k5_sesph_force", "",
         lambda: (grid, inp["vel"], inp["rinv"], inp["rr"], inp["pi"],
                  inp["p"]), lambda a, r: [r], TOL_SWEEP),
        ("k5_iisph_adv", "", lambda: (grid, inp["vel"]), fields(3, 1, 1),
         TOL_SWEEP),
        ("k5_iisph_aii", "", lambda: (grid, inp["dii"]), lambda a, r: [r],
         TOL_SWEEP),
        ("k5_iisph_force", "", lambda: (grid, inp["dpi"]), lambda a, r: [r],
         TOL_SWEEP),
        ("k6_fused_tension", "", lambda: (grid, inp["ril"], inp["rho"]),
         lambda a, r: list(r), TOL_FUSED),
        ("k7_fused_jacobi_iter", "",
         lambda: (grid, inp["dii"], inp["deninv"], inp["aii"], inp["b"],
                  inp["p"].clone(), dt),
         lambda a, r: [r[0], r[1], a[5], r[2].reshape(1)], TOL_FUSED),
        ("k8_fused_pcisph_iter", "",
         lambda: (grid, inp["vel"], inp["p"].clone(), dt, inp["factor"]),
         lambda a, r: [r[0], r[1], a[2], r[2].reshape(1)], TOL_FUSED),
    ]


def check_kernels(grid, cases, chk):
    """Every kernel on the card against its plain twin, same operands."""
    import torch

    from wcsph_tpu_torch import engine

    saved = dict(engine.LAUNCHES)
    for name, label, make, outs, tol in cases:
        ak = make()
        got = outs(ak, getattr(engine, name)(*ak))
        ap = make()
        want = outs(ap, engine.KERNELS[name][2](*ap))
        if name in ("k1_density_alpha_drho", "k5_density_alpha"):
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"{name}: neighbour counts differ")
            log(f"  {name}: counts equal (max {int(want[1].max())}, "
                f"{int(want[1].sum())} pairs)")
        tag = f"{label} " if label else ""
        scales = [chk.close(name, g, w, tol, f"[{tag}out {c}]")
                  for c, (g, w) in enumerate(zip(got, want))]
        if not max(scales) > 0:
            raise AssertionError(f"{name} {label}: vacuous (all outputs 0)")
    torch.cuda.synchronize()
    engine.LAUNCHES.update(saved)     # check launches are not main-path


def check_list(grid, vel, chk):
    """Build the grid's neighbour list with the fill kernel (kept as
    ``grid.nbr``) from the density kernel's counts and hold it against the
    plain list slot for slot and record for record; returns the counts."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine

    saved = dict(engine.LAUNCHES)
    count = engine.k1_density_alpha_drho(grid, vel)[1].to(torch.int32)
    want = dense_ops.neighbor_list(grid, count)
    got = engine.nbr_list_fill(grid, count)
    torch.cuda.synchronize()
    if not torch.equal(got.off, want.off):
        raise AssertionError("nbr_list_fill: slice offsets differ")
    if not torch.equal(got.idx, want.idx):
        raise AssertionError(
            f"nbr_list_fill: {int((got.idx != want.idx).sum())} of "
            f"{got.idx.numel()} slots differ from the plain list")
    if not torch.equal(got.rec, want.rec):
        raise AssertionError(
            f"nbr_list_fill: {int((got.rec != want.rec).any(1).sum())} of "
            f"{grid.n} records differ from the plain build")
    err = float((got.idx - want.idx).abs().max()) if got.idx.numel() else 0.0
    chk.max_abs["nbr_list_fill"] = max(chk.max_abs.get("nbr_list_fill", 0.0),
                                       err)
    width = got.width
    log(f"  nbr_list_fill: list equals the plain list slot for slot and "
        f"record for record ({grid.n} records): "
        f"{got.idx.numel()} slots ({got.idx.numel() * 4 / 2 ** 20:.1f} MiB) "
        f"over {width.numel()} slices, width max {int(width.max())}, "
        f"{int((got.idx >= 0).sum())} pairs")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    return count


def check_list_required(grid, inp, count):
    """K2, K3, K4, k1_div_acc and k1_vorticity raise on a grid whose step
    built no list, and the fill raises on a count below the pairs within h
    (it would drop a neighbour) rather than leave a short list."""
    import dataclasses

    import torch

    from wcsph_tpu_torch import engine

    bare = dataclasses.replace(grid, nbr=None)
    saved = dict(engine.LAUNCHES)
    try:
        engine.nbr_list_fill(bare, torch.clamp(count - 1, min=0))
    except ValueError as e:
        if "count differs" not in str(e):
            raise
    else:
        raise AssertionError("nbr_list_fill took a count below the pairs")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    m = grid.n
    calls = [("k1_div_acc", (bare, inp["vel"])),
             ("k1_vorticity", (bare, inp["vel"], inp["om"], inp["rinv"])),
             ("k4_fused_visc_iter", (
                 bare, inp["vel"].clone(), inp["r"].clone(),
                 inp["d"].clone(), torch.ones((), device=grid.device),
                 inp["rinv"], torch.ones((6, m), device=grid.device),
                 inp["dt"])),
             ("k2_fused_kappa_drho", (bare, inp["vel"].clone(), inp["kf"],
                                      inp["gate"], inp["kf"].clone())),
             ("k3_fused_iter_full", (bare, inp["vel"].clone(),
                                     inp["kv"].clone(), inp["s1"].clone(),
                                     inp["a1"], inp["paux1"], inp["dt"], 1))]
    for name, args in calls:
        try:
            getattr(engine, name)(*args)
        except ValueError as e:
            if "neighbour list" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on a grid with no list")
    log(f"  {', '.join(name for name, _ in calls)} raise on a grid with no "
        "neighbour list; nbr_list_fill raises on a short count")


def time_kernels(grid, cases, count, reps_kernel=20, reps_plain=5):
    """(kernel ms, plain ms) per kernel (K3 timed in mode 1, the pressure
    iteration, which the main path runs most), and for the list fill
    (the whole wrapper: slice offsets, two host reads, the fill; its plain
    twin's time excludes the pair list it reads)."""
    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.bench import time_call

    saved = dict(engine.LAUNCHES)
    twins = {**engine.KERNELS, **engine.OWN_KERNELS}
    times = {}
    for name, label, make, _, _ in [
            *cases, ("nbr_list_fill", "", lambda: (grid, count), 0, 0)]:
        if label == "mode 0":
            continue
        times[name] = (time_call(getattr(engine, name), make, reps_kernel),
                       time_call(twins[name][2], make, reps_plain))
        log(f"  {name}: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms (M={grid.n})")
    engine.LAUNCHES.update(saved)     # timing launches are not main-path
    return times


# ---------------------------------------------------------------------------
# The least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# name -> (float32 words read per row, words written per row, operations as
# a function of the pair counts P and the rows M[, other words moved as a
# function of P and M]).  Words: the kernel's operand list, each input read
# once and each output written once; scratch that a kernel keeps between
# its own launches is not counted, nor is the neighbour list that K2, K3,
# K4, k1_div_acc and k1_vorticity read (the functions they compute do not
# need it; the fill that writes it, slots and records, has its own row).
# Every sweep also reads the geometry once (positions 3, liquid flag 1,
# cell id 1 per row, and the cell offsets).  Operations: float32 adds,
# multiplies, divides and square roots of the one-sided formula per
# directed pair WITHIN h (not per 27-cell candidate: scanning candidates is
# the implementation's cost), with the pair geometry 8, W 8, gradW factor 7
# (13 for both), taking the outer spline branch; selects and compares are
# not counted.  P["all"]: every pair; P["liq"]: pairs with a liquid
# receiver; P["gate"]: pairs whose receiver passes K2's gate of this run's
# inputs; P["star"]: pairs with a liquid receiver at PCISPH's moved
# positions of this run's inputs; P["slots"]: the slots of the neighbour
# list (int32 words), which the fill writes, with its slice offsets (its
# 4 words per row written are the list's records).
WORK = {
    "k1_density_alpha_drho": (3, 7, lambda P, M: 45 * P["all"]),
    "k1_div_acc": (3, 1, lambda P, M: 26 * P["liq"]),
    "k1_visc_init": (4, 9, lambda P, M: 58 * P["liq"]),
    "k1_vorticity": (7, 9, lambda P, M: 84 * P["liq"]),
    "k2_fused_kappa_drho": (5, 4,
                            lambda P, M: 24 * P["gate"] + 26 * P["liq"]),
    "k3_fused_iter_full": (7, 5, lambda P, M: (27 + 26) * P["liq"] + 10 * M),
    "k4_fused_visc_iter": (16, 9, lambda P, M: 39 * P["liq"] + 60 * M),
    "k5_density_alpha": (0, 2, lambda P, M: 19 * P["all"]),
    "k5_sesph_force": (7, 3, lambda P, M: 59 * P["liq"]),
    "k5_iisph_adv": (3, 5, lambda P, M: 35 * P["liq"]),
    "k5_iisph_aii": (3, 1, lambda P, M: 23 * P["liq"]),
    "k5_iisph_force": (1, 3, lambda P, M: 29 * P["liq"]),
    "k6_fused_tension": (2, 6, lambda P, M: (23 + 62) * P["liq"]),
    "k7_fused_jacobi_iter": (7, 5,
                             lambda P, M: (24 + 48) * P["liq"] + 15 * M),
    "k8_fused_pcisph_iter": (4, 5,
                             lambda P, M: (24 + 35) * P["star"] + 5 * M),
    "nbr_list_fill": (0, 4, lambda P, M: 8 * P["liq"],
                      lambda P, M: P["slots"] + 2 * (-(-M // 32) + 1)),
}


def pair_counts(grid, inp):
    """The directed pairs within h that this run's inputs make each kind
    of sweep evaluate (see WORK)."""
    import torch

    from wcsph_tpu_torch import dense_ops

    p = dense_ops.pairs_of(grid)
    xs = torch.where(grid.liquid[None],
                     grid.pos + inp["vel"] * float(inp["dt"]), grid.pos)
    star = dense_ops.build_pairs(grid, xs)
    return {"all": int(p.i.shape[0]),
            "liq": int(grid.liquid[p.i].sum()),
            "gate": int((inp["gate"][p.i] != 0).sum()),
            "star": int(grid.liquid[star.i].sum()),
            "slots": int(grid.nbr.idx.numel())}


def bounds(grid, counts):
    """name -> (bound ms, "bytes" or "operations") from WORK and the
    card's published peaks."""
    m = grid.n
    geom_words = 5 * m + grid.cfg.num_cells + 1
    out = {}
    for name, (n_in, n_out, ops, *more) in WORK.items():
        words = geom_words + (n_in + n_out) * m
        if more:
            words += more[0](counts, m)
        t_bytes = 4 * words / PEAK_BYTES_PER_S
        t_ops = ops(counts, m) / PEAK_FP32_FLOPS
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


# ---------------------------------------------------------------------------

def main():
    import torch

    # ---- phase 0: device ------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the CUDA card")
    from wcsph_tpu_torch import bench, dense_ops, engine
    from wcsph_tpu_torch.grid import build_grid
    from wcsph_tpu_torch.simulation import Simulation, default_config

    dev = torch.device("cuda")
    card = bench.card_info()
    kind = torch.cuda.get_device_name(0)
    log("[phase 0] card (nvidia-smi name, power.limit):")
    log(card)
    log(f"[phase 0] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device_count "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    engine.library()
    log(f"[phase 1] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for f in sorted(engine.BUILD_DIR.glob("*.ptxas.txt")):
        for line in f.read_text().splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  ptxas: {line.strip()}")

    # ---- phase 2: kernels vs plain twins ----------------------------------
    r = 0.025
    side = 24
    sc = squeezed_dam_break(side, 0.92, box_extent=side * 2 * r * 1.35)
    lo, hi = sc.domain(pad=6 * r)
    # tension, adhesion and the boundary term of the explicit viscosity on,
    # so that no term of a formula is zero
    all_terms = dict(explicit_viscosity_b=0.05)
    cfg = default_config("dfsph", particle_radius=r, domain_min=lo,
                         domain_max=hi, **all_terms,
                         **bench.flagship_paths(side)["dfsph+tension"][1])
    sim = Simulation(sc, cfg, device=dev)     # resolves the boundary volume
    grid = build_grid(sim.state.pos, sc.n_liquid, sim.cfg)
    log(f"[phase 2] side {side} squeezed 0.92: M={grid.n} rows, "
        f"{grid.n_liquid} liquid")
    chk = KernelCheck()
    inp = kernel_inputs(grid, sc.positions[: sc.n_liquid],
                        np.random.RandomState(0))
    count = check_list(grid, inp["vel"], chk)
    check_list_required(grid, inp, count)
    cases = kernel_cases(grid, inp)
    if {c[0] for c in cases} != set(engine.KERNELS):
        raise AssertionError("a kernel entry has no case")
    check_kernels(grid, cases, chk)
    log("[phase 2] every kernel agrees with its plain twin")

    # ---- phase 3: whole steps -------------------------------------------
    from wcsph_tpu_torch import dam_break

    gsc = dam_break(particle_radius=r, fluid_dims=(5, 5, 5), box_extent=0.55)
    glo, ghi = gsc.domain(pad=4 * r)
    for solver in SOLVERS:
        ref = np.load(os.path.join(GOLDEN_DIR, f"{solver}_golden.npz"))
        gsim = Simulation(gsc, default_config(
            solver, particle_radius=r, domain_min=glo, domain_max=ghi),
            solver=solver, device=dev)
        gsim.run(20)
        np.testing.assert_allclose(gsim.state.pos.cpu().numpy(), ref["pos"],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(gsim.state.vel.cpu().numpy(), ref["vel"],
                                   rtol=2e-3, atol=2e-4)
        assert abs(float(gsim.state.dt) - float(ref["dt"])) < 1e-6
        if solver != "sesph":
            assert (gsim.state.diag.pressure_iters
                    == int(ref["pressure_iters"]))
        gsim.check_health()
        dpos = np.abs(gsim.state.pos.cpu().numpy() - ref["pos"]).max()
        log(f"[phase 3] {solver} golden 20 steps on CUDA within golden "
            f"tolerances (max|dpos|={dpos:.2e})")

    pressurized = [(s, {}) for s in SOLVERS] + [
        ("dfsph", dict(tension_coff=0.25, tension_coff_b=0.4,
                       adhesion_center=(0.0, -0.45, 0.0),
                       adhesion_radius=0.3))]
    for solver, over in pressurized:
        psc = squeezed_dam_break(8, 0.90 if solver == "pcisph" else 0.92,
                                 box_extent=0.9)
        plo, phi = psc.domain(pad=4 * r)
        pcfg = default_config(solver, particle_radius=r, domain_min=plo,
                              domain_max=phi, **over)
        traces = []
        for use_plain in (False, True):
            psim = Simulation(psc, pcfg, solver=solver, device=dev)
            if solver == "dfsph":
                psim.state = psim.state.replace(vel=torch.as_tensor(
                    converging_velocity(psc.positions[: psc.n_liquid]),
                    device=dev))
            iters, pmax = [], 0.0
            with (engine.plain_twins() if use_plain
                  else contextlib.nullcontext()):
                for _ in range(3):
                    psim.step()
                    dg = psim.state.diag
                    iters.append((dg.divergence_iters, dg.pressure_iters,
                                  dg.viscosity_iters))
                    pmax = max(pmax, float(psim.state.pressure.abs().max()))
            psim.check_health()
            traces.append((iters, psim.state.pos.cpu().numpy(), pmax))
        tag = solver + (" + tension" if over else "")
        log(f"[phase 3] pressurized side 8, {tag}: (div, pressure, visc) "
            f"iters per step: kernels {traces[0][0]}, plain {traces[1][0]}; "
            f"max|p| over the steps {traces[0][2]:.4g}")
        if traces[0][0] != traces[1][0]:
            raise AssertionError(f"pressurized {tag}: iteration counts "
                                 f"differ")
        np.testing.assert_allclose(traces[0][1], traces[1][1], rtol=2e-4,
                                   atol=2e-5)

    # ---- phase 4: the paths at full width -----------------------------------
    # the kernels each path must launch
    visc = ("k1_visc_init", "k4_fused_visc_iter")
    dfsph_kernels = ("k1_density_alpha_drho", "nbr_list_fill", "k1_div_acc",
                     "k1_vorticity", "k2_fused_kappa_drho",
                     "k3_fused_iter_full") + visc
    must_launch = {
        "dfsph": dfsph_kernels,
        "sesph": ("k5_density_alpha", "k5_sesph_force"),
        "pcisph": ("k5_density_alpha", "k5_sesph_force",
                   "k8_fused_pcisph_iter"),
        "iisph": ("k5_density_alpha", "k5_iisph_adv", "k5_iisph_aii",
                  "k5_iisph_force", "k7_fused_jacobi_iter",
                  "nbr_list_fill") + visc,
        "dfsph+tension": dfsph_kernels + ("k6_fused_tension",),
    }
    paths = bench.flagship_paths(MAIN_SIDE)
    launches = {name: 0 for name in engine.LAUNCHES}
    path_records = {}
    mstate = None
    for path, (solver, over) in paths.items():
        t0 = time.perf_counter()
        msim = bench.build_sim(MAIN_SIDE, dev, solver, **over)
        build_s = time.perf_counter() - t0
        log(f"[phase 4] {path}, side {MAIN_SIDE}: {msim.state.n_liquid} "
            f"liquid + {msim.state.n_solid} boundary, grid "
            f"{msim.cfg.grid_res} = {msim.cfg.num_cells} cells, scene+setup "
            f"{build_s:.1f} s")
        res = bench.measure(msim, MAIN_WARMUP, MAIN_STEPS)
        tel = res["telemetry"]
        log(f"[phase 4] {path}: {res['particle_steps_per_s']:.6e} "
            f"particle-steps/s ({res['steps']} steps in "
            f"{res['elapsed_s']:.3f} s, warm-up {res['warmup_s']:.1f} s; "
            f"step ms median {statistics.median(res['step_ms']):.3f} max "
            f"{max(res['step_ms']):.3f}) on {card}; (div, pressure, visc) "
            f"iters {res['iters']}; density error "
            f"{tel['density_error']:.3e} (pre {tel['density_error_pre']:.3e}"
            f"); overflow {tel['neighbor_overflow']}; vel_max "
            f"{tel['vel_max']:.3f}; dt {tel['dt']:.3e}")
        ran = {k: v for k, v in res["launches"].items() if v}
        log(f"[phase 4] {path}: launches {ran}")
        missing = [k for k in must_launch[path]
                   if res["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"{path} did not launch {missing}")
        if tel["neighbor_overflow"] != 0:
            raise AssertionError(f"{path}: overflow != 0")
        if solver in ("dfsph", "iisph") and res["launches"][
                "nbr_list_fill"] != res["steps"]:
            raise AssertionError(f"{path}: the list fill did not run once "
                                 f"per step")
        for k, v in res["launches"].items():
            launches[k] += v
        path_records[path] = {
            "particle_steps_per_s": res["particle_steps_per_s"],
            "n_liquid": res["n_liquid"], "iters": res["iters"],
            "step_ms": res["step_ms"], "launches": ran}
        if path == "dfsph":
            mstate, mcfg = msim.state, msim.cfg
        del msim
        torch.cuda.empty_cache()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"no full-width path launched {missing}")

    # each kernel against its plain twin again, and timed beside it, at
    # the full-width shapes (the rows of the DFSPH path's last grid, with
    # every term of the formulas switched on as in phase 2)
    mgrid = build_grid(mstate.pos, mstate.n_liquid, mcfg.replace(
        **all_terms, **paths["dfsph+tension"][1]))
    t0 = time.perf_counter()
    dense_ops.pairs_of(mgrid)
    torch.cuda.synchronize()
    log(f"[phase 4] plain pair list: {int(mgrid.pairs.i.shape[0])} directed "
        f"pairs, built in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    liq_pos = mstate.pos[:, : mstate.n_liquid].T.cpu().numpy()
    minp = kernel_inputs(mgrid, liq_pos, np.random.RandomState(1))
    mcount = check_list(mgrid, minp["vel"], chk)
    cases = kernel_cases(mgrid, minp)
    check_kernels(mgrid, cases, chk)
    log(f"[phase 4] the list and every kernel agree with their plain twins "
        f"at M={mgrid.n}")
    times = time_kernels(mgrid, cases, mcount)
    counts = pair_counts(mgrid, minp)
    bound = bounds(mgrid, counts)
    log(f"[phase 4] pairs within h at M={mgrid.n}: {counts}")
    for name, (ms, by) in bound.items():
        log(f"  {name}: bound {ms:.4f} ms by {by}; kernel "
            f"{times[name][0] / ms:.1f}x its bound")

    # no single PyTorch call computes a neighbour sweep over a cell list (or
    # the list itself), so no kernel has a library yardstick
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": chk.max_abs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bound[name][0], "bound_by": bound[name][1],
         "library_ms": None}
        for name, (src, rep, _) in [
            *engine.KERNELS.items(),
            *[(n, (src, "none: " + what, tw))
              for n, (src, what, tw) in engine.OWN_KERNELS.items()]]],
        "card": card, "rows": mgrid.n, "pairs": counts,
        "paths": path_records}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
