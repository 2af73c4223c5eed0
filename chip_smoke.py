#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wcsph_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  Imports
torch, numpy and ``wcsph_tpu_torch`` only (no JAX).  Phases, each printing
its own lines and raising on failure:

0. device: torch.cuda must be available; the card's name and power limit
   (nvidia-smi), torch and CUDA versions;
1. build: compile the kernels of ``wcsph_tpu_torch/csrc`` with nvcc;
2. each kernel against its plain PyTorch twin on the card, at the shapes
   of a squeezed side-24 dam break with a converging velocity and
   numpy-seeded k / S fields;
3. whole steps: the 20-step golden scene on CUDA against
   ``tests/golden/dfsph_golden.npz``, and 3 steps of the pressurized
   side-8 scene with the kernels against the plain twins on the card
   (per-step iteration counts equal);
4. the main path: DFSPH dam break at side 100 (1M liquid particles),
   warm-up steps, launch counters reset, timed steps, health check, every
   kernel launched; then each kernel's time beside its plain twin's at the
   main path's shapes.

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
GOLDEN = os.path.join(HERE, "tests", "golden", "dfsph_golden.npz")

# The main path: bench.py's flagship dam break (side 100 = 1M liquid
# particles), warm-up steps, then the timed steps.
MAIN_SIDE = 100
MAIN_WARMUP = 3
MAIN_STEPS = 10

# Tolerances of the kernel-vs-plain checks, as max|kernel - plain| /
# max|plain| per output field (a vector field counts as one: a component
# whose exact value is ~0, such as the stretch term of a converging velocity
# field, is rounding noise of the size of its neighbours' terms).  Every
# pair term rounds the same way in both (same formulas, the library is
# built with -fmad=false); only the summation order differs: the kernel
# adds a receiver's ~40 terms in neighbour order, the plain twin's
# index_add_ on the card in arbitrary (atomic) order.
TOL_SWEEP = 1e-5     # one sweep: a few float32 ulps of the largest term
TOL_FUSED = 1e-4     # K2-K4 chain a second sweep / global sums on the first
                     # sweep's order-dependent rounding


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
    k and S fields."""
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
    return dict(
        dt=dt, vel=vel.contiguous(), rho=rho,
        rinv=engine.rho_inv(rho).contiguous(),
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
    value), tolerance) for every kernel of the path, K3 in both modes.
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
        if name == "k1_density_alpha_drho":
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


def time_call(fn, make_args, reps):
    """Mean ms of fn(*make_args()) over reps launches, each between CUDA
    events (operands re-made, untimed, before every call)."""
    import torch

    fn(*make_args())
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        args = make_args()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def time_kernels(grid, cases, reps_kernel=20, reps_plain=5):
    """(kernel ms, plain ms) per kernel (K3 timed in mode 1, the pressure
    iteration, which the main path runs most)."""
    from wcsph_tpu_torch import engine

    saved = dict(engine.LAUNCHES)
    times = {}
    for name, label, make, _, _ in cases:
        if label == "mode 0":
            continue
        times[name] = (time_call(getattr(engine, name), make, reps_kernel),
                       time_call(engine.KERNELS[name][2], make, reps_plain))
        log(f"  {name}: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms (M={grid.n})")
    engine.LAUNCHES.update(saved)     # timing launches are not main-path
    return times


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
    cfg = default_config("dfsph", particle_radius=r, domain_min=lo,
                         domain_max=hi)
    sim = Simulation(sc, cfg, device=dev)     # resolves the boundary volume
    grid = build_grid(sim.state.pos, sc.n_liquid, sim.cfg)
    log(f"[phase 2] side {side} squeezed 0.92: M={grid.n} rows, "
        f"{grid.n_liquid} liquid")
    chk = KernelCheck()
    cases = kernel_cases(grid, kernel_inputs(
        grid, sc.positions[: sc.n_liquid], np.random.RandomState(0)))
    check_kernels(grid, cases, chk)
    log("[phase 2] every kernel agrees with its plain twin")

    # ---- phase 3: whole steps -------------------------------------------
    ref = np.load(GOLDEN)
    from wcsph_tpu_torch import dam_break

    gsc = dam_break(particle_radius=r, fluid_dims=(5, 5, 5), box_extent=0.55)
    glo, ghi = gsc.domain(pad=4 * r)
    gsim = Simulation(gsc, default_config(
        "dfsph", particle_radius=r, domain_min=glo, domain_max=ghi),
        device=dev)
    gsim.run(20)
    np.testing.assert_allclose(gsim.state.pos.cpu().numpy(), ref["pos"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gsim.state.vel.cpu().numpy(), ref["vel"],
                               rtol=2e-3, atol=2e-4)
    assert abs(float(gsim.state.dt) - float(ref["dt"])) < 1e-6
    assert gsim.state.diag.pressure_iters == int(ref["pressure_iters"])
    dpos = np.abs(gsim.state.pos.cpu().numpy() - ref["pos"]).max()
    log(f"[phase 3] golden 20 steps on CUDA within golden tolerances "
        f"(max|dpos|={dpos:.2e})")

    psc = squeezed_dam_break(8, 0.92, box_extent=0.9)
    plo, phi = psc.domain(pad=4 * r)
    pcfg = default_config("dfsph", particle_radius=r, domain_min=plo,
                          domain_max=phi)
    traces = []
    for use_plain in (False, True):
        psim = Simulation(psc, pcfg, device=dev)
        psim.state = psim.state.replace(vel=torch.as_tensor(
            converging_velocity(psc.positions[: psc.n_liquid]), device=dev))
        iters = []
        with engine.plain_twins() if use_plain else contextlib.nullcontext():
            for _ in range(3):
                psim.step()
                dg = psim.state.diag
                iters.append((dg.divergence_iters, dg.pressure_iters,
                              dg.viscosity_iters))
        traces.append((iters, float(psim.state.kappa_v.abs().max()),
                       psim.state.pos.cpu().numpy()))
    log(f"[phase 3] pressurized side 8, (div, pressure, visc) iters per "
        f"step: kernels {traces[0][0]}, plain {traces[1][0]}")
    if traces[0][0] != traces[1][0]:
        raise AssertionError("pressurized scene: iteration counts differ")
    np.testing.assert_allclose(traces[0][2], traces[1][2], rtol=2e-4,
                               atol=2e-5)

    # ---- phase 4: the main path ------------------------------------------
    t0 = time.perf_counter()
    msim = bench.build_sim(MAIN_SIDE, dev)
    build_s = time.perf_counter() - t0
    log(f"[phase 4] side {MAIN_SIDE}: {msim.state.n_liquid} liquid + "
        f"{msim.state.n_solid} boundary, grid {msim.cfg.grid_res} = "
        f"{msim.cfg.num_cells} cells, scene+setup {build_s:.1f} s")
    res = bench.measure(msim, MAIN_WARMUP, MAIN_STEPS)
    launches = res["launches"]
    tel = res["telemetry"]
    log(f"[phase 4] {res['particle_steps_per_s']:.6e} particle-steps/s "
        f"({res['steps']} steps in {res['elapsed_s']:.3f} s, warm-up "
        f"{res['warmup_s']:.1f} s; step ms median "
        f"{statistics.median(res['step_ms']):.3f} max "
        f"{max(res['step_ms']):.3f}) on {card}; (div, pressure, visc) iters "
        f"{res['iters']}; overflow {tel['neighbor_overflow']}; "
        f"vel_max {tel['vel_max']:.3f}; dt {tel['dt']:.3e}")
    log(f"[phase 4] launches {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    if tel["neighbor_overflow"] != 0:
        raise AssertionError("overflow != 0")
    # each kernel against its plain twin again, and timed beside it, at
    # the main path's shapes (the rows of the last step's grid)
    mgrid = build_grid(msim.state.pos, msim.state.n_liquid, msim.cfg)
    t0 = time.perf_counter()
    dense_ops.pairs_of(mgrid)
    torch.cuda.synchronize()
    log(f"[phase 4] plain pair list: {int(mgrid.pairs.i.shape[0])} directed "
        f"pairs, built in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    liq_pos = msim.state.pos[:, : msim.state.n_liquid].T.cpu().numpy()
    cases = kernel_cases(mgrid, kernel_inputs(mgrid, liq_pos,
                                              np.random.RandomState(1)))
    check_kernels(mgrid, cases, chk)
    log(f"[phase 4] every kernel agrees with its plain twin at M={mgrid.n}")
    times = time_kernels(mgrid, cases)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": chk.max_abs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep, _) in engine.KERNELS.items()],
        "card": card,
        "main_path": {"particle_steps_per_s": res["particle_steps_per_s"],
                      "n_liquid": res["n_liquid"], "iters": res["iters"],
                      "step_ms": res["step_ms"]}}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
