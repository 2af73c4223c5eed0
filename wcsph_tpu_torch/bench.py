"""Throughput benchmark of the port: dam break, particle-steps/s.

    python -m wcsph_tpu_torch.bench --side 100 --steps 10 --solver dfsph

Prints ONE JSON line shaped like the JAX package's ``bench.py``:
``{"metric", "value", "unit", "vs_baseline", "config"}``, where ``config``
names the backend, the card, and which stages run hand kernels.  There is
no fallback: a failure exits non-zero with its traceback.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from . import engine
from .scene import dam_break
from .simulation import Simulation, default_config

DEVICE_TRACES = 3    # traces device_ms takes before it gives up

_TORCH = {"bin_sort_offsets": "cuda:bin_cells",
          "pack_unpack": "cuda:pack_rows,unpack_rows",
          "elementwise_and_host_loop_control": "torch"}
_VISC = {"viscosity_setup": "cuda:k1_visc_init",
         "viscosity_iterations": "cuda:k4_fused_visc_iter"}
# Stages of one step, per solver, and what runs them on a CUDA device.
STAGES = {
    "dfsph": {
        "density_alpha_drho": "cuda:k1_density_alpha_drho",
        "neighbor_list": "cuda:nbr_list_offsets,nbr_list_fill",
        "divergence_warm_start": "cuda:k2_fused_kappa_drho",
        "divergence_iterations": "cuda:k3_fused_iter_full",
        "surface_tension_when_on": "cuda:k6_fused_tension",
        **_VISC,
        "vorticity": "cuda:k1_vorticity",
        "advected_density": "cuda:k1_div_acc",
        "pressure_iterations": "cuda:k3_fused_iter_full",
        **_TORCH},
    "sesph": {
        "density": "cuda:k5_density_alpha",
        "viscosity_and_pressure_force": "cuda:k5_sesph_force",
        **_TORCH},
    "pcisph": {
        "density": "cuda:k5_density_alpha",
        "explicit_viscosity": "cuda:k5_sesph_force",
        "prediction_iterations": "cuda:k8_fused_pcisph_iter",
        **_TORCH},
    "iisph": {
        "density": "cuda:k5_density_alpha",
        "neighbor_list": "cuda:nbr_list_offsets,nbr_list_fill",
        **_VISC,
        "advection_coefficients": "cuda:k5_iisph_adv,k5_iisph_aii",
        "jacobi_iterations": "cuda:k7_fused_jacobi_iter",
        "pressure_force": "cuda:k5_iisph_force",
        **_TORCH},
}


def card_info() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_sim(n_side: int, device="cuda", solver: str = "dfsph",
              **cfg_over) -> Simulation:
    """The flagship scene of the JAX package's bench.py: an n_side^3 liquid
    block in a box shell of extent 1.35 x the block, r = 0.025, with the
    solver's default config (and ``cfg_over`` on top)."""
    r = 0.025
    extent = n_side * 2 * r * 1.35
    sc = dam_break(particle_radius=r, fluid_dims=(n_side,) * 3,
                   box_extent=extent)
    lo, hi = sc.domain(pad=6 * r)
    cfg = default_config(solver, particle_radius=r, domain_min=lo,
                         domain_max=hi, **cfg_over)
    return Simulation(sc, cfg, solver=solver, device=device)


def flagship_paths(n_side: int) -> dict:
    """The paths that ``chip_smoke.py`` and ``profile_paths.py`` drive on the
    flagship scene: name -> (solver, config overrides).  The tension path
    takes the coefficients of examples/run_showcase.py:102, with an adhesion
    region that meets the wall: centred on the middle of the box floor,
    under the liquid block."""
    extent = n_side * 2 * 0.025 * 1.35
    tension = dict(tension_coff=0.5, tension_coff_b=0.25,
                   adhesion_center=(0.0, -0.5 * extent, 0.0),
                   adhesion_radius=0.25 * extent)
    return {"dfsph": ("dfsph", {}), "sesph": ("sesph", {}),
            "pcisph": ("pcisph", {}), "iisph": ("iisph", {}),
            "dfsph+tension": ("dfsph", tension)}


def measure(sim: Simulation, warmup: int, steps: int) -> dict:
    """Run ``warmup`` steps, reset the launch counters (and the list
    replays), time ``steps`` steps (host clock around work ending in a
    synchronize, per step and in total)."""
    sync = (torch.cuda.synchronize if sim.device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    for _ in range(warmup):
        sim.step()
    sync()
    warmup_s = time.perf_counter() - t0
    engine.reset_launch_counts()
    iters, step_ms = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        sim.step()
        sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        d = sim.state.diag
        iters.append((d.divergence_iters, d.pressure_iters,
                      d.viscosity_iters))
    elapsed = time.perf_counter() - t0
    launches = dict(engine.LAUNCHES)
    replays = engine.LIST_REPLAYS
    sim.check_health()
    nl = sim.state.n_liquid
    return {"particle_steps_per_s": nl * steps / elapsed,
            "elapsed_s": elapsed, "warmup_s": warmup_s, "steps": steps,
            "n_liquid": nl, "n_total": sim.state.n_total,
            "iters": iters, "launches": launches, "replays": replays,
            "step_ms": step_ms,
            "telemetry": sim.telemetry()}


def time_call(fn, make_args, reps: int) -> float:
    """Mean ms of fn(*make_args()) over reps calls, each between CUDA
    events, after one untimed call (operands re-made, untimed, before
    every call)."""
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


def device_ms(fn, make_args, reps: int):
    """(mean device time, device kernels) of one call ``fn(*make_args())``:
    the time of the kernels it launches summed over them, and their count
    (torch.profiler): the call's work on the card without the host's share
    (``make_args`` runs before the trace).  A trace whose count of device
    events is not a positive whole multiple of ``reps`` missed some (the
    profiler drops one now and then) and is taken again, up to
    ``DEVICE_TRACES`` times; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn(*make_args())
    counts = []
    for _ in range(DEVICE_TRACES):
        calls = [make_args() for _ in range(reps)]
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for args in calls:
                fn(*args)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev and len(dev) % reps == 0:
            return (sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3,
                    len(dev) // reps)
        counts.append(len(dev))
    raise RuntimeError(f"{DEVICE_TRACES} traces of {reps} calls caught "
                       f"{counts} device events: none a whole multiple")


def profile(sim: Simulation, steps: int) -> dict:
    """``steps`` more steps under torch.profiler: device time per kernel
    name, and the device's busy share of its own timeline (kernel time over
    the span from the first kernel's start to the last one's end; tracing
    slows the host, so the share is a lower bound on the untraced one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sim.step()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    span_us = (max(e.time_range.end for e in dev)
               - min(e.time_range.start for e in dev))
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:20]
    return {"steps": steps,
            "device_span_ms_per_step": span_us / steps / 1e3,
            "device_busy_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / span_us,
            "kernels_ms_per_step": [
                (e.key[:60], e.count // steps,
                 e.self_device_time_total / steps / 1e3) for e in top]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=100,
                    help="liquid cube side (100 = 1M particles)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--solver", default="dfsph", choices=sorted(STAGES))
    ap.add_argument("--profile", type=int, default=0,
                    help="after the timed steps, trace this many more under "
                         "torch.profiler and print the device breakdown to "
                         "stderr (not part of the metric)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wcsph_tpu_torch.bench measures the CUDA device; "
                         "torch.cuda.is_available() is False")
    t0 = time.perf_counter()
    sim = build_sim(args.side, "cuda", args.solver)
    build_s = time.perf_counter() - t0
    res = measure(sim, args.warmup, args.steps)
    nl = res["n_liquid"]
    label = ("1M" if nl >= 900_000 else ("100k" if nl >= 90_000 else str(nl)))
    print(f"[bench] {res}", file=sys.stderr)
    if args.profile:
        print(f"[bench] profile {json.dumps(profile(sim, args.profile))}",
              file=sys.stderr)
    value = res["particle_steps_per_s"]
    print(json.dumps({
        "metric": f"{args.solver}_particle_steps_per_sec_{label}",
        "value": value,
        "unit": "particle-steps/s",
        # BASELINE.json's north star, 5e8 particle-steps/s
        "vs_baseline": value / 5.0e8,
        "config": {
            "backend": "torch-cuda",
            "device": torch.cuda.get_device_name(0),
            "card": card_info(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "stages": STAGES[args.solver],
            "iters": res["iters"],
            "overflow": res["telemetry"]["neighbor_overflow"],
            "list_replays": res["replays"],
            "build_s": build_s,
            "kernel_build_s": engine.BUILD_SECONDS,
            "warmup_s": res["warmup_s"],
            "steps": res["steps"],
            "step_ms_median": statistics.median(res["step_ms"]),
            "step_ms_max": max(res["step_ms"]),
        },
    }))


if __name__ == "__main__":
    main()
