#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``wcsph_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card.  Imports
torch, numpy and ``wcsph_tpu_torch`` only (no JAX).  Phases, each printing
its own lines and raising on failure:

0. device: torch.cuda must be available; the card's name and power limit
   (nvidia-smi), torch and CUDA versions;
1. build: compile the kernels of ``wcsph_tpu_torch/csrc`` with nvcc (one
   nvcc per source, in parallel); ptxas's registers of every kernel, and
   one line with those of each list walker's kernels (``LIST_WALKERS``);
2. each kernel (K1-K8, every entry point, K1's seven entries of the
   unfused solver loops too) against its plain PyTorch twin on
   the card, at the shapes of a squeezed side-24 dam break with a
   converging velocity, numpy-seeded k / S / pressure fields, tension and
   adhesion on; first the grid stage, with three particles moved outside
   the domain: the bin's permutation, offsets and rows equal the plain
   stable sort's, and pack and unpack equal their twins; then the
   neighbour list that K2, K3, K4, K6, K7, IISPH's three K5 entries,
   ``k1_div_acc``, ``k1_visc_init``, ``k1_vorticity`` and the unfused
   loops' six list walkers walk: its slice offsets (whole and clamped to
   a short buffer), the fill kernel's list and its per-row records equal
   the plain build bit for bit, a fill into a short buffer is clamped and
   flagged as the twin's, those seventeen raise on a grid without a list,
   and a short count raises at the grid's first read; K8 into a hit
   buffer of the widest row's hits and into one of half that width: its
   hits equal the twin's slot for slot, and both flag the same row count;
   the unfused PCISPH prediction's cut and walk likewise (its kept hits,
   full counts and records as the twin's, the walk at a second pressure
   bit-equal to a cut there, the half width, whose rows of more hits the
   walk scans again, bit-equal to the full width); last the cut sweeps
   (the DFSPH density sweep, K5's density and SESPH-force entries) on a
   block squeezed to 0.6 of its spacing, where receivers have more hits
   than the density sweep's per-thread buffer (``engine.CUT_SLOTS``) and
   so sum it more than once,
   and K5's columns hold several 32-candidate chunks; at side 24 and on
   the 0.6 block the surface kernels (``aniso_moments``, its count bit for
   bit, ``aniso_g`` and ``mc_field`` plain and anisotropic), and on each
   kernel field the device extractor under budgets sized from the field
   against the host extractor: the same triangles, vertices within 1e-5;
3. whole steps: the 20-step golden scene of each of the four solvers on
   CUDA against ``tests/golden/<solver>_golden.npz``, and of DFSPH,
   PCISPH and IISPH again with the unfused loops
   (``fused_solver_iters=False``), and 3 steps of the
   pressurized side-8 scene, per solver and for DFSPH with tension, fused
   and (but SESPH) unfused, with
   the kernels against the plain twins on the card (per-step iteration
   counts equal, and the unfused ones equal to the fused ones); then one
   DFSPH, one PCISPH, one IISPH and one DFSPH
   with tension step with the buffer of the list (PCISPH: of K8's hits)
   forced to 64 slots, which replay once to the unforced bits;
4. the paths at full width, a dam break at side 100 (1M liquid particles):
   DFSPH (the first slice's main path), then SESPH, PCISPH, IISPH and DFSPH
   with surface tension, then DFSPH, PCISPH, IISPH and DFSPH with tension
   with the unfused loops; for each, warm-up steps, launch counters reset,
   timed steps, health check, overflow 0, no list replay, every kernel of
   the path launched (the bin, pack and unpack once per step, the list's
   offsets and fill once per DFSPH and IISPH step); an unfused path
   launches none of K2, K3, K4, K6, K7, K8 and each of K1's unfused entries
   as often as its iterations ask, a fused path none of those entries;
   the unfused PCISPH path one more step with its walks counting the rows
   they scan again (the buffer sized by the first step: expected 0);
   then the step's stage
   from the bin through the filled list (SESPH, PCISPH: through the pack)
   under ``torch.cuda.set_sync_debug_mode("error")``, and the host
   synchronizations of one step counted under ``"warn"`` (an unfused
   step's beyond one an iteration no more than its fused path's; its
   median step beside the fused path's); then the grid
   stage, the list and each kernel against its plain twin again and timed
   beside it at those shapes (the six walks that load slots ahead,
   ``DEEP_WALKS``, and the list they walk also with the liquid jittered;
   every list walker's device time too,
   torch.profiler), with the least time the card could take for
   the same work (``bound_ms``) and, for the grid stage, one PyTorch call
   that computes its core (``library_ms``, and its device time), the
   device time of its own kernels and their count a call (torch.profiler;
   the kernel time is the whole wrapper's), gated at one device kernel a
   call for the pack, the unpack and the list offsets, at most four device
   operations (kernels and memsets) for the bin, and 8, 1, 1 and 0
   allocations a call for the bin, pack, unpack and offsets; and the bin
   at side 24 (particles outside the domain), at 1M and at side 24 again,
   back to back, each equal to its twin bit for bit;
5. surface reconstruction of the DFSPH path's 1M state: ``reconstruct``
   with the host and the device extractor, plain and anisotropic, the
   launch counters reset just before and read just after (the bin, the
   density sweep, ``mc_field`` once a reconstruct, ``aniso_moments`` once
   an anisotropic one, and ``aniso_g`` launched); then the three kernels
   against their plain twins at those shapes (aniso_g's reach too), every
   nonzero term of the plain twin's anisotropic field within its
   candidate's reach (the radius past which the field kernel skips it),
   each field's active cubes and triangles, the device extractor
   under budgets sized from them (nothing dropped, equal to the host
   extractor) and under its default budgets (what they drop, printed), and
   ms a call (CUDA events) of the density sweep, the three kernels and
   their twins, ``torch.linalg.eigh`` of aniso_g's matrices, both
   extractor runs and the whole ``reconstruct(on_device=True)``, the host
   extractor's seconds, the kernels' bounds, and the device time of
   ``mc_field`` (both forms) and ``aniso_moments`` (torch.profiler; one
   device kernel a call, a gate);
6. the mesh-scene tooling: the sampler's phase kernel against its twin
   (``poisson_phase``: the kernel-driven and the twin-driven sampler on the
   showcase's weir tank at r = 0.025, two z-chunks, bit for bit, order
   included) and the rasterizer's (``splat_points`` on the 1M state at
   512x512, radius 3, bit for bit), with the splat's times beside its twin
   and ``scatter_reduce_`` of the same keys; then the showcase path
   (``wcsph_tpu_torch.examples.run_showcase``): its shell sampled on the
   card at r = 0.0125 (12 chunks, 3,240 phase launches), 126,900 liquid
   particles, DFSPH with tension and adhesion for 120 frames x 8 steps, a
   768x512 frame every 10 frames through ``Canvas`` written as PNG under
   out/showcase, one anisotropic reconstruct, the launch counts set to 0
   just before and read just after; gates: the shell within 0.5% of the
   committed shell's 106,734 points, every point within 1e-4 of its face,
   no two points of one face closer than 0.999 r, no NaN, overflow 0, no
   wall leak; the run's numbers beside benchmarks/showcase.json's; then
   the sampler at r = 0.0125 again, whole and its phase launches alone,
   and once more through the twin, which counts the work of the phase
   kernel's bound and must give the same shell;
7. the slab decomposition (``wcsph_tpu_torch.parallel``): the 1M DFSPH
   dam break (3 warm-up + 10 steps) over 4 ranks spawned from here, which
   share the card over gloo (the halo staged through host memory), on the
   one-plane front (``step_slab``, every loop unfused) and on the
   two-plane direct front (``step_slab_direct``, the JAX package's default
   multi-chip step: DFSPH's loops run K2 and K3), in turns (one plane,
   direct, direct, one plane), each gathered state
   against the single-device port over the same steps in the front's loop
   forms (the same iterations at every step, pos within 1e-5 m and vel
   within 1e-4 m/s, no NaN, every particle in one seat, no fused loop
   kernel launched on any rank but, on the direct front, K2 once a step
   and K3 once an iteration, and no ``k1_kappa_acc``), one line a rank
   (own rows, ghost rows and migrants a step, replays, median step ms,
   host synchronizations of a step) and one line a rank with both fronts
   side by side; where the machine has two cards or more, the same over
   NCCL, one rank a card; then at side 24 over 3 ranks, kicked in x so that
   seats migrate: SESPH, PCISPH, IISPH and DFSPH with tension on both
   fronts (seats must cross on the one-plane front; with tension the direct
   front launches K2 and K3, not K6), and the four global-grid sharded
   steps (``halo.*_step_sharded``, every rank holding the same state after
   each step, ``halo.density_sharded`` equal to one device's density bit
   for bit), each against its single-device run (SESPH and PCISPH bit for
   bit).  The times of ranks that share a card are not a scaling figure.

The line before the last is one JSON object with the per-kernel record;
the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before those lines are printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    fac = (-liq * deninv * press).contiguous()
    ril = (liq * rinv).contiguous()
    return dict(
        # the operands of K1's unfused entries, in the JAX methods' form
        fac=fac, dij=dense_ops.iisph_dij(grid, fac).contiguous(),
        p_liq=(liq * press).contiguous(),
        g=(deninv * press).contiguous(),
        normals=(cfg.support_radius
                 * dense_ops.surface_normals(grid, ril)).contiguous(),
        xstar=(grid.pos + torch.where(grid.liquid[None], vel * float(dt),
                                      0.0)).contiguous(),
        p=press, rr=(rho / cfg.rest_density).contiguous(),
        pi=(press * rinv * rinv).contiguous(),
        ril=ril,
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
        # the unfused prediction's second call: another pressure
        p2=(seeded(m, scale=1e3).abs() * liq).contiguous(),
    )


def k8_width(grid, inp):
    """The most hits a row of K8's iteration at these inputs has (the plain
    twin's, on a copy of the grid); the unfused prediction's cut at
    ``inp["xstar"]``, the same moved positions, has the same."""
    import dataclasses

    from wcsph_tpu_torch import dense_ops

    g = dataclasses.replace(grid, star=None)
    dense_ops.fused_pcisph_iter(g, inp["vel"], inp["p"].clone(), inp["dt"],
                                inp["factor"])
    return g.star.width


def kernel_cases(grid, inp):
    """(wrapper name, label, make operands, outputs of (operands, return
    value), tolerance) for every kernel entry, K3 in both modes, K8 and the
    unfused prediction's cut into a hit buffer of the widest row's hits,
    the walk over the hits of a cut there at a second pressure.  ``make``
    returns fresh copies of what a call updates in place."""
    import torch

    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.grid import ListSlots
    from wcsph_tpu_torch.utils import mat3

    dt = inp["dt"]
    width = k8_width(grid, inp)
    hits = ListSlots(width * grid.n)
    saved = dict(engine.LAUNCHES)
    cut = engine.k1_pcisph_predict(grid, inp["xstar"], inp["p"],
                                   ListSlots(width * grid.n))[1]
    engine.LAUNCHES.update(saved)     # check launches are not main-path
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
         lambda: (grid, inp["vel"], inp["p"].clone(), dt, inp["factor"],
                  hits),
         lambda a, r: [r[0], r[1], a[2], r[2].reshape(1)], TOL_FUSED),
        # K1's emits that the unfused solver loops run alone: one sweep each
        ("k1_kappa_acc", "", lambda: (grid, inp["kf"]), lambda a, r: [r],
         TOL_SWEEP),
        ("k1_visc_acc", "", lambda: (grid, inp["d"], inp["rinv"]),
         lambda a, r: [r], TOL_SWEEP),
        ("k1_pcisph_predict", "",
         lambda: (grid, inp["xstar"], inp["p"], hits),
         lambda a, r: list(torch.split(r[0], (1, 3))), TOL_SWEEP),
        ("k1_pcisph_walk", "", lambda: (grid, inp["xstar"], inp["p2"], cut),
         fields(1, 3), TOL_SWEEP),
        ("k1_iisph_dij", "", lambda: (grid, inp["fac"]), lambda a, r: [r],
         TOL_SWEEP),
        ("k1_iisph_s", "",
         lambda: (grid, inp["dii"], inp["dij"], inp["p_liq"], inp["g"]),
         lambda a, r: [r], TOL_SWEEP),
        ("k1_surface_normals", "", lambda: (grid, inp["ril"]),
         lambda a, r: [r], TOL_SWEEP),
        ("k1_tension_accel", "",
         lambda: (grid, inp["rho"], inp["normals"]), lambda a, r: [r],
         TOL_SWEEP),
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
    if (int(got.need) != int(want.need) or int(got.flag) != 0
            or int(want.flag) != 0):
        raise AssertionError("nbr_list_fill: need or flag differ")
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


# The list walks that take a depth above 1 (kKappaDepth, kViscDepth in
# csrc/sweeps.cu; the kDepth of the unfused IISPH and tension emits in
# csrc/solver_sweeps.cu), held to their twins once more on the 1M state with
# every liquid position jittered by a numpy-seeded uniform +-JITTER r:
# ragged slot counts a row run the tail of each group of slots the walk
# loads ahead
DEEP_WALKS = ("k1_kappa_acc", "k1_visc_acc", "k1_iisph_dij", "k1_iisph_s",
              "k1_surface_normals", "k1_tension_accel")
JITTER = 0.3


def check_jittered_walks(state, cfg, chk, rng):
    """DEEP_WALKS against their twins (``check_kernels``, TOL_SWEEP) on the
    grid of ``state`` with its liquid positions jittered, on seeded k, d,
    1 / rho, IISPH's fac, dii, dij, p_liq and g, and the tension's rho, ril
    = liq / rho and h-scaled normals, after the fill's list of that grid is
    held to the plain list (``check_list``)."""
    import torch

    from wcsph_tpu_torch.grid import build_grid

    nl, r = state.n_liquid, cfg.particle_radius
    pos = state.pos.clone()
    pos[:, :nl] += torch.as_tensor(
        rng.uniform(-JITTER * r, JITTER * r, (3, nl)).astype(np.float32),
        device=pos.device)
    grid = build_grid(pos, nl, cfg)
    if int(grid.cell_start[-1]) != state.n_total:
        raise AssertionError("jittered 1M state: a particle left the domain")
    check_list(grid, torch.zeros_like(grid.pos), chk)
    m, liq = grid.n, grid.liq

    def seeded(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=pos.device)

    k = (seeded(m) * 1e-2 * liq).contiguous()
    d = (seeded(3, m) * liq).contiguous()
    rinv = torch.as_tensor((1.0 / rng.uniform(950.0, 1050.0, m))
                           .astype(np.float32), device=pos.device)
    fac = (seeded(m) * liq).contiguous()
    dii = (seeded(3, m) * liq).contiguous()
    dij = (seeded(3, m) * liq).contiguous()
    p_liq = (seeded(m).abs() * 1e3 * liq).contiguous()
    g = (seeded(m) * liq).contiguous()
    rho = (1.0 / rinv).contiguous()
    ril = (liq * rinv).contiguous()
    normals = (seeded(3, m) * liq).contiguous()
    make = {"k1_kappa_acc": lambda: (grid, k),
            "k1_visc_acc": lambda: (grid, d, rinv),
            "k1_iisph_dij": lambda: (grid, fac),
            "k1_iisph_s": lambda: (grid, dii, dij, p_liq, g),
            "k1_surface_normals": lambda: (grid, ril),
            "k1_tension_accel": lambda: (grid, rho, normals)}
    check_kernels(grid, [(name, "jittered", make[name], lambda a, r: [r],
                          TOL_SWEEP) for name in DEEP_WALKS], chk)


def check_list_required(grid, inp, count):
    """K2, K3, K4, K6, K7, IISPH's three K5 entries, k1_div_acc,
    k1_visc_init, k1_vorticity and the six list walkers of the unfused
    loops (k1_kappa_acc, k1_visc_acc, k1_iisph_dij, k1_iisph_s,
    k1_surface_normals, k1_tension_accel) raise on a grid whose step built
    no list,
    and a fill from a count below the pairs within h (it would drop a
    neighbour) flags it, so that the grid's first host read raises rather
    than the step walk a short list."""
    import dataclasses

    import torch

    from wcsph_tpu_torch import engine

    bare = dataclasses.replace(grid, nbr=None)
    saved = dict(engine.LAUNCHES)
    short = dataclasses.replace(grid, nbr=None)
    try:
        # the kernel flags it for the read; a plain twin raises at once
        engine.nbr_list_fill(short, torch.clamp(count - 1, min=0))
        short.read(torch.zeros((), device=grid.device))
    except ValueError as e:
        if "count differs" not in str(e):
            raise
    else:
        raise AssertionError("nbr_list_fill took a count below the pairs")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    m = grid.n
    calls = [("k1_div_acc", (bare, inp["vel"])),
             ("k1_visc_init", (bare, inp["vel"], inp["rinv"])),
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
                                     inp["a1"], inp["paux1"], inp["dt"], 1)),
             ("k7_fused_jacobi_iter", (bare, inp["dii"], inp["deninv"],
                                       inp["aii"], inp["b"],
                                       inp["p"].clone(), inp["dt"])),
             ("k5_iisph_adv", (bare, inp["vel"])),
             ("k5_iisph_aii", (bare, inp["dii"])),
             ("k5_iisph_force", (bare, inp["dpi"])),
             ("k6_fused_tension", (bare, inp["ril"], inp["rho"])),
             ("k1_kappa_acc", (bare, inp["kf"])),
             ("k1_visc_acc", (bare, inp["d"], inp["rinv"])),
             ("k1_iisph_dij", (bare, inp["fac"])),
             ("k1_iisph_s", (bare, inp["dii"], inp["dij"], inp["p_liq"],
                             inp["g"])),
             ("k1_surface_normals", (bare, inp["ril"])),
             ("k1_tension_accel", (bare, inp["rho"], inp["normals"]))]
    for name, args in calls:
        try:
            getattr(engine, name)(*args)
        except ValueError as e:
            if "neighbour list" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} ran on a grid with no list")
    log(f"  {', '.join(name for name, _ in calls)} raise on a grid with no "
        "neighbour list; a fill from a short count raises at the first read")


# The wrappers that walk the step's neighbour list (for_each_listed_record
# in csrc/common.cuh), each with the __global__ kernels of its launches that
# walk it (a template's emit after its name): phase 1 prints their
# registers, phase 4 reads their device time (torch.profiler, every kernel
# of a call)
LIST_WALKERS = {
    "k1_div_acc": ("k1_div_kernel",),
    "k1_visc_init": ("k1_visc_init_kernel",),
    "k1_vorticity": ("k1_vorticity_kernel",),
    "k2_fused_kappa_drho": ("k2_kappa_kernel", "k1_div_kernel"),
    "k3_fused_iter_full": ("k3_kappa_kernel", "k3_div_kernel"),
    "k4_fused_visc_iter": ("k4_matvec_kernel",),
    "k1_kappa_acc": ("k1_kappa_kernel",),
    "k1_visc_acc": ("k1_visc_acc_kernel",),
    "k5_iisph_adv": ("k5_list_kernel IisphAdv",),
    "k5_iisph_aii": ("k5_list_kernel IisphAii",),
    "k5_iisph_force": ("k5_list_kernel IisphForce",),
    "k6_fused_tension": ("k5_list_kernel SurfaceNormals",
                         "k5_list_kernel TensionAccel"),
    "k7_fused_jacobi_iter": ("k5_list_kernel IisphDijOf FacFromP",
                             "k5_list_kernel IisphSOf PressFromP"),
    "k1_iisph_dij": ("k5_list_kernel IisphDijFac",),
    "k1_iisph_s": ("k5_list_kernel IisphSFields",),
    "k1_surface_normals": ("k5_list_kernel SurfaceNormalsK1",),
    "k1_tension_accel": ("k5_list_kernel TensionAccelK1",),
}


def ptxas_registers(text):
    """mangled kernel name -> registers, from a ``-Xptxas -v`` report."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


def walker_registers(regs):
    """wrapper -> {kernel: registers} of LIST_WALKERS from
    ``ptxas_registers`` (None where the report names no such kernel): a
    kernel is matched by its mangled name, its own name first, then the
    names inside its template arguments, in order."""
    import re

    def find(kernel):
        name, *args = kernel.split()
        pat = re.compile(rf"_ZL?{len(name)}{name}" + (
            "I" + "".join(rf".*?(?<!\d){len(a)}{a}" for a in args)
            if args else r"(?!I)"))
        hits = [v for k, v in regs.items() if pat.match(k)]
        return hits[0] if len(hits) == 1 else None

    return {w: {k: find(k) for k in ks} for w, ks in LIST_WALKERS.items()}


def check_k8_hits(grid, inp, chk):
    """K8 against its twin into a hit buffer of the widest row's hits and
    into one of half that width: the same outputs (within TOL_FUSED), the
    same hits slot for slot, the same kept counts and the same overflow
    flag (0, then the widest row's hits)."""
    import dataclasses

    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import ListSlots

    saved = dict(engine.LAUNCHES)
    width = k8_width(grid, inp)
    m = grid.n
    for w in (width, width // 2):
        runs = []
        for fn in (engine.k8_fused_pcisph_iter, dense_ops.fused_pcisph_iter):
            g = dataclasses.replace(grid, star=None)
            p = inp["p"].clone()
            out = fn(g, inp["vel"], p, inp["dt"], inp["factor"],
                     ListSlots(w * m))
            runs.append((g.star, [out[0], out[1], p, out[2].reshape(1)]))
        (got, got_out), (want, want_out) = runs
        torch.cuda.synchronize()
        for c, (a, b) in enumerate(zip(got_out, want_out)):
            chk.close("k8_fused_pcisph_iter", a, b, TOL_FUSED,
                      f"[width {w} out {c}]")
        live = (torch.arange(w, device=grid.device)[:, None]
                < want.count[None, :]).flatten()
        if not (got.width == want.width == w
                and torch.equal(got.count, want.count)
                and torch.equal(got.idx[: w * m][live],
                                want.idx[: w * m][live])
                and torch.equal(got.rec, want.rec)
                and int(got.over) == int(want.over)
                == (0 if w == width else width)):
            raise AssertionError(f"K8 at width {w}: hits, counts, records or "
                                 "flag differ from its twin")
        log(f"  k8_fused_pcisph_iter: width {w}: {int(live.sum())} hits "
            f"equal to the twin's slot for slot, records equal, overflow "
            f"flag {int(got.over)} as the twin's")
    engine.LAUNCHES.update(saved)     # check launches are not main-path


def check_predict_hits(grid, inp, chk):
    """The unfused PCISPH prediction's cut and walk at ``inp["xstar"]``,
    into a hit buffer of the widest row's hits and into one of half that
    width, against their twins: the cut's outputs (within TOL_SWEEP), its
    full hit counts, records and kept hits slot for slot as the twin's;
    the walk at a second pressure within TOL_SWEEP of the twin's walk of
    the twin's hits, and bit-equal to a cut at that pressure; the outputs
    of the half width, where the rows of more hits are scanned again
    inside the walk, bit-equal to those of the full width.  Returns the
    rows scanned again at the half width."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import ListSlots

    saved = dict(engine.LAUNCHES)
    width = k8_width(grid, inp)
    m = grid.n
    xs, p, p2 = inp["xstar"], inp["p"], inp["p2"]
    outs, rescanned = [], 0
    for w in (width, width // 2):
        cut, got = engine.k1_pcisph_predict(grid, xs, p, ListSlots(w * m))
        cut_t, want = dense_ops.pcisph_predict(grid, xs, p, ListSlots(w * m))
        walk = engine.k1_pcisph_walk(grid, xs, p2, got)
        again = engine.k1_pcisph_predict(grid, xs, p2, ListSlots(w * m))[0]
        walk_t = dense_ops.pcisph_walk(grid, xs, p2, want)
        torch.cuda.synchronize()
        for name, a, b in (("k1_pcisph_predict", cut, cut_t),
                           ("k1_pcisph_walk", walk, walk_t)):
            for c, (x, y) in enumerate(zip(torch.split(a, (1, 3)),
                                           torch.split(b, (1, 3)))):
                chk.close(name, x, y, TOL_SWEEP, f"[width {w} out {c}]")
        kept = torch.clamp(want.count, max=w)
        live = (torch.arange(w, device=grid.device)[:, None]
                < kept[None, :]).flatten()
        if not (got.width == want.width == w
                and torch.equal(got.count, want.count)
                and torch.equal(got.idx[: w * m][live],
                                want.idx[: w * m][live])
                and torch.equal(got.rec, want.rec)):
            raise AssertionError(f"k1_pcisph_predict at width {w}: hits, "
                                 "counts or records differ from its twin")
        if not torch.equal(walk, again):
            raise AssertionError(f"k1_pcisph_walk at width {w}: not the "
                                 "bits of a cut at the same x* and pressure")
        outs.append((cut, walk))
        rows = int(((got.count > w) & grid.liquid).sum())
        rescanned = rows if w < width else rescanned
        log(f"  k1_pcisph_predict / k1_pcisph_walk: width {w}: "
            f"{int(live.sum())} kept hits equal to the twin's slot for "
            f"slot, full counts and records equal; the walk at a second "
            f"pressure equals a cut there bit for bit; {rows} rows scanned "
            "again in the walk")
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("the unfused prediction at half width differs "
                             "from the full width's bits")
    if rescanned == 0:
        raise AssertionError("the half width scanned no row again")
    log(f"  k1_pcisph_predict / k1_pcisph_walk: the half width ({width // 2},"
        f" {rescanned} rows scanned again) has the full width's bits")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    return rescanned


def walk_rescans(sim):
    """One more step of an unfused PCISPH path with the walk wrapped to
    count, per call, the rows of more hits than the buffer's width, which
    it scans again: (walks, width, the largest hit count, rows scanned
    again over the walks).  Host reads; not a timed step."""
    from wcsph_tpu_torch import engine

    seen = []
    walk = engine.k1_pcisph_walk

    def counting(grid, xstar, p, hits):
        seen.append((hits.width, int(hits.count.max()),
                     int(((hits.count > hits.width) & grid.liquid).sum())))
        return walk(grid, xstar, p, hits)

    engine.k1_pcisph_walk = counting
    try:
        sim.step()
    finally:
        engine.k1_pcisph_walk = walk
    return (len(seen), seen[0][0], max(s[1] for s in seen),
            sum(s[2] for s in seen))


def check_dense(cfg, side, chk):
    """The cut sweeps on the liquid block squeezed to 0.6 of its spacing,
    against their plain twins: the density sweep where receivers have more
    hits than its buffer (up to ~170 neighbours a receiver against
    CUT_SLOTS), and K5's density and SESPH-force entries (the force with a
    numpy-seeded pressure), whose columns hold more candidates than one
    32-bit hit mask."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import build_grid, pack
    from wcsph_tpu_torch.kernels import cubic_w0

    r = cfg.particle_radius
    sc = squeezed_dam_break(side, 0.6, box_extent=side * 2 * r * 1.35)
    dev = torch.device("cuda")
    grid = build_grid(torch.as_tensor(np.ascontiguousarray(
        sc.positions.T.astype(np.float32)), device=dev), sc.n_liquid, cfg)
    vel = pack(grid, [torch.as_tensor(converging_velocity(
        sc.positions[: sc.n_liquid]), device=dev)])[0].contiguous()
    rho = cfg.rest_density * (cfg.liquid_volume * cubic_w0(
        cfg.support_radius) + dense_ops.density_alpha(grid)[0])
    rinv = engine.rho_inv(rho).contiguous()
    p = (torch.as_tensor(np.random.RandomState(5).rand(grid.n).astype(
        np.float32) * 1e3, device=dev) * grid.liq).contiguous()
    force = (vel, rinv, (rho / cfg.rest_density).contiguous(),
             (p * rinv * rinv).contiguous(), p)
    cases = [("k1_density_alpha_drho", "dense", lambda: (grid, vel),
              lambda a, out: list(torch.split(out, (1, 1, 3, 1, 1))),
              TOL_SWEEP),
             ("k5_density_alpha", "dense", lambda: (grid,),
              lambda a, out: list(torch.split(out, (1, 1))), TOL_SWEEP),
             ("k5_sesph_force", "dense", lambda: (grid, *force),
              lambda a, out: [out], TOL_SWEEP)]
    check_kernels(grid, cases, chk)
    check_surface(grid, chk, "squeeze 0.6")
    most = int(dense_ops.density_alpha_drho(grid, vel)[1].max())
    log(f"  dense block (squeeze 0.6, M={grid.n}): max count {most} against "
        f"{engine.CUT_SLOTS} slots a receiver")
    # the rows of three z-consecutive cells of one (x, y) column: what one
    # (dx, dy) step of the sweeps scans
    start, gz = grid.cell_start, grid.cfg.grid_res[2]
    first = torch.arange(grid.cfg.num_cells - 2, device=dev)
    column = int((start[3:] - start[:-3])[first % gz <= gz - 3].max())
    log(f"  dense block: the largest 3-cell column holds {column} "
        "candidates against 32 a hit mask")
    if most <= engine.CUT_SLOTS or column <= 32:
        raise AssertionError("the dense case never fills the density "
                             "sweep's buffer or a K5 hit mask")


# ---------------------------------------------------------------------------
# Surface reconstruction: the field and anisotropy kernels, the extractors
# ---------------------------------------------------------------------------

SURFACE_KERNELS = ("mc_field", "aniso_moments", "aniso_g")
MOMENTS = (1, 3, 6, 1)   # aniso_moments' fields: sum w, sum w x, the six
                         # covariance sums, the count


def surface_inputs(grid):
    """(gated coefficients, smoothed centres, G, reach) of the grid, as
    ``reconstruct`` forms them: the density sweep, then the anisotropy
    moments and eigh, on the kernels."""
    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.surface import aniso, field

    rho, _ = engine.density(grid)
    an = aniso.compute(grid)
    return (field.gated_coefficients(grid, rho),
            aniso.smoothed_positions(grid, an), an.g, an.reach)


def mc_need(dense):
    """(active cubes, triangles) that marching cubes needs for the field:
    the budgets under which ``marching_cubes_device`` drops nothing (one
    host read)."""
    import torch

    from wcsph_tpu_torch.surface import mc, tables

    config = mc.cube_configs(dense).reshape(-1).to(torch.int64)
    per_case = torch.as_tensor(
        (tables.TRI_TABLE[:, :-1].reshape(256, -1, 3)[:, :, 0] >= 0).sum(1),
        device=dense.device)
    active = (config != 0) & (config != 255)
    return tuple(torch.stack([active.sum(), per_case[config].sum()])
                 .tolist())


def aniso_g_args(grid, mom):
    from wcsph_tpu_torch.surface import aniso

    return (grid, mom, aniso.KR, aniso.KS, aniso.KN, aniso.MIN_NEIGHBORS)


def check_moments(grid, chk, what):
    """aniso_moments against its plain twin (the count bit for bit, the
    sums within TOL_SWEEP), then aniso_g against its twin (torch's eigh)
    on those moments, within TOL_FUSED: the eigendecompositions differ in
    their rounding.  Returns the moments."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine

    saved = dict(engine.LAUNCHES)
    got = engine.aniso_moments(grid)
    want = dense_ops.aniso_moments(grid)
    torch.cuda.synchronize()
    if not torch.equal(got[10], want[10]):
        raise AssertionError(f"aniso_moments ({what}): counts differ")
    for c, (a, b) in enumerate(zip(torch.split(got, MOMENTS),
                                   torch.split(want, MOMENTS))):
        chk.close("aniso_moments", a, b, TOL_SWEEP, f"[{what} out {c}]")
    args = aniso_g_args(grid, want)
    g, reach = engine.aniso_g(*args)
    want_g, want_reach = dense_ops.aniso_g(*args)
    chk.close("aniso_g", g, want_g, TOL_FUSED, f"[{what}]")
    chk.close("aniso_g", reach, want_reach, TOL_FUSED, f"[{what} reach]")
    clamped = int((g[0] != args[4]).sum())
    log(f"  aniso_g ({what}): {clamped} of {grid.n} rows take the clamped "
        "spectral G, the rest kn I")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    return want


def check_surface(grid, chk, what):
    """aniso_moments and mc_field (plain and anisotropic) against their
    plain twins, and on each kernel field the device extractor, under
    budgets sized from the field, against the host extractor: the same
    triangles, vertices within 1e-5, nothing dropped.  Returns the kernel
    fields."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.surface import field, mc

    check_moments(grid, chk, what)
    saved = dict(engine.LAUNCHES)
    coeff, xs, g, reach = surface_inputs(grid)
    fields = {}
    for label, args in (("plain", (grid.pos, coeff)),
                        ("anisotropic", (xs, coeff, g, reach))):
        fields[label] = engine.mc_field(grid, *args)
        scale = chk.close("mc_field", fields[label],
                          dense_ops.mc_field(grid, *args), TOL_SWEEP,
                          f"[{what} {label}]")
        if not scale > 0.5:
            raise AssertionError(f"mc_field ({what}, {label}): max|phi| "
                                 f"{scale} never reaches the isolevel")
    origin, spacing = field.mc_grid_geometry(grid.cfg)
    for label, dense in fields.items():
        n_act, n_tri = mc_need(dense)
        hv, ht = mc.marching_cubes(dense.cpu().numpy(), origin, spacing,
                                   max_vertices=3 * n_tri)
        dv, n, dropped = mc.marching_cubes_device(
            dense, origin, spacing, max_active=n_act,
            max_vertices=3 * n_tri)
        n, dropped = torch.stack([n, dropped]).tolist()
        if dropped or n != n_tri or ht.shape[0] != n_tri or n == 0:
            raise AssertionError(f"marching cubes ({what}, {label}): device "
                                 f"{n} triangles ({dropped} dropped), host "
                                 f"{ht.shape[0]}, needed {n_tri}")
        np.testing.assert_allclose(dv[: 3 * n].cpu().numpy(), hv,
                                   rtol=1e-5, atol=1e-5)
        log(f"  marching cubes ({what}, {label}): device extractor equals "
            f"the host extractor on the kernel's field: {n} triangles of "
            f"{n_act} active cubes, vertices within 1e-5, 0 dropped")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    return fields


# float32 operations of one field term (a point and a candidate within the
# support: r 3, d^2 5, W 8, coeff W and the sum 2; anisotropic also 2 G r,
# 18) and of aniso_moments per pair with a liquid receiver (the geometry 8
# and the count 1 per pair; per liquid neighbour the weight 5 twice, pass
# 1's four sums 7, pass 2's offsets and six sums 21); aniso_g per row: the
# six divides, at most 8 sweeps of 3 Jacobi rotations of ~40, the clamp
# and G's 45 (an upper count: a row stops sweeping once it is diagonal)
FIELD_OPS = {"plain": 18, "anisotropic": 36}
MOMENT_OPS = (2 * 8 + 1, 5 + 7 + 5 + 21)
G_OPS = 6 + 8 * 3 * 40 + 10 + 45


def surface_bounds(grid, terms, pairs):
    """(bound ms, by) of mc_field per variant and of aniso_moments, from
    the bytes each input read once and output written once and the
    operations this run's data needs (``terms``: the field's terms within
    the support per variant; ``pairs``: (pairs with a liquid receiver, of
    them with a liquid neighbour))."""
    m = grid.n
    nc = grid.cfg.num_cells
    start = nc + 1
    out = {}
    for label, words in (("plain", 4 * m), ("anisotropic", 13 * m)):
        t_bytes = 4 * (words + start + 64 * nc) / PEAK_BYTES_PER_S
        t_ops = FIELD_OPS[label] * terms[label] / PEAK_FP32_FLOPS
        out[label] = (max(t_bytes, t_ops) * 1e3,
                      "bytes" if t_bytes >= t_ops else "operations")
    t_bytes = 4 * (5 * m + start + 11 * m) / PEAK_BYTES_PER_S
    t_ops = (MOMENT_OPS[0] * pairs[0] + MOMENT_OPS[1] * pairs[1]) / (
        PEAK_FP32_FLOPS)
    out["aniso_moments"] = (max(t_bytes, t_ops) * 1e3,
                            "bytes" if t_bytes >= t_ops else "operations")
    # the moments' rows it reads (sum w, the six sums, the count), the
    # liquid flag, G's nine rows and the reach written
    t_bytes = 4 * (8 + 1 + 10) * m / PEAK_BYTES_PER_S
    t_ops = G_OPS * m / PEAK_FP32_FLOPS
    out["aniso_g"] = (max(t_bytes, t_ops) * 1e3,
                      "bytes" if t_bytes >= t_ops else "operations")
    return out


def surface_times(grid, args, dense, n_act, n_tri, state, cfg, anisotropic):
    """ms a call (CUDA events) of one field variant's stages at the grid's
    shapes: the field kernel and its plain twin (``args``: its operands),
    the kernel's own device time (``mc_field_device``), the device extractor
    on ``dense`` under budgets sized for it and under its defaults, and
    the whole ``reconstruct(on_device=True)``."""
    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.bench import time_call
    from wcsph_tpu_torch.surface import field, mc
    from wcsph_tpu_torch.surface.reconstruction import reconstruct

    origin, spacing = field.mc_grid_geometry(cfg)
    return {
        "mc_field": time_call(engine.mc_field, lambda: (grid, *args), 10),
        "mc_field_device": kernel_device_ms(
            "mc_field", engine.mc_field, lambda: (grid, *args), 20),
        "mc_field_plain": time_call(dense_ops.mc_field,
                                    lambda: (grid, *args), 1),
        "extractor_sized": time_call(
            mc.marching_cubes_device,
            lambda: (dense, origin, spacing, 0.5, n_act, 3 * n_tri), 5),
        "extractor_default": time_call(
            mc.marching_cubes_device, lambda: (dense, origin, spacing), 5),
        "reconstruct_device": time_call(
            reconstruct,
            lambda: (state, cfg, 0.5, anisotropic, mc.MAX_VERTEX, True), 3)}


def kernel_device_ms(name, fn, make, reps):
    """The device time of one call's kernel (torch.profiler,
    ``bench.device_ms``), None where the profiler dropped events; raises
    where a call ran more than one device kernel."""
    from wcsph_tpu_torch.bench import device_ms

    try:
        dev, n = device_ms(fn, make, reps)
    except RuntimeError as e:     # the profiler dropped events
        log(f"  {name}: device time not measured ({e})")
        return None
    if n != 1:
        raise AssertionError(f"{name}: {n:g} device kernels a call, not 1")
    log(f"  {name}: {dev:.4f} ms on the device, {n:g} device kernel a call")
    return dev


def surface_full_width(state, cfg, chk, card):
    """Phase 5: reconstruct the 1M state on the card, host and device
    extractors, plain and anisotropic, with the launch counts set to 0
    just before and read just after (mc_field once a reconstruct,
    aniso_moments once an anisotropic one); then the kernels against their
    plain twins at those shapes, every nonzero term of the plain twin's
    anisotropic field within its candidate's reach, the device extractor
    under budgets sized from each field (nothing dropped, equal to the host
    extractor) and under its default budgets (what they drop), and the
    times, the field's and the moments' device time too (one device
    kernel a call).  Returns the launches, the per-kernel (ms, plain ms,
    device ms), bounds, the record and aniso_g's library time."""
    import warnings

    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.bench import time_call
    from wcsph_tpu_torch.grid import build_grid
    from wcsph_tpu_torch.surface import field, mc
    from wcsph_tpu_torch.surface.reconstruction import reconstruct

    variants = (("plain", False), ("anisotropic", True))
    engine.reset_launch_counts()
    meshes = {}
    for label, anisotropic in variants:
        for where, on_device in (("host", False), ("device", True)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                v, t = reconstruct(state, cfg, anisotropic=anisotropic,
                                   on_device=on_device)
                secs = time.perf_counter() - t0
            said = [str(w.message) for w in caught]
            meshes[f"{label} {where}"] = {"triangles": int(t.shape[0]),
                                          "s": secs, "warnings": said}
            if not (t.shape[0] > 0 and np.isfinite(v).all()
                    and v.shape == (3 * t.shape[0], 3)):
                raise AssertionError(f"reconstruct ({label}, {where}) gave "
                                     "no finite mesh")
            log(f"[phase 5] reconstruct {label}, {where} extractor: "
                f"{t.shape[0]} triangles in {secs:.3f} s (first call) on "
                f"{card}; warnings {said}")
    launches = dict(engine.LAUNCHES)
    ran = {k: v for k, v in launches.items() if v}
    log(f"[phase 5] launches of the four reconstructions: {ran}")
    missing = [k for k in ("bin_cells", "k5_density_alpha", *SURFACE_KERNELS)
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"reconstruct did not launch {missing}")
    # one field a reconstruct; the moments in one launch, once for each of
    # the two anisotropic reconstructs
    if launches["mc_field"] != 4 or launches["aniso_moments"] != 2:
        raise AssertionError(f"the four reconstructs launched mc_field "
                             f"{launches['mc_field']} and aniso_moments "
                             f"{launches['aniso_moments']} times, not 4 "
                             "and 2")

    grid = build_grid(state.pos, state.n_liquid, cfg)
    mom = check_moments(grid, chk, "1M")
    saved = dict(engine.LAUNCHES)
    coeff, xs, g, reach = surface_inputs(grid)
    ratio = dense_ops.field_reach_ratio(grid, xs, coeff, g, reach)
    log(f"[phase 5] anisotropic field at M={grid.n}: every nonzero term of "
        f"the plain twin lies within its candidate's reach (largest |r| / "
        f"reach {ratio:.6f})")
    if not 0.0 < ratio <= 1.0:
        raise AssertionError(f"an anisotropic field term lies at {ratio} "
                             "times its candidate's reach")
    origin, spacing = field.mc_grid_geometry(cfg)
    times, terms, record = {}, {}, {"reconstruct": meshes,
                                    "reach_ratio": ratio}
    for label, anisotropic in variants:
        args = (grid.pos, coeff) if not anisotropic else (xs, coeff, g, reach)
        dense = engine.mc_field(grid, *args)
        chk.close("mc_field", dense, dense_ops.mc_field(grid, *args),
                  TOL_SWEEP, f"[1M {label}]")
        terms[label] = dense_ops.mc_field_terms(grid, *args[:3])
        n_act, n_tri = mc_need(dense)
        dv, n, dropped = mc.marching_cubes_device(
            dense, origin, spacing, max_active=n_act, max_vertices=3 * n_tri)
        n, dropped = torch.stack([n, dropped]).tolist()
        _, n_def, drop_def = mc.marching_cubes_device(dense, origin, spacing)
        n_def, drop_def = torch.stack([n_def, drop_def]).tolist()
        t0 = time.perf_counter()
        hv, ht = mc.marching_cubes(dense.cpu().numpy(), origin, spacing,
                                   max_vertices=3 * n_tri)
        host_s = time.perf_counter() - t0
        if dropped or n != n_tri or ht.shape[0] != n_tri:
            raise AssertionError(f"marching cubes at 1M ({label}): device "
                                 f"{n} triangles ({dropped} dropped) under "
                                 f"sized budgets, host {ht.shape[0]}, "
                                 f"needed {n_tri}")
        np.testing.assert_allclose(dv[: 3 * n].cpu().numpy(), hv,
                                   rtol=1e-5, atol=1e-5)
        del dv, hv
        with warnings.catch_warnings():
            # each default-budget reconstruct warns of what it drops
            warnings.simplefilter("ignore")
            times[label] = surface_times(grid, args, dense, n_act, n_tri,
                                         state, cfg, anisotropic)
        times[label]["host_extractor_s"] = host_s
        record[label] = {"active_cubes": n_act, "triangles": n_tri,
                         "vertices": 3 * n_tri, "field_terms": terms[label],
                         "default_budgets": {"triangles": n_def,
                                             "dropped": drop_def},
                         **times[label]}
        log(f"[phase 5] {label} field at M={grid.n}: {n_act} active cubes, "
            f"{n_tri} triangles ({3 * n_tri} vertices) needed; under sized "
            f"budgets the device extractor kept all ({dropped} dropped) and "
            f"equals the host extractor (vertices within 1e-5); under its "
            f"default budgets (262144 cubes, {mc.MAX_VERTEX} vertices) it "
            f"kept {n_def} triangles and dropped {drop_def}")
        log(f"[phase 5] {label} on {card}: mc_field "
            f"{times[label]['mc_field']:.4f} ms (device "
            f"{times[label]['mc_field_device']}, plain "
            f"{times[label]['mc_field_plain']:.4f}), device extractor "
            f"{times[label]['extractor_sized']:.4f} ms sized, "
            f"{times[label]['extractor_default']:.4f} ms default budgets, "
            f"whole reconstruct(on_device=True) "
            f"{times[label]['reconstruct_device']:.4f} ms, host extractor "
            f"{host_s:.3f} s")
    liq_i = grid.liquid[dense_ops.pairs_of(grid).i]
    liq_j = dense_ops.pairs_of(grid).liq_j != 0
    pairs = (int(liq_i.sum()), int((liq_i & liq_j).sum()))
    cov = mom[4:10] / torch.clamp(mom[0], min=1e-12)
    cov3 = torch.stack([cov[[0, 1, 2]], cov[[1, 3, 4]], cov[[2, 4, 5]]]
                       ).permute(2, 0, 1).contiguous()

    def eigh_library(c):
        # one call of the whole batch fails on the card (dense_ops.EIG_CHUNK)
        return [torch.linalg.eigh(part)
                for part in torch.split(c, dense_ops.EIG_CHUNK)]

    try:     # one call of the whole batch, as a library would be called
        eigh_once = time_call(torch.linalg.eigh, lambda: (cov3,), 3)
        refused = None
    except RuntimeError as e:
        eigh_once, refused = None, f"{type(e).__name__}: {str(e)[:100]}"
    said = (f"{eigh_once:.4f} ms" if refused is None
            else f"refused ({refused})")
    log(f"[phase 5] torch.linalg.eigh, one call of {grid.n} 3x3 matrices: "
        f"{said}")
    extra = {
        "eigh_one_call": eigh_once, "eigh_one_call_refused": refused,
        "density": time_call(engine.density, lambda: (grid,), 10),
        "aniso_moments": time_call(engine.aniso_moments, lambda: (grid,), 10),
        "aniso_moments_device": kernel_device_ms(
            "aniso_moments", engine.aniso_moments, lambda: (grid,), 20),
        "aniso_moments_plain": time_call(dense_ops.aniso_moments,
                                         lambda: (grid,), 2),
        "aniso_g": time_call(engine.aniso_g,
                             lambda: aniso_g_args(grid, mom), 10),
        "aniso_g_plain": time_call(dense_ops.aniso_g,
                                   lambda: aniso_g_args(grid, mom), 2),
        "eigh": time_call(eigh_library, lambda: (cov3,), 3),
        "eigh_calls": -(-grid.n // dense_ops.EIG_CHUNK)}
    record.update(extra)
    engine.LAUNCHES.update(saved)     # timing launches are not the path's
    bound = surface_bounds(grid, terms, pairs)
    log(f"[phase 5] on {card}, M={grid.n}: density "
        f"{extra['density']:.4f} ms, aniso_moments "
        f"{extra['aniso_moments']:.4f} ms (device "
        f"{extra['aniso_moments_device']}, plain "
        f"{extra['aniso_moments_plain']:.4f}), aniso_g "
        f"{extra['aniso_g']:.4f} ms (plain {extra['aniso_g_plain']:.4f}), "
        f"torch.linalg.eigh of the same {grid.n} 3x3 matrices (library, "
        f"{extra['eigh_calls']} calls of {dense_ops.EIG_CHUNK}) "
        f"{extra['eigh']:.4f} ms; field terms {terms}, moment pairs "
        f"{pairs}; bounds {bound}")
    record["bounds"] = bound
    # (kernel ms, plain ms, device ms) a kernel; the library call of aniso_g
    # (torch.linalg.eigh in one call; None where the card refuses the batch)
    kernel_times = {
        "mc_field": (times["plain"]["mc_field"],
                     times["plain"]["mc_field_plain"],
                     times["plain"]["mc_field_device"]),
        "aniso_moments": (extra["aniso_moments"],
                          extra["aniso_moments_plain"],
                          extra["aniso_moments_device"]),
        "aniso_g": (extra["aniso_g"], extra["aniso_g_plain"], None)}
    return (launches, kernel_times,
            {"mc_field": bound["plain"],
             "aniso_moments": bound["aniso_moments"],
             "aniso_g": bound["aniso_g"]}, record,
            {"aniso_g": extra["eigh_one_call"]})


# ---------------------------------------------------------------------------
# Phase 6: the mesh-scene tooling, the showcase end to end
# ---------------------------------------------------------------------------

TOOLING_KERNELS = ("poisson_phase", "splat_points")
# the JAX package's record of the showcase (a TPU run: its shell is the
# committed asset; only its counts and physics are compared here)
SHOWCASE_RECORD = os.path.join(HERE, "benchmarks", "showcase.json")
SHOWCASE_SHELL = os.path.join(HERE, "examples", "assets",
                              "showcase_shell_0.0125.npy")
SHELL_COUNT_TOL = 0.005       # the port's shell within 0.5% of its count
SHELL_ON_MESH = 1e-4          # every point this close to its face
SHELL_SPACING = 0.999         # no two points of one face closer than this r
SPLAT_SIZE = 512
SPLAT_RADIUS = 3
# float32 operations of the splat a point: the projection's four rows (a
# product, two fused multiply-adds, an add: 6 each), the three divides, the
# screen position (3 a coordinate), the depth key 1 and the colours 3
SPLAT_OPS = 4 * 6 + 3 + 2 * 3 + 1 + 3
# float32 operations of one (candidate, accepted point) test of the
# sampler: the difference 3, d^2 5, the floor and the square root 2, the
# compare; the cross-face correction (the direction, two cosines, clips,
# the arcsin quotient) is not counted, so the bound is a lower one
PAIR_OPS = 11


@contextlib.contextmanager
def timed_calls(name):
    """Time every call of ``engine.<name>`` (the wrapper: its kernel, or
    its twin inside ``plain_twins``) between CUDA events; yields the list
    that holds each call's ms once the block has ended."""
    import torch

    from wcsph_tpu_torch import engine

    real = getattr(engine, name)
    events, ms = [], []

    def timed(*args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args)
        b.record()
        events.append((a, b))
        return out

    setattr(engine, name, timed)
    try:
        yield ms
    finally:
        setattr(engine, name, real)
        torch.cuda.synchronize()
        ms.extend(a.elapsed_time(b) for a, b in events)


def phase_work(verts, faces, radius):
    """Sample with the plain twin on the card, timing each of its phase
    steps (CUDA events around the twin alone) and counting per step the
    candidates tried, the (candidate, accepted point) pairs tested, the
    accepted points those pairs read (each once a step) and the
    candidates accepted: the work the bound counts.  Returns (positions,
    faces, totals, the twin's step times in ms)."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.sampling import sample_surface

    real = dense_ops.poisson_phase
    parts, events = [], []

    def counting(ch, phase, trial):
        cells, _, pair, _, flat = dense_ops.phase_window(ch, phase, trial)
        before = ch.acc_cnt.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        real(ch, phase, trial)
        b.record()
        events.append((a, b))
        parts.append(torch.stack([
            torch.tensor(cells.shape[0], device=pair.device),
            pair.sum(), torch.tensor(torch.unique(flat[pair]).numel(),
                                     device=pair.device),
            ch.acc_cnt.sum() - before]))

    dense_ops.poisson_phase = counting
    try:
        with engine.plain_twins():
            pos, fid = sample_surface(verts, faces, radius)
    finally:
        dense_ops.poisson_phase = real
    torch.cuda.synchronize()
    tot = torch.stack(parts).sum(0).tolist()
    work = dict(zip(("tried", "pairs", "read", "accepted"), tot),
                launches=len(parts))
    return pos, fid, work, [a.elapsed_time(b) for a, b in events]


def shell_gates(shell, fid, verts, faces, radius):
    """The shell's gates: every point within SHELL_ON_MESH of its own face
    (so of the mesh), and no two points of one face closer than
    SHELL_SPACING r.  Returns (largest distance to the face, least
    spacing of a face's pair / r)."""
    import torch

    dev = torch.device("cuda")
    p = torch.as_tensor(shell, dtype=torch.float64, device=dev)
    f = torch.as_tensor(faces.astype(np.int64), device=dev)[
        torch.as_tensor(fid.astype(np.int64), device=dev)]
    v = torch.as_tensor(verts, dtype=torch.float64, device=dev)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = torch.linalg.cross(b - a, c - a)
    n = n / torch.linalg.norm(n, dim=1, keepdim=True)
    off = (torch.sum((p - a) * n, 1)).abs()
    # inside the triangle (up to the tolerance) by its three edges
    inside = torch.ones_like(off, dtype=torch.bool)
    for e0, e1 in ((a, b), (b, c), (c, a)):
        side = torch.sum(torch.linalg.cross(e1 - e0, p - e0) * n, 1)
        inside &= side / torch.linalg.norm(e1 - e0, dim=1) > -SHELL_ON_MESH
    far = float(torch.where(inside, off, float("inf")).max())
    if not far <= SHELL_ON_MESH:
        raise AssertionError(f"shell: a point lies {far:.3e} from its face")
    order = np.argsort(fid, kind="stable")
    bounds = np.searchsorted(fid[order], np.arange(faces.shape[0] + 1))
    ps = p[torch.as_tensor(order, device=dev)]
    least = float("inf")
    for k in range(faces.shape[0]):
        q = ps[bounds[k]:bounds[k + 1]]
        for r0 in range(0, q.shape[0], 4096):
            d = torch.cdist(q[r0:r0 + 4096], q,
                            compute_mode="donot_use_mm_for_euclid_dist")
            d[torch.arange(d.shape[0], device=dev),
              torch.arange(r0, r0 + d.shape[0], device=dev)] = float("inf")
            if d.numel():
                least = min(least, float(d.min()))
    if not least >= SHELL_SPACING * radius:
        raise AssertionError(f"shell: two points of one face are "
                             f"{least:.6f} apart (r = {radius})")
    return far, least / radius


def splat_args(state):
    """The rasterizer's operands on the 1M state: Canvas's colours (liquid
    white, boundary grey) and radii (3 and 1 px), the showcase's camera
    angles around the box."""
    import torch

    from wcsph_tpu_torch.render import Camera

    n, nl = state.pos.shape[1], state.n_liquid
    cols = torch.full((3, n), 0.3, dtype=torch.float32, device=state.pos.device)
    cols[:, :nl] = 1.0
    radii = torch.ones((n,), dtype=torch.int32, device=state.pos.device)
    radii[:nl] = SPLAT_RADIUS
    cam = Camera(SPLAT_SIZE, SPLAT_SIZE)
    cam.yaw_cam(0.0, 0.0, 0.0)
    cam.scale, cam.yaw, cam.pitch = 12.0, 0.45, 0.35
    view, proj = cam.matrices()
    return (state.pos, cols, radii, np.asarray(proj @ view, np.float32),
            SPLAT_SIZE, SPLAT_SIZE, SPLAT_RADIUS, 0.0)


def splat_library(args):
    """(make_args, fn) of one ``scatter_reduce_`` call that computes the
    splat's z-buffer, all three channels in one call, from the twin's
    pixel indices and keys (``dense_ops.splat_keys``, made outside the
    timing)."""
    import torch

    from wcsph_tpu_torch import dense_ops

    pos, cols, radii, pv, w, h, rad, _ = args
    flat, keys = dense_ops.splat_keys(pos, cols, radii, pv, w, h, rad)
    idx = torch.cat([flat + c * (w * h + 1) for c in range(3)])
    keys = keys.reshape(-1)

    def make():
        img = torch.full((3 * (w * h + 1),), dense_ops.BACKGROUND_KEY,
                         dtype=torch.int64, device=pos.device)
        return img, idx, keys

    def fn(img, i, k):
        return img.scatter_reduce_(0, i, k, "amin")

    return make, fn


def tooling_full_width(mstate, chk, card):
    """Phase 6.  The sampler's phase kernel against its twin (kernel- and
    twin-driven samplers on the weir tank at r = 0.025, bit for bit, order
    included), the splat against its twin on the 1M state; then the path:
    the showcase (``examples.run_showcase.run``: its shell sampled at r =
    0.0125, 120 frames x 8 DFSPH + tension steps, a frame every 10 frames
    through ``Canvas`` written as PNG under out/showcase, one anisotropic
    reconstruct) with the launch counts set to 0 just before and read
    just after; the shell's and the run's gates; the times.  Returns the
    launches, per-kernel (ms, plain ms, library ms), bounds and record."""
    import argparse

    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.bench import time_call
    from wcsph_tpu_torch.examples import run_showcase as showcase
    from wcsph_tpu_torch.sampling import sample_surface

    verts, faces = showcase.vessel()
    saved = dict(engine.LAUNCHES)
    # -- the phase kernel against its twin: two whole samplers -------------
    t0 = time.perf_counter()
    pk, fk = sample_surface(verts, faces, 0.025)
    k_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with engine.plain_twins(), timed_calls("poisson_phase") as twin_steps:
        pt, ft = sample_surface(verts, faces, 0.025)
    p_s = time.perf_counter() - t0
    if pk.shape != pt.shape or not np.array_equal(fk, ft):
        raise AssertionError(f"poisson_phase: kernel {pk.shape} and twin "
                             f"{pt.shape} samplers differ (r = 0.025)")
    chk.close("poisson_phase", torch.from_numpy(pk), torch.from_numpy(pt),
              0.0, f" [weir tank r=0.025, {pk.shape[0]} points, order "
                   "included]")
    log(f"[phase 6] poisson_phase: the kernel-driven sampler equals the "
        f"twin-driven one bit for bit at r = 0.025 ({pk.shape[0]} points, "
        f"{len(twin_steps)} phase steps; {k_s:.3f} s and {p_s:.3f} s "
        f"whole, first calls) on {card}")
    # -- the splat against its twin on the 1M state ------------------------
    args = splat_args(mstate)
    a = engine.splat_points(*args)
    with engine.plain_twins():
        b = engine.splat_points(*args)
    chk.close("splat_points", a, b, 0.0,
              f" [1M, {SPLAT_SIZE}x{SPLAT_SIZE}, radius {SPLAT_RADIUS}]")
    covered = float((a.sum(-1) > 0).float().mean())
    make, lib = splat_library(args)
    splat = {"ms": time_call(engine.splat_points, lambda: args, 20),
             "plain_ms": time_call(dense_ops.splat_points, lambda: args, 3),
             "library_ms": time_call(lib, make, 10)}
    del make, lib
    torch.cuda.empty_cache()
    log(f"[phase 6] splat_points at {args[0].shape[1]} points, "
        f"{SPLAT_SIZE}x{SPLAT_SIZE}, radius {SPLAT_RADIUS} on {card}: equal "
        f"to its twin bit for bit ({covered:.1%} of the pixels covered); "
        f"kernel {splat['ms']:.4f} ms, plain {splat['plain_ms']:.4f} ms, "
        f"scatter_reduce_ of the same keys (library) "
        f"{splat['library_ms']:.4f} ms")
    engine.LAUNCHES.update(saved)     # comparison launches are not the path's

    # -- the path: the showcase ---------------------------------------------
    out = os.path.join(HERE, "out", "showcase")
    opts = argparse.Namespace(radius=0.0125, frames=120, steps_per_frame=8,
                              small=False, export_surface=True,
                              render_every=10, out=out, shell=None,
                              device="cuda")
    engine.reset_launch_counts()
    t0 = time.perf_counter()
    rec = showcase.run(opts)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(engine.LAUNCHES)
    ran = {k: v for k, v in launches.items() if v}
    log(f"[phase 6] showcase launches: {ran}")
    must = ("poisson_phase", "splat_points", "bin_cells", "pack_rows",
            "unpack_rows", "nbr_list_offsets", "nbr_list_fill",
            "k1_density_alpha_drho", "k3_fused_iter_full",
            "k6_fused_tension", "k5_density_alpha", *SURFACE_KERNELS)
    missing = [k for k in must if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the showcase did not launch {missing}")
    n_frames = len(rec["frames"])
    if launches["splat_points"] != n_frames:
        raise AssertionError(f"{n_frames} frames, "
                             f"{launches['splat_points']} splat launches")

    shell, fid = rec["shell"], rec["shell_fid"]
    committed = np.load(SHOWCASE_SHELL)
    row = np.dtype((np.void, 12))
    matched = np.intersect1d(np.ascontiguousarray(shell).view(row),
                             np.ascontiguousarray(committed).view(row)).size
    far, least = shell_gates(shell, fid, verts, faces, 0.0125)
    count_ok = abs(shell.shape[0] - committed.shape[0]) <= (
        SHELL_COUNT_TOL * committed.shape[0])
    log(f"[phase 6] showcase shell r = 0.0125: {shell.shape[0]} points "
        f"against the committed {committed.shape[0]} (the JAX package's TPU "
        f"shell), {matched / committed.shape[0]:.4%} of them matched "
        f"exactly; {launches['poisson_phase']} phase launches, "
        f"{rec['shell_s']:.3f} s (sampler with its host setup and the .npy "
        f"save); farthest point {far:.2e} from its face, closest pair of "
        f"one face {least:.5f} r")
    if not count_ok:
        raise AssertionError("shell count not within 0.5% of the committed "
                             "shell's")
    with open(SHOWCASE_RECORD) as f:
        jax_rec = json.load(f)
    if rec["max_overflow"] != 0:
        raise AssertionError("showcase: overflow != 0")
    surf = rec["surface"]
    if not (surf["triangles"] > 0 and surf["finite"]):
        raise AssertionError("showcase: no finite anisotropic surface")
    steps_per_s = rec["steps"] / rec["steps_s"]
    log(f"[phase 6] showcase on {card}: {rec['n_liquid']} liquid + "
        f"{rec['n_solid']} boundary, {rec['steps']} DFSPH + tension steps in "
        f"{rec['steps_s']:.2f} s ({steps_per_s:.2f} steps/s, "
        f"{rec['n_liquid'] * steps_per_s:.4e} particle-steps/s, frames and "
        f"host reads included); simulated {rec['sim_time']:.3f} s (JAX "
        f"record {jax_rec['sim_time_s']}); no NaN, overflow 0, 0 wall leaks "
        f"(record {jax_rec['wall_leaks']}); max pressure iterations "
        f"{rec['max_pressure_iters']} (record "
        f"{jax_rec['max_pressure_iters']}), max density error "
        f"{rec['max_density_error']:.4e} (record "
        f"{jax_rec['max_density_error']}), max weir-crossed share "
        f"{rec['max_crossed']:.4f} (record "
        f"{jax_rec['max_crossed_weir_frac']}), max airborne ejecta "
        f"{rec['max_ejecta']} (record {jax_rec['max_airborne_ejecta']}), "
        f"most outside the walls' box at a frame {rec['outside_box']} (the "
        f"JAX script's leak count), most gone over a side wall's top "
        f"{rec['over_wall_top']} (crossings {rec['over_witness']}), max "
        f"|v| {rec['max_vel']:.3f} (record {jax_rec['max_vel']}); "
        f"{n_frames} frames {rec['frames'][0]} ... written; anisotropic "
        f"surface {surf['triangles']} triangles in {surf['s']:.3f} s; the "
        f"whole run {run_s:.2f} s")

    # -- the splat against its twin on the path's frame ----------------------
    saved = dict(engine.LAUNCHES)
    canvas = showcase.showcase_canvas()
    pos = rec["state"].pos
    img = canvas.render(pos, rec["n_liquid"],
                        liquid_color=showcase.LIQUID_COLOR)
    with engine.plain_twins():
        twin_img = canvas.render(pos, rec["n_liquid"],
                                 liquid_color=showcase.LIQUID_COLOR)
    w, h = canvas.camera.width, canvas.camera.height
    chk.close("splat_points", torch.from_numpy(img),
              torch.from_numpy(twin_img), 0.0,
              f" [the showcase's last state, {pos.shape[1]} points, "
              f"{w}x{h}, Canvas.render]")

    # -- the sampler at full width: timed, then its work counted -------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_calls("poisson_phase") as kernel_ms:
        again, _ = sample_surface(verts, faces, 0.0125)
    whole_s = time.perf_counter() - t0
    if not np.array_equal(again, shell):
        raise AssertionError("the sampler gave another shell the second time")
    twin, twin_fid, work, plain_ms = phase_work(verts, faces, 0.0125)
    if not (np.array_equal(twin, shell) and np.array_equal(twin_fid, fid)):
        raise AssertionError("poisson_phase: the kernel and twin samplers "
                             "differ at r = 0.0125")
    engine.LAUNCHES.update(saved)
    # what a phase step must move: each tried candidate (its cell and
    # index 8 B, position 12, normal 12, face 4), each accepted point its
    # pairs read (28 B, once a step), each accepted candidate written (28
    # B and its cell's count 4); the cells of the colour with nothing to
    # try are not the function's work
    n_l = work["launches"]
    t_bytes = (36 * work["tried"] + 28 * work["read"]
               + 32 * work["accepted"]) / PEAK_BYTES_PER_S
    t_ops = PAIR_OPS * work["pairs"] / PEAK_FP32_FLOPS
    n_pts = args[0].shape[1]
    s_bytes = (4 * 7 * n_pts + 4 * 3 * SPLAT_SIZE ** 2) / PEAK_BYTES_PER_S
    s_ops = SPLAT_OPS * n_pts / PEAK_FP32_FLOPS
    bound = {"poisson_phase": (max(t_bytes, t_ops) * 1e3 / n_l,
                               "bytes" if t_bytes >= t_ops else "operations"),
             "splat_points": (max(s_bytes, s_ops) * 1e3,
                              "bytes" if s_bytes >= s_ops else "operations")}
    times = {"poisson_phase": (statistics.mean(kernel_ms),
                               statistics.mean(plain_ms), None),
             "splat_points": (splat["ms"], splat["plain_ms"],
                              splat["library_ms"])}
    log(f"[phase 6] the sampler at r = 0.0125 on {card}: whole "
        f"{whole_s:.3f} s; its {len(kernel_ms)} phase launches alone "
        f"{sum(kernel_ms):.3f} ms (CUDA events around each wrapper call: "
        f"mean {statistics.mean(kernel_ms):.4f} ms, max "
        f"{max(kernel_ms):.4f}); the twin-driven sampler gives the same "
        f"shell (its {len(plain_ms)} phase steps: mean "
        f"{statistics.mean(plain_ms):.4f} ms, sum {sum(plain_ms):.3f} ms); "
        f"work {work}")
    for name in TOOLING_KERNELS:
        log(f"  {name}: bound {bound[name][0]:.6f} ms by {bound[name][1]}; "
            f"kernel {times[name][0] / bound[name][0]:.1f}x its bound")
    record = {"shell": {"points": int(shell.shape[0]),
                        "committed": int(committed.shape[0]),
                        "matched": int(matched), "shell_s": rec["shell_s"],
                        "sampler_s": whole_s, "launches_ms": sum(kernel_ms),
                        "far": far, "least_spacing_r": least, "work": work},
              "showcase": {k: v for k, v in rec.items()
                           if k not in ("shell", "shell_fid", "state")},
              "splat": splat, "run_s": run_s}
    return launches, times, bound, record


# ---------------------------------------------------------------------------
# The grid stage: bin, pack, unpack and the list's offsets, exactly
# ---------------------------------------------------------------------------

BIN_OUTPUTS = ("order", "row_of", "cell", "cell_start", "pos", "liquid",
               "liq", "n_liquid")


def with_outside(pos, cfg):
    """The planar positions with liquid particles 0 and 1 past the
    domain's top corner and the last particle (boundary) below its
    floor."""
    import torch

    out = pos.clone()
    hi = torch.tensor(cfg.domain_max, dtype=torch.float32)
    out[:, 0] = (hi + 0.3).to(out.device)
    out[:, 1] = (hi + 0.7).to(out.device)
    out[1, -1] = float(cfg.domain_min[1]) - 0.2
    return out


def step_fields(nl, dev, rng):
    """DFSPH's five per-liquid fields (vel, omega, vel_guess, kappa,
    kappa_v), numpy-seeded."""
    import torch

    return [torch.as_tensor(rng.randn(*shape).astype(np.float32), device=dev)
            for shape in ((3, nl), (3, nl), (3, nl), (nl,), (nl,))]


def check_grid_stage(pos, n_liquid, cfg, chk, rng):
    """The bin, pack and unpack kernels against their plain twins, every
    output equal; returns the kernel-built grid."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import Grid

    saved = dict(engine.LAUNCHES)
    got = engine.bin_cells(pos, n_liquid, cfg)
    want = dense_ops.bin_cells(pos, n_liquid, cfg)
    torch.cuda.synchronize()
    for name, a, b in zip(BIN_OUTPUTS, got, want):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"bin_cells: {name} differs from the plain "
                                 "stable sort")
    grid = Grid(cfg, *got)
    m_in = int(grid.cell_start[-1])
    fields = step_fields(n_liquid, pos.device, rng)
    packed = engine.pack_rows(grid, fields)
    for a, b in zip(packed, dense_ops.pack_rows(grid, fields)):
        if not torch.equal(a, b):
            raise AssertionError("pack_rows differs from its plain twin")
    block = packed[0]._base
    if not (block is not None and block.shape == (11, grid.n)
            and all(p._base is block and p.is_contiguous() for p in packed)
            and packed[3].data_ptr() == block[9].data_ptr()):
        raise AssertionError("pack_rows: the fields are not row views of "
                             "one (11, M) block")
    defaults = step_fields(n_liquid, pos.device, rng)
    back = engine.unpack_rows(grid, packed, defaults)
    for a, b in zip(back, dense_ops.unpack_rows(grid, packed, defaults)):
        if not torch.equal(a, b):
            raise AssertionError("unpack_rows differs from its plain twin")
    block = back[0]._base
    if not (block is not None and block.shape == (11, n_liquid)
            and all(x._base is block and x.is_contiguous() for x in back)
            and back[3].data_ptr() == block[9].data_ptr()):
        raise AssertionError("unpack_rows: the fields are not row views of "
                             "one (11, N_L) block")
    out = grid.row_of[:n_liquid] < 0
    for a, x, d in zip(back, fields, defaults):
        if not torch.equal(torch.where(out, d, x), a):
            raise AssertionError("pack then unpack lost a field")
    for name in ("bin_cells", "pack_rows", "unpack_rows"):
        chk.max_abs[name] = 0.0
    log(f"  bin_cells: order, offsets, cells, rows, positions, flags and "
        f"the liquid count equal to the plain stable sort ({grid.n} rows, "
        f"{grid.n - m_in} outside the domain, last); pack_rows and "
        f"unpack_rows of DFSPH's five fields (each row views of one block) "
        f"equal to their twins, and "
        f"{int(out.sum())} liquid particles outside kept their defaults")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    return grid


def check_bin_alternating(calls):
    """The bin kernel on ``calls`` (each (positions, n_liquid, cfg)) back to
    back on one stream, then each call's outputs against its plain twin:
    its kept scratch (the histogram zero between calls) serves grids of
    other sizes in turn."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine

    saved = dict(engine.LAUNCHES)
    got = [engine.bin_cells(*args) for args in calls]
    torch.cuda.synchronize()
    for c, (args, out) in enumerate(zip(calls, got)):
        want = dense_ops.bin_cells(*args)
        for name, a, b in zip(BIN_OUTPUTS, out, want):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"bin_cells, call {c} of the alternating "
                                     f"sizes: {name} differs from the plain "
                                     "stable sort")
    engine.LAUNCHES.update(saved)     # check launches are not main-path
    log(f"  bin_cells: {len(calls)} calls back to back at "
        f"{[args[0].shape[1] for args in calls]} particles, every output "
        f"equal to the plain stable sort")


def check_list_capacity(grid, count, chk):
    """The list's slice offsets against their twin, whole and clamped to a
    capacity of half the slots needed, and the fill into that short buffer:
    the same clamped offsets, need and flag, and the same slots."""
    import dataclasses

    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.grid import ListSlots

    saved = dict(engine.LAUNCHES)
    need = int(dense_ops.list_offsets(count, grid.liquid)[1])
    short = ListSlots(need // 2)
    # new tensors, then the kept ones of a ListSlots (the step's form)
    for cap, slots in ((2 ** 31 - 1, None), (short.capacity, None),
                       (2 ** 31 - 1, short), (short.capacity, short)):
        got = engine.nbr_list_offsets(count, grid.liquid, cap, slots)
        want = dense_ops.list_offsets(count, grid.liquid, cap)
        if not (torch.equal(got[0], want[0]) and int(got[1]) == need
                and int(want[1]) == need):
            raise AssertionError(f"nbr_list_offsets differs at capacity "
                                 f"{cap}" + (" into kept slots" if slots
                                              else ""))
        if slots is not None and got[0] is not slots.offsets(
                grid.n, grid.device)[0]:
            raise AssertionError("nbr_list_offsets did not write the kept "
                                 "offsets")
    # on a copy of the grid: the fill keeps its list as the grid's, and the
    # walkers checked after this must walk the whole one
    got = engine.nbr_list_fill(dataclasses.replace(grid), count, short)
    want = dense_ops.neighbor_list(grid, count, ListSlots(need // 2))
    live = int(got.off[-1])
    if not (live == short.capacity and torch.equal(got.off, want.off)
            and torch.equal(got.idx[:live], want.idx[:live])
            and torch.equal(got.rec, want.rec) and int(got.need) == need
            and int(got.flag) == 1 and int(want.flag) == 1):
        raise AssertionError("nbr_list_fill into a short buffer differs "
                             "from its plain twin")
    chk.max_abs["nbr_list_offsets"] = 0.0
    log(f"  nbr_list_offsets: equal to the twin, whole ({need} slots) and "
        f"clamped to {short.capacity}, new and into kept slots; the fill "
        f"into that buffer is clamped and flagged as the twin's, its {live} "
        f"slots equal")
    engine.LAUNCHES.update(saved)


def check_replay(solver, dev, over):
    """One step of the pressurized side-8 scene (config overrides
    ``over``) with the buffer of the list (PCISPH: of K8's hits) forced to
    64 slots: it replays once and gives the bits of the step with an
    unforced buffer."""
    import torch

    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.grid import ListSlots
    from wcsph_tpu_torch.simulation import Simulation, default_config

    r = 0.025
    sc = squeezed_dam_break(8, 0.92, box_extent=0.9)
    lo, hi = sc.domain(pad=4 * r)
    sim = Simulation(sc, default_config(solver, particle_radius=r,
                                        domain_min=lo, domain_max=hi,
                                        **over),
                     solver=solver, device=dev)
    state = sim.state.replace(vel=torch.as_tensor(converging_velocity(
        sc.positions[: sc.n_liquid]), device=dev))
    before = engine.LIST_REPLAYS
    want = sim._solver.step(state, sim.cfg, ListSlots())
    forced = ListSlots(64)
    got = sim._solver.step(state, sim.cfg, forced)
    replays = engine.LIST_REPLAYS - before
    fields = ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
              "kappa_v")
    same = all(torch.equal(getattr(got, f), getattr(want, f))
               for f in fields) and got.diag == want.diag
    tag = solver + (" + tension" if over else "")
    log(f"[phase 3] {tag}: a step with 64 slots replayed {replays} "
        f"time(s) (buffer grown to {forced.capacity}) and "
        f"{'equals' if same else 'DIFFERS FROM'} the unforced step bit for "
        f"bit")
    if replays != 1 or not same:
        raise AssertionError(f"{tag}: the forced-capacity step did not "
                             "replay to the same bits")


def stage_without_sync(sim, solver):
    """The step's stage from the bin through the filled list (SESPH and
    PCISPH: through the pack), the solver's own functions, under
    torch.cuda.set_sync_debug_mode("error"): any host read raises."""
    import torch

    from wcsph_tpu_torch.solvers import dfsph, iisph, pcisph, sesph

    mod = {"dfsph": dfsph, "iisph": iisph, "sesph": sesph,
           "pcisph": pcisph}[solver]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid, packed = mod.bin_and_pack(sim.state, sim.cfg)
        if solver == "dfsph":
            dfsph.density_and_list(grid, packed[0], sim.list_slots)
        elif solver == "iisph":
            iisph.density_and_list(grid, sim.list_slots)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if solver in ("dfsph", "iisph"):
        kept_off = sim.list_slots.offsets(grid.n, grid.device)[0]
        if (grid.nbr.idx.data_ptr() != sim.list_slots.idx.data_ptr()
                or grid.nbr.off is not kept_off):
            raise AssertionError("the fill did not use the kept buffer and "
                                 "offsets")
        grid.read(torch.zeros((), device=grid.device))   # status: no raise
    return "bin, pack" + (", density, list offsets and fill"
                          if solver in ("dfsph", "iisph") else "")


def allocations(fn, args):
    """The allocations from PyTorch's caching allocator that one call
    ``fn(*args)`` makes (``allocation.all.allocated`` of
    torch.cuda.memory_stats)."""
    import torch

    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn(*args)
    return torch.cuda.memory_stats()[key] - before


# gates of the grid stage at 1M: the wrappers of one device kernel a call,
# the most device operations (kernels and memsets) of one bin, and the
# allocations one call makes (the bin's outputs; one block for the pack
# and the unpack; none for the offsets into a sized ListSlots)
ONE_KERNEL = ("pack_rows", "unpack_rows", "nbr_list_offsets")
BIN_OPERATIONS = 4
ALLOCATIONS = {"bin_cells": 8, "pack_rows": 1, "unpack_rows": 1,
               "nbr_list_offsets": 0}


def time_grid_stage(grid, pos, n_liquid, count, rng, reps_kernel=20,
                    reps_plain=5):
    """name -> (kernel ms, plain ms, library ms, device ms, device kernels
    per call) of the bin, pack, unpack and list offsets at the grid's
    shapes.  Kernel: the whole wrapper between two CUDA events; device:
    its kernels' own time (torch.profiler).  Library: the one PyTorch call
    that computes the same function's core: torch.sort(stable=True) of the
    cell keys for the bin, one gather (index_select of the stacked field
    rows) for pack and unpack, torch.cumsum of the slice widths for the
    offsets.  The offsets run as a step runs them, into a sized
    ``ListSlots``.  Gates: ``ONE_KERNEL``, ``BIN_OPERATIONS`` and
    ``ALLOCATIONS``."""
    import torch

    from wcsph_tpu_torch import dense_ops, engine
    from wcsph_tpu_torch.bench import device_ms, time_call
    from wcsph_tpu_torch.grid import ListSlots

    cfg = grid.cfg
    saved = dict(engine.LAUNCHES)
    fields = step_fields(n_liquid, pos.device, rng)
    defaults = step_fields(n_liquid, pos.device, rng)
    packed = engine.pack_rows(grid, fields)
    keys = dense_ops.cell_keys(pos, cfg)
    rows11 = torch.cat([f.reshape(-1, n_liquid) for f in fields])
    src = torch.where(grid.liquid, grid.order, 0)
    packed11 = torch.cat([p.reshape(-1, grid.n) for p in packed])
    back = grid.row_of[:n_liquid].clamp(min=0).to(torch.int64)
    kept = ListSlots(int(dense_ops.list_offsets(count, grid.liquid)[1]))
    width = (dense_ops.list_offsets(count, grid.liquid)[0].diff())
    cases = {
        "bin_cells": (lambda: (pos, n_liquid, cfg),
                      lambda: torch.sort(keys, stable=True)),
        "pack_rows": (lambda: (grid, fields),
                      lambda: rows11.index_select(1, src)),
        "unpack_rows": (lambda: (grid, packed, defaults),
                        lambda: packed11.index_select(1, back)),
        "nbr_list_offsets": (
            lambda: (count, grid.liquid, kept.capacity, kept),
            lambda: torch.cumsum(width, 0)),
    }
    times = {}
    for name, (make, library) in cases.items():
        times[name] = (time_call(getattr(engine, name), make, reps_kernel),
                       time_call(engine.OWN_KERNELS[name][2], make,
                                 reps_plain),
                       time_call(library, tuple, reps_kernel),
                       *device_ms(getattr(engine, name), make, reps_kernel))
        ms, plain, lib, dev, kernels = times[name]
        lib_dev, lib_kernels = device_ms(library, tuple, reps_kernel)
        log(f"  {name}: kernel {ms:.4f} ms (its kernels on the device "
            f"{dev:.4f} ms, {kernels:g} device kernels a call), plain "
            f"{plain:.4f} ms, library {lib:.4f} ms (on the device "
            f"{lib_dev:.4f} ms, {lib_kernels:g} kernels), kernel / library "
            f"{ms / lib:.3f} (M={grid.n})")
    allocs = {name: allocations(getattr(engine, name), make())
              for name, (make, _) in cases.items()}
    log(f"  allocations a call: bin_cells {allocs['bin_cells']} (its "
        f"outputs), pack_rows {allocs['pack_rows']}, unpack_rows "
        f"{allocs['unpack_rows']} (11 field rows), nbr_list_offsets into a "
        f"sized ListSlots {allocs['nbr_list_offsets']}")
    engine.LAUNCHES.update(saved)     # timing launches are not main-path
    if (any(times[k][4] != 1 for k in ONE_KERNEL)
            or not 0 < times["bin_cells"][4] <= BIN_OPERATIONS
            or allocs != ALLOCATIONS):
        raise AssertionError(
            f"{', '.join(ONE_KERNEL)} must launch one device kernel a call "
            f"and bin_cells at most {BIN_OPERATIONS} device operations; "
            f"allocations a call must be {ALLOCATIONS}")
    return times


def grid_bytes(grid, counts, k_fields):
    """name -> bytes each input read once and each output written once, for
    the grid stage's kernels (their operations are a few per row: bytes
    bound them).  ``k_fields``: field rows a pack or unpack moves."""
    n = grid.n
    nl = counts["particles_liquid"]
    l_in = counts["rows_liquid"]
    s = -(-n // 32)
    return {
        # positions read; order (8), row_of, cell, sorted positions (12),
        # liquid flag (1) and liq written per row; cell offsets, the count
        "bin_cells": 12 * n + 33 * n + 4 * (grid.cfg.num_cells + 1) + 4,
        # liquid flag (1 byte) per row, order and the fields at liquid rows
        # read; every row of every field written
        "pack_rows": n + 8 * l_in + 4 * k_fields * l_in
        + 4 * k_fields * n,
        # each liquid particle's row, its packed value or (outside the
        # domain) its default read; every field written
        "unpack_rows": 4 * nl + 4 * k_fields * l_in
        + 4 * k_fields * (nl - l_in) + 4 * k_fields * nl,
        # counts and liquid flags (1 byte) read; offsets and the need
        # written
        "nbr_list_offsets": 5 * n + 4 * (s + 1) + 8,
    }


def time_kernels(grid, cases, count, reps_kernel=20, reps_plain=5):
    """(kernel ms, plain ms[, device ms]) per kernel (K3 timed in mode 1,
    the pressure iteration, which the main path runs most; the device time,
    torch.profiler's, for ``LIST_WALKERS``), and for the list fill (the
    whole wrapper as a step runs it, into a buffer sized as a step's:
    slice offsets and the fill, no host read; its plain twin's time
    excludes the pair list it reads)."""
    from wcsph_tpu_torch import engine
    from wcsph_tpu_torch.bench import device_ms, time_call
    from wcsph_tpu_torch.grid import ListSlots

    saved = dict(engine.LAUNCHES)
    twins = {**engine.KERNELS, **engine.OWN_KERNELS}
    slots = ListSlots()
    engine.nbr_list_fill(grid, count, slots)     # sizes the buffer
    times = {}
    for name, label, make, _, _ in [
            *cases, ("nbr_list_fill", "", lambda: (grid, count, slots), 0,
                     0)]:
        if label == "mode 0":
            continue
        times[name] = (time_call(getattr(engine, name), make, reps_kernel),
                       time_call(twins[name][2], make, reps_plain))
        log(f"  {name}: kernel {times[name][0]:.4f} ms, plain "
            f"{times[name][1]:.4f} ms (M={grid.n})")
        if name in LIST_WALKERS:
            try:
                dev, kernels = device_ms(getattr(engine, name), make,
                                         reps_kernel)
            except RuntimeError as e:     # the profiler dropped events
                times[name] += (None,)
                log(f"  {name}: device time not measured ({e})")
                continue
            times[name] += (dev,)
            log(f"  {name}: its kernels on the device {dev:.4f} ms "
                f"({kernels:g} device kernels a call)")
    engine.LAUNCHES.update(saved)     # timing launches are not main-path
    return times


# ---------------------------------------------------------------------------
# The least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

# name -> (float32 words read per row, words written per row, operations as
# a function of the pair counts P and the rows M[, other words moved as a
# function of P and M]).  Words: the kernel's operand list, each input read
# once and each output written once; scratch that a kernel keeps between
# its own launches is not counted (K8's hits and records at x*), nor is the
# neighbour list that the seventeen list walkers read (the functions they
# compute do not need it; the fill that writes it, slots and records, has
# its own row),
# nor the shared-memory hit buffer of the density sweep and of K8.
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
    # K1's emits of the unfused loops: K2's kappa sum, K4's matvec sum,
    # K7's two sweeps and K6's two alone; the PCISPH prediction is K8's
    # predicted density and acceleration in one sweep (W and gradW 13),
    # cut and walk alike: the hits, records and counts the cut keeps for
    # the walk are scratch between the two launches (as K8's), not outputs
    "k1_kappa_acc": (1, 3, lambda P, M: 24 * P["liq"]),
    "k1_visc_acc": (4, 3, lambda P, M: 39 * P["liq"]),
    "k1_pcisph_predict": (4, 4, lambda P, M: 37 * P["star"]),
    "k1_pcisph_walk": (4, 4, lambda P, M: 37 * P["star"]),
    "k1_iisph_dij": (1, 3, lambda P, M: 24 * P["liq"]),
    "k1_iisph_s": (8, 1, lambda P, M: 48 * P["liq"]),
    "k1_surface_normals": (1, 3, lambda P, M: 23 * P["liq"]),
    "k1_tension_accel": (4, 3, lambda P, M: 62 * P["liq"]),
}


def pair_counts(grid, inp, n_liquid):
    """The directed pairs within h that this run's inputs make each kind
    of sweep evaluate (see WORK), and the liquid particles and rows (see
    grid_bytes)."""
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
            "slots": int(grid.nbr.off[-1]),
            "particles_liquid": int(n_liquid),
            "rows_liquid": int(grid.liquid.sum())}


def bounds(grid, counts, k_fields):
    """name -> (bound ms, "bytes" or "operations") from WORK, grid_bytes
    and the card's published peaks."""
    m = grid.n
    geom_words = 5 * m + grid.cfg.num_cells + 1
    out = {name: (b / PEAK_BYTES_PER_S * 1e3, "bytes")
           for name, b in grid_bytes(grid, counts, k_fields).items()}
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

# K1's entries that only the unfused solver loops run, and the fused
# kernels they stand in for
UNFUSED_ENTRIES = ("k1_kappa_acc", "k1_visc_acc", "k1_pcisph_predict",
                   "k1_pcisph_walk", "k1_iisph_dij", "k1_iisph_s",
                   "k1_surface_normals", "k1_tension_accel")
FUSED_LOOPS = ("k2_fused_kappa_drho", "k3_fused_iter_full",
               "k4_fused_visc_iter", "k6_fused_tension",
               "k7_fused_jacobi_iter", "k8_fused_pcisph_iter")


def unfused_launches(cfg, solver, iters):
    """The launches of the unfused loops' sweeps that steps of these
    (divergence, pressure, viscosity) iterations make (the unfused forms
    of solvers/*.py and viscosity.py): DFSPH's divergence solve one kappa
    sweep for its warm start, a divergence sweep before its loop and one
    of each an iteration, its pressure solve likewise (a kappa sweep and a
    divergence sweep more for its warm start, when on), the tension one
    normals and one tension sweep a step; PCISPH a prediction cut and a
    walk of its hits an iteration; IISPH a dij and an s sweep an
    iteration; one viscosity matvec an iteration."""
    steps = len(iters)
    d, p, v = (sum(i[k] for i in iters) for k in range(3))
    if solver == "pcisph":
        return {"k1_pcisph_predict": p, "k1_pcisph_walk": p}
    if solver == "iisph":
        return {"k1_iisph_dij": p, "k1_iisph_s": p, "k1_visc_acc": v}
    ws_d = int(cfg.divergence_warm_start)
    ws_p = int(cfg.pressure_warm_start)
    tension = int(cfg.tension_coff != 0.0 or cfg.tension_coff_b != 0.0)
    return {"k1_kappa_acc": steps * (ws_d + ws_p) + d + p,
            "k1_div_acc": steps * (2 + ws_p) + d + p,
            "k1_visc_acc": v,
            "k1_surface_normals": steps * tension,
            "k1_tension_accel": steps * tension}


# ---------------------------------------------------------------------------
# Phase 7: the slab decomposition (wcsph_tpu_torch/parallel)
# ---------------------------------------------------------------------------

SLAB_RANKS = 4            # ranks of the 1M run (gloo: all on the one card)
SLAB_SMALL_RANKS = 3      # ranks of the side-24 runs: an inner slab
SLAB_SMALL_SIDE = 24
SLAB_SMALL_STEPS = 6
SHARDED_STEPS = 4         # steps of each global-grid sharded step at side 24
SLAB_KICK = 3.0           # m/s in x at side 24, so that seats migrate
SLAB_SECONDS = 600        # a spawn's deadline
# The slab step against one device, from the sound runs' readings on the
# H100: 1M DFSPH after 13 steps max|dpos| 1.2e-7 to 2.4e-7 m and max|dvel|
# 1.5e-6 to 2.9e-6 m/s (the ranks sum the PCG's dot products in another
# order); side 24 IISPH and DFSPH with tension at most 6e-8 m and 7.2e-7
# m/s.  The limits sit some 40 times above those; SESPH and PCISPH sum
# nothing that decides a value and must keep every bit.
SLAB_POS_TOL = dict(rtol=0, atol=1e-5)
SLAB_VEL_TOL = dict(rtol=0, atol=1e-4)
SLAB_BIT_EQUAL = ("sesph", "pcisph")
SLAB_LABEL = "ranks sharing one card, gloo, halo staged through the host"


def slab_spawn(world, jobs, where, device, backend):
    """Run the jobs on ``world`` spawned ranks; the per-rank records and
    rank 0's gathered states (``dryrun.run_jobs``)."""
    from wcsph_tpu_torch.parallel import dryrun

    store = os.path.join(where, f"store-{backend}-{world}")
    t0 = time.perf_counter()
    dryrun.spawn(dryrun.run_jobs, world,
                 (store, jobs, where, device, backend, True),
                 timeout=SLAB_SECONDS)
    out = {}
    for job in jobs:
        ranks = []
        for r in range(world):
            with open(os.path.join(where, f"{job.name}.rank{r}.json")) as f:
                ranks.append(json.load(f))
        out[job.name] = (dict(np.load(os.path.join(where,
                                                   f"{job.name}.npz"))),
                         ranks)
    return out, time.perf_counter() - t0


# the fused loop kernels a direct-front rank may launch (DFSPH's two)
DIRECT_FUSED = ("k2_fused_kappa_drho", "k3_fused_iter_full")


def slab_gates(tag, got, ranks, ref_state, ref_iters, label, card,
               exact=False, front="slab"):
    """The slab run ``got`` (rank 0's gathered state, its iterations)
    against the single-device port's ``ref_state`` after the same steps in
    the front's loop forms: the same iterations at every step, pos and vel
    within SLAB_POS_TOL and SLAB_VEL_TOL (``exact``: bit for bit), no NaN,
    every particle in one seat (the ranks' own rows add up to the scene;
    slab_gather checks the ids; on the sharded front, every rank holding
    the same state after each step), no fused loop kernel launched on any
    rank but, on the direct front, K2 and K3 (``direct_launches``).  One
    line a rank."""
    want_pos = ref_state.pos.cpu().numpy()
    want_vel = ref_state.vel.cpu().numpy()
    iters = [tuple(int(v) for v in i) for i in got["iters"]]
    dpos = float(np.abs(got["pos"] - want_pos).max())
    dvel = float(np.abs(got["vel"] - want_vel).max())
    allowed = DIRECT_FUSED if front == "direct" else ()
    fused = sorted({k for r in ranks for k in r["launches"]
                    if k in FUSED_LOOPS and k not in allowed})
    for r in ranks:
        steps = max(len(r["step_ms"]), 1)
        per_step = {k: round(v / steps, 2) for k, v in r["launches"].items()}
        if front == "sharded":
            rows = (f"the same state on every rank at each step "
                    f"{all(r['same_on_every_rank'])}")
        else:
            counts = np.asarray(r["counts"])
            rows = (f"own rows {counts[:, 0].tolist()}, ghost rows "
                    f"{counts[:, 1].tolist()}, migrants in "
                    f"{counts[:, 2].tolist()} a step; seats {r['ncap']}, "
                    f"ghost buffer {r['kghost']}, migration buffer "
                    f"{r['kmig']}; replays {r['replays']}")
        log(f"[phase 7] {tag} rank {r['rank']}/{r['world']}: {rows}; median "
            f"step {statistics.median(r['step_ms']):.3f} ms ({label}) on "
            f"{card}; host syncs of a step {r.get('host_syncs')}; launches "
            f"a step {per_step}")
    own = (ref_state.n_total if front == "sharded"
           else sum(r["counts"][-1][0] for r in ranks))
    log(f"[phase 7] {tag}: (div, pressure, visc) iterations {iters} against "
        f"one device's {ref_iters}; max|dpos| {dpos:.3e}, max|dvel| "
        f"{dvel:.3e}; own rows {own} of {ref_state.n_total}; fused loop "
        f"kernels launched beyond the front's: {fused or 'none'}")
    if iters != [tuple(i) for i in ref_iters]:
        raise AssertionError(f"{tag}: iteration counts differ from one "
                             "device's")
    if not (np.isfinite(got["pos"]).all() and np.isfinite(got["vel"]).all()):
        raise AssertionError(f"{tag}: NaN in the slab state")
    if exact and (dpos or dvel):
        raise AssertionError(f"{tag}: the state differs from one device's, "
                             "which it must match bit for bit")
    np.testing.assert_allclose(got["pos"], want_pos, **SLAB_POS_TOL)
    np.testing.assert_allclose(got["vel"], want_vel, **SLAB_VEL_TOL)
    if own != ref_state.n_total:
        raise AssertionError(f"{tag}: {own} own rows, not one a particle")
    if front == "sharded" and not all(all(r["same_on_every_rank"])
                                      for r in ranks):
        raise AssertionError(f"{tag}: the ranks' states differ")
    if fused:
        raise AssertionError(f"{tag}: a rank launched {fused}")
    return {"front": front, "iters": iters, "max_abs_dpos": dpos,
            "max_abs_dvel": dvel,
            "ranks": [{k: r.get(k) for k in (
                "rank", "counts", "replays", "step_ms", "host_syncs",
                "launches", "ncap", "kghost", "kmig", "same_on_every_rank")}
                for r in ranks]}


def direct_launches(tag, cfg, ranks, iters, warmup, tension=False):
    """On every rank of a direct-front DFSPH run, over its timed steps:
    K2 once a step the divergence warm start asks for it, K3 once a
    divergence and a pressure iteration, no ``k1_kappa_acc`` (the unfused
    loops' kappa sweep), and with tension the unfused normals and tension
    sweeps, not K6.  A step that replays had launched K2 and its first K3
    before its first read raised: each replay in the timed steps adds
    those."""
    timed = iters[warmup:]
    ws = int(cfg.divergence_warm_start)
    for r in ranks:
        again = r["timed_replays"]
        want = {"k2_fused_kappa_drho": (len(timed) + again) * ws,
                "k3_fused_iter_full": sum(d + p for d, p, _ in timed)
                + again, "k1_kappa_acc": 0, "k6_fused_tension": 0}
        if tension:
            want.update(k1_surface_normals=len(timed),
                        k1_tension_accel=len(timed))
        got = {k: r["launches"].get(k, 0) for k in want}
        if got != want or not got["k2_fused_kappa_drho"] \
                or not got["k3_fused_iter_full"]:
            raise AssertionError(f"{tag} rank {r['rank']}: launches {got}, "
                                 f"want {want} ({again} replays)")
        log(f"[phase 7] {tag} rank {r['rank']}: launched {got} over "
            f"{len(timed)} timed steps ({again} replays)")


def fronts_side_by_side(turns, card):
    """One line a rank: each front's median step in its two turns (one
    plane, direct, direct, one plane: ``turns``, records of
    ``slab_gates``), host syncs a step, ghost rows a step and replays,
    from one call, and the direct front's mean step over the one-plane
    front's."""
    rows = []
    for per_rank in zip(*(t["ranks"] for t in turns)):
        row = {"rank": per_rank[0]["rank"]}
        for name, (a, b) in (("one_plane", (per_rank[0], per_rank[3])),
                             ("direct", (per_rank[1], per_rank[2]))):
            row[name] = {
                "median_step_ms": [statistics.median(r["step_ms"])
                                   for r in (a, b)],
                "host_syncs": a.get("host_syncs"),
                "ghost_rows": statistics.mean(c[1] for c in a["counts"]),
                "replays": a["replays"] + b["replays"]}
        one, two = (statistics.mean(row[k]["median_step_ms"])
                    for k in ("one_plane", "direct"))
        row["direct_over_one_plane"] = two / one
        log(f"[phase 7] rank {row['rank']} on {card}, one-plane / direct "
            "front: median step in turns (one, direct, direct, one) "
            f"{row['one_plane']['median_step_ms'][0]:.3f}, "
            f"{row['direct']['median_step_ms'][0]:.3f}, "
            f"{row['direct']['median_step_ms'][1]:.3f}, "
            f"{row['one_plane']['median_step_ms'][1]:.3f} ms (direct / one "
            f"{two / one:.3f}), host syncs {row['one_plane']['host_syncs']} "
            f"/ {row['direct']['host_syncs']} a step, ghost rows "
            f"{row['one_plane']['ghost_rows']:.0f} / "
            f"{row['direct']['ghost_rows']:.0f} a step, replays "
            f"{row['one_plane']['replays']} / {row['direct']['replays']}")
        rows.append(row)
    return rows


def where_they_differ(tag, got, ref_state, cfg, ranks, thresh=1e-6):
    """Where a slab run's velocities leave one device's: the liquid
    particles whose largest |dvel| component is over ``thresh``, and how
    many of them lie in the two outermost x-planes of a slab, where a halo
    error would show first (one line; a record)."""
    from wcsph_tpu_torch.parallel import halo

    nl = ref_state.n_liquid
    dv = np.abs(got["vel"] - ref_state.vel.cpu().numpy()).max(0)
    geo = halo.SlabGeometry(cfg, ranks, 0)
    fx, _ = geo.planes(ref_state.pos[:, :nl].cpu())
    off = fx.numpy().astype(np.int64) % geo.width
    edge = (off < 2) | (off >= geo.width - 2)
    big = dv > thresh
    out = {"over": int(big.sum()), "over_at_slab_edges": int((big & edge)
                                                             .sum()),
           "edge_share": float(edge.mean())}
    log(f"[phase 7] {tag}: {out['over']} particles with |dvel| over "
        f"{thresh:g}, {out['over_at_slab_edges']} of them in a slab's two "
        f"outermost x-planes (which hold {out['edge_share']:.3f} of the "
        "particles)")
    return out


def kicked(side, dev, name, **over):
    """The side-``side`` flagship path ``name`` at a fixed dt of 3 ms,
    kicked SLAB_KICK m/s in x so that seats migrate: (state, config padded
    for SLAB_SMALL_RANKS)."""
    from wcsph_tpu_torch import bench
    from wcsph_tpu_torch.parallel import halo

    solver, path_over = bench.flagship_paths(side)[name]
    sim = bench.build_sim(side, dev, solver, adaptive_dt=False,
                          dt_init=3e-3, **{**path_over, **over})
    vel = sim.state.vel.clone()
    vel[0] += SLAB_KICK
    return sim.state.replace(vel=vel), halo.slab_config(sim.cfg,
                                                        SLAB_SMALL_RANKS)


def slab_full_width(dev, card):
    """Phase 7: the 1M DFSPH dam break over SLAB_RANKS ranks sharing the
    card over gloo, on the one-plane front and on the direct front in
    turns (and
    over NCCL, one rank a card, where there are two cards or more); then
    at side 24 over SLAB_SMALL_RANKS ranks with an x-kick SESPH, PCISPH,
    IISPH and DFSPH with tension on both fronts and the four global-grid
    sharded steps (with ``halo.density_sharded``); each against the
    single-device port over the same steps in the front's loop forms."""
    import shutil
    import tempfile

    import torch

    from wcsph_tpu_torch import bench
    from wcsph_tpu_torch.parallel import dryrun, halo

    where = tempfile.mkdtemp(prefix="wcsph-slab-")
    record = {}
    try:
        steps = MAIN_WARMUP + MAIN_STEPS
        msim = bench.build_sim(MAIN_SIDE, dev, "dfsph")
        cfgs = {"slab": halo.slab_config(dataclasses.replace(
                    msim.cfg, fused_solver_iters=False), SLAB_RANKS),
                "direct": halo.slab_config(msim.cfg, SLAB_RANKS)}
        refs = {f: dryrun.reference(msim.state, cfg, "dfsph", steps, f)
                for f, cfg in cfgs.items()}
        # both fronts in turns (one plane, direct, direct, one plane), so
        # that neither owns the spawn's first or last turn
        names = {"slab": ("dfsph-1M", "dfsph-1M-2"),
                 "direct": ("dfsph-1M-direct", "dfsph-1M-direct-2")}
        order = [("slab", 0), ("direct", 0), ("direct", 1), ("slab", 1)]
        jobs = [dryrun.save_job(names[f][k], "dfsph", msim.state, cfgs[f],
                                steps, where, warmup=MAIN_WARMUP, front=f)
                for f, k in order]
        del msim
        torch.cuda.empty_cache()
        runs, secs = slab_spawn(SLAB_RANKS, jobs, where, "cuda", "gloo")
        log(f"[phase 7] 1M DFSPH over {SLAB_RANKS} {SLAB_LABEL}, one-plane "
            f"and direct front in turns: spawn, 4 x {steps} steps and the "
            f"gathers in {secs:.1f} s; not a scaling figure")
        label = f"{SLAB_RANKS} {SLAB_LABEL}"
        turns = []
        for f, k in order:
            name = names[f][k]
            what = "" if f == "slab" else ", direct front"
            turns.append(slab_gates(
                f"1M DFSPH{what}, turn {k + 1}, {SLAB_RANKS} ranks, gloo",
                *runs[name], *refs[f], label, card, front=f))
            record[f"{name}-gloo"] = turns[-1]
            if f == "direct":
                direct_launches(f"1M DFSPH, direct front, turn {k + 1}",
                                cfgs[f], runs[name][1], refs[f][1],
                                MAIN_WARMUP)
        record["fronts-1M"] = fronts_side_by_side(turns, card)
        # the two single-device references (unfused; K2 and K3 fused)
        # against each other, and where each front leaves its own
        gap = float((refs["slab"][0].vel - refs["direct"][0].vel).abs().max())
        log(f"[phase 7] one device, unfused against K2 and K3 fused, after "
            f"{steps} steps: max|dvel| {gap:.3e}")
        record["fronts-1M-where"] = {"reference_gap_max_abs_dvel": gap, **{
            f: where_they_differ(f"1M DFSPH, {f} front", runs[names[f][0]][0],
                                 refs[f][0], cfgs[f], SLAB_RANKS)
            for f in cfgs}}
        if torch.cuda.device_count() >= 2:
            # 2 or 4 ranks: the planes padded for SLAB_RANKS divide
            world = SLAB_RANKS if torch.cuda.device_count() >= SLAB_RANKS \
                else 2
            njobs = [dataclasses.replace(j, name=f"{j.name}-nccl")
                     for j in jobs[:2]]
            runs, secs = slab_spawn(world, njobs, where, "cuda:rank", "nccl")
            for j in njobs:
                record[j.name] = slab_gates(
                    f"{j.name}, {world} ranks, NCCL", *runs[j.name],
                    *refs[j.front], f"{world} ranks, one card each, NCCL",
                    card, front=j.front)
        else:
            log("[phase 7] the NCCL transport was not run: the machine has "
                f"{torch.cuda.device_count()} card (NCCL takes one rank a "
                "card)")
        del refs

        # side 24, 3 ranks: the one-plane front (unfused loops), the
        # direct front (fused loops asked for), the sharded steps
        small, refs = [], {}
        plan = [(f"{n}", "slab", n, SLAB_SMALL_STEPS, False)
                for n in ("sesph", "pcisph", "iisph", "dfsph+tension")]
        plan += [(f"direct-{n}", "direct", n, SLAB_SMALL_STEPS, True)
                 for n in ("sesph", "pcisph", "iisph", "dfsph+tension")]
        plan += [(f"sharded-{n}", "sharded", n, SHARDED_STEPS, False)
                 for n in SOLVERS]
        for name, front, path, nsteps, fused in plan:
            state, scfg = kicked(SLAB_SMALL_SIDE, dev, path,
                                 fused_solver_iters=fused)
            solver = path.split("+")[0]
            small.append(dryrun.save_job(name, solver, state, scfg, nsteps,
                                         where, front=front))
            refs[name] = (*dryrun.reference(state, scfg, solver, nsteps,
                                            front), scfg, solver, path)
            if front == "sharded":
                refs[f"{name}-density"] = dryrun.reference_density(state,
                                                                   scfg)
        runs, secs = slab_spawn(SLAB_SMALL_RANKS, small, where, "cuda",
                                "gloo")
        log(f"[phase 7] side {SLAB_SMALL_SIDE}, {SLAB_SMALL_RANKS} "
            f"{SLAB_LABEL}, kicked {SLAB_KICK} m/s in x: spawn and "
            f"{len(small)} runs in {secs:.1f} s")
        label = f"{SLAB_SMALL_RANKS} {SLAB_LABEL}"
        for name, front, path, _, _ in plan:
            got, ranks = runs[name]
            ref_state, ref_iters, scfg, solver, _ = refs[name]
            rec = slab_gates(f"side {SLAB_SMALL_SIDE} {name}", got, ranks,
                             ref_state, ref_iters, label, card,
                             exact=solver in SLAB_BIT_EQUAL, front=front)
            if front == "slab":
                moved = sum(c[2] for r in ranks for c in r["counts"])
                if moved <= 0:
                    raise AssertionError(f"side {SLAB_SMALL_SIDE} {name}: no "
                                         "seat crossed a slab boundary")
            if front == "direct" and solver == "dfsph":
                direct_launches(f"side {SLAB_SMALL_SIDE} {name}", scfg, ranks,
                                ref_iters, 0, tension="+tension" in path)
            if front == "sharded":
                rho = got["rho"]
                want = refs[f"{name}-density"].cpu().numpy()
                if not np.array_equal(rho, want):
                    raise AssertionError(f"side {SLAB_SMALL_SIDE} {name}: "
                                         "density_sharded differs from one "
                                         "device's")
                rec["density_sharded_bit_equal"] = True
            key = (name if front == "slab"
                   else f"{path}-{front}")
            record[f"{key}-side{SLAB_SMALL_SIDE}"] = rec
        log(f"[phase 7] side {SLAB_SMALL_SIDE}: density_sharded equals one "
            "device's density bit for bit on every sharded run")
    finally:
        shutil.rmtree(where, ignore_errors=True)
    return record


def phase_seconds(n, since):
    """Log phase n's seconds since ``since``; return now."""
    now = time.perf_counter()
    log(f"[phase {n}] took {now - since:.1f} s")
    return now


def main():
    import torch

    started = time.perf_counter()
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
    regs = {}
    for f in sorted(engine.BUILD_DIR.glob("*.ptxas.txt")):
        for line in f.read_text().splitlines():
            if "entry function" in line or "registers" in line:
                log(f"  ptxas: {line.strip()}")
        regs.update(ptxas_registers(f.read_text()))
    log(f"[phase 1] list walkers' registers (ptxas): "
        f"{json.dumps(walker_registers(regs))}")

    mark = phase_seconds(1, started)
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
    chk = KernelCheck()
    small_bin = (with_outside(sim.state.pos, sim.cfg), sc.n_liquid, sim.cfg)
    check_grid_stage(*small_bin, chk, np.random.RandomState(2))
    grid = build_grid(sim.state.pos, sc.n_liquid, sim.cfg)
    log(f"[phase 2] side {side} squeezed 0.92: M={grid.n} rows, "
        f"{grid.liquid_count} liquid")
    inp = kernel_inputs(grid, sc.positions[: sc.n_liquid],
                        np.random.RandomState(0))
    count = check_list(grid, inp["vel"], chk)
    check_list_capacity(grid, count, chk)
    check_list_required(grid, inp, count)
    cases = kernel_cases(grid, inp)
    if {c[0] for c in cases} != set(engine.KERNELS):
        raise AssertionError("a kernel entry has no case")
    check_kernels(grid, cases, chk)
    check_k8_hits(grid, inp, chk)
    check_predict_hits(grid, inp, chk)
    check_surface(grid, chk, f"side {side}")
    check_dense(sim.cfg, side, chk)
    log("[phase 2] every kernel agrees with its plain twin")

    mark = phase_seconds(2, mark)
    # ---- phase 3: whole steps -------------------------------------------
    from wcsph_tpu_torch import dam_break

    gsc = dam_break(particle_radius=r, fluid_dims=(5, 5, 5), box_extent=0.55)
    glo, ghi = gsc.domain(pad=4 * r)
    # every solver fused, and the three with a solver loop unfused
    goldens = [(s, True) for s in SOLVERS] + [
        (s, False) for s in SOLVERS if s != "sesph"]
    for solver, fused in goldens:
        ref = np.load(os.path.join(GOLDEN_DIR, f"{solver}_golden.npz"))
        gsim = Simulation(gsc, default_config(
            solver, particle_radius=r, domain_min=glo, domain_max=ghi,
            fused_solver_iters=fused), solver=solver, device=dev)
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
        log(f"[phase 3] {solver}{'' if fused else ' unfused'} golden 20 "
            f"steps on CUDA within golden tolerances (max|dpos|={dpos:.2e})")

    tension = dict(tension_coff=0.25, tension_coff_b=0.4,
                   adhesion_center=(0.0, -0.45, 0.0), adhesion_radius=0.3)
    pressurized = [(s, {}) for s in SOLVERS] + [("dfsph", tension)]
    for solver, over in pressurized:
        psc = squeezed_dam_break(8, 0.90 if solver == "pcisph" else 0.92,
                                 box_extent=0.9)
        plo, phi = psc.domain(pad=4 * r)
        fused_iters = None
        # the fused loops, then (where the solver has a loop) the unfused
        for fused in ((True,) if solver == "sesph" else (True, False)):
            pcfg = default_config(solver, particle_radius=r, domain_min=plo,
                                  domain_max=phi, fused_solver_iters=fused,
                                  **over)
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
                        pmax = max(pmax,
                                   float(psim.state.pressure.abs().max()))
                psim.check_health()
                traces.append((iters, psim.state.pos.cpu().numpy(), pmax))
            tag = (solver + (" + tension" if over else "")
                   + ("" if fused else " unfused"))
            log(f"[phase 3] pressurized side 8, {tag}: (div, pressure, "
                f"visc) iters per step: kernels {traces[0][0]}, plain "
                f"{traces[1][0]}; max|p| over the steps {traces[0][2]:.4g}")
            if traces[0][0] != traces[1][0]:
                raise AssertionError(f"pressurized {tag}: iteration counts "
                                     f"differ")
            np.testing.assert_allclose(traces[0][1], traces[1][1], rtol=2e-4,
                                       atol=2e-5)
            if fused:
                fused_iters = traces[0][0]
            elif traces[0][0] != fused_iters:
                raise AssertionError(
                    f"pressurized {tag}: iteration counts {traces[0][0]} "
                    f"differ from the fused port's {fused_iters}")
    for solver, over in (("dfsph", {}), ("pcisph", {}), ("iisph", {}),
                         ("dfsph", tension)):
        check_replay(solver, dev, over)

    mark = phase_seconds(3, mark)
    # ---- phase 4: the paths at full width -----------------------------------
    # the kernels each path must launch
    visc = ("k1_visc_init", "k4_fused_visc_iter")
    # once per step: the grid stage on every path, the list on two
    stage = ("bin_cells", "pack_rows", "unpack_rows")
    listed = ("nbr_list_offsets", "nbr_list_fill")
    dfsph_kernels = ("k1_density_alpha_drho", "k1_div_acc",
                     "k1_vorticity", "k2_fused_kappa_drho",
                     "k3_fused_iter_full") + visc + stage + listed
    # the unfused loops: K1's emits in place of K2-K4 and K6-K8
    dfsph_unfused = ("k1_density_alpha_drho", "k1_div_acc", "k1_vorticity",
                     "k1_visc_init", "k1_kappa_acc", "k1_visc_acc") + stage \
        + listed
    must_launch = {
        "dfsph": dfsph_kernels,
        "sesph": ("k5_density_alpha", "k5_sesph_force") + stage,
        "pcisph": ("k5_density_alpha", "k5_sesph_force",
                   "k8_fused_pcisph_iter") + stage,
        "iisph": ("k5_density_alpha", "k5_iisph_adv", "k5_iisph_aii",
                  "k5_iisph_force", "k7_fused_jacobi_iter") + visc + stage
        + listed,
        "dfsph+tension": dfsph_kernels + ("k6_fused_tension",),
        "dfsph-unfused": dfsph_unfused,
        "pcisph-unfused": ("k5_density_alpha", "k5_sesph_force",
                           "k1_pcisph_predict", "k1_pcisph_walk") + stage,
        "iisph-unfused": ("k5_density_alpha", "k5_iisph_adv",
                          "k5_iisph_aii", "k5_iisph_force", "k1_visc_init",
                          "k1_visc_acc", "k1_iisph_dij", "k1_iisph_s")
        + stage + listed,
        "dfsph+tension-unfused": dfsph_unfused + ("k1_surface_normals",
                                                  "k1_tension_accel"),
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
        once = stage + (listed if solver in ("dfsph", "iisph") else ())
        if any(res["launches"][k] != res["steps"] for k in once):
            raise AssertionError(f"{path}: {once} did not run once per step")
        fused = msim.cfg.fused_solver_iters
        if fused:
            ran_unfused = [k for k in UNFUSED_ENTRIES if res["launches"][k]]
            if ran_unfused:
                raise AssertionError(f"{path} launched the unfused loops' "
                                     f"{ran_unfused}")
        else:
            ran_fused = [k for k in FUSED_LOOPS if res["launches"][k]]
            want = unfused_launches(msim.cfg, solver, res["iters"])
            got = {k: res["launches"][k] for k in want}
            log(f"[phase 4] {path}: the unfused entries launched {got} "
                f"times, as its iterations ask ({want}); launched of "
                f"{', '.join(FUSED_LOOPS)}: {ran_fused or 'none'}")
            if ran_fused or got != want:
                raise AssertionError(f"{path}: the unfused step launched "
                                     f"{got} (want {want}) and {ran_fused}")
        if res["replays"]:
            raise AssertionError(f"{path}: {res['replays']} list replays in "
                                 "the timed window")
        for k, v in res["launches"].items():
            launches[k] += v
        ran_clean = stage_without_sync(msim, solver)
        syncs = bench.host_syncs(msim.step)
        dg = msim.state.diag
        sync_iters = (dg.divergence_iters, dg.pressure_iters,
                      dg.viscosity_iters)
        log(f"[phase 4] {path}: {ran_clean} ran under "
            f"set_sync_debug_mode('error') with no host read; one step made "
            f"{syncs} host synchronizations (counted under 'warn'), its "
            f"(div, pressure, visc) iterations {sync_iters}; "
            f"{res['replays']} list replays in the timed window")
        path_records[path] = {
            "particle_steps_per_s": res["particle_steps_per_s"],
            "n_liquid": res["n_liquid"], "iters": res["iters"],
            "step_ms": res["step_ms"], "launches": ran,
            "host_syncs_per_step": syncs, "host_sync_step_iters": sync_iters,
            "replays": res["replays"]}
        if solver == "pcisph" and not fused:
            walks, width, most, again = walk_rescans(msim)
            log(f"[phase 4] {path}: one more step's {walks} prediction "
                f"walks at width {width} (the buffer sized by the first "
                f"step): the most hits of a row {most}, rows scanned again "
                f"{again} (expected 0)")
            path_records[path]["walk_rescans"] = {
                "walks": walks, "width": width, "most_hits": most,
                "rows_scanned_again": again}
        if not fused:
            # one host read an iteration in either form: beyond those, the
            # unfused step may read no more than the fused one
            base = path_records[path.removesuffix("-unfused")]
            extra = syncs - sum(sync_iters)
            base_extra = (base["host_syncs_per_step"]
                          - sum(base["host_sync_step_iters"]))
            log(f"[phase 4] {path} beside {path.removesuffix('-unfused')} "
                f"on {card}: median step "
                f"{statistics.median(res['step_ms']):.3f} ms against "
                f"{statistics.median(base['step_ms']):.3f} ms; host "
                f"synchronizations of a step {syncs} ({extra} beyond one an "
                f"iteration) against {base['host_syncs_per_step']} "
                f"({base_extra})")
            if extra > base_extra:
                raise AssertionError(f"{path}: more host synchronizations a "
                                     "step than the fused path")
        if path == "dfsph":
            mstate, mcfg = msim.state, msim.cfg
        del msim
        torch.cuda.empty_cache()
    missing = [k for k, v in launches.items()
               if v <= 0 and k not in (*SURFACE_KERNELS, *TOOLING_KERNELS)]
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
    check_grid_stage(mstate.pos, mstate.n_liquid, mgrid.cfg, chk,
                     np.random.RandomState(3))
    check_bin_alternating([small_bin, (mstate.pos, mstate.n_liquid,
                                       mgrid.cfg), small_bin])
    mcount = check_list(mgrid, minp["vel"], chk)
    check_list_capacity(mgrid, mcount, chk)
    cases = kernel_cases(mgrid, minp)
    check_kernels(mgrid, cases, chk)
    check_k8_hits(mgrid, minp, chk)
    check_predict_hits(mgrid, minp, chk)
    check_jittered_walks(mstate, mgrid.cfg, chk, np.random.RandomState(5))
    log(f"[phase 4] the grid stage, the list and every kernel agree with "
        f"their plain twins at M={mgrid.n}, {', '.join(DEEP_WALKS)} also "
        f"with the liquid jittered by +-{JITTER} r")
    times = time_kernels(mgrid, cases, mcount)
    grid_times = time_grid_stage(mgrid, mstate.pos, mstate.n_liquid, mcount,
                                 np.random.RandomState(4))
    times.update({k: v[:2] for k, v in grid_times.items()})
    counts = pair_counts(mgrid, minp, mstate.n_liquid)
    bound = bounds(mgrid, counts, k_fields=11)
    rows = mgrid.n
    log(f"[phase 4] pairs within h at M={rows}: {counts}")
    for name, (ms, by) in bound.items():
        log(f"  {name}: bound {ms:.4f} ms by {by}; kernel "
            f"{times[name][0] / ms:.1f}x its bound")

    mark = phase_seconds(4, mark)
    # ---- phase 5: surface reconstruction at full width --------------------
    del mgrid, minp, cases, mcount
    torch.cuda.empty_cache()
    (surf_launches, surf_times, surf_bound, surface,
     surf_library) = surface_full_width(mstate, mcfg, chk, card)
    for name in SURFACE_KERNELS:
        launches[name] = surf_launches[name]
        log(f"  {name}: bound {surf_bound[name][0]:.4f} ms by "
            f"{surf_bound[name][1]}; kernel "
            f"{surf_times[name][0] / surf_bound[name][0]:.1f}x its bound")
    times.update(surf_times)
    bound.update(surf_bound)
    library = {k: v[2] for k, v in grid_times.items()}
    library.update(surf_library)

    mark = phase_seconds(5, mark)
    # ---- phase 6: the mesh-scene tooling and the showcase ----------------
    torch.cuda.empty_cache()
    tool_launches, tool_times, tool_bound, tooling = tooling_full_width(
        mstate, chk, card)
    del mstate
    for name in TOOLING_KERNELS:
        launches[name] = tool_launches[name]
        times[name] = tool_times[name][:2]
        library[name] = tool_times[name][2]
    bound.update(tool_bound)
    mark = phase_seconds(6, mark)
    # ---- phase 7: the slab decomposition -----------------------------------
    torch.cuda.empty_cache()
    slab = slab_full_width(dev, card)
    phase_seconds(7, mark)
    log(f"[phases] the whole script: {time.perf_counter() - started:.1f} s")

    # no single PyTorch call computes a neighbour sweep over a cell list (or
    # the list itself, or the surface's field or moments over the cells'
    # windows, or a sampler's phase step): library yardsticks for the grid
    # stage, for aniso_g (torch.linalg.eigh of the same matrices) and for
    # splat_points (scatter_reduce_ of the same keys)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": chk.max_abs[name],
         "ms": times[name][0], "plain_ms": times[name][1],
         "bound_ms": bound[name][0], "bound_by": bound[name][1],
         "library_ms": library.get(name),
         "device_ms": (times[name][2] if len(times[name]) > 2
                       else grid_times[name][3] if name in grid_times
                       else None)}
        for name, (src, rep, _) in [
            *engine.KERNELS.items(),
            *[(n, (src, "none: " + what, tw))
              for n, (src, what, tw) in engine.OWN_KERNELS.items()]]],
        "card": card, "rows": rows, "pairs": counts,
        "grid_stage_device_ms": {k: v[3] for k, v in grid_times.items()},
        "grid_stage_kernels_per_call": {k: v[4]
                                        for k, v in grid_times.items()},
        "paths": path_records, "surface": surface, "tooling": tooling,
        "slab": slab}
    log(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
