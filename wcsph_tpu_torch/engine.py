"""The hand kernels of the port, their plain twins, and the build.

Every wrapper below has one plain PyTorch twin in ``dense_ops.py`` with the
same arguments and outputs.  The wrapper picks by the tensors' device:

* CPU tensors go to the plain twin (the CPU tests);
* CUDA tensors go to the kernel in ``csrc/``.  If the kernel cannot be
  built or launched the wrapper raises; nothing falls back.
  Only inside ``plain_twins()``, the one explicit switch, do they go to the
  plain twin instead: the oracle that ``chip_smoke.py`` holds the kernels
  against on the card.

Each wrapper adds one to its launch counter (``LAUNCHES``) where it
launches its kernel on the card, and nowhere else, so a run can show that
its path went through the kernels.

The kernels (K1-K8, one per Pallas kernel of ``wcsph_tpu/pallas/engine.py``):

=====  ==========================  =========================================
K1     ``k1_density_alpha_drho``,  pair sweep, one launch per call
       ``k1_div_acc``,
       ``k1_visc_init``,
       ``k1_vorticity``
K2     ``k2_fused_kappa_drho``     gated kappa sweep, then divergence sweep
K3     ``k3_fused_iter_full``      whole divergence / pressure iteration
K4     ``k4_fused_visc_iter``      whole viscosity-PCG iteration
K5     ``k5_density_alpha``,       one-sided sweep templated on its emit,
       ``k5_sesph_force``,         one launch per call
       ``k5_iisph_adv``,
       ``k5_iisph_aii``,
       ``k5_iisph_force``
K6     ``k6_fused_tension``        surface normals, then tension on them
K7     ``k7_fused_jacobi_iter``    whole IISPH relaxed-Jacobi iteration
K8     ``k8_fused_pcisph_iter``    whole PCISPH prediction iteration
=====  ==========================  =========================================

Five walkers read the step's neighbour list (``grid.NeighborList``)
instead of the 27 cells: K2, K3, ``k1_div_acc`` (which shares K2's
divergence launch), ``k1_vorticity`` and K4.  A DFSPH or IISPH step builds
the list once, right after its density sweep, with ``nbr_list_fill``, a
kernel of the port's own design that no TPU kernel corresponds to
(``OWN_KERNELS``).  On the card these five raise where the grid has no
list; their plain twins need none.

The libraries are built at first use on CUDA: one ``nvcc`` per
``csrc/*.cu``, all started together, for ``sm_90a`` into ``_build/``, keyed
by a hash of the sources and flags, and the plain C entry points are bound
with ``ctypes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import dense_ops, kernels
from .grid import Grid, NeighborList, slice_offsets
from .utils import mat3

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_SRC = "wcsph_tpu_torch/csrc/sweeps.cu"
_SRC2 = "wcsph_tpu_torch/csrc/solver_sweeps.cu"
_ENG = "wcsph_tpu/pallas/engine.py:"
_SYM = _ENG + "441 (_build_sweep_sym, emit "
_ONE = _ENG + "279 (_build_sweep, emit "
# wrapper name -> (kernel source, TPU kernel it replaces, plain twin)
KERNELS = {
    "k1_density_alpha_drho": (_SRC, _SYM + "_DensityAlphaDrho 1973)",
                              dense_ops.density_alpha_drho),
    "k1_div_acc": (_SRC, _SYM + "_DivAcc 2023)", dense_ops.div_acc),
    "k1_visc_init": (_SRC, _SYM + "_ViscInit 2092)", dense_ops.visc_init),
    "k1_vorticity": (_SRC, _SYM + "_Vorticity 2133)", dense_ops.vorticity),
    "k2_fused_kappa_drho": (_SRC, _ENG + "736 (_build_fused_iter)",
                            dense_ops.fused_kappa_drho),
    "k3_fused_iter_full": (_SRC, _ENG + "1041 (_build_fused_iter_full)",
                           dense_ops.fused_iter_full),
    "k4_fused_visc_iter": (_SRC, _ENG + "1677 (_build_fused_visc_iter)",
                           dense_ops.fused_visc_iter),
    "k5_density_alpha": (_SRC2, _ONE + "_DensityAlpha 1920)",
                         dense_ops.density_alpha),
    "k5_sesph_force": (_SRC2, _ONE + "_SesphForce 2214)",
                       dense_ops.sesph_force),
    "k5_iisph_adv": (_SRC2, _ONE + "_IisphAdv 2337)", dense_ops.iisph_adv),
    "k5_iisph_aii": (_SRC2, _ONE + "_IisphAii 2374)", dense_ops.iisph_aii),
    "k5_iisph_force": (_SRC2, _ONE + "_IisphForce 2466)",
                       dense_ops.iisph_force),
    "k6_fused_tension": (_SRC2, _ENG + "904 (_build_fused_tension)",
                         dense_ops.fused_tension),
    "k7_fused_jacobi_iter": (_SRC2, _ENG + "1238 (_build_fused_iisph_iter)",
                             dense_ops.fused_jacobi_iter),
    "k8_fused_pcisph_iter": (_SRC2, _ENG + "1466 (_build_fused_pcisph_iter)",
                             dense_ops.fused_pcisph_iter),
}
# kernels of the port's own design, counterparts of no TPU kernel:
# wrapper name -> (kernel source, what it serves, plain twin)
OWN_KERNELS = {
    "nbr_list_fill": (_SRC, "the neighbour list that K2, K3, k1_div_acc, "
                      "k1_vorticity and K4 walk", dense_ops.neighbor_list),
}
LAUNCHES = {name: 0 for name in (*KERNELS, *OWN_KERNELS)}
BLOCK = 256          # threads per block of every sweep (csrc/common.cuh)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

class _Geom(ctypes.Structure):
    """Mirror of ``struct Geom`` in csrc/common.cuh (same field order)."""

    _fields_ = [("pos", ctypes.c_void_p), ("liq", ctypes.c_void_p),
                ("cell", ctypes.c_void_p), ("start", ctypes.c_void_p),
                ("M", ctypes.c_int), ("gx", ctypes.c_int),
                ("gy", ctypes.c_int), ("gz", ctypes.c_int),
                ("h", ctypes.c_float), ("h2", ctypes.c_float),
                ("vl", ctypes.c_float), ("vs", ctypes.c_float),
                ("w_sigma", ctypes.c_float), ("gs_ml", ctypes.c_float),
                ("nl_idx", ctypes.c_void_p), ("nl_off", ctypes.c_void_p),
                ("nl_rec", ctypes.c_void_p)]


class _TensionParams(ctypes.Structure):
    """Mirror of ``struct TensionParams`` in csrc/solver_sweeps.cu."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "coh", "adh", "curv", "rho0x2", "eps", "coh_k", "coh_c", "adh_k",
        "cx", "cy", "cz", "radius2")]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_G = ctypes.POINTER(_Geom)
_T = ctypes.POINTER(_TensionParams)
_SIGNATURES = {
    "k1_density_alpha_drho": [_G, _P, _P, _P],
    "k1_div_acc": [_G, _P, _P, _P],
    "k1_visc_init": [_G, _P, _P, _F, _F, _F, _P, _P],
    "k1_vorticity": [_G, _P, _P, _P, _F, _F, _F, _P, _P],
    "k2_fused_kappa_drho": [_G, _P, _P, _P, _P, _P],
    "k3_fused_iter_full": [_G, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P],
    "k4_fused_visc_iter": [_G, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                           _P, _P, _P, _P, _P],
    "k5_density_alpha": [_G, _P, _P],
    "k5_sesph_force": [_G, _P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _P],
    "k5_iisph_adv": [_G, _P, _P, _P],
    "k5_iisph_aii": [_G, _P, _P, _P],
    "k5_iisph_force": [_G, _P, _P, _P],
    "k6_fused_tension": [_G, _P, _P, _T, _F, _P, _P, _P],
    "k7_fused_jacobi_iter": [_G, _P, _P, _P, _P, _P, _F, _F, _F, _P, _P, _P,
                             _P, _P],
    "k8_fused_pcisph_iter": [_G, _P, _P, _F, _F, _F, _P, _P, _P, _P, _P],
    "nbr_list_fill": [_G, _P, _P, _P, _P, _P],
}

_lib = None
BUILD_SECONDS = None


def _nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def build_library(build_dir: Path | None = None) -> dict:
    """Compile every csrc/*.cu into a shared library of its own (one nvcc
    per source, all started together; once per hash of the sources and
    flags), load them and return {entry point name: bound function}.
    Raises RuntimeError, with nvcc's output, when nvcc is missing or a build
    fails."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    cus = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in cus + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    libs = [build_dir / f"libwcsph_{s.stem}_{tag}.so" for s in cus]
    todo = [(s, lib) for s, lib in zip(cus, libs) if not lib.exists()]
    if todo:
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
                "wcsph_tpu_torch are built from csrc/ at first use on CUDA")
        build_dir.mkdir(parents=True, exist_ok=True)
        running = []
        for s, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            report = build_dir / (lib.stem + ".ptxas.txt")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
            with open(report, "w") as out:
                running.append((cmd, tmp, lib, report, subprocess.Popen(
                    cmd, stdout=out, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, tmp, lib, report, proc in running:
            if proc.wait() != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{report.read_text()}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
    fns = {}
    for lib_path in libs:
        lib = ctypes.CDLL(str(lib_path))
        for name, args in _SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
                fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise RuntimeError(f"no source under {SRC_DIR} defines {missing}")
    return fns


def library():
    """The kernels' entry points by name, built on first call."""
    global _lib, BUILD_SECONDS
    if _lib is None:
        t0 = time.perf_counter()
        _lib = build_library()
        BUILD_SECONDS = time.perf_counter() - t0
    return _lib


def _geom(grid: Grid, listed: bool = False) -> _Geom:
    """The grid's geometry for a launch; ``listed``: the kernel walks the
    step's neighbour list, which must exist."""
    cfg = grid.cfg
    gx, gy, gz = cfg.grid_res
    h = cfg.support_radius
    nl = grid.nbr
    if listed and nl is None:
        raise ValueError("this sweep walks the step's neighbour list: build "
                         "it first (engine.nbr_list_fill)")
    tensors = [grid.pos, grid.liq, grid.cell, grid.cell_start]
    if nl is not None:
        tensors += [nl.idx, nl.off, nl.rec]
    for t in tensors:
        if not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError("grid tensors must be contiguous, on the card")
    if nl is not None and nl.rec.data_ptr() % 16:
        raise ValueError("the list's records are read as float4: 16-byte "
                         "alignment")
    if 9 * grid.n >= 2 ** 31:
        raise ValueError("row indices of the kernels are 32-bit: "
                         f"{grid.n} rows is too many")
    return _Geom(grid.pos.data_ptr(), grid.liq.data_ptr(),
                 grid.cell.data_ptr(), grid.cell_start.data_ptr(),
                 grid.n, gx, gy, gz, h, h * h, cfg.liquid_volume,
                 cfg.solid_volume, kernels.cubic_w0(h),
                 48.0 / (math.pi * h * h * h),
                 nl.idx.data_ptr() if nl is not None else None,
                 nl.off.data_ptr() if nl is not None else None,
                 nl.rec.data_ptr() if nl is not None else None)


def _check(*tensors, shapes):
    for t, shp in zip(tensors, shapes):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"operand shape {tuple(t.shape)} != {shp}")
        if t.device.type != "cuda":
            raise ValueError("kernel operands must all be on the card")


def _launch(name: str, *args) -> None:
    rc = library()[name](*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_plain_on_card = False     # set only by plain_twins()


@contextlib.contextmanager
def plain_twins():
    """Send CUDA tensors to the plain twins too, inside this block: the
    oracle that ``chip_smoke.py`` holds the kernels against on the card.
    No launch is counted there."""
    global _plain_on_card
    _plain_on_card = True
    try:
        yield
    finally:
        _plain_on_card = False


def _route(t: torch.Tensor) -> bool:
    """True for the kernel on the card, False for the plain twin (CPU
    tensors, or CUDA tensors inside ``plain_twins``)."""
    if t.device.type == "cuda":
        return not _plain_on_card
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain twin for device {t.device}")


def _nblocks(m: int) -> int:
    return max(1, -(-m // BLOCK))


# ---------------------------------------------------------------------------
# Kernel wrappers (plain twin on CPU tensors)
# ---------------------------------------------------------------------------

def k1_density_alpha_drho(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    if not _route(vel):
        return dense_ops.density_alpha_drho(grid, vel)
    m = grid.n
    _check(vel, shapes=[(3, m)])
    out = torch.empty((7, m), dtype=torch.float32, device=vel.device)
    _launch("k1_density_alpha_drho", ctypes.byref(_geom(grid)),
            vel.data_ptr(), out.data_ptr(), _stream())
    return out


def k1_div_acc(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    if not _route(vel):
        return dense_ops.div_acc(grid, vel)
    m = grid.n
    _check(vel, shapes=[(3, m)])
    out = torch.empty((m,), dtype=torch.float32, device=vel.device)
    _launch("k1_div_acc", ctypes.byref(_geom(grid, listed=True)),
            vel.data_ptr(), out.data_ptr(), _stream())
    return out


def k1_visc_init(grid: Grid, x: torch.Tensor,
                 rinv: torch.Tensor) -> torch.Tensor:
    if not _route(x):
        return dense_ops.visc_init(grid, x, rinv)
    a_liq, b_sol = dense_ops.visc_consts(grid.cfg)
    m = grid.n
    _check(x, rinv, shapes=[(3, m), (m,)])
    h = grid.cfg.support_radius
    out = torch.empty((9, m), dtype=torch.float32, device=x.device)
    _launch("k1_visc_init", ctypes.byref(_geom(grid)), x.data_ptr(),
            rinv.data_ptr(), a_liq, b_sol, 0.01 * h * h, out.data_ptr(),
            _stream())
    return out


def k1_vorticity(grid: Grid, vel: torch.Tensor, om: torch.Tensor,
                 rinv: torch.Tensor) -> torch.Tensor:
    if not _route(vel):
        return dense_ops.vorticity(grid, vel, om, rinv)
    m = grid.n
    _check(vel, om, rinv, shapes=[(3, m), (3, m), (m,)])
    cfg = grid.cfg
    out = torch.empty((9, m), dtype=torch.float32, device=vel.device)
    _launch("k1_vorticity", ctypes.byref(_geom(grid, listed=True)),
            vel.data_ptr(), om.data_ptr(), rinv.data_ptr(), cfg.liquid_mass,
            cfg.rest_density * cfg.solid_volume,
            cfg.rest_density * cfg.liquid_volume, out.data_ptr(), _stream())
    return out


def k2_fused_kappa_drho(grid: Grid, vel: torch.Tensor, kf: torch.Tensor,
                        gate: torch.Tensor, acc: torch.Tensor):
    """In place: vel += gate sum V_j (k'_i + k'_j) gs r; acc = divergence
    sum of the new vel.  Returns (vel, acc)."""
    if not _route(vel):
        return dense_ops.fused_kappa_drho(grid, vel, kf, gate, acc)
    m = grid.n
    _check(vel, kf, gate, acc, shapes=[(3, m), (m,), (m,), (m,)])
    _launch("k2_fused_kappa_drho", ctypes.byref(_geom(grid, listed=True)),
            vel.data_ptr(), kf.data_ptr(), gate.data_ptr(), acc.data_ptr(),
            _stream())
    return vel, acc


def k3_fused_iter_full(grid: Grid, vel: torch.Tensor, kv: torch.Tensor,
                       s: torch.Tensor, a: torch.Tensor, paux: torch.Tensor,
                       dt, mode: int) -> torch.Tensor:
    """In place on vel, kv, S; returns the 0-dim error sum (see
    dense_ops.fused_iter_full)."""
    if not _route(vel):
        return dense_ops.fused_iter_full(grid, vel, kv, s, a, paux, dt, mode)
    m = grid.n
    _check(vel, kv, s, a, paux, shapes=[(3, m), (m,), (m,), (m,), (m,)])
    partials = torch.empty((_nblocks(m),), dtype=torch.float32,
                           device=vel.device)
    err = torch.empty((), dtype=torch.float32, device=vel.device)
    _launch("k3_fused_iter_full", ctypes.byref(_geom(grid, listed=True)),
            vel.data_ptr(), kv.data_ptr(), s.data_ptr(), a.data_ptr(),
            paux.data_ptr(), float(dt), int(mode), partials.data_ptr(),
            err.data_ptr(), _stream())
    return err


def k4_fused_visc_iter(grid: Grid, x: torch.Tensor, r: torch.Tensor,
                       d: torch.Tensor, delta: torch.Tensor,
                       rinv: torch.Tensor, minv6: torch.Tensor,
                       dt) -> torch.Tensor:
    """In place on x, r, d; returns (2,) [eps + d.Ad, delta'] (see
    dense_ops.fused_visc_iter)."""
    if not _route(x):
        return dense_ops.fused_visc_iter(grid, x, r, d, delta, rinv, minv6,
                                         dt)
    cfg = grid.cfg
    a_liq, b_sol = dense_ops.visc_consts(cfg)
    m = grid.n
    _check(x, r, d, delta, rinv, minv6,
           shapes=[(3, m), (3, m), (3, m), (), (m,), (6, m)])
    h = cfg.support_radius
    ad = torch.empty((3, m), dtype=torch.float32, device=x.device)
    s = torch.empty((3, m), dtype=torch.float32, device=x.device)
    partials = torch.empty((_nblocks(m),), dtype=torch.float32,
                           device=x.device)
    scal = torch.empty((2,), dtype=torch.float32, device=x.device)
    _launch("k4_fused_visc_iter", ctypes.byref(_geom(grid, listed=True)),
            x.data_ptr(), r.data_ptr(), d.data_ptr(), rinv.data_ptr(),
            minv6.data_ptr(), delta.data_ptr(), float(dt), cfg.eps, a_liq,
            b_sol, 0.01 * h * h, ad.data_ptr(), s.data_ptr(),
            partials.data_ptr(), scal.data_ptr(), _stream())
    return scal


def nbr_list_fill(grid: Grid, count: torch.Tensor) -> NeighborList:
    """Build the neighbour list of the grid's positions, keep it as
    ``grid.nbr`` and return it.  ``count`` (M,) is the density sweep's
    neighbour count of each row; the slice widths follow from it (torch
    ops and one host read of the number of slots), then the fill kernel
    writes the slots and each row's record.  Raises ValueError, after a
    second host read, where a liquid row has more pairs within h than its
    slice has slots (a count too low), as the plain twin does."""
    if not _route(count):
        grid.nbr = dense_ops.neighbor_list(grid, count)
        return grid.nbr
    if count.shape != (grid.n,) or count.device.type != "cuda":
        raise ValueError("count must be (M,), on the card")
    off, total = slice_offsets(count, grid.liquid)
    idx = torch.empty((total,), dtype=torch.int32, device=count.device)
    rec = torch.empty((grid.n, 4), dtype=torch.float32, device=count.device)
    overflow = torch.zeros((), dtype=torch.int32, device=count.device)
    _launch("nbr_list_fill", ctypes.byref(_geom(grid)), off.data_ptr(),
            idx.data_ptr(), rec.data_ptr(), overflow.data_ptr(), _stream())
    if overflow.item():
        raise ValueError("count differs from the pairs within h: a row has "
                         "more neighbours than its slots")
    grid.nbr = NeighborList(idx=idx, off=off, rec=rec)
    return grid.nbr


def _sweep(name: str, grid: Grid, operands, shapes, n_out, *consts):
    """Launch a K5 entry: checked operands, then constants, then the
    (n_out, M) output."""
    _check(*operands, shapes=shapes)
    out = torch.empty((n_out, grid.n), dtype=torch.float32,
                      device=grid.device)
    _launch(name, ctypes.byref(_geom(grid)),
            *[t.data_ptr() for t in operands], *consts, out.data_ptr(),
            _stream())
    return out


def k5_density_alpha(grid: Grid) -> torch.Tensor:
    if not _route(grid.pos):
        return dense_ops.density_alpha(grid)
    return _sweep("k5_density_alpha", grid, [], [], 2)


def k5_sesph_force(grid: Grid, vel: torch.Tensor, rinv: torch.Tensor,
                   rr: torch.Tensor, pi: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    if not _route(vel):
        return dense_ops.sesph_force(grid, vel, rinv, rr, pi, p)
    m = grid.n
    cfg = grid.cfg
    a_liq, b_sol = dense_ops.explicit_visc_consts(cfg)
    h = cfg.support_radius
    return _sweep("k5_sesph_force", grid, [vel, rinv, rr, pi, p],
                  [(3, m), (m,), (m,), (m,), (m,)], 3, a_liq, b_sol,
                  0.01 * h * h, cfg.rest_density)


def k5_iisph_adv(grid: Grid, vel: torch.Tensor) -> torch.Tensor:
    if not _route(vel):
        return dense_ops.iisph_adv(grid, vel)
    return _sweep("k5_iisph_adv", grid, [vel], [(3, grid.n)], 5)


def k5_iisph_aii(grid: Grid, dii: torch.Tensor) -> torch.Tensor:
    if not _route(dii):
        return dense_ops.iisph_aii(grid, dii)
    return _sweep("k5_iisph_aii", grid, [dii], [(3, grid.n)], 1)[0]


def k5_iisph_force(grid: Grid, dpi: torch.Tensor) -> torch.Tensor:
    if not _route(dpi):
        return dense_ops.iisph_force(grid, dpi)
    return _sweep("k5_iisph_force", grid, [dpi], [(grid.n,)], 3)


def k6_fused_tension(grid: Grid, ril: torch.Tensor, rho: torch.Tensor):
    """(h-scaled surface normals (3, M), tension acceleration (3, M)) at
    liquid rows (see dense_ops.fused_tension)."""
    if not _route(rho):
        return dense_ops.fused_tension(grid, ril, rho)
    m = grid.n
    cfg = grid.cfg
    _check(ril, rho, shapes=[(m,), (m,)])
    normals = torch.empty((3, m), dtype=torch.float32, device=rho.device)
    acc = torch.empty((3, m), dtype=torch.float32, device=rho.device)
    t = dense_ops.tension_consts(cfg)
    params = _TensionParams(
        t["coh"], t["adh"], t["curv"], t["rho0x2"], cfg.eps, t["coh_k"],
        t["coh_c"], t["adh_k"], *cfg.adhesion_center,
        cfg.adhesion_radius ** 2)
    _launch("k6_fused_tension", ctypes.byref(_geom(grid)), ril.data_ptr(),
            rho.data_ptr(), ctypes.byref(params), cfg.liquid_mass,
            normals.data_ptr(), acc.data_ptr(), _stream())
    return normals, acc


def k7_fused_jacobi_iter(grid: Grid, dii: torch.Tensor, deninv: torch.Tensor,
                         aii: torch.Tensor, b: torch.Tensor, p: torch.Tensor,
                         dt):
    """In place on p; returns (dij (3, M), s (M,), 0-dim residual sum) (see
    dense_ops.fused_jacobi_iter)."""
    if not _route(p):
        return dense_ops.fused_jacobi_iter(grid, dii, deninv, aii, b, p, dt)
    m = grid.n
    cfg = grid.cfg
    _check(dii, deninv, aii, b, p, shapes=[(3, m), (m,), (m,), (m,), (m,)])
    dij = torch.empty((3, m), dtype=torch.float32, device=p.device)
    s = torch.empty((m,), dtype=torch.float32, device=p.device)
    partials = torch.empty((_nblocks(m),), dtype=torch.float32,
                           device=p.device)
    resid = torch.empty((), dtype=torch.float32, device=p.device)
    _launch("k7_fused_jacobi_iter", ctypes.byref(_geom(grid)),
            dii.data_ptr(), deninv.data_ptr(), aii.data_ptr(), b.data_ptr(),
            p.data_ptr(), float(dt), cfg.iisph_omega, cfg.eps,
            dij.data_ptr(), s.data_ptr(), partials.data_ptr(),
            resid.data_ptr(), _stream())
    return dij, s, resid


def k8_fused_pcisph_iter(grid: Grid, vel_star: torch.Tensor, p: torch.Tensor,
                         dt, factor):
    """In place on p; returns (adv (M,), acc (3, M), 0-dim error sum) (see
    dense_ops.fused_pcisph_iter)."""
    if not _route(p):
        return dense_ops.fused_pcisph_iter(grid, vel_star, p, dt, factor)
    m = grid.n
    cfg = grid.cfg
    _check(vel_star, p, shapes=[(3, m), (m,)])
    adv = torch.empty((m,), dtype=torch.float32, device=p.device)
    acc = torch.empty((3, m), dtype=torch.float32, device=p.device)
    partials = torch.empty((_nblocks(m),), dtype=torch.float32,
                           device=p.device)
    err = torch.empty((), dtype=torch.float32, device=p.device)
    _launch("k8_fused_pcisph_iter", ctypes.byref(_geom(grid)),
            vel_star.data_ptr(), p.data_ptr(), float(dt), float(factor),
            cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius),
            adv.data_ptr(), acc.data_ptr(), partials.data_ptr(),
            err.data_ptr(), _stream())
    return adv, acc, err


# ---------------------------------------------------------------------------
# Engine front end: the caller-side combinations of the sweep channels
# (twins of SweepEngine's methods in wcsph_tpu/pallas/engine.py)
# ---------------------------------------------------------------------------

def rho_inv(rho: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(rho, min=1.0)


def density_alpha(grid: Grid, vel: torch.Tensor):
    """(rho, alpha, count, div_acc) at every row (SweepEngine.density_alpha
    with ``velp``): rho = rho0 (V0 W0 + sum V_j W), alpha = -1/den."""
    cfg = grid.cfg
    out = k1_density_alpha_drho(grid, vel)
    w0 = cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius)
    rho = cfg.rest_density * (w0 + out[0])
    den = out[5] + out[2] ** 2 + out[3] ** 2 + out[4] ** 2
    alpha = torch.where(den > cfg.eps, -1.0 / den, 0.0)
    return rho, alpha, out[1].to(torch.int32), out[6]


def drho_divergence(grid: Grid, vel: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
    drho = torch.clamp(k1_div_acc(grid, vel), min=0.0)
    return torch.where(count < grid.cfg.min_div_neighbors, 0.0, drho)


def advected_density(grid: Grid, vel: torch.Tensor, rho: torch.Tensor,
                     dt) -> torch.Tensor:
    acc = k1_div_acc(grid, vel)
    return torch.clamp(rho / grid.cfg.rest_density + dt * acc, min=1.0)


def visc_init(grid: Grid, x0: torch.Tensor, rho: torch.Tensor, dt):
    """(Minv: Sym3, A x0) (SweepEngine.visc_init)."""
    out = k1_visc_init(grid, x0, rho_inv(rho))
    inv_rho = dt / torch.clamp(rho, min=1.0)
    a = mat3.sym3_identity_minus(mat3.Sym3(*out[:6]), inv_rho)
    ax0 = x0 - out[6:9] * inv_rho[None]
    return mat3.sym3_inverse(a), ax0


def vorticity(grid: Grid, vel: torch.Tensor, om: torch.Tensor,
              rho: torch.Tensor, count: torch.Tensor, dt):
    """(d_vel, new omega) (SweepEngine.vorticity)."""
    cfg = grid.cfg
    inv_rho_i = rho_inv(rho)
    out = k1_vorticity(grid, vel, om, inv_rho_i)
    cv, tr, st = out[0:3], out[3:6], out[6:9]
    c_vo, c_in = cfg.vorticity_coff, cfg.vorticity_init
    dv = c_vo * inv_rho_i[None] * cv
    # float32 scalar chain, rounded as the JAX package's traced dt is
    t_coeff = float(np.float32(-1.0) / np.float32(dt) * np.float32(c_in)
                    * np.float32(cfg.viscosity_omega)
                    * np.float32(cfg.liquid_mass))
    damp = -2.0 * c_in * c_vo
    dom = (t_coeff * tr
           + c_vo * c_in * inv_rho_i[None] * st
           + damp * om * count.to(torch.float32)[None])
    return dv, om + dom * float(dt)


def density(grid: Grid):
    """(rho, count) at every row (SweepEngine.density_alpha with
    ``with_alpha=False``): rho = rho0 (V0 W0 + sum V_j W)."""
    cfg = grid.cfg
    out = k5_density_alpha(grid)
    w0 = cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius)
    return cfg.rest_density * (w0 + out[0]), out[1].to(torch.int32)


def sesph_force(grid: Grid, vel: torch.Tensor, rho: torch.Tensor,
                p: torch.Tensor) -> torch.Tensor:
    """Explicit viscosity + Tait-pressure acceleration
    (SweepEngine.sesph_force)."""
    rinv = rho_inv(rho)
    return k5_sesph_force(grid, vel, rinv, rho / grid.cfg.rest_density,
                          p * rinv * rinv, p)


def iisph_adv(grid: Grid, vel: torch.Tensor):
    """(d_ii raw (3, M), advection sum, d_ji sum) (SweepEngine.iisph_adv)."""
    out = k5_iisph_adv(grid, vel)
    return out[0:3], out[3], out[4]


def fused_tension(grid: Grid, rho: torch.Tensor):
    """(h-scaled normals, cohesion + curvature + adhesion acceleration)
    (PaddedEngine.fused_tension)."""
    ril = torch.where(grid.liquid, rho_inv(rho), 0.0)
    return k6_fused_tension(grid, ril, rho)


def fused_pcisph_iter(grid: Grid, vel_star: torch.Tensor, p: torch.Tensor,
                      dt, coff):
    """One PCISPH prediction iteration (PaddedEngine.fused_pcisph_iter):
    the stiffness factor coff / dt^2 in float32, as the JAX package forms
    it."""
    dt = np.float32(dt)
    return k8_fused_pcisph_iter(grid, vel_star, p, dt,
                                np.float32(coff) / (dt * dt))
