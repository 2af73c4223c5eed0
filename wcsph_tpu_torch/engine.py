"""The hand kernels of the DFSPH main path, their plain twins, and the build.

Every wrapper below has one plain PyTorch twin in ``dense_ops.py`` with the
same arguments and outputs.  The wrapper picks by the tensors' device:

* CPU tensors go to the plain twin (the CPU tests);
* CUDA tensors go to the kernel in ``csrc/sweeps.cu``.  If the kernel
  cannot be built or launched the wrapper raises; nothing falls back.
  Only inside ``plain_twins()``, the one explicit switch, do they go to the
  plain twin instead: the oracle that ``chip_smoke.py`` holds the kernels
  against on the card.

Each wrapper adds one to its launch counter (``LAUNCHES``) where it
launches its kernel on the card, and nowhere else, so a run can show that
its main path went through the kernels.

The kernels (K1-K4, one per Pallas kernel of ``wcsph_tpu/pallas/engine.py``):

=====  ==========================  =========================================
K1     ``k1_density_alpha_drho``,  pair sweep, one launch per call
       ``k1_div_acc``,
       ``k1_visc_init``,
       ``k1_vorticity``
K2     ``k2_fused_kappa_drho``     gated kappa sweep, then divergence sweep
K3     ``k3_fused_iter_full``      whole divergence / pressure iteration
K4     ``k4_fused_visc_iter``      whole viscosity-PCG iteration
=====  ==========================  =========================================

The library is built at first use on CUDA: ``nvcc`` compiles
``csrc/*.cu`` for ``sm_90a`` into ``_build/``, keyed by a hash of the
sources and flags, and the plain C entry points are bound with ``ctypes``.
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
from .grid import Grid
from .utils import mat3

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_SRC = "wcsph_tpu_torch/csrc/sweeps.cu"
_SYM = "wcsph_tpu/pallas/engine.py:441 (_build_sweep_sym, emit "
# wrapper name -> (kernel source, TPU kernel it replaces, plain twin)
KERNELS = {
    "k1_density_alpha_drho": (_SRC, _SYM + "_DensityAlphaDrho 1973)",
                              dense_ops.density_alpha_drho),
    "k1_div_acc": (_SRC, _SYM + "_DivAcc 2023)", dense_ops.div_acc),
    "k1_visc_init": (_SRC, _SYM + "_ViscInit 2092)", dense_ops.visc_init),
    "k1_vorticity": (_SRC, _SYM + "_Vorticity 2133)", dense_ops.vorticity),
    "k2_fused_kappa_drho": (
        _SRC, "wcsph_tpu/pallas/engine.py:736 (_build_fused_iter)",
        dense_ops.fused_kappa_drho),
    "k3_fused_iter_full": (
        _SRC, "wcsph_tpu/pallas/engine.py:1041 (_build_fused_iter_full)",
        dense_ops.fused_iter_full),
    "k4_fused_visc_iter": (
        _SRC, "wcsph_tpu/pallas/engine.py:1677 (_build_fused_visc_iter)",
        dense_ops.fused_visc_iter),
}
LAUNCHES = {name: 0 for name in KERNELS}
BLOCK = 256          # threads per block of every sweep (csrc/sweeps.cu)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

class _Geom(ctypes.Structure):
    """Mirror of ``struct Geom`` in csrc/sweeps.cu (same field order)."""

    _fields_ = [("pos", ctypes.c_void_p), ("liq", ctypes.c_void_p),
                ("cell", ctypes.c_void_p), ("start", ctypes.c_void_p),
                ("M", ctypes.c_int), ("gx", ctypes.c_int),
                ("gy", ctypes.c_int), ("gz", ctypes.c_int),
                ("h", ctypes.c_float), ("h2", ctypes.c_float),
                ("vl", ctypes.c_float), ("vs", ctypes.c_float),
                ("w_sigma", ctypes.c_float), ("gs_ml", ctypes.c_float)]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_G = ctypes.POINTER(_Geom)
_SIGNATURES = {
    "k1_density_alpha_drho": [_G, _P, _P, _P],
    "k1_div_acc": [_G, _P, _P, _P],
    "k1_visc_init": [_G, _P, _P, _F, _F, _F, _P, _P],
    "k1_vorticity": [_G, _P, _P, _P, _F, _F, _F, _P, _P],
    "k2_fused_kappa_drho": [_G, _P, _P, _P, _P, _P],
    "k3_fused_iter_full": [_G, _P, _P, _P, _P, _P, _F, _I, _P, _P, _P],
    "k4_fused_visc_iter": [_G, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F,
                           _P, _P, _P, _P, _P],
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


def build_library(build_dir: Path | None = None):
    """Compile csrc/*.cu (once per source hash) and load the library.
    Raises RuntimeError, with nvcc's output, when nvcc is missing or the
    build fails."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    srcs = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib_path = build_dir / f"libwcsph_sweeps_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
                "wcsph_tpu_torch are built from csrc/ at first use on CUDA")
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in srcs if s.suffix == ".cu"]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        (build_dir / (lib_path.stem + ".ptxas.txt")).write_text(proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built on first call."""
    global _lib, BUILD_SECONDS
    if _lib is None:
        t0 = time.perf_counter()
        _lib = build_library()
        BUILD_SECONDS = time.perf_counter() - t0
    return _lib


def _geom(grid: Grid) -> _Geom:
    cfg = grid.cfg
    gx, gy, gz = cfg.grid_res
    h = cfg.support_radius
    for t in (grid.pos, grid.liq, grid.cell, grid.cell_start):
        if not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError("grid tensors must be contiguous, on the card")
    if 9 * grid.n >= 2 ** 31:
        raise ValueError("row indices of the kernels are 32-bit: "
                         f"{grid.n} rows is too many")
    return _Geom(grid.pos.data_ptr(), grid.liq.data_ptr(),
                 grid.cell.data_ptr(), grid.cell_start.data_ptr(),
                 grid.n, gx, gy, gz, h, h * h, cfg.liquid_volume,
                 cfg.solid_volume, kernels.cubic_w0(h),
                 48.0 / (math.pi * h * h * h))


def _check(*tensors, shapes):
    for t, shp in zip(tensors, shapes):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous float32")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"operand shape {tuple(t.shape)} != {shp}")
        if t.device.type != "cuda":
            raise ValueError("kernel operands must all be on the card")


def _launch(name: str, *args) -> None:
    rc = getattr(library(), name)(*args)
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
    _launch("k1_div_acc", ctypes.byref(_geom(grid)), vel.data_ptr(),
            out.data_ptr(), _stream())
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
    _launch("k1_vorticity", ctypes.byref(_geom(grid)), vel.data_ptr(),
            om.data_ptr(), rinv.data_ptr(), cfg.liquid_mass,
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
    _launch("k2_fused_kappa_drho", ctypes.byref(_geom(grid)),
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
    _launch("k3_fused_iter_full", ctypes.byref(_geom(grid)),
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
    _launch("k4_fused_visc_iter", ctypes.byref(_geom(grid)), x.data_ptr(),
            r.data_ptr(), d.data_ptr(), rinv.data_ptr(), minv6.data_ptr(),
            delta.data_ptr(), float(dt), cfg.eps, a_liq, b_sol,
            0.01 * h * h, ad.data_ptr(), s.data_ptr(), partials.data_ptr(),
            scal.data_ptr(), _stream())
    return scal


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
