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
K1     ``k1_density_alpha_drho``,  pair sweep, one launch per call; the
       ``k1_div_acc``,             last seven only in the unfused solver
       ``k1_visc_init``,           loops (``fused_solver_iters=False``,
       ``k1_vorticity``,           ``use_fused_iters``), each one emit of
       ``k1_kappa_acc``,           K2-K4 or K6-K8 alone on the JAX
       ``k1_visc_acc``,            method's operands (``_PcisphPredict``
       ``k1_pcisph_predict``,      two entries: a cut, then a walk of its
       ``k1_pcisph_walk``,         hits)
       ``k1_iisph_dij``,
       ``k1_iisph_s``,
       ``k1_surface_normals``,
       ``k1_tension_accel``
K2     ``k2_fused_kappa_drho``     gated kappa sweep, then divergence sweep
K3     ``k3_fused_iter_full``      whole divergence / pressure iteration
K4     ``k4_fused_visc_iter``      whole viscosity-PCG iteration
K5     ``k5_density_alpha``,       one-sided sweep templated on its emit,
       ``k5_sesph_force``,         one launch per call; the IISPH three
       ``k5_iisph_adv``,           walk the list, the other two cut, then sum
       ``k5_iisph_aii``,
       ``k5_iisph_force``
K6     ``k6_fused_tension``        surface normals, then tension on them
K7     ``k7_fused_jacobi_iter``    whole IISPH relaxed-Jacobi iteration
K8     ``k8_fused_pcisph_iter``    whole PCISPH prediction iteration
=====  ==========================  =========================================

Seventeen walkers read the step's neighbour list (``grid.NeighborList``)
instead of the 27 cells: K2, K3, ``k1_div_acc`` (which shares K2's
divergence launch), ``k1_visc_init``, ``k1_vorticity``, K4, K7, IISPH's
three K5 entries (``k5_iisph_adv``, ``k5_iisph_aii``, ``k5_iisph_force``),
K6 (``k6_fused_tension``, both of its launches) and the unfused loops'
``k1_kappa_acc``, ``k1_visc_acc``, ``k1_iisph_dij``, ``k1_iisph_s``,
``k1_surface_normals`` and ``k1_tension_accel``.  A DFSPH or IISPH
step builds the list once, right after its density sweep, with
``nbr_list_offsets`` and ``nbr_list_fill``, kernels of the port's own
design that no TPU kernel corresponds to (``OWN_KERNELS``), as are the
step's bin, pack and unpack (``bin_cells``, ``pack_rows``, ``unpack_rows``:
XLA ops in the JAX package).  On the card the seventeen walkers raise
where the grid has no list; their plain twins need none.  From the positions to
the filled list no wrapper reads anything back to the host (the list's
first fill sizes its buffer: one read).

The surface reconstruction has three kernels of its own (``OWN_KERNELS``,
``csrc/surface.cu``; XLA in the JAX package): ``mc_field``,
the scalar field at the reconstruction points, one block per grid cell
over its 27-cell window, plain or anisotropic; ``aniso_moments``, the
anisotropy estimator's weighted mean and covariance sums, two launches of
one cell scan; and ``aniso_g``, its matrices G, a 3x3 eigendecomposition
per row.

The mesh-scene tooling has two kernels of its own (``OWN_KERNELS``; XLA in
the JAX package): ``poisson_phase`` (``csrc/sampling.cu``), one phase step
of the Poisson-disk boundary sampler, one thread per cell of the phase's
colour over the points accepted in its 5^3 window, launched 27 times a
trial per chunk; and ``splat_points`` (``csrc/render.cu``), the point
rasterizer's z-buffered splat, one thread per point with an atomicMin per
pixel channel.

K8's pairs are those at PCISPH's moved positions, new in every iteration:
its first sweep cuts the cells' candidates there and writes its hits into
a buffer of a uniform width (``grid.StarHits``, in the step's kept
``grid.ListSlots``), which its second sweep walks.  The unfused loop calls
the prediction twice an iteration at the same positions: its first call,
``k1_pcisph_predict``, cuts the cells' candidates there into register
masks and keeps its hits the same way (``grid.PredictHits``), and its
second, ``k1_pcisph_walk``, walks them; a row with more hits than the
buffer's width is scanned again inside the walk, so nothing is flagged or
replayed.

``k1_density_alpha_drho`` runs before the list exists (its counts size
it), so it scans the cells, in two phases: each receiver first cuts its
candidates into ``CUT_SLOTS`` slots of shared memory, then sums the pair
terms over its own hits, in the single loop's order and with its bits.
``k5_density_alpha`` and ``k5_sesph_force`` run on steps that build no
list (SESPH, PCISPH; ``k5_density_alpha`` before IISPH's) and scan the
cells too, but cut each column's candidates, 32 at a time, into a bit mask
in a register before they sum over the hits: the same calls in the same
order, so the single loop's bits, with no shared memory.

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
from .grid import (OFFSET_TILES, Grid, ListSlots, NeighborList,
                   PredictHits, StarHits, outside_cell)
from .utils import mat3

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_SRC = "wcsph_tpu_torch/csrc/sweeps.cu"
_SRC2 = "wcsph_tpu_torch/csrc/solver_sweeps.cu"
_BIN = "wcsph_tpu_torch/csrc/bin.cu"
_SURF = "wcsph_tpu_torch/csrc/surface.cu"
_SAMPLE = "wcsph_tpu_torch/csrc/sampling.cu"
_RENDER = "wcsph_tpu_torch/csrc/render.cu"
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
    "k1_kappa_acc": (_SRC, _SYM + "_KappaAcc 1998)", dense_ops.kappa_acc),
    "k1_visc_acc": (_SRC, _SYM + "_ViscAcc 2044)", dense_ops.visc_acc),
    "k1_pcisph_predict": (_SRC2, _SYM + "_PcisphPredict 2270)",
                          dense_ops.pcisph_predict),
    "k1_pcisph_walk": (_SRC2, _SYM + "_PcisphPredict 2270)",
                       dense_ops.pcisph_walk),
    "k1_iisph_dij": (_SRC2, _SYM + "_IisphDij 2397)", dense_ops.iisph_dij),
    "k1_iisph_s": (_SRC2, _SYM + "_IisphS 2417)", dense_ops.iisph_s),
    "k1_surface_normals": (_SRC2, _SYM + "_SurfaceNormals 2498)",
                           dense_ops.surface_normals),
    "k1_tension_accel": (_SRC2, _SYM + "_TensionAccel 2519)",
                         dense_ops.tension_accel),
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
    "bin_cells": (_BIN, "the step's bin: rows sorted by cell, cell offsets "
                  "(XLA's argsort and rank-in-run in the JAX package, "
                  "wcsph_tpu/grid.py:75-122, wcsph_tpu/resident.py:121-186)",
                  dense_ops.bin_cells),
    "pack_rows": (_BIN, "the step's pack of its fields into sorted rows "
                  "(XLA's gather, wcsph_tpu/resident.py:194)",
                  dense_ops.pack_rows),
    "unpack_rows": (_BIN, "the step's unpack of its fields from sorted rows "
                    "(XLA's gather, wcsph_tpu/resident.py:274)",
                    dense_ops.unpack_rows),
    "nbr_list_offsets": (_BIN, "the slice offsets of the neighbour list, "
                         "clamped to its kept slot capacity",
                         dense_ops.list_offsets),
    "nbr_list_fill": (_SRC, "the neighbour list that K2, K3, k1_div_acc, "
                      "k1_visc_init, k1_vorticity, K4, K7, IISPH's K5 "
                      "entries, K6 and the unfused loops' six list walkers "
                      "walk", dense_ops.neighbor_list),
    "mc_field": (_SURF, "the surface's scalar field at the reconstruction "
                 "points, plain and anisotropic (XLA's window sweep, "
                 "wcsph_tpu/surface/field.py:57)", dense_ops.mc_field),
    "aniso_moments": (_SURF, "the anisotropy estimator's weighted mean and "
                      "covariance sums (XLA's two window sweeps, "
                      "wcsph_tpu/surface/aniso.py:45)",
                      dense_ops.aniso_moments),
    "aniso_g": (_SURF, "the anisotropy estimator's matrices G from its "
                "moments (XLA's batched eigh, wcsph_tpu/surface/aniso.py:"
                "105)", dense_ops.aniso_g),
    "poisson_phase": (_SAMPLE, "one phase step of the Poisson-disk boundary "
                      "sampler (XLA's _phase_step, wcsph_tpu/sampling.py:"
                      "117)", dense_ops.poisson_phase),
    "splat_points": (_RENDER, "the point rasterizer's z-buffered splat "
                     "(XLA's _rasterize, wcsph_tpu/render.py:111)",
                     dense_ops.splat_points),
}
LAUNCHES = {name: 0 for name in (*KERNELS, *OWN_KERNELS)}
# steps run again because their neighbour list outgrew its slot buffer
# (solvers/common.py:replaying); reset with the launch counts
LIST_REPLAYS = 0
BLOCK = 256          # threads per block of every sweep (csrc/common.cuh)
CUT_SLOTS = 40       # hits the density sweep's receiver keeps before it
                     # sums them (kCutSlots, csrc/common.cuh)
BIN_TILES = 2 * OFFSET_TILES   # int64 tile sums of the bin's scan: two
                               # sets of kMaxTiles (csrc/bin.cu)
MAX_FIELDS = 16      # field rows one pack or unpack moves (kMaxFields)
PACK_SOURCES = 5     # fields one pack or unpack takes (kPackSources):
                     # DFSPH's five


def reset_launch_counts() -> None:
    global LIST_REPLAYS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LIST_REPLAYS = 0


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


class _PhaseChunk(ctypes.Structure):
    """Mirror of ``struct PhaseChunk`` in csrc/sampling.cu."""

    _fields_ = [("pts", ctypes.c_void_p), ("nrm", ctypes.c_void_p),
                ("fid", ctypes.c_void_p), ("n", ctypes.c_int),
                ("order", ctypes.c_void_p),
                ("start", ctypes.c_void_p), ("gx", ctypes.c_int),
                ("gy", ctypes.c_int), ("gz", ctypes.c_int),
                ("z0", ctypes.c_int), ("r", ctypes.c_float),
                ("cap", ctypes.c_int), ("acc_p", ctypes.c_void_p),
                ("acc_n", ctypes.c_void_p), ("acc_f", ctypes.c_void_p),
                ("acc_cnt", ctypes.c_void_p)]


class _Splat(ctypes.Structure):
    """Mirror of ``struct Splat`` in csrc/render.cu."""

    _fields_ = [("pts", ctypes.c_void_p), ("col", ctypes.c_void_p),
                ("radii", ctypes.c_void_p), ("n", ctypes.c_int),
                ("pv", ctypes.c_float * 16), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("radius", ctypes.c_int),
                ("background", ctypes.c_float), ("keys", ctypes.c_void_p),
                ("out", ctypes.c_void_p)]


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
    "k1_kappa_acc": [_G, _P, _P, _P],
    "k1_visc_acc": [_G, _P, _P, _F, _F, _F, _P, _P],
    "k1_pcisph_predict": [_G, _P, _P, _I, _P, _P, _P, _P, _P],
    "k1_pcisph_walk": [_G, _P, _P, _I, _P, _P, _P, _P, _P],
    "k1_iisph_dij": [_G, _P, _P, _P],
    "k1_iisph_s": [_G, _P, _P, _P, _P, _P, _P],
    "k1_surface_normals": [_G, _P, _F, _P, _P],
    "k1_tension_accel": [_G, _P, _P, _T, _P, _P],
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
    "k8_fused_pcisph_iter": [_G, _P, _P, _F, _F, _F, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P, _P],
    "nbr_list_fill": [_G, _P, _P, _P, _P, _P],
    "bin_cells": [_P, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P, _I, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P],
    "pack_rows": [_I, _I, _P, _P, _P, *[_P, _I] * PACK_SOURCES, _P],
    "unpack_rows": [_I, _I, _P, _P, *[_P, _I] * PACK_SOURCES,
                    *[_P] * PACK_SOURCES, _P],
    "nbr_list_offsets": [_P, _P, _I, _I, _P, _P, _P, _P],
    "mc_field": [_G, _P, _P, _P, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "aniso_moments": [_G, _P, _P],
    "aniso_g": [_I, _P, _P, _F, _F, _F, _I, _P, _P],
    "poisson_phase": [ctypes.POINTER(_PhaseChunk), _I, _I, _P],
    "splat_points": [ctypes.POINTER(_Splat), _P],
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


def _stream() -> int:
    """The raw handle of the current device's current stream:
    ``torch.cuda.current_stream().cuda_stream`` without building a Stream
    object."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


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
    if t.is_cuda:
        return not _plain_on_card
    if t.is_cpu:
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
    _launch("k1_visc_init", ctypes.byref(_geom(grid, listed=True)),
            x.data_ptr(), rinv.data_ptr(), a_liq, b_sol, 0.01 * h * h,
            out.data_ptr(), _stream())
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


def nbr_list_offsets(count: torch.Tensor, liquid: torch.Tensor,
                     capacity: int = 2 ** 31 - 1,
                     slots: ListSlots | None = None):
    """((S + 1,) int32 slice offsets of the neighbour list, clamped to
    ``capacity``; () int64 slots it needs) from the density sweep's count
    (M,) and the rows' liquid flags (M,) (bool on the card).  With
    ``slots``, both are its kept tensors (``ListSlots.offsets``),
    overwritten: the call allocates nothing; without, those of a new
    ``ListSlots``.  One launch."""
    if not _route(count):
        return dense_ops.list_offsets(count, liquid, capacity, slots)
    m = count.shape[0]
    if (count.dtype != torch.int32 or liquid.dtype != torch.bool
            or liquid.shape != (m,) or not count.is_contiguous()
            or not liquid.is_contiguous() or liquid.device != count.device):
        raise ValueError("count must be contiguous int32 (M,), beside the "
                         "(M,) bool liquid flags on the card")
    slots = ListSlots() if slots is None else slots
    off, need, tiles = slots.offsets(m, count.device)
    _launch("nbr_list_offsets", count.data_ptr(), liquid.data_ptr(), m,
            int(capacity), off.data_ptr(), need.data_ptr(), tiles.data_ptr(),
            _stream())
    return off, need


def nbr_list_fill(grid: Grid, count: torch.Tensor,
                  slots: ListSlots | None = None) -> NeighborList:
    """Build the neighbour list of the grid's positions, keep it as
    ``grid.nbr`` and return it.  ``count`` (M,) is the density sweep's
    neighbour count of each row; the slice offsets follow from it on the
    card (``nbr_list_offsets``, into the kept tensors of ``slots``), then
    the fill kernel writes the slots into the buffer of ``slots``, kept
    from step to step, and each row's record.
    No host read, but where ``slots`` is unsized: its first fill reads the
    slots needed and sizes it (``ListSlots.sized``; a buffer of exactly
    that size where ``slots`` is None).  A list that needs more slots than
    the buffer holds is clamped to it and flagged, as is a liquid row with
    more pairs within h than its slots (a count too low): ``Grid.read``
    raises on either at the step's first host read."""
    if not _route(count):
        grid.nbr = dense_ops.neighbor_list(grid, count, slots)
        return grid.nbr
    if count.shape != (grid.n,) or count.device.type != "cuda":
        raise ValueError("count must be (M,), on the card")
    cap = None if slots is None else slots.capacity
    off, need = nbr_list_offsets(count, grid.liquid,
                                 2 ** 31 - 1 if cap is None else cap, slots)
    if cap is None:                      # the first fill's one host read
        slots = ListSlots.sized(slots, int(need))
    idx = slots.buffer(count.device)
    rec = torch.empty((grid.n, 4), dtype=torch.float32, device=count.device)
    flag = torch.zeros((), dtype=torch.int32, device=count.device)
    _launch("nbr_list_fill", ctypes.byref(_geom(grid)), off.data_ptr(),
            idx.data_ptr(), rec.data_ptr(), flag.data_ptr(), _stream())
    grid.nbr = NeighborList(idx=idx, off=off, rec=rec, need=need, flag=flag)
    return grid.nbr


# ---------------------------------------------------------------------------
# The grid stage: bin, pack, unpack (csrc/bin.cu)
# ---------------------------------------------------------------------------

# the bin's scratch, kept from call to call here (build_grid's callers hold
# no buffer of their own): (device index, stream) -> (int32 tensor,
# particles, cells it holds), so that no two streams share one; its
# histogram is all zero between calls
_bin_scratch = {}


def _bin_scratch_for(dev: torch.device, stream: int, n: int, nc: int):
    """The kept scratch of the bin on this device and stream, for at least
    n particles and nc cells: (tensor, particle capacity).  It grows, never
    shrinks, and is zeroed when allocated (the kernel keeps its histogram
    zero from then on)."""
    key = (dev.index, stream)
    held = _bin_scratch.get(key)
    if held is None or held[1] < n or held[2] < nc:
        cap = max(n, held[1] if held else 0)
        ncap = max(nc, held[2] if held else 0)
        # int32 words: the int64 tile sums, then key, slot, tmp and the
        # histogram (the layout bin_cells in csrc/bin.cu reads)
        held = (torch.zeros((2 * BIN_TILES + 3 * cap + ncap,),
                            dtype=torch.int32, device=dev), cap, ncap)
        _bin_scratch[key] = held
    return held[0], held[1]


def bin_cells(pos: torch.Tensor, n_liquid: int, cfg):
    """The sorted layout of ``grid.Grid`` for planar positions (3, N), no
    host read: (order, row_of, cell, cell_start, sorted positions, liquid,
    liq, the () int32 liquid count inside the domain).  It allocates its
    eight outputs; its scratch is kept per device and stream
    (``_bin_scratch``), so that a call neither allocates nor clears it."""
    if not _route(pos):
        return dense_ops.bin_cells(pos, n_liquid, cfg)
    n = pos.shape[1]
    _check(pos, shapes=[(3, n)])
    if 9 * n >= 2 ** 31:
        raise ValueError(f"row indices of the kernels are 32-bit: {n} "
                         "particles is too many")
    gx, gy, gz = cfg.grid_res
    nc = gx * gy * gz
    dev = pos.device

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    order, row_of, cell = empty(n, dtype=torch.int64), empty(n), empty(n)
    start, pos_out = empty(nc + 1), empty(3, n, dtype=torch.float32)
    liquid, liq = empty(n, dtype=torch.bool), empty(n, dtype=torch.float32)
    n_liq = empty()
    stream = _stream()
    scratch, cap = _bin_scratch_for(dev, stream, n, nc)
    dmin = [float(np.float32(v)) for v in cfg.domain_min]
    try:
        _launch("bin_cells", pos.data_ptr(), n, int(n_liquid), *dmin,
                float(np.float32(1.0 / cfg.cell_size)), gx, gy, gz,
                outside_cell(cfg), scratch.data_ptr(), cap, order.data_ptr(),
                row_of.data_ptr(), cell.data_ptr(), start.data_ptr(),
                pos_out.data_ptr(), liquid.data_ptr(), liq.data_ptr(),
                n_liq.data_ptr(), stream)
    except RuntimeError:
        # a launch refused after the count may leave the histogram dirty
        _bin_scratch.pop((dev.index, stream), None)
        raise
    return order, row_of, cell, start, pos_out, liquid, liq, n_liq


_NO_SOURCE = (None, 0)


def pack_rows(grid: Grid, fields):
    """Per-liquid (N_L,) or (k, N_L) fields (at most ``PACK_SOURCES``) ->
    sorted (M,) / (k, M), rows that hold no liquid 0: row views, in the
    order of ``fields``, of one (K, M) block allocated here, all written by
    one launch."""
    if not fields or not _route(fields[0]):
        return dense_ops.pack_rows(grid, fields)
    if len(fields) > PACK_SOURCES:
        raise ValueError(f"{len(fields)} fields: one pack takes at most "
                         f"{PACK_SOURCES}")
    nl = fields[0].shape[-1]
    held, args, k = [], [], 0     # held: the sources, alive until the launch
    for x in fields:
        if not x.is_contiguous():
            x = x.contiguous()
        shape = x.shape
        if (x.dtype != torch.float32 or len(shape) > 2 or shape[-1] != nl
                or not x.is_cuda):
            raise ValueError("fields must be float32 (N_L,) or (k, N_L) on "
                             "the card")
        rows = shape[0] if len(shape) == 2 else 1
        held.append(x)
        args += (x.data_ptr(), rows)
        k += rows
    if k > MAX_FIELDS:
        raise ValueError(f"{k} field rows: one launch moves at most "
                         f"{MAX_FIELDS}")
    m = grid.n
    out = held[0].new_empty((k, m))
    _launch("pack_rows", m, nl, grid.order.data_ptr(),
            grid.liquid.data_ptr(), out.data_ptr(), *args,
            *_NO_SOURCE * (PACK_SOURCES - len(held)), _stream())
    return dense_ops.row_views(out, fields)


def unpack_rows(grid: Grid, packed, defaults):
    """Sorted (M,) / (k, M) fields (at most ``PACK_SOURCES``) -> per-liquid
    (N_L,) / (k, N_L), a liquid particle outside the domain keeping its
    ``defaults`` entry: row views, in the order of ``packed``, of one
    (K, N_L) block allocated here, all written by one launch."""
    if not packed or not _route(packed[0]):
        return dense_ops.unpack_rows(grid, packed, defaults)
    if len(packed) > PACK_SOURCES or len(defaults) != len(packed):
        raise ValueError(f"{len(packed)} fields with {len(defaults)} "
                         f"defaults: one unpack takes at most "
                         f"{PACK_SOURCES}, each with its default")
    m = grid.n
    nl = defaults[0].shape[-1]
    f32 = torch.float32
    copies, args, dflt, k = [], [], [], 0   # copies: alive until the launch
    for p, d in zip(packed, defaults):
        if not p.is_contiguous():
            p = p.contiguous()
            copies.append(p)
        if not d.is_contiguous():
            d = d.contiguous()
            copies.append(d)
        shape = p.shape
        if (p.dtype is not f32 or d.dtype is not f32 or not p.is_cuda
                or not d.is_cuda or len(shape) > 2 or shape[-1] != m
                or d.shape != (*shape[:-1], nl)):
            raise ValueError("packed fields must be float32 (M,) or (k, M) "
                             "on the card, each with a default of its shape "
                             "and N_L columns")
        rows = shape[0] if len(shape) == 2 else 1
        args += (p.data_ptr(), rows)
        dflt.append(d.data_ptr())
        k += rows
    if k > MAX_FIELDS:
        raise ValueError(f"{k} field rows: one launch moves at most "
                         f"{MAX_FIELDS}")
    out = defaults[0].new_empty((k, nl))
    pad = PACK_SOURCES - len(packed)
    _launch("unpack_rows", m, nl, grid.row_of.data_ptr(), out.data_ptr(),
            *args, *_NO_SOURCE * pad, *dflt, *(None,) * pad, _stream())
    return dense_ops.row_views(out, defaults)


def _sweep(name: str, grid: Grid, operands, shapes, n_out, *consts,
           listed: bool = False):
    """Launch a sweep entry with one (n_out, M) output (K5's, and K1's
    emits of the unfused loops): checked operands, then constants, then the
    output; ``listed``: the entry walks the step's neighbour list (see
    ``_geom``)."""
    _check(*operands, shapes=shapes)
    out = torch.empty((n_out, grid.n), dtype=torch.float32,
                      device=grid.device)
    _launch(name, ctypes.byref(_geom(grid, listed)),
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
    return _sweep("k5_iisph_adv", grid, [vel], [(3, grid.n)], 5,
                  listed=True)


def k5_iisph_aii(grid: Grid, dii: torch.Tensor) -> torch.Tensor:
    if not _route(dii):
        return dense_ops.iisph_aii(grid, dii)
    return _sweep("k5_iisph_aii", grid, [dii], [(3, grid.n)], 1,
                  listed=True)[0]


def k5_iisph_force(grid: Grid, dpi: torch.Tensor) -> torch.Tensor:
    if not _route(dpi):
        return dense_ops.iisph_force(grid, dpi)
    return _sweep("k5_iisph_force", grid, [dpi], [(grid.n,)], 3,
                  listed=True)


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
    _launch("k6_fused_tension", ctypes.byref(_geom(grid, listed=True)),
            ril.data_ptr(), rho.data_ptr(),
            ctypes.byref(_tension_params(cfg)), cfg.liquid_mass,
            normals.data_ptr(), acc.data_ptr(), _stream())
    return normals, acc


def _tension_params(cfg) -> _TensionParams:
    t = dense_ops.tension_consts(cfg)
    return _TensionParams(
        t["coh"], t["adh"], t["curv"], t["rho0x2"], cfg.eps, t["coh_k"],
        t["coh_c"], t["adh_k"], *cfg.adhesion_center,
        cfg.adhesion_radius ** 2)


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
    _launch("k7_fused_jacobi_iter", ctypes.byref(_geom(grid, listed=True)),
            dii.data_ptr(), deninv.data_ptr(), aii.data_ptr(), b.data_ptr(),
            p.data_ptr(), float(dt), cfg.iisph_omega, cfg.eps,
            dij.data_ptr(), s.data_ptr(), partials.data_ptr(),
            resid.data_ptr(), _stream())
    return dij, s, resid


def k8_fused_pcisph_iter(grid: Grid, vel_star: torch.Tensor, p: torch.Tensor,
                         dt, factor, slots: ListSlots | None = None):
    """In place on p; returns (adv (M,), acc (3, M), 0-dim error sum) (see
    dense_ops.fused_pcisph_iter) and keeps the iteration's hits at x* as
    ``grid.star``, in the buffer of ``slots`` (``slots.capacity // M`` a
    row): a row with more hits is flagged, and ``Grid.read`` raises
    ``ListOverflow`` at the next read.  On the card ``slots`` must be
    sized; the plain twin takes None for a buffer that holds every hit."""
    if not _route(p):
        return dense_ops.fused_pcisph_iter(grid, vel_star, p, dt, factor,
                                           slots)
    if slots is None or slots.capacity is None:
        raise ValueError("K8 keeps its hits in a sized buffer: pass a "
                         "grid.ListSlots with a capacity")
    m = grid.n
    cfg = grid.cfg
    _check(vel_star, p, shapes=[(3, m), (m,)])
    adv = torch.empty((m,), dtype=torch.float32, device=p.device)
    acc = torch.empty((3, m), dtype=torch.float32, device=p.device)
    partials = torch.empty((_nblocks(m),), dtype=torch.float32,
                           device=p.device)
    err = torch.empty((), dtype=torch.float32, device=p.device)
    hits = StarHits(
        idx=slots.buffer(p.device),
        count=torch.empty((m,), dtype=torch.int32, device=p.device),
        rec=torch.empty((m, 4), dtype=torch.float32, device=p.device),
        width=slots.capacity // m,
        over=torch.empty((), dtype=torch.int32, device=p.device))
    _launch("k8_fused_pcisph_iter", ctypes.byref(_geom(grid)),
            vel_star.data_ptr(), p.data_ptr(), float(dt), float(factor),
            cfg.liquid_volume * kernels.cubic_w0(cfg.support_radius),
            hits.width, hits.idx.data_ptr(), hits.count.data_ptr(),
            hits.rec.data_ptr(), hits.over.data_ptr(), adv.data_ptr(),
            acc.data_ptr(), partials.data_ptr(), err.data_ptr(), _stream())
    grid.star = hits
    return adv, acc, err


# ---------------------------------------------------------------------------
# K1's emits that only the unfused solver loops run alone
# (fused_solver_iters=False): one sweep a call, the JAX methods' operands
# ---------------------------------------------------------------------------

def k1_kappa_acc(grid: Grid, k: torch.Tensor) -> torch.Tensor:
    """(3, M) sum V_j (k_i + k_j) gs r at liquid rows (walks the list)."""
    if not _route(k):
        return dense_ops.kappa_acc(grid, k)
    return _sweep("k1_kappa_acc", grid, [k], [(grid.n,)], 3, listed=True)


def k1_visc_acc(grid: Grid, x: torch.Tensor,
                rinv: torch.Tensor) -> torch.Tensor:
    """(3, M) sum c (x_i - x_j).r gs r at liquid rows, rinv = 1 / max(rho,
    1) (walks the list)."""
    if not _route(x):
        return dense_ops.visc_acc(grid, x, rinv)
    m = grid.n
    a_liq, b_sol = dense_ops.visc_consts(grid.cfg)
    h = grid.cfg.support_radius
    return _sweep("k1_visc_acc", grid, [x, rinv], [(3, m), (m,)], 3, a_liq,
                  b_sol, 0.01 * h * h, listed=True)


def k1_pcisph_predict(grid: Grid, xstar: torch.Tensor, p: torch.Tensor,
                      slots: ListSlots | None = None):
    """The cut: ((4, M) [sum V_j W, pressure acceleration (3)] at liquid
    rows, at the moved positions ``xstar`` (3, M) with the pressure ``p``:
    the grid's cells scanned, the pairs cut at ``xstar``; its hits,
    ``grid.PredictHits``, in the buffer of ``slots``, ``slots.capacity //
    M`` a row, for ``k1_pcisph_walk`` at the same ``xstar``).  On the card
    ``slots`` must be sized; the plain twin takes None for a buffer that
    holds every hit."""
    if not _route(p):
        return dense_ops.pcisph_predict(grid, xstar, p, slots)
    if slots is None or slots.capacity is None:
        raise ValueError("the prediction keeps its hits in a sized buffer: "
                         "pass a grid.ListSlots with a capacity")
    m = grid.n
    _check(xstar, p, shapes=[(3, m), (m,)])
    out = torch.empty((4, m), dtype=torch.float32, device=p.device)
    hits = PredictHits(
        idx=slots.buffer(p.device),
        count=torch.empty((m,), dtype=torch.int32, device=p.device),
        rec=torch.empty((m, 4), dtype=torch.float32, device=p.device),
        width=slots.capacity // m)
    _launch("k1_pcisph_predict", ctypes.byref(_geom(grid)),
            xstar.data_ptr(), p.data_ptr(), hits.width, hits.idx.data_ptr(),
            hits.count.data_ptr(), hits.rec.data_ptr(), out.data_ptr(),
            _stream())
    return out, hits


def k1_pcisph_walk(grid: Grid, xstar: torch.Tensor, p: torch.Tensor,
                   hits: PredictHits) -> torch.Tensor:
    """The walk: ``k1_pcisph_predict``'s (4, M) at the same ``xstar`` with
    the pressure ``p``, over the hits of its cut there (each row of more
    hits than ``hits.width`` scans its cells again): the cut's bits."""
    if not _route(p):
        return dense_ops.pcisph_walk(grid, xstar, p, hits)
    m = grid.n
    _check(xstar, p, hits.rec, shapes=[(3, m), (m,), (m, 4)])
    if (hits.count.shape != (m,) or hits.count.device != p.device
            or hits.idx.numel() < hits.width * m):
        raise ValueError("hits of another grid's cut")
    out = torch.empty((4, m), dtype=torch.float32, device=p.device)
    _launch("k1_pcisph_walk", ctypes.byref(_geom(grid)), xstar.data_ptr(),
            p.data_ptr(), hits.width, hits.idx.data_ptr(),
            hits.count.data_ptr(), hits.rec.data_ptr(), out.data_ptr(),
            _stream())
    return out


def k1_iisph_dij(grid: Grid, fac: torch.Tensor) -> torch.Tensor:
    """(3, M) dij = sum_j fac_j gs r at liquid rows (walks the list)."""
    if not _route(fac):
        return dense_ops.iisph_dij(grid, fac)
    return _sweep("k1_iisph_dij", grid, [fac], [(grid.n,)], 3, listed=True)


def k1_iisph_s(grid: Grid, dii: torch.Tensor, dij: torch.Tensor,
               p_liq: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(M,) s of the relaxed Jacobi iteration at liquid rows, from the
    finished dij, p_liq = liq p and g = deninv p (walks the list)."""
    if not _route(dij):
        return dense_ops.iisph_s(grid, dii, dij, p_liq, g)
    m = grid.n
    return _sweep("k1_iisph_s", grid, [dii, dij, p_liq, g],
                  [(3, m), (3, m), (m,), (m,)], 1, listed=True)[0]


def k1_surface_normals(grid: Grid, ril: torch.Tensor) -> torch.Tensor:
    """(3, M) sum_j m ril_j gs r at liquid rows, unscaled (walks the
    list)."""
    if not _route(ril):
        return dense_ops.surface_normals(grid, ril)
    return _sweep("k1_surface_normals", grid, [ril], [(grid.n,)], 3,
                  grid.cfg.liquid_mass, listed=True)


def k1_tension_accel(grid: Grid, rho: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """(3, M) cohesion, curvature and adhesion acceleration at liquid rows
    on the h-scaled normals ``n`` (walks the list)."""
    if not _route(rho):
        return dense_ops.tension_accel(grid, rho, n)
    m = grid.n
    return _sweep("k1_tension_accel", grid, [rho, n], [(m,), (3, m)], 3,
                  ctypes.byref(_tension_params(grid.cfg)), listed=True)


# ---------------------------------------------------------------------------
# Surface reconstruction (csrc/surface.cu)
# ---------------------------------------------------------------------------

def mc_field(grid: Grid, x: torch.Tensor, coeff: torch.Tensor,
             g: torch.Tensor | None = None) -> torch.Tensor:
    """The surface's scalar field at the reconstruction points, dense
    (gx MC_SUB, gy MC_SUB, gz MC_SUB) (``dense_ops.mc_field``): positions
    ``x`` (3, M), coefficients ``coeff`` (M,) (0 for a row that does not
    contribute) and, anisotropic, G (9, M); the candidates are those of
    the grid's cells."""
    if not _route(x):
        return dense_ops.mc_field(grid, x, coeff, g)
    cfg = grid.cfg
    m = grid.n
    operands = [x, coeff] + ([] if g is None else [g])
    _check(*operands, shapes=[(3, m), (m,), (9, m)])
    s = dense_ops.MC_SUB
    shape = tuple(n * s for n in cfg.grid_res)
    if math.prod(shape) >= 2 ** 31:
        raise ValueError(f"a dense field of {shape} points is too many for "
                         "the kernel's 32-bit indices")
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    off = dense_ops.field_offsets(cfg)
    dmin = [float(np.float32(v)) for v in cfg.domain_min]
    _launch("mc_field", ctypes.byref(_geom(grid)), x.data_ptr(),
            coeff.data_ptr(), None if g is None else g.data_ptr(), *dmin,
            float(np.float32(cfg.cell_size)), *map(float, off[1:]),
            out.data_ptr(), _stream())
    return out


def aniso_moments(grid: Grid) -> torch.Tensor:
    """(11, M) weighted moments of the anisotropy estimator at liquid rows
    (``dense_ops.aniso_moments``), in two launches of one kernel."""
    if not _route(grid.pos):
        return dense_ops.aniso_moments(grid)
    out = torch.empty((11, grid.n), dtype=torch.float32, device=grid.device)
    _launch("aniso_moments", ctypes.byref(_geom(grid)), out.data_ptr(),
            _stream())
    return out


def aniso_g(grid: Grid, mom: torch.Tensor, kr: float, ks: float, kn: float,
            min_neighbors: int) -> torch.Tensor:
    """(9, M) row-major G of the anisotropy estimator from the (11, M)
    moments of ``aniso_moments`` (``dense_ops.aniso_g``)."""
    if not _route(mom):
        return dense_ops.aniso_g(grid, mom, kr, ks, kn, min_neighbors)
    m = grid.n
    _check(mom, grid.liq, shapes=[(11, m), (m,)])
    out = torch.empty((9, m), dtype=torch.float32, device=mom.device)
    _launch("aniso_g", m, mom.data_ptr(), grid.liq.data_ptr(), kr, ks, kn,
            int(min_neighbors), out.data_ptr(), _stream())
    return out


# ---------------------------------------------------------------------------
# Tooling: the Poisson-disk sampler's phase step (csrc/sampling.cu) and the
# point rasterizer (csrc/render.cu)
# ---------------------------------------------------------------------------

def poisson_phase(ch: dense_ops.PhaseChunk, phase: int, trial: int) -> None:
    """One phase step of the Poisson-disk sampler, in place on the chunk's
    accepted points (``dense_ops.poisson_phase``): one thread per cell of
    colour ``phase``."""
    if not _route(ch.acc_p):
        return dense_ops.poisson_phase(ch, phase, trial)
    gx, gy, gz = ch.res
    nc = gx * gy * gz
    cap = ch.accept_cap
    n = ch.fid.shape[0]
    _check(ch.pts, ch.nrm, ch.acc_p, ch.acc_n,
           shapes=[(3, n), (3, n), (3, cap, nc), (3, cap, nc)])
    for t, shp in ((ch.fid, (n,)), (ch.order, (n,)), (ch.start, (nc + 1,)),
                   (ch.acc_f, (cap, nc)), (ch.acc_cnt, (nc,))):
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != shp or t.device.type != "cuda"):
            raise ValueError(f"int32 operand {tuple(t.shape)} {t.dtype} "
                             f"!= contiguous int32 {shp} on the card")
    if 3 * cap * nc >= 2 ** 31 or 3 * n >= 2 ** 31:
        raise ValueError("the phase kernel's indices are 32-bit")
    args = _PhaseChunk(ch.pts.data_ptr(), ch.nrm.data_ptr(),
                       ch.fid.data_ptr(), n, ch.order.data_ptr(),
                       ch.start.data_ptr(), gx, gy, gz, ch.z0,
                       float(np.float32(ch.radius)), cap,
                       ch.acc_p.data_ptr(), ch.acc_n.data_ptr(),
                       ch.acc_f.data_ptr(), ch.acc_cnt.data_ptr())
    _launch("poisson_phase", ctypes.byref(args), int(phase), int(trial),
            _stream())


def splat_points(points: torch.Tensor, colors: torch.Tensor,
                 radii: torch.Tensor, pv: np.ndarray, width: int,
                 height: int, radius_px: int,
                 background: float) -> torch.Tensor:
    """(H, W, 3) float32 image of the (3, N) points, their (3, N) colours
    and (N,) int32 disk radii under the 4x4 float32 ``pv``
    (``dense_ops.splat_points``): one thread per point over its disk, an
    atomicMin per pixel channel on a uint32 key image, then the keys to
    colours."""
    if not _route(points):
        return dense_ops.splat_points(points, colors, radii, pv, width,
                                      height, radius_px, background)
    n = points.shape[1]
    _check(points, colors, shapes=[(3, n), (3, n)])
    if (radii.dtype != torch.int32 or not radii.is_contiguous()
            or tuple(radii.shape) != (n,) or radii.device != points.device):
        raise ValueError("radii must be a contiguous (N,) int32 tensor on "
                         "the points' card")
    if 3 * width * height >= 2 ** 31 or 3 * n >= 2 ** 31:
        raise ValueError("the rasterizer's indices are 32-bit")
    keys = torch.empty((height * width * 3,), dtype=torch.int32,
                       device=points.device)
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=points.device)
    pvf = (ctypes.c_float * 16)(*np.asarray(pv, np.float32).reshape(-1))
    args = _Splat(points.data_ptr(), colors.data_ptr(), radii.data_ptr(), n,
                  pvf, int(width), int(height), int(radius_px),
                  float(np.float32(background)), keys.data_ptr(),
                  out.data_ptr())
    _launch("splat_points", ctypes.byref(args), _stream())
    return out


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


def use_fused_iters(comm, method: str) -> bool:
    """Run a solver loop in its fused form, one K2-K4 or K6-K8 call an
    iteration, or in the JAX package's unfused form, K1's emits one sweep
    a call (use_fused_iters of the JAX engine, engine.py:2602): fused where
    the config asks for it (``fused_solver_iters``) and the communicator
    carries ``method``, the JAX engine's name of the fused loop
    (``parallel/comm.py``: a ``NoComm`` carries all six, the one-plane
    ``SlabComm`` none, the two-plane ``DirectSlabComm`` DFSPH's
    ``fused_kappa_drho`` and ``fused_iter_full``)."""
    return comm.cfg.fused_solver_iters and method in comm.fused


def kappa_velocity_update(grid: Grid, vel: torch.Tensor, k: torch.Tensor,
                          dt) -> torch.Tensor:
    """vel + dt sum V_j (k_i + k_j) gs r at liquid rows; boundary rows keep
    their velocity (SweepEngine.kappa_velocity_update)."""
    acc = k1_kappa_acc(grid, k)
    return vel + torch.where(grid.liquid[None], float(dt) * acc, 0.0)


def visc_scales(rho: torch.Tensor, dt):
    """(1 / max(rho, 1), dt / max(rho, 1) as a (1, M) row): the unfused
    matvec's two factors of the density, the same in every iteration of a
    solve."""
    return rho_inv(rho), (float(dt) / torch.clamp(rho, min=1.0))[None]


def visc_matvec(grid: Grid, x: torch.Tensor, rho: torch.Tensor, dt,
                scales=None) -> torch.Tensor:
    """x - dt / max(rho, 1) sum c (x_i - x_j).r gs r
    (SweepEngine.visc_matvec); ``scales``: ``visc_scales(rho, dt)``,
    formed once a solve (None: here)."""
    rinv, step = visc_scales(rho, dt) if scales is None else scales
    return x - k1_visc_acc(grid, x, rinv) * step


def pcisph_predict(grid: Grid, xstar: torch.Tensor, p: torch.Tensor,
                   slots: ListSlots | None = None):
    """(raw predicted density sum (M,), pressure acceleration (3, M), the
    hits) at the moved positions with the pressure ``p``
    (SweepEngine.pcisph_predict), by the cut (``k1_pcisph_predict``), its
    hits kept in the buffer of ``slots`` for ``k1_pcisph_walk`` at the same
    ``xstar``; the caller adds the self term and clamps."""
    out, hits = k1_pcisph_predict(grid, xstar, p, slots)
    return out[0], out[1:4], hits


def _liquid_rho_inv(grid: Grid, rho: torch.Tensor) -> torch.Tensor:
    return torch.where(grid.liquid, rho_inv(rho), 0.0)


def surface_normals(grid: Grid, rho: torch.Tensor) -> torch.Tensor:
    """h sum_j liq_j (m / rho_j) gs r (SweepEngine.surface_normals)."""
    return grid.cfg.support_radius * k1_surface_normals(
        grid, _liquid_rho_inv(grid, rho))


def fused_tension(grid: Grid, rho: torch.Tensor):
    """(h-scaled normals, cohesion + curvature + adhesion acceleration)
    (PaddedEngine.fused_tension)."""
    return k6_fused_tension(grid, _liquid_rho_inv(grid, rho), rho)


def fused_pcisph_iter(grid: Grid, vel_star: torch.Tensor, p: torch.Tensor,
                      dt, coff, slots: ListSlots | None = None):
    """One PCISPH prediction iteration (PaddedEngine.fused_pcisph_iter):
    the stiffness factor coff / dt^2 in float32, as the JAX package forms
    it; its hits at x* go into the buffer of ``slots``."""
    dt = np.float32(dt)
    return k8_fused_pcisph_iter(grid, vel_star, p, dt,
                                np.float32(coff) / (dt * dt), slots)
