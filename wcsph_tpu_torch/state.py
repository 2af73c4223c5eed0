"""Simulation state: dataclasses of tensors with the JAX package's layout.

``pos`` holds ALL particles, liquid rows first ([0, n_liquid)) and boundary
rows after; per-liquid vectors are planar (3, n_liquid).  The warm-start
fields the reference persists across frames (kappa, kappa_v, vel_guess) are
part of the state.

The step's scalars (``dt``, ``time``, iteration counts, diagnostics) are
host values: the solver loops end on the host (they read their error after
every iteration), so the step's control already lives there.  ``dt`` and
``time`` are ``numpy.float32`` so their arithmetic rounds as the JAX
package's float32 scalars do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene import Scene


@dataclasses.dataclass
class StepDiagnostics:
    """Per-step telemetry (the reference prints these per frame)."""

    divergence_iters: int = 0
    pressure_iters: int = 0
    viscosity_iters: int = 0
    density_error: np.float32 = np.float32(0.0)
    # pre-solve density error of the pressure loop
    density_error_pre: np.float32 = np.float32(0.0)
    # particles dropped by a capacity cap: always 0 (the port has no cap)
    neighbor_overflow: int = 0
    vel_max: np.float32 = np.float32(0.0)


@dataclasses.dataclass
class FluidState:
    pos: torch.Tensor          # (3, n_total) all particles, liquid first
    vel: torch.Tensor          # (3, n_liquid)
    omega: torch.Tensor        # (3, n_liquid) micropolar angular velocity
    vel_guess: torch.Tensor    # (3, n_liquid) viscosity-PCG warm start
    pressure: torch.Tensor     # (n_liquid,) SESPH / PCISPH / IISPH pressure
    kappa: torch.Tensor        # (n_liquid,) density warm start (x dt^2)
    kappa_v: torch.Tensor      # (n_liquid,) divergence warm start (x dt)
    dt: np.float32
    time: np.float32
    last_visc_iters: int
    last_pressure_iters: int
    diag: StepDiagnostics
    n_liquid: int
    n_total: int

    @property
    def n_solid(self) -> int:
        return self.n_total - self.n_liquid

    def replace(self, **kw) -> "FluidState":
        return dataclasses.replace(self, **kw)


_TENSORS = ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
            "kappa_v")


def init_state(scene: Scene, device) -> FluidState:
    """Initial state from a host-side Scene: zero velocities and warm
    starts, dt = 1e-3 (Simulation sets cfg.dt_init)."""
    nl, n = scene.n_liquid, scene.n_total

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    pos = torch.as_tensor(np.ascontiguousarray(scene.positions.T),
                          dtype=torch.float32).to(device)
    return FluidState(pos=pos, vel=z(3, nl), omega=z(3, nl),
                      vel_guess=z(3, nl), pressure=z(nl), kappa=z(nl),
                      kappa_v=z(nl), dt=np.float32(1e-3),
                      time=np.float32(0.0), last_visc_iters=0,
                      last_pressure_iters=0, diag=StepDiagnostics(),
                      n_liquid=nl, n_total=n)


def state_from_numpy(d: dict, device) -> FluidState:
    """State from the dict of ``wcsph_tpu.state.state_to_numpy`` (or of
    ``state_to_numpy`` below), on ``device``."""
    tens = {k: torch.as_tensor(np.array(d[k], np.float32)).to(device)
            for k in _TENSORS}
    return FluidState(**tens, dt=np.float32(d["dt"]),
                      time=np.float32(d["time"]),
                      last_visc_iters=int(d["last_visc_iters"]),
                      last_pressure_iters=int(d["last_pressure_iters"]),
                      diag=StepDiagnostics(),
                      n_liquid=int(d["n_liquid"]), n_total=int(d["n_total"]))


def state_to_numpy(state: FluidState) -> dict:
    """Host copy of the state, keyed like the JAX package's
    ``state_to_numpy``."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _TENSORS}
    out["dt"] = np.asarray(state.dt, np.float32)
    out["time"] = np.asarray(state.time, np.float32)
    out["last_visc_iters"] = np.asarray(state.last_visc_iters, np.int32)
    out["last_pressure_iters"] = np.asarray(state.last_pressure_iters,
                                            np.int32)
    out["n_liquid"] = state.n_liquid
    out["n_total"] = state.n_total
    return out


def has_nan(state: FluidState) -> bool:
    """NaN watchdog over positions, velocities, dt and the diagnostics."""
    d = state.diag
    scal = np.asarray([state.dt, d.density_error, d.density_error_pre,
                       d.vel_max], np.float32)
    return bool(torch.isnan(state.pos).any() or torch.isnan(state.vel).any()
                or np.isnan(scal).any())
