"""High-level simulation entry point (port of ``wcsph_tpu/simulation.py``).

``Simulation(scene, cfg, solver="dfsph", device="cuda")`` owns the config
and the state on ``device``, the card unless the caller asks for the CPU.
On a CUDA device every pair sweep of the step runs a hand kernel
(``engine.py``); on the CPU the same step runs their plain PyTorch twins.
Asking for CUDA where there is none raises, as PyTorch does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .boundary import akinci_solid_volume_scale
from .config import SimConfig
from .scene import Scene
from .solvers import dfsph, iisph, pcisph, sesph
from .state import FluidState, has_nan, init_state

_SOLVERS = {"sesph": sesph, "pcisph": pcisph, "iisph": iisph, "dfsph": dfsph}


def get_solver(name: str):
    try:
        return _SOLVERS[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; choose from "
                         f"{sorted(_SOLVERS)}") from None


def default_config(solver: str = "dfsph", **overrides) -> SimConfig:
    return get_solver(solver).default_config(**overrides)


class Simulation:
    """Owns (config, solver, state on ``device``) for a run."""

    def __init__(self, scene: Scene, cfg: SimConfig, solver: str = "dfsph",
                 device="cuda"):
        self.solver_name = solver
        self._solver = get_solver(solver)
        self.device = torch.device(device)
        if cfg.solid_volume_auto and scene.n_solid > 0:
            # boundary volume from the ACTUAL shell sampling (Akinci 2012)
            pos_solid = torch.as_tensor(
                np.ascontiguousarray(scene.positions[scene.n_liquid:].T),
                dtype=torch.float32).to(self.device)
            scale = akinci_solid_volume_scale(pos_solid, cfg)
            cfg = dataclasses.replace(cfg, solid_volume_scale=scale,
                                      solid_volume_auto=False)
        self.cfg = cfg
        state = init_state(scene, self.device)
        self.state = state.replace(dt=np.float32(cfg.dt_init))

    def step(self) -> FluidState:
        self.state = self._solver.step(self.state, self.cfg)
        return self.state

    def run(self, n_steps: int) -> FluidState:
        for _ in range(n_steps):
            self.step()
        return self.state

    def telemetry(self) -> dict:
        s = self.state
        d = s.diag
        return {"time": float(s.time), "dt": float(s.dt),
                "divergence_iters": d.divergence_iters,
                "pressure_iters": d.pressure_iters,
                "viscosity_iters": d.viscosity_iters,
                "density_error": float(d.density_error),
                "density_error_pre": float(d.density_error_pre),
                "neighbor_overflow": d.neighbor_overflow,
                "vel_max": float(d.vel_max)}

    def check_health(self) -> None:
        """NaN watchdog (reference dfsph.py:645-647): raises on divergence."""
        if has_nan(self.state):
            raise FloatingPointError(
                f"NaN detected at t={float(self.state.time):.4f} "
                f"(telemetry: {self.telemetry()})")
