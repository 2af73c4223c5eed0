"""High-level simulation entry point (port of ``wcsph_tpu/simulation.py``,
DFSPH only).

``Simulation(scene, cfg, solver="dfsph", device=...)`` owns the config and
the state on ``device``.  On a CUDA device every pair sweep of the step runs
a hand kernel (``engine.py``); on the CPU the same step runs their plain
PyTorch twins.  Asking for CUDA where there is none raises, as PyTorch does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .boundary import akinci_solid_volume_scale
from .config import SimConfig
from .scene import Scene
from .solvers import dfsph
from .state import FluidState, has_nan, init_state


def _check_solver(name: str) -> None:
    if name != "dfsph":
        raise ValueError(f"unknown solver {name!r}: the port has only "
                         f"'dfsph' so far (ROADMAP queue 1)")


def default_config(solver: str = "dfsph", **overrides) -> SimConfig:
    _check_solver(solver)
    return dfsph.default_config(**overrides)


class Simulation:
    """Owns (config, solver, state on ``device``) for a run."""

    def __init__(self, scene: Scene, cfg: SimConfig, solver: str = "dfsph",
                 device="cpu"):
        _check_solver(solver)
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
        self.state = dfsph.step(self.state, self.cfg)
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
