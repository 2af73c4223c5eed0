"""Per-particle state equations (the one function of ``wcsph_tpu/ops.py``
that the solvers call; the rest of that module is a test oracle of the JAX
package)."""

from __future__ import annotations

from typing import Tuple

import torch

from .config import SimConfig


def tait_pressure(rho: torch.Tensor,
                  cfg: SimConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tait EOS with density clamped >= rho0 (sesph.py:158-166).
    Returns (clamped rho, pressure)."""
    rho = torch.clamp(rho, min=cfg.rest_density)
    q = rho / cfg.rest_density
    p = cfg.stiffness * (q ** cfg.sesph_eos_exponent - 1.0)
    return rho, p
