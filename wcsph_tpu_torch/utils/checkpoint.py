"""Checkpoint / resume of the port's ``FluidState`` (port of
``wcsph_tpu/utils/checkpoint.py``).

The state's tensors, including the warm-start fields the reference persists
across frames (kappa, kappa_v, vel_guess; dfsph.py:199-200, 417-418,
488-490), and its scalars go to one compressed ``.npz`` under the JAX
package's keys and types (``state_to_numpy``), so a checkpoint written by
either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..state import FluidState, state_from_numpy, state_to_numpy


def save(path: str, state: FluidState) -> None:
    """Write the state (not its diagnostics) to ``path`` (.npz)."""
    np.savez_compressed(path, **state_to_numpy(state))


def load(path: str, device="cuda") -> FluidState:
    """The state saved at ``path``, its tensors on ``device`` (the card
    unless the caller asks for the CPU), with empty diagnostics."""
    with np.load(path) as z:
        return state_from_numpy({k: z[k] for k in z.files}, device)
