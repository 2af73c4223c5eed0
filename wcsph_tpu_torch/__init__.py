"""wcsph_tpu_torch: the four solvers of ``wcsph_tpu`` (DFSPH, SESPH, PCISPH,
IISPH) in PyTorch, with hand-written CUDA kernels for an NVIDIA H100
(sm_90a).

The JAX package ``wcsph_tpu`` stays the reference; this package imports
neither it nor JAX.  State is dataclasses of planar float32 tensors with
the reference's layout; every constructor that allocates takes a
``device``.  The system has no trainable parameters, so nothing here is an
``nn.Module``, and nothing here needs a gradient, so there is no
``autograd.Function``.  On CUDA tensors the pair sweeps run the kernels of
``csrc/`` (see ``engine.py``); on CPU tensors their plain PyTorch twins.
"""

from .config import SimConfig, config_from_dict
from .scene import Scene, SceneBuilder, dam_break
from .simulation import Simulation, default_config, get_solver
from .state import (FluidState, StepDiagnostics, init_state,
                    state_from_numpy, state_to_numpy)

__all__ = ["SimConfig", "config_from_dict", "Scene", "SceneBuilder",
           "dam_break", "Simulation", "default_config", "get_solver",
           "FluidState", "StepDiagnostics", "init_state", "state_from_numpy",
           "state_to_numpy"]
