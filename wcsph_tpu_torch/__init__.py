"""wcsph_tpu_torch: ``wcsph_tpu`` in PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (sm_90a): the four solvers (DFSPH with surface tension,
SESPH, PCISPH, IISPH), surface reconstruction (``surface/``), and the
mesh-scene tooling: procedural meshes (``utils/meshgen``), the Poisson-disk
boundary sampler (``sampling``), the point rasterizer and PNG export
(``render``), the live viewer (``viewer``), checkpoints and profiling
(``utils/``), and the runnable entry points (``examples/``).

The JAX package ``wcsph_tpu`` stays the reference; this package imports
neither it nor JAX.  State is dataclasses of planar float32 tensors with
the reference's layout; every constructor that allocates takes a
``device``.  The system has no trainable parameters, so nothing here is an
``nn.Module``, and nothing here needs a gradient, so there is no
``autograd.Function``.  On CUDA tensors the pair sweeps, the sampler's phase
steps and the rasterizer run the kernels of ``csrc/`` (see ``engine.py``);
on CPU tensors their plain PyTorch twins.  Every entry point runs on the
card unless the caller passes ``device="cpu"``, and raises where there is
none.
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
