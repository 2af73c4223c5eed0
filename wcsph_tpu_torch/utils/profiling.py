"""Tracing and step timing (port of ``wcsph_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``trace.json``, for chrome://tracing or Perfetto)
  of what runs inside it, the card's kernels with the host's calls.
- ``benchmark_step(sim, steps, warmup)``: per-step wall time, each step
  ending in a synchronize of the card (``bench.measure``).
- Per-step physics telemetry (solver iterations, density error) is
  ``Simulation.telemetry()``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from .. import bench


@contextlib.contextmanager
def trace(log_dir: str = "out/wcsph_trace"):
    """Profile the block (CPU and, where the card is available, CUDA
    activity) and write ``log_dir/trace.json``; yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark_step(sim, steps: int = 20, warmup: int = 3) -> Dict[str, float]:
    """Time ``steps`` single steps after ``warmup`` (``bench.measure``: host
    clock around each step, which ends in a synchronize on the card); mean,
    min and median in milliseconds and the liquid particle-steps a
    second."""
    arr = np.asarray(bench.measure(sim, warmup, steps)["step_ms"])
    return {
        "mean_ms": float(arr.mean()),
        "min_ms": float(arr.min()),
        "p50_ms": float(np.median(arr)),
        "particle_steps_per_sec": float(sim.state.n_liquid
                                        / (arr.mean() / 1e3)),
    }
