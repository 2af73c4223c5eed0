"""Anisotropic kernel estimator, Yu & Turk 2013 (port of
``wcsph_tpu/surface/aniso.py``).

Reference: ParticleData.cal_anistropic_kernel (ParticleData.py:220-289):
per liquid particle a weighted mean position x̄ (weight 1 - (d / 2h)^3 over
the liquid neighbours within h, weight_func ParticleData.py:291-298), the
weighted covariance of the neighbours' positions about x̄, a 3x3 spectral
decomposition with clamped eigenvalues (kr = 4, ks = 1400, kn = 0.5, more
than 25 neighbours), and G = R diag(1 / (ks σ̃)) Rᵀ to deform the
reconstruction kernel.

The two weighted sums are one kernel in one launch
(``engine.aniso_moments``, csrc/surface.cu: each row cuts its window
once and walks its hits twice), and G another (``engine.aniso_g``: a 3x3
Jacobi eigendecomposition per row), which also gives each row's reach,
the distance past which its deformed kernel is 0 (the field kernel skips
candidates out of reach).  The JAX
package leaves the eigendecomposition to XLA's batched
``jnp.linalg.eigh`` (the covariance is symmetric PSD, so eigh equals the
reference's SVD up to order); the plain twin on the CPU runs
``torch.linalg.eigh``, which on the card refuses a batch of the
flagship's size.  The JAX package's ``EIG_CHUNK`` bounded TPU tile
padding; the card needs no chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import engine
from ..grid import Grid

KR = 4.0
KS = 1400.0
KN = 0.5
MIN_NEIGHBORS = 25


class Anisotropy(NamedTuple):
    pos_avr: torch.Tensor   # (3, M) weighted mean positions x̄
    g: torch.Tensor         # (9, M) row-major G
    reach: torch.Tensor     # (M,) |r| past which |2 G r| > h


def compute(grid: Grid) -> Anisotropy:
    mom = engine.aniso_moments(grid)
    sw = mom[0]
    pos_avr = torch.where(sw > 0.0, mom[1:4] / torch.clamp(sw, min=1e-12),
                          grid.pos)
    g, reach = engine.aniso_g(grid, mom, KR, KS, KN, MIN_NEIGHBORS)
    return Anisotropy(pos_avr=pos_avr, g=g.contiguous(),
                      reach=reach.contiguous())


def smoothed_positions(grid: Grid, an: Anisotropy) -> torch.Tensor:
    """0.05 x + 0.95 x̄ (MarchingCubeGrid.py:228); only liquid rows move."""
    mixed = 0.05 * grid.pos + 0.95 * an.pos_avr
    return torch.where(grid.liquid[None], mixed, grid.pos)
