"""SPH smoothing kernels on tensors (twin of ``wcsph_tpu/kernels.py``).

Cubic spline W and the scalar gradient factor ``gs`` with
gradW(r) = gs(|r|) * r (reference kernels/CubicKernel.py:20-54), and the
Akinci cohesion and adhesion splines of the surface tension.  Branches
are ``torch.where`` selections; every function takes the support radius
``h`` explicitly.
"""

from __future__ import annotations

import math

import torch

_EPS = 1.0e-5


def cubic_w_q(q: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic spline W as a function of q = |r| / h:
    sigma (6q^3 - 6q^2 + 1) for q <= 0.5, sigma 2 (1 - q)^3 for q <= 1,
    0 beyond, with sigma = 8 / (pi h^3)."""
    sigma = 8.0 / (math.pi * h * h * h)
    inner = 6.0 * q * q * q - 6.0 * q * q + 1.0
    f = 1.0 - q
    outer = 2.0 * f * f * f
    w = torch.where(q <= 0.5, inner, outer)
    return torch.where(q <= 1.0, sigma * w, 0.0)


def cubic_w_scalar(dist: torch.Tensor, h: float) -> torch.Tensor:
    """W(|r|) for a distance tensor (reference Cubic_W_norm)."""
    return cubic_w_q(dist / h, h)


def cubic_w0(h: float) -> float:
    """W(0): the self-contribution used in density sums."""
    return 8.0 / (math.pi * h * h * h)


def cubic_grad_scale(dist: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar s(|r|) with gradW(r) = s * r:
    L (3q - 2) / h^2 for q <= 0.5, -L (1 - q)^2 / (d h) for q <= 1,
    0 for d <= 1e-5 or q > 1, with L = 48 / (pi h^3)."""
    m_l = 48.0 / (math.pi * h * h * h)
    q = dist / h
    inner = m_l * (3.0 * q - 2.0) / (h * h)
    outer = -m_l * (1.0 - q) * (1.0 - q) / (torch.clamp(dist, min=_EPS) * h)
    s = torch.where(q <= 0.5, inner, outer)
    return torch.where((dist > _EPS) & (q <= 1.0), s, 0.0)


def cohesion_w_scalar(dist: torch.Tensor, h: float) -> torch.Tensor:
    """Akinci cohesion spline (CohesionKernel.py:17-29):
    k (h - r)^3 r^3 for h/2 < r <= h, 2 k (h - r)^3 r^3 - h^6/64 for
    r <= h/2, 0 beyond, with k = 32 / (pi h^9).  The inner branch's offset
    sits outside the k factor, as in the reference.  Cubes are written as
    products, the arithmetic of the CUDA kernel."""
    m_k = 32.0 / (math.pi * h ** 9)
    hd = h - dist
    base = hd * hd * hd * (dist * dist * dist)
    w = torch.where(dist > 0.5 * h, m_k * base,
                    2.0 * m_k * base - h ** 6 / 64.0)
    return torch.where(dist * dist <= h * h, w, 0.0)


def cohesion_w(r: torch.Tensor, h: float) -> torch.Tensor:
    return cohesion_w_scalar(torch.linalg.norm(r, dim=-1), h)


def adhesion_w_scalar(dist: torch.Tensor, h: float) -> torch.Tensor:
    """Akinci adhesion spline (AdhesionKernel.py:20-29):
    0.007 / h^3.25 (-4 r^2 / h + 6 r - 2 h)^(1/4) for h/2 < r <= h, else
    0.  The fourth root is two square roots, as in the CUDA kernel."""
    m_k = 0.007 / h ** 3.25
    arg = torch.clamp(-4.0 * dist * dist / h + 6.0 * dist - 2.0 * h, min=0.0)
    inside = (dist > 0.5 * h) & (dist * dist <= h * h)
    return torch.where(inside, m_k * torch.sqrt(torch.sqrt(arg)), 0.0)


def adhesion_w(r: torch.Tensor, h: float) -> torch.Tensor:
    return adhesion_w_scalar(torch.linalg.norm(r, dim=-1), h)
