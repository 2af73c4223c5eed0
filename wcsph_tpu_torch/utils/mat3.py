"""Batched symmetric 3x3 linear algebra on planar tensors.

A batch of symmetric 3x3 matrices is 6 planar component tensors
(xx, xy, xz, yy, yz, zz) of equal shape, as in ``wcsph_tpu/utils/mat3.py``;
the closed-form adjugate inverse replaces the reference's per-particle
matrix inverses (dfsph.py:215).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Sym3(NamedTuple):
    xx: torch.Tensor
    xy: torch.Tensor
    xz: torch.Tensor
    yy: torch.Tensor
    yz: torch.Tensor
    zz: torch.Tensor

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """v is planar (3, N); returns (3, N)."""
        x, y, z = v[0], v[1], v[2]
        return torch.stack([
            self.xx * x + self.xy * y + self.xz * z,
            self.xy * x + self.yy * y + self.yz * z,
            self.xz * x + self.yz * y + self.zz * z,
        ])


def sym3_identity_minus(m: Sym3, scale: torch.Tensor) -> Sym3:
    """I - scale * M (scale broadcasts over the batch)."""
    return Sym3(
        xx=1.0 - scale * m.xx, xy=-scale * m.xy, xz=-scale * m.xz,
        yy=1.0 - scale * m.yy, yz=-scale * m.yz, zz=1.0 - scale * m.zz,
    )


def sym3_inverse(m: Sym3, eps: float = 1e-12) -> Sym3:
    """Closed-form inverse via the adjugate; identity for near-singular
    matrices (preconditioner safety)."""
    c_xx = m.yy * m.zz - m.yz * m.yz
    c_xy = m.xz * m.yz - m.xy * m.zz
    c_xz = m.xy * m.yz - m.xz * m.yy
    c_yy = m.xx * m.zz - m.xz * m.xz
    c_yz = m.xy * m.xz - m.xx * m.yz
    c_zz = m.xx * m.yy - m.xy * m.xy
    det = m.xx * c_xx + m.xy * c_xy + m.xz * c_xz
    ok = det.abs() > eps
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)

    def pick(cof, ident):
        return torch.where(ok, cof * inv_det, ident)

    return Sym3(
        xx=pick(c_xx, 1.0), xy=pick(c_xy, 0.0), xz=pick(c_xz, 0.0),
        yy=pick(c_yy, 1.0), yz=pick(c_yz, 0.0), zz=pick(c_zz, 1.0),
    )
