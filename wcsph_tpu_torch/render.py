"""Software rasterizer: z-buffered particle splatting + camera (port of
``wcsph_tpu/render.py``; reference Canvas.py).

``Camera`` builds the row-major view and projection matrices in numpy
(Canvas.py:67-100), as the JAX package does.  ``render_points`` splats each
point's disk on the card with ``splat_points`` (``engine.py``,
csrc/render.cu; its plain twin on CPU tensors): one scatter-min per colour
channel of a packed (depth, colour) key, the nearest point winning
(Canvas.py:137-178).  ``Canvas.export_png`` and ``write_png`` write 8-bit
RGB PNG files with the standard library (``zlib``, ``struct``): the port
needs no imaging package.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import engine


class Camera:
    """Look-at camera with yaw/pitch orbit and perspective/ortho projection
    (Canvas.py:38-123)."""

    def __init__(self, width: int = 512, height: int = 512):
        self.width = width
        self.height = height
        self.target = np.zeros(3, np.float32)
        self.yaw = 0.0
        self.pitch = 0.0
        self.scale = 3.0
        self.fov = 1.0
        self.near = 1.0
        self.far = 1000.0
        self.ortho = False

    # camera animators (Canvas.py:38-64)
    def static_cam(self, tx, ty, tz):
        self.fov, self.ortho = 2.0, True
        self.target[:] = (tx, ty, tz)

    def yaw_cam(self, tx, ty, tz, d_yaw: float = 0.003, limit: float = 3.14):
        self.fov, self.ortho = 1.0, False
        self.target[:] = (tx, ty, tz)
        if self.yaw < limit:
            self.yaw += d_yaw

    def pitch_cam(self, tx, ty, tz, d_pitch: float = 0.003, limit: float = 0.5):
        self.fov, self.ortho = 1.0, False
        self.target[:] = (tx, ty, tz)
        if self.pitch < limit:
            self.pitch += d_pitch

    def matrices(self) -> Tuple[np.ndarray, np.ndarray]:
        """(view, proj) 4x4 row-major (Canvas.py:67-100)."""
        pitch = np.clip(self.pitch, -1.57, 1.57)
        eye = self.target + self.scale * np.array([
            math.cos(pitch) * math.sin(self.yaw),
            math.sin(pitch),
            math.cos(pitch) * math.cos(self.yaw),
        ])
        up = np.array([
            -math.sin(pitch) * math.sin(self.yaw),
            math.cos(pitch),
            -math.sin(pitch) * math.cos(self.yaw),
        ])
        z = eye - self.target
        z = z / np.linalg.norm(z)
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        view = np.array([
            [*x, -x @ eye],
            [*y, -y @ eye],
            [*z, -z @ eye],
            [0.0, 0.0, 0.0, 1.0],
        ], np.float32)
        y_scale = 1.0 / math.tan(self.fov / 2.0)
        x_scale = y_scale / (self.width / self.height)
        n, f = self.near, self.far
        if self.ortho:
            proj = np.array([
                [x_scale, 0, 0, 0],
                [0, y_scale, 0, 0],
                [0, 0, 1.0 / (n - f), n / (n - f)],
                [0, 0, 0, 1.0],
            ], np.float32)
        else:
            proj = np.array([
                [x_scale, 0, 0, 0],
                [0, y_scale, 0, 0],
                [0, 0, f / (n - f), n * f / (n - f)],
                [0, 0, -1.0, 0],
            ], np.float32)
        return view, proj


def render_points(points: torch.Tensor, colors: torch.Tensor,
                  view: np.ndarray, proj: np.ndarray, width: int,
                  height: int, radius_px: int = 3, background: float = 0.0,
                  radii: torch.Tensor | None = None) -> torch.Tensor:
    """Rasterize planar (3, N) points into an (H, W, 3) float image on the
    points' device.

    Each point splats a disk of ``radius_px`` (or its per-point ``radii``
    entry, capped at radius_px); hidden-surface removal keeps the least
    packed (depth, colour) key per channel.  The reference draws liquid as
    3 px Bresenham circles and boundary as single pixels (sesph.py:201-207).
    """
    pv = np.asarray(proj @ view, np.float32)
    if radii is None:
        radii = torch.full((points.shape[1],), radius_px, dtype=torch.int32,
                           device=points.device)
    return engine.splat_points(points, colors, radii, pv, width, height,
                               radius_px, float(background))


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) image, float in [0, 1] or uint8, as the bytes of an
    8-bit RGB PNG (each row filter type 0, one zlib stream)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    h, w = a.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = a.reshape(h, 3 * w)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    """Write ``img`` (see ``png_bytes``) to ``path``, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return path


class Canvas:
    """Camera + frame export, mirroring the reference Canvas API."""

    def __init__(self, width: int = 512, height: int = 512, fps: float = 30.0):
        self.camera = Camera(width, height)
        self.fps = fps
        self.frame = 0

    def render(self, pos: torch.Tensor, n_liquid: int,
               liquid_color: Sequence[float] = (1.0, 1.0, 1.0),
               solid_color: Sequence[float] = (0.3, 0.3, 0.3),
               radius_px: int = 3) -> np.ndarray:
        """(H, W, 3) float32 numpy image of the (3, N) positions, liquid
        rows first, rendered on their device."""
        n = pos.shape[1]
        # colours and radii stay on the device across frames while the
        # scene and colours do
        key = (n, n_liquid, tuple(liquid_color), tuple(solid_color),
               radius_px, pos.device)
        if getattr(self, "_attr_key", None) != key:
            colors = np.zeros((3, n), np.float32)
            colors[:, :n_liquid] = np.asarray(liquid_color,
                                              np.float32)[:, None]
            colors[:, n_liquid:] = np.asarray(solid_color,
                                              np.float32)[:, None]
            # boundary as single pixels, liquid as discs (sesph.py:201-207)
            radii = np.full((n,), 1, np.int32)
            radii[:n_liquid] = radius_px
            self._colors = torch.as_tensor(colors).to(pos.device)
            self._radii = torch.as_tensor(radii).to(pos.device)
            self._attr_key = key
        view, proj = self.camera.matrices()
        img = render_points(pos, self._colors, view, proj,
                            self.camera.width, self.camera.height, radius_px,
                            radii=self._radii)
        return img.cpu().numpy()

    def export_png(self, img: np.ndarray, time: float,
                   prefix: str = "out/frame_") -> Optional[str]:
        """fps-gated PNG export (Canvas.py:125-135)."""
        if int(time * self.fps) != self.frame:
            return None
        path = write_png(f"{prefix}{self.frame}.png", img)
        self.frame += 1
        return path
