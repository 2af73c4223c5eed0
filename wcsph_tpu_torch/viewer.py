"""Live viewer: the headless analogue of the reference's ``ti.GUI`` loop
(dfsph.py:595-624, ``gui.set_image(...); gui.show()`` on a local window);
port of ``wcsph_tpu/viewer.py``.

A GPU host is a server, not a workstation: there is no display, and a user
watching a run does it from a browser.  So the "GUI" is a small
standard-library HTTP server on a background thread that streams the most
recent rendered frame (``render.Canvas`` output, rasterized on the card by
``render.render_points``) as ``multipart/x-mixed-replace``, the transport
IP cameras use: no client dependencies, one open browser tab, frames as
fast as the simulation produces them.  The frames are PNG
(``render.png_bytes``, standard library only), where the JAX package sends
JPEG through an imaging package that the port does not use; ``/frame.png``
serves the latest one alone.

Usage (mirrors the reference's while-gui.running loop):

    canvas = render.Canvas(512, 512)
    with LiveViewer() as gui:            # prints the URL to open
        while gui.running:
            sim.step()
            img = canvas.render(sim.state.pos, nl)
            gui.show(img)                # ti.GUI.set_image + show

``gui.running`` flips False when a viewer hits the Stop button (the
reference's window-close).  ``show()`` never blocks the sim loop: encoding
happens on the server thread, and if no client is connected the frame is
just kept as the latest numpy array.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .render import png_bytes

_PAGE = """<!doctype html>
<html><head><title>wcsph-tpu live (torch)</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 img { image-rendering:pixelated; border:1px solid #333; margin-top:1em }
 a.btn { color:#f66; text-decoration:none; border:1px solid #f66;
         padding:2px 8px; border-radius:3px }
</style></head><body>
<h3>wcsph-tpu live view &nbsp; <a class="btn" href="/stop">stop</a></h3>
<img src="/stream" alt="waiting for first frame...">
</body></html>
"""


class LiveViewer:
    """Minimal live view server.  All state is a (frame, seq) pair under a
    condition variable; every connected ``/stream`` client waits for seq to
    advance and receives the newest frame only (no backlog — a slow client
    skips frames instead of lagging the sim)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8089,
                 quality: int = 85):
        """``quality`` is the JAX package's JPEG quality, kept in the
        signature and not used: PNG frames are lossless."""
        self._cond = threading.Condition()
        self._frame: bytes | None = None   # encoded PNG
        self._raw: np.ndarray | None = None
        self._seq = 0
        self._running = True

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # stay silent
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame.png":
                    data = viewer._encoded()
                    if data is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seen = -1
                    try:
                        while viewer._running:
                            with viewer._cond:
                                viewer._cond.wait_for(
                                    lambda: viewer._seq != seen
                                    or not viewer._running, timeout=1.0)
                                if viewer._seq == seen:
                                    continue
                                seen = viewer._seq
                            data = viewer._encoded()
                            if data is None:
                                continue
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(b"Content-Type: image/png\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(data)}\r\n\r\n"
                                .encode())
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/stop":
                    viewer.stop()
                    body = b"stopped"
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- sim-loop API (the ti.GUI shape) ------------------------------------

    @property
    def running(self) -> bool:
        return self._running

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def show(self, img: np.ndarray) -> None:
        """Publish a frame: (H, W, 3) float [0,1] or uint8.  Non-blocking —
        stores the raw array and wakes stream clients; PNG encoding is
        deferred to the first request that needs this frame."""
        with self._cond:
            self._raw = img
            self._frame = None
            self._seq += 1
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()

    def close(self) -> None:
        self.stop()
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        print(f"live view at {self.url}")
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals -----------------------------------------------------------

    def _encoded(self) -> bytes | None:
        """Latest frame as PNG; encodes at most once per published frame."""
        with self._cond:
            if self._frame is not None:
                return self._frame
            raw = self._raw
            if raw is None:
                return None
        data = png_bytes(raw)
        with self._cond:
            self._frame = data
        return data


def run_live(sim, canvas, *, host: str = "127.0.0.1", port: int = 8089,
             max_frames: int | None = None, render_every: int = 1,
             frame_cb=None) -> int:
    """Reference main-loop shape (dfsph.py:600-624) as a helper: step the
    sim, rasterize on its device, publish; returns frames shown.  ``frame_cb``
    (sim, img) runs after each published frame (telemetry prints etc.)."""
    shown = 0
    with LiveViewer(host=host, port=port) as gui:
        while gui.running and (max_frames is None or shown < max_frames):
            for _ in range(render_every):
                sim.step()
            img = canvas.render(sim.state.pos, sim.state.n_liquid)
            gui.show(img)
            shown += 1
            if frame_cb is not None:
                frame_cb(sim, img)
    return shown
