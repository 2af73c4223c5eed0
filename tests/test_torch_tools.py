"""The port's tooling (wcsph_tpu_torch, CPU, plain twins) against the JAX
package on the same inputs.

(a) ``render_points`` on the golden SESPH scene's positions
    (tests/test_aux.py) and on the depth-order case of tests/test_aux.py,
    at 64x64 and 128x96, radius 2 and 3, perspective and ortho, against
    ``wcsph_tpu.render.render_points``: equal images, except that a pixel
    may differ where a splat centre lies within 1e-4 px of a .5 rounding
    boundary (at most 0.1% of the pixels); the same for ``Canvas.render``.
    The PNG writer's image round-trips through zlib and, where PIL is
    installed here, decodes with PIL.
(b) Checkpoints: the JAX package's ``save`` -> the port's ``load`` -> 5
    port steps equal the JAX package's 5 steps at the golden tolerances;
    the port's ``save`` -> ``load`` -> 3 steps equal 3 steps of the saved
    run bit for bit; the port's ``save`` -> the JAX package's ``load``
    gives the same arrays.
(c) The native OBJ reader (built from native/objio.cpp into the port's
    _build/) equals the port's Python parser and the JAX package's
    ``load_obj`` on tests/test_aux.py's case; skipped where g++ is absent.
(d) The viewer: the page, ``/frame.png``, one ``/stream`` frame that
    decodes as PNG, ``/stop`` flipping ``running``, and ``run_live`` for 3
    frames on a 4^3 SESPH scene (tests/test_viewer.py's).
(e) ``profiling.benchmark_step`` returns the JAX package's keys;
    ``profiling.trace`` writes a Chrome trace.
(f) The sampler and ``checkpoint.load`` run on the card unless asked for
    the CPU: here, with no card, they raise.
"""

import os
import shutil
import struct
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from wcsph_tpu import render as jrender
from wcsph_tpu import scene
from wcsph_tpu.simulation import Simulation as JSimulation
from wcsph_tpu.simulation import default_config as jdefault_config
from wcsph_tpu.utils import checkpoint as jcheckpoint
from wcsph_tpu.utils import objio as jobjio

torch = wt = trender = None   # bound by _port

R = 0.025


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, trender
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch import render as trender
    torch.set_num_threads(1)


def _golden_scene():
    return scene.dam_break(particle_radius=R, fluid_dims=(5, 5, 5),
                           box_extent=0.55)


def _scene_points(name):
    """(points (3, N), colours (3, N), radii (N,) or None) of a case."""
    if name == "depth":
        # tests/test_aux.py::test_renderer_depth_order: the nearer red point
        # must win the centre
        pts = np.asarray([[0.0, 0.0], [0.0, 0.0], [0.5, -0.5]], np.float32)
        cols = np.asarray([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], np.float32)
        return pts, cols, None
    sc = _golden_scene()
    pts = np.ascontiguousarray(sc.positions.T)
    n = pts.shape[1]
    cols = np.random.default_rng(0).uniform(0, 1, (3, n)).astype(np.float32)
    radii = np.ones((n,), np.int32)
    radii[: sc.n_liquid] = 3
    return pts, cols, radii


def _camera(cam, projection):
    if projection == "ortho":
        cam.static_cam(0.0, 0.0, 0.0)
    else:
        cam.yaw_cam(0.0, 0.0, 0.0)
        cam.scale, cam.yaw, cam.pitch = 1.5, 0.45, 0.35
    return cam


def _assert_images_match(got, ref, pts, view, proj, width, height, radius):
    """Equal, but for pixels near a splat whose centre lies within 1e-4 px
    of a .5 rounding boundary (at most 0.1% of the pixels)."""
    bad = np.argwhere((got != ref).any(-1))
    if not bad.size:
        return
    assert bad.shape[0] <= 1e-3 * width * height, bad.shape[0]
    hom = np.concatenate([pts, np.ones((1, pts.shape[1]))]).astype(np.float64)
    clip = (proj.astype(np.float64) @ view.astype(np.float64)) @ hom
    sx = (clip[0] / clip[3] + 1.0) * 0.5 * width
    sy = (clip[1] / clip[3] + 1.0) * 0.5 * height
    tie = ((np.abs(sx - np.floor(sx) - 0.5) < 1e-4)
           | (np.abs(sy - np.floor(sy) - 0.5) < 1e-4))
    for py, px in bad:
        near = tie & (np.abs(sx - px) <= radius + 1) & (np.abs(sy - py)
                                                         <= radius + 1)
        assert near.any(), (py, px, got[py, px], ref[py, px])


# (width, height, radius, projection) of each scene's render cases, all in
# one test item (each takes well under a second; the suite's scheduler
# hands out consecutive items in batches that grow with the items left)
RENDER_CASES = [(w, h, rad, proj)
                for w, h in ((64, 64), (128, 96))
                for rad in (2, 3)
                for proj in ("perspective", "ortho")]


def test_render_matches_jax(tmp_path):
    for name in ("golden", "depth"):
        pts, cols, radii = _scene_points(name)
        for width, height, radius, projection in RENDER_CASES:
            view, proj = _camera(jrender.Camera(width, height),
                                 projection).matrices()
            view2, proj2 = _camera(trender.Camera(width, height),
                                   projection).matrices()
            np.testing.assert_array_equal(view, view2)
            np.testing.assert_array_equal(proj, proj2)
            ref = np.asarray(jrender.render_points(
                jnp.asarray(pts), jnp.asarray(cols), view, proj, width,
                height, radius_px=radius,
                radii=None if radii is None else jnp.asarray(radii)))
            got = trender.render_points(
                torch.from_numpy(pts), torch.from_numpy(cols), view, proj,
                width, height, radius_px=radius,
                radii=None if radii is None
                else torch.from_numpy(radii)).numpy()
            assert got.shape == (height, width, 3)
            assert got.dtype == np.float32
            _assert_images_match(got, ref, pts, view, proj, width, height,
                                 radius)
            if name == "depth" and projection == "ortho":
                centre = got[height // 2, width // 2]
                assert centre[0] > 0.9 and centre[1] < 0.1

    sc = _golden_scene()
    pts = np.ascontiguousarray(sc.positions.T)
    jc, tc = jrender.Canvas(128, 96), trender.Canvas(128, 96)
    for c in (jc, tc):
        _camera(c.camera, "perspective")
    ref = jc.render(jnp.asarray(pts), sc.n_liquid, liquid_color=(0.35, 0.65,
                                                                  1.0))
    got = tc.render(torch.from_numpy(pts), sc.n_liquid,
                    liquid_color=(0.35, 0.65, 1.0))
    view, proj = tc.camera.matrices()
    _assert_images_match(got, ref, pts, view, proj, 128, 96, 3)
    assert 0.005 < (got.sum(-1) > 0).mean() < 0.9

    # fps-gated export, then the file: signature, IHDR, and the rows
    # (filter byte 0 each) of the one zlib stream
    assert tc.export_png(got, 0.5 / tc.fps, prefix=str(tmp_path / "f_")) \
        == str(tmp_path / "f_0.png")
    assert tc.export_png(got, 0.5 / tc.fps, prefix=str(tmp_path / "f_")) \
        is None
    data = (tmp_path / "f_0.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, kind = struct.unpack(">IIBB", data[16:26])
    assert (w, h, depth, kind) == (128, 96, 8, 2)
    idat = data.index(b"IDAT")
    size = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + size]),
                        np.uint8).reshape(96, 1 + 3 * 128)
    assert (raw[:, 0] == 0).all()
    want = (np.clip(got, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(raw[:, 1:].reshape(96, 128, 3), want)
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f_0.png").convert("RGB")), want)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _jsim():
    sc = _golden_scene()
    lo, hi = sc.domain(pad=4 * R)
    cfg = jdefault_config("dfsph", particle_radius=R, domain_min=lo,
                          domain_max=hi)
    return JSimulation(sc, cfg, solver="dfsph")


def _tsim():
    sc = wt.dam_break(particle_radius=R, fluid_dims=(5, 5, 5),
                      box_extent=0.55)
    lo, hi = sc.domain(pad=4 * R)
    cfg = wt.default_config("dfsph", particle_radius=R, domain_min=lo,
                            domain_max=hi)
    return wt.Simulation(sc, cfg, solver="dfsph", device="cpu")


def test_checkpoints_cross_both_packages(tmp_path):
    """JAX save -> port load -> 5 steps at the golden tolerances; port
    save -> load -> 3 steps bit for bit; port save -> JAX load."""
    from wcsph_tpu_torch.utils import checkpoint

    jsim = _jsim()
    jsim.run(5)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jsim.state)
    jsim.run(5)
    tsim = _tsim()
    tsim.state = checkpoint.load(path, device="cpu")
    tsim.run(5)
    np.testing.assert_allclose(tsim.state.pos.numpy(),
                               np.asarray(jsim.state.pos),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tsim.state.vel.numpy(),
                               np.asarray(jsim.state.vel),
                               rtol=2e-3, atol=2e-4)
    assert abs(float(tsim.state.dt) - float(jsim.state.dt)) < 1e-6

    sim = _tsim()
    sim.run(5)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, sim.state)
    sim2 = _tsim()
    sim2.state = checkpoint.load(path, device="cpu")
    sim.run(3)
    sim2.run(3)
    for name in ("pos", "vel", "kappa", "kappa_v", "vel_guess"):
        np.testing.assert_array_equal(getattr(sim2.state, name).numpy(),
                                      getattr(sim.state, name).numpy())
    assert sim2.state.dt == sim.state.dt and sim2.state.time == sim.state.time

    sim = _tsim()
    sim.run(2)
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, sim.state)
    js = jcheckpoint.load(path)
    st = sim.state
    for name in ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
                 "kappa_v"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(st, name).numpy())
    assert np.asarray(js.dt).dtype == np.float32
    assert float(js.dt) == float(st.dt) and float(js.time) == float(st.time)
    assert int(js.last_pressure_iters) == st.last_pressure_iters
    assert int(js.last_visc_iters) == st.last_visc_iters
    assert (js.n_liquid, js.n_total) == (st.n_liquid, st.n_total)


# ---------------------------------------------------------------------------
# Native OBJ reader
# ---------------------------------------------------------------------------

def test_native_objio_matches_python_and_jax(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native reader cannot be built")
    from wcsph_tpu_torch.utils import native, objio

    rng = np.random.default_rng(5)
    v = rng.normal(size=(500, 3)).astype(np.float32)
    f = rng.integers(0, 500, (300, 3)).astype(np.int32)
    p = str(tmp_path / "n.obj")
    objio.save_obj(p, v, f)
    assert native.load() is not None
    assert native.BUILD_DIR in native._library_path().parents
    vn, fn = objio._load_obj_native(p)
    vp, fp = objio._load_obj_python(p)
    vj, fj = jobjio.load_obj(p)
    vl, fl = objio.load_obj(p)
    np.testing.assert_allclose(vn, vp, atol=1e-6)
    np.testing.assert_array_equal(fn, fp)
    np.testing.assert_array_equal(vn, vj)
    np.testing.assert_array_equal(fn, fj)
    np.testing.assert_array_equal(vl, vn)
    np.testing.assert_array_equal(fl, fn)


# ---------------------------------------------------------------------------
# Viewer
# ---------------------------------------------------------------------------

def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers, r.read()


def _png_pixels(data):
    """(H, W, 3) uint8 of an 8-bit RGB PNG written by ``png_bytes``."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    size = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + size]),
                        np.uint8).reshape(h, 1 + 3 * w)
    return raw[:, 1:].reshape(h, w, 3)


def test_viewer_and_run_live():
    """The page, /frame.png, one /stream frame as PNG and /stop on one
    viewer; then run_live for 3 frames."""
    from wcsph_tpu_torch.viewer import LiveViewer, run_live

    viewer = LiveViewer(port=0)           # ephemeral port
    try:
        status, _, body = _get(viewer.url)
        assert status == 200 and b"wcsph-tpu live" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.url + "frame.png")
        assert e.value.code == 503
        img = np.zeros((32, 48, 3), np.float32)
        img[8:16, 12:24, 0] = 1.0
        viewer.show(img)
        status, headers, body = _get(viewer.url + "frame.png")
        assert status == 200 and headers["Content-Type"] == "image/png"
        np.testing.assert_array_equal(_png_pixels(body),
                                      (img * 255).astype(np.uint8))

        img = np.full((16, 16, 3), 0.5, np.float32)
        viewer.show(img)
        req = urllib.request.urlopen(viewer.url + "stream", timeout=10)
        assert "multipart/x-mixed-replace" in req.headers["Content-Type"]
        assert req.readline().strip() == b"--frame"
        assert b"image/png" in req.readline()
        clen = int(req.readline().split(b":")[1])
        req.readline()                           # blank
        data = req.read(clen)
        req.close()
        np.testing.assert_array_equal(_png_pixels(data),
                                      (img * 255).astype(np.uint8))

        assert viewer.running
        status, _, body = _get(viewer.url + "stop")
        assert status == 200 and body == b"stopped"
        assert not viewer.running
    finally:
        viewer.close()

    sc = wt.dam_break(particle_radius=R, fluid_dims=(4, 4, 4),
                      box_extent=0.35)
    lo, hi = sc.domain(pad=6 * R)
    cfg = wt.default_config("sesph", particle_radius=R, domain_min=lo,
                            domain_max=hi)
    sim = wt.Simulation(sc, cfg, solver="sesph", device="cpu")
    canvas = trender.Canvas(64, 64)
    canvas.camera.static_cam(0.0, 0.0, 0.0)
    seen = []
    shown = run_live(sim, canvas, port=0, max_frames=3,
                     frame_cb=lambda s, img: seen.append(img.shape))
    assert shown == 3
    assert seen == [(64, 64, 3)] * 3
    assert float(sim.state.time) > 0.0


# ---------------------------------------------------------------------------
# Profiling, and the card as the default device
# ---------------------------------------------------------------------------

def test_profiling_and_the_card_by_default(tmp_path):
    """benchmark_step's keys and trace's file; with no card, the sampler
    and checkpoint.load (both on the card by default) raise."""
    from wcsph_tpu_torch.sampling import poisson_disk_sample
    from wcsph_tpu_torch.utils import checkpoint, profiling

    sim = _tsim()
    out = profiling.benchmark_step(sim, steps=2, warmup=1)
    assert set(out) == {"mean_ms", "min_ms", "p50_ms",
                        "particle_steps_per_sec"}
    assert all(isinstance(v, float) and v > 0 for v in out.values())
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        sim.step()
    assert os.path.getsize(os.path.join(log_dir, "trace.json")) > 0

    if torch.cuda.is_available():
        return        # a card is present: the default device is usable
    v, f = np.eye(3, dtype=np.float32), np.asarray([[0, 1, 2]], np.int32)
    with pytest.raises((RuntimeError, AssertionError)):
        poisson_disk_sample(v, f, 0.2)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, sim.state)
    with pytest.raises((RuntimeError, AssertionError)):
        checkpoint.load(path)
