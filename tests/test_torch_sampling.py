"""The port's Poisson-disk sampler and meshes (wcsph_tpu_torch, CPU, the
plain twin of the phase kernel) against the JAX package on the same
inputs.

(a) ``poisson_disk_sample`` equals ``wcsph_tpu.sampling.poisson_disk_sample``
    bit for bit, order included, with two trials a cell: in one chunk on
    the unit cube of tests/test_sampling.py at r = 0.1 and 0.12 and on
    ``icosphere(2, 0.5)`` at r = 0.1, and in two z-chunks (``max_cells``
    of 15 planes: the second chunk's halo seeded by the first's accepted
    points, which both trials test against) on the cube and the icosphere
    at r = 0.1.  Every point lies on the mesh, and no two points of one
    face are closer than 0.999 r (the sampler's guarantee: across a face's
    edge the geodesic correction lets a pair come closer, so the JAX
    test's same-plane mask, which flags a pair at the cube's crease in the
    JAX output too, is not used).
(b) The port's ``asin_f32`` equals ``jnp.arcsin`` bit for bit on float32
    values over [-1, 1]: the phase step's geodesic correction uses it.
(c) Every mesh of ``utils/meshgen`` equals the JAX package's bit for bit.
(d) ``sample_obj`` writes the points ``poisson_disk_sample`` returns.
"""

import numpy as np
import pytest

from wcsph_tpu.sampling import poisson_disk_sample as jax_sample
from wcsph_tpu.utils import meshgen as jmeshgen

torch = tsampling = tmeshgen = tdense = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, tsampling, tmeshgen, tdense
    import torch
    from wcsph_tpu_torch import dense_ops as tdense
    from wcsph_tpu_torch import sampling as tsampling
    from wcsph_tpu_torch.utils import meshgen as tmeshgen
    torch.set_num_threads(1)


def _unit_cube_mesh():
    """tests/test_sampling.py's unit cube: 12 triangles, 2 per face."""
    v = np.array([(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = []
    for a, b, c, d in quads:
        f += [(a, b, c), (a, c, d)]
    return v, np.asarray(f, np.int32)


MESHES = {"cube": _unit_cube_mesh,
          "icosphere": lambda: jmeshgen.icosphere(2, 0.5)}
# (mesh, radius) a chunking: one test item each (the suite's scheduler
# hands out consecutive items in batches that grow with the items left, so
# the port's cases are few items).  The JAX sampler's cost is its compiles,
# one phase step a (radius, grid) and eager ops a chunk's candidate count,
# so the chunked cases share one radius and grid (22 x 22 x 15 cells in two
# chunks) and the cube at r = 0.12 runs in one chunk only.
CASES = {"one-chunk": (3_000_000, [("cube", 0.1), ("icosphere", 0.1),
                                    ("cube", 0.12)]),
         "chunked": (22 * 22 * 15, [("cube", 0.1), ("icosphere", 0.1)])}
TRIALS = 2


def _on_surface(mesh, pts):
    """Each point within 1e-4 of a face: of the cube's planes, or of the
    icosphere's triangles (distance to the triangle's plane, and inside
    its edges within 1e-4)."""
    if mesh == "cube":
        on = np.zeros(pts.shape[0], bool)
        for d in range(3):
            on |= (np.abs(pts[:, d]) < 1e-4) | (np.abs(pts[:, d] - 1) < 1e-4)
        return on
    v, f = MESHES[mesh]()
    a, b, c = (v[f[:, k]].astype(np.float64) for k in range(3))
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    p = pts.astype(np.float64)[:, None]
    plane = np.abs(np.sum((p - a[None]) * n[None], -1))
    inside = np.ones(plane.shape, bool)
    for e0, e1 in ((a, b), (b, c), (c, a)):
        side = np.sum(np.cross(e1 - e0, p - e0[None]) * n[None], -1)
        inside &= side / np.linalg.norm(e1 - e0, axis=1)[None] > -1e-4
    return ((plane < 1e-4) & inside).any(1)


def _spacing_violations(pts, same, r):
    """Pairs with ``same`` (an (M, M) mask) closer than 0.999 r."""
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, 1e9)
    return int(((d2 < (0.999 * r) ** 2) & same).sum())


@pytest.mark.parametrize("chunking", list(CASES))
def test_sampler_matches_jax(chunking):
    max_cells, cases = CASES[chunking]
    for mesh, radius in cases:
        v, f = MESHES[mesh]()
        ref = jax_sample(v, f, radius, trials=TRIALS, seed=1,
                         max_cells=max_cells)
        got, fid = tsampling.sample_surface(v, f, radius, trials=TRIALS,
                                            seed=1, max_cells=max_cells,
                                            device="cpu")
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, ref)
        assert _on_surface(mesh, got).all(), (mesh, radius)
        assert _spacing_violations(got, fid[:, None] == fid[None, :],
                                   radius) == 0, (mesh, radius)


MESHGEN = {
    "icosphere": ((2, 0.7, (0.1, -0.2, 0.3)), {}),
    "open_tank": (((1.2, 0.8, 1.2), (0.0, 0.1, 0.0), True), {}),
    "torus": ((0.3, 0.1, (0.9, -0.3, 0.0), "x", 24, 12), {}),
    "panel": (((0.04, 0.7, 2.0), (0.2, -0.45, 0.0), 0), {}),
    "merge": ((), {}),
    "weir_tank": ((), {"torus_kw": dict(major=0.3, minor=0.1,
                                        center=(0.9, -0.3, 0.0), axis="x")}),
}


def test_pieces_match_jax(tmp_path):
    """asin_f32 and the meshes bit for bit; sample_obj's file."""
    import jax
    import jax.numpy as jnp

    from wcsph_tpu_torch.utils import objio

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1, 1, 400_000), rng.uniform(-1e-3, 1e-3, 50_000),
        1 - rng.uniform(0, 1e-3, 50_000), -1 + rng.uniform(0, 1e-6, 5_000),
        [0.0, -0.0, 1.0, -1.0, 1e-30, 3e-9, -4e-9, 0.4375, 0.6875]
    ]).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.arcsin)(x))
    got = tdense.asin_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))

    for name, (args, kw) in MESHGEN.items():
        if name == "merge":
            ref = jmeshgen.merge(jmeshgen.icosphere(1), jmeshgen.open_tank())
            got = tmeshgen.merge(tmeshgen.icosphere(1), tmeshgen.open_tank())
        else:
            ref = getattr(jmeshgen, name)(*args, **kw)
            got = getattr(tmeshgen, name)(*args, **kw)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b)

    v, f = _unit_cube_mesh()
    mesh = str(tmp_path / "cube.obj")
    objio.save_obj(mesh, v, f)
    out = str(tmp_path / "cube_boundry.obj")
    pts = tsampling.sample_obj(mesh, out, radius=0.15, trials=2,
                               device="cpu")
    np.testing.assert_array_equal(
        pts, tsampling.poisson_disk_sample(v, f, 0.15, trials=2,
                                           device="cpu"))
    back, faces = objio.load_obj(out)
    assert faces.shape == (0, 3)
    np.testing.assert_allclose(back, pts, atol=1e-6)
