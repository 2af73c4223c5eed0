"""The port's surface reconstruction and host views (wcsph_tpu_torch, CPU,
plain twins) against the JAX package on the same inputs.

(a) The tables equal bit for bit; ``marching_cubes`` equals the JAX
    package's exactly on the sphere and the three seeded rough fields of
    tests/test_surface.py; ``marching_cubes_device`` equals the port's host
    extractor at rtol / atol 1e-5 with the tail of its buffer zero, and
    drops the JAX test's budget case as it does.
(b) On the 8^3 liquid block of tests/test_surface.py: the dense field
    within 1e-5 max|phi| (plain) and 1e-4 max|phi| (anisotropic) of
    ``mc_field_packed`` -> ``field_to_dense``; G within 1e-4 of max|G| of
    the JAX package's, and each liquid row's reach (the radius past which
    the field kernel skips a candidate) bounds its ellipsoid: |2 G r| > h
    at r = reach u (1 + 1e-4) for numpy-seeded unit directions u;
    ``reconstruct`` on the host and on the device, plain
    and anisotropic, with the triangles of the JAX extractor on the JAX
    field and vertices within 1e-4 (no cube changes case between the two
    fields: the test counts them), and a watertight mesh.
(c) On the golden-size SESPH scene of tests/test_aux.py: ``grid_stats``
    equal to the JAX package's on every key but the inert
    ``cell_capacity``, ``liquid_positions`` equal, the color field and its
    gradient per liquid particle at rtol 1e-5 (of max |value|), the same
    count from ``export_field_points``, a ``save_obj`` / ``load_obj``
    round trip, and ``SurfaceExporter`` writing ``mc_0.obj`` at t = 0.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from wcsph_tpu import dense_ops, scene
from wcsph_tpu.config import SimConfig
from wcsph_tpu.grid import build_grid, unpack_liquid
from wcsph_tpu.simulation import Simulation, default_config
from wcsph_tpu.state import init_state
from wcsph_tpu.surface import aniso, field, mc, tables

torch = wt = tmc = ttables = None   # bound by _port

R = 0.025


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, tmc, ttables
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch.surface import mc as tmc, tables as ttables
    torch.set_num_threads(1)


def _watertight(verts, tris):
    """Every edge of the welded mesh is used exactly twice."""
    _, t = tmc.weld_vertices(verts, tris)
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]],
                                    t[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return t.size > 0 and (counts == 2).all()


def _sphere(n):
    ax = np.linspace(-1.2, 1.2, n)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    return (1.5 - np.linalg.norm(g, axis=-1)).astype(np.float32)


def test_tables_and_extractors():
    for name in ("TRI_TABLE", "CENTROID_TABLE", "EDGES", "CORNERS",
                 "EDGE_TABLE"):
        a, b = getattr(ttables, name), getattr(tables, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name

    # the fields of tests/test_surface.py::test_device_mc_matches_host
    rng = np.random.default_rng(3)
    fields = [_sphere(20)]
    for _ in range(3):
        base = rng.normal(size=(6, 6, 6))
        fields.append((np.kron(base, np.ones((2, 2, 2)))
                       + 0.3 * rng.normal(size=(12, 12, 12))).astype(
                           np.float32))
    origin = (0.5, -1.0, 2.0)
    for fld in fields:
        hv, ht = mc.marching_cubes(fld, origin, 0.1, isolevel=0.5)
        pv, pt = tmc.marching_cubes(fld, origin, 0.1, isolevel=0.5)
        assert ht.shape[0] > 0
        assert np.array_equal(pv, hv) and np.array_equal(pt, ht)
        dv, n_tris, n_drop = tmc.marching_cubes_device(
            torch.as_tensor(fld), origin, 0.1, isolevel=0.5,
            max_active=4096, max_vertices=30000)
        n = int(n_tris)
        assert int(n_drop) == 0 and n == pt.shape[0]
        np.testing.assert_allclose(dv[: 3 * n].numpy(), pv, rtol=1e-5,
                                   atol=1e-5)
        assert not dv[3 * n:].any()

    # tests/test_surface.py::test_device_mc_budgets
    fld = _sphere(16)
    hv, ht = tmc.marching_cubes(fld, (0, 0, 0), 1.0)
    full = ht.shape[0]
    dv, n_tris, n_drop = tmc.marching_cubes_device(
        torch.as_tensor(fld), (0, 0, 0), 1.0, max_active=4096,
        max_vertices=3 * (full // 2))
    assert int(n_tris) == full // 2 and int(n_drop) == full - full // 2
    np.testing.assert_allclose(dv.numpy(), hv[: 3 * (full // 2)],
                               rtol=1e-5, atol=1e-5)


def test_field_anisotropy_and_reconstruct():
    from wcsph_tpu_torch.config import config_from_dict
    from wcsph_tpu_torch.grid import build_grid as tbuild
    from wcsph_tpu_torch.surface import aniso as taniso
    from wcsph_tpu_torch.surface import reconstruction as trec

    b = scene.SceneBuilder()
    b.add_liquid_block((8, 8, 8), 2 * R, (0, 0, 0))
    sc = b.build()
    lo, hi = sc.domain(pad=6 * R)
    cfg = SimConfig(particle_radius=R, domain_min=lo, domain_max=hi)
    state = init_state(sc, cfg)

    @jax.jit
    def reference(pos):
        grid = build_grid(pos, state.n_liquid, cfg)
        rhop = dense_ops.density_stats(grid, cfg, with_alpha=False).rho
        an = aniso.compute(grid, cfg)
        xs = aniso.smoothed_positions(grid, an)
        return (field.field_to_dense(field.mc_field_packed(grid, cfg, rhop),
                                     cfg),
                field.field_to_dense(field.mc_field_packed(
                    grid, cfg, rhop, pos_smooth=xs, g_packed=an.g), cfg),
                jnp.stack(an.g), grid.pid, grid.overflow)

    phi, phi_a, g_packed, pid, overflow = map(np.asarray,
                                              reference(state.pos))
    assert int(overflow) == 0
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tstate = wt.init_state(sc, "cpu")

    # the dense fields
    got = trec.surface_field(tstate, tcfg).numpy()
    got_a = trec.surface_field(tstate, tcfg, anisotropic=True).numpy()
    assert got.shape == phi.shape and phi.max() > 0.5
    assert np.abs(got - phi).max() <= 1e-5 * np.abs(phi).max()
    assert np.abs(got_a - phi_a).max() <= 1e-4 * np.abs(phi_a).max()

    # G per liquid particle, both packages mapped back to particle order
    nl = sc.n_liquid
    tgrid = tbuild(tstate.pos, nl, tcfg)
    an = taniso.compute(tgrid)
    g_port = np.zeros((9, sc.n_total), np.float32)
    g_port[:, tgrid.order.numpy()] = an.g.numpy()
    g_ref = np.zeros((9, sc.n_total), np.float32)
    g_ref[:, pid[pid >= 0]] = g_packed[:, pid >= 0]
    assert (np.abs(g_port[:, :nl] - g_ref[:, :nl]).max()
            <= 1e-4 * np.abs(g_ref[:, :nl]).max())
    # the reach bounds the ellipsoid |2 G r| <= h of every liquid row
    rows = tgrid.liquid.numpy()
    g_rows = an.g.numpy().T.reshape(-1, 3, 3)[rows]            # (L, 3, 3)
    u = np.random.default_rng(7).normal(size=(g_rows.shape[0], 64, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = an.reach.numpy()[rows, None, None] * u * (1.0 + 1e-4)
    gr = 2.0 * np.einsum("lab,lkb->lka", g_rows, r)
    assert (np.linalg.norm(gr, axis=-1) > tcfg.support_radius).all()

    origin, spacing = field.mc_grid_geometry(cfg)
    for anisotropic, ref_field, port_field in ((False, phi, got),
                                               (True, phi_a, got_a)):
        changed = (tmc.cube_configs(torch.as_tensor(port_field))
                   != tmc.cube_configs(torch.tensor(ref_field)))
        assert int(changed.sum()) == 0, anisotropic
        hv, ht = mc.marching_cubes(ref_field, origin, spacing)
        for on_device in (False, True):
            v, t = trec.reconstruct(tstate, tcfg, anisotropic=anisotropic,
                                    on_device=on_device)
            assert t.shape == ht.shape and ht.shape[0] > 50
            np.testing.assert_allclose(v, hv, rtol=0, atol=1e-4)
            assert _watertight(v, t), (anisotropic, on_device)


def test_host_views_and_exports(tmp_path):
    from wcsph_tpu_torch.surface.reconstruction import SurfaceExporter
    from wcsph_tpu_torch.utils import debug_export as tdebug
    from wcsph_tpu_torch.utils import objio as tobjio

    sc = scene.dam_break(particle_radius=R, fluid_dims=(5, 5, 5),
                         box_extent=0.55)
    lo, hi = sc.domain(pad=4 * R)
    ref = Simulation(sc, default_config("sesph", particle_radius=R,
                                        domain_min=lo, domain_max=hi),
                     solver="sesph")
    port = wt.Simulation(sc, wt.default_config(
        "sesph", particle_radius=R, domain_min=lo, domain_max=hi),
        solver="sesph", device="cpu")
    assert port.cfg.solid_volume_scale == pytest.approx(
        ref.cfg.solid_volume_scale, rel=1e-6)

    want = ref.grid_stats()
    got = port.grid_stats()
    assert want["overflow"] == 0 and got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "cell_capacity"} == {
        k: v for k, v in want.items() if k != "cell_capacity"}
    np.testing.assert_array_equal(port.liquid_positions(),
                                  ref.liquid_positions())
    assert port.positions().shape == (sc.n_total, 3)

    cfg, nl = ref.cfg, sc.n_liquid

    @jax.jit
    def reference(pos):
        grid = build_grid(pos, nl, cfg)
        rhop = dense_ops.density_stats(grid, cfg, False).rho
        color, grad = dense_ops.color_field(grid, cfg, rhop)
        phi = field.field_to_dense(field.mc_field_packed(grid, cfg, rhop),
                                   cfg)
        return (unpack_liquid(grid, color, jnp.zeros((nl,))),
                unpack_liquid(grid, grad, jnp.zeros((3, nl))),
                jnp.sum(phi > 0.0))

    color, grad, n_points = map(np.asarray, reference(ref.state.pos))
    t_color, t_grad = (t.numpy() for t in tdebug.color_field(port.state,
                                                             port.cfg))
    assert (color > 0).all()
    for a, b in ((t_color, color), (t_grad, grad)):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert tdebug.export_field_points(
        port.state, port.cfg, str(tmp_path / "pts.obj")) == int(n_points)
    assert tdebug.export_color_field(
        port.state, port.cfg, str(tmp_path / "color.obj")) == nl

    v = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    f = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    tobjio.save_obj(str(tmp_path / "m.obj"), v, f)
    v2, f2 = tobjio.load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_allclose(v2, v, atol=1e-5)
    np.testing.assert_array_equal(f2, f)

    out = str(tmp_path / "mesh")
    path = SurfaceExporter(port.cfg, out_dir=out).maybe_export(port.state)
    assert path == f"{out}/mc_0.obj" and os.path.getsize(path) > 0
    mv, mt = tobjio.load_obj(path)
    assert mt.shape[0] > 0 and _watertight(mv, mt)
