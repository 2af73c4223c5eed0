"""Package-level contracts of the port (wcsph_tpu_torch).

* importing it pulls in no JAX, flax or wcsph_tpu (the GPU machine has none);
* its SimConfig has the JAX package's fields and defaults, the config and
  state cross between the packages, and its scene builders give the JAX
  package's particles;
* the CPU path (plain twins) never touches the kernel launch counters, and
  a tensor on a device with neither a kernel nor a plain twin raises;
* the kernel tables of engine.py (KERNELS, OWN_KERNELS, LAUNCHES,
  _SIGNATURES, the ctypes mirrors) agree with the CUDA sources and with the
  TPU kernels they name, one case per kernel;
* building the CUDA kernels without nvcc raises with a clear message.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = wt = engine = tgrid = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, engine, tgrid
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch import engine, grid as tgrid
    torch.set_num_threads(1)


ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "wcsph_tpu_torch"


def test_port_imports_no_jax():
    """In a fresh interpreter, with every module of the package loaded (the
    import statements of each source file: tests/test_torch_sources.py)."""
    mods = sorted(".".join(f.relative_to(ROOT).with_suffix("").parts)
                  for f in PKG.rglob("*.py") if f.name != "__init__.py")
    assert "wcsph_tpu_torch.solvers.iisph" in mods
    code = (f"import sys, wcsph_tpu_torch, {', '.join(mods)}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'wcsph_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_host_model_crosses_between_packages(tmp_path):
    """SimConfig parity and round trip; state_from_numpy of the JAX
    package's state_to_numpy (non-zero warm starts) and back; the scene
    builders (a numpy copy) give the JAX package's particles, for the dam
    break and an OBJ obstacle read by load_obj."""
    import jax.numpy as jnp

    from wcsph_tpu import dam_break
    from wcsph_tpu import scene as jscene
    from wcsph_tpu.config import SimConfig as JaxConfig
    from wcsph_tpu.state import init_state, state_to_numpy

    ref = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(wt.SimConfig)]
    assert got == ref
    jcfg = JaxConfig(particle_radius=0.02, domain_min=(-1, -2, -3),
                     cell_capacity=24, viscosity=3.0)
    tcfg = wt.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.grid_res == jcfg.grid_res
    with pytest.raises(ValueError):
        wt.config_from_dict({"no_such_field": 1})

    sc = dam_break(particle_radius=0.025, fluid_dims=(3, 3, 3),
                   box_extent=0.3)
    s = init_state(sc, JaxConfig())
    rng = np.random.RandomState(0)
    nl = sc.n_liquid
    s = s.replace(vel=jnp.asarray(rng.randn(3, nl), jnp.float32),
                  vel_guess=jnp.asarray(rng.randn(3, nl), jnp.float32),
                  kappa=jnp.asarray(rng.randn(nl), jnp.float32),
                  kappa_v=jnp.asarray(rng.randn(nl), jnp.float32),
                  dt=jnp.float32(2.5e-3), time=jnp.float32(0.125),
                  last_pressure_iters=jnp.int32(7))
    d = state_to_numpy(s)
    t = wt.state_from_numpy(d, "cpu")
    back = wt.state_to_numpy(t)
    for k in ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
              "kappa_v", "dt", "time", "last_visc_iters",
              "last_pressure_iters", "n_liquid", "n_total"):
        np.testing.assert_array_equal(back[k], np.asarray(d[k]), err_msg=k)
    assert t.n_liquid == nl and float(t.kappa_v.abs().max()) > 0.0

    obj = tmp_path / "quad.obj"
    obj.write_text("# quad\nv 0 0 0\nv 0.1 0 0\nv 0.1 0.1 0\n"
                   "v 0 0.1 0.05\nf 1 2 3 4\n")
    scenes = []
    for mod in (jscene, wt.scene):
        sc = mod.dam_break(particle_radius=0.025, fluid_dims=(3, 4, 5),
                           box_extent=0.5)
        b = mod.SceneBuilder()
        b.add_liquid_block((2, 2, 2), 0.05)
        b.add_obj(str(obj))
        scenes.append((sc, b.build()))
    for a, b in zip(*scenes):
        np.testing.assert_array_equal(a.positions, b.positions)
        assert (a.n_liquid, a.n_solid) == (b.n_liquid, b.n_solid)
        np.testing.assert_array_equal(a.aabb_min, b.aabb_min)
        np.testing.assert_array_equal(a.aabb_max, b.aabb_max)
    assert scenes[1][1].n_solid == 4


def _golden_sim():
    r = 0.025
    sc = wt.dam_break(particle_radius=r, fluid_dims=(4, 4, 4),
                      box_extent=0.45)
    lo, hi = sc.domain(pad=4 * r)
    return wt.Simulation(sc, wt.default_config(
        "dfsph", particle_radius=r, domain_min=lo, domain_max=hi),
        device="cpu")


def test_cpu_path_counts_no_launch_and_never_falls_back():
    """The plain twins on CPU tensors leave every launch counter at 0; a
    tensor on a device with neither a kernel nor a plain twin raises."""
    engine.reset_launch_counts()
    sim = _golden_sim()
    sim.run(2)
    sim.check_health()
    assert sim.telemetry()["neighbor_overflow"] == 0
    assert all(v == 0 for v in engine.LAUNCHES.values()), engine.LAUNCHES
    assert set(engine.LAUNCHES) == set(engine.KERNELS) | set(
        engine.OWN_KERNELS)

    g = tgrid.build_grid(sim.state.pos, sim.state.n_liquid, sim.cfg)
    vel = torch.zeros((3, g.n), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain twin"):
        engine.k1_div_acc(g, vel)
    # the oracle's switch sends nothing but CUDA tensors elsewhere, and
    # is off again once its block is left, by an exception too
    with pytest.raises(ValueError, match="no kernel or plain twin"):
        with engine.plain_twins():
            engine.k1_div_acc(g, vel)
    assert not engine._plain_on_card


@pytest.mark.parametrize("solver,over", [
    ("sesph", {}), ("pcisph", {}), ("iisph", {}),
    ("dfsph", {"tension_coff": 0.25, "tension_coff_b": 0.25})],
    ids=["sesph", "pcisph", "iisph", "dfsph-tension"])
def test_cpu_path_of_each_solver_counts_no_launch(solver, over):
    engine.reset_launch_counts()
    r = 0.025
    sc = wt.dam_break(particle_radius=r, fluid_dims=(4, 4, 4),
                      box_extent=0.45)
    lo, hi = sc.domain(pad=4 * r)
    sim = wt.Simulation(sc, wt.default_config(
        solver, particle_radius=r, domain_min=lo, domain_max=hi, **over),
        solver=solver, device="cpu")
    assert sim.solver_name == solver
    sim.run(2)
    sim.check_health()
    assert all(v == 0 for v in engine.LAUNCHES.values()), engine.LAUNCHES


# the wrappers of engine.py, by name: parametrized here so that collection
# needs no torch; test_kernel_tables_list_the_same_entries holds the list
# against engine.KERNELS
KERNEL_NAMES = [
    "k1_density_alpha_drho", "k1_div_acc", "k1_visc_init", "k1_vorticity",
    "k2_fused_kappa_drho", "k3_fused_iter_full", "k4_fused_visc_iter",
    "k5_density_alpha", "k5_sesph_force", "k5_iisph_adv", "k5_iisph_aii",
    "k5_iisph_force", "k6_fused_tension", "k7_fused_jacobi_iter",
    "k8_fused_pcisph_iter"]


def _cuda_entries():
    """name -> (source file, parameter count) of every ``extern "C"`` entry
    under csrc/, and the sources' text by file."""
    src = {f: f.read_text() for f in sorted((PKG / "csrc").glob("*.cu*"))}
    entries = {}
    for f, text in src.items():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = (f, m.group(2).count(",") + 1)
    return entries, src


# the port's own kernels (no TPU counterpart): the grid stage, the list and
# the surface reconstruction's field and anisotropy moments and matrices
OWN_KERNEL_NAMES = ["bin_cells", "pack_rows", "unpack_rows",
                    "nbr_list_offsets", "nbr_list_fill", "mc_field",
                    "aniso_moments", "aniso_g"]


def test_kernel_tables_list_the_same_entries():
    """KERNELS has the 15 counterparts of TPU kernels and OWN_KERNELS the
    port's own (the bin, pack, unpack, the neighbour list's offsets and
    fill, and the surface's field, anisotropy moments and G); LAUNCHES and _SIGNATURES have the names of both, and they are
    exactly the ``extern "C"`` entries of csrc/.  Each of the port's own
    has a wrapper of its name, a source that defines its entry, a plain
    twin and a ctypes signature with as many parameters as the entry."""
    assert set(engine.KERNELS) == set(KERNEL_NAMES)
    assert len(KERNEL_NAMES) == 15
    assert set(engine.OWN_KERNELS) == set(OWN_KERNEL_NAMES)
    names = set(KERNEL_NAMES) | set(engine.OWN_KERNELS)
    assert names == set(engine.LAUNCHES) == set(engine._SIGNATURES)
    entries = _cuda_entries()[0]
    assert set(entries) == names
    for name in OWN_KERNEL_NAMES:
        source, _, twin = engine.OWN_KERNELS[name]
        f, n_params = entries[name]
        assert ROOT / source == f, name
        assert callable(getattr(engine, name)) and callable(twin)
        assert n_params == len(engine._SIGNATURES[name]), name


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_tables_agree_with_sources(name):
    """The wrapper has a source, a plain twin and a ctypes signature with
    as many parameters as its ``extern "C"`` entry; its ``replaces`` names
    a function or emit that stands at that line of the JAX package's
    engine."""
    source, replaces, twin = engine.KERNELS[name]
    assert callable(getattr(engine, name)) and callable(twin)
    f, n_params = _cuda_entries()[0][name]
    assert ROOT / source == f
    assert n_params == len(engine._SIGNATURES[name])
    jax_engine = (ROOT / "wcsph_tpu" / "pallas" / "engine.py").read_text(
    ).splitlines()
    cited = re.findall(r"(\d+) \((\w+)|(\w+) (\d+)\)", replaces)
    assert cited, replaces
    for line, what, what2, line2 in cited:
        line, what = (line, what) if what else (line2, what2)
        text = jax_engine[int(line) - 1]
        assert re.match(rf"(def|class) {what}\b", text), text


# structs retired with their ctypes mirrors
RETIRED_STRUCTS = {"Fields"}


@pytest.mark.parametrize("struct,where", [
    ("Geom", "common.cuh"), ("TensionParams", "solver_sweeps.cu"),
    ("Fields", "bin.cu")])
def test_ctypes_mirror_follows_the_cuda_struct(struct, where):
    """The ctypes mirror lists the fields of the CUDA struct in order (an
    array field with the length of its ``constexpr int`` bound).  A struct
    that Python no longer passes (``Fields``, the unpack's pointer table:
    the unpack takes its fields' bases as plain arguments) is gone from
    both sides."""
    import ctypes

    mirror = getattr(engine, "_" + struct, None)
    text = _cuda_entries()[1][PKG / "csrc" / where]
    found = re.search(rf"struct {struct} {{(.*?)\n}};", text, re.S)
    if struct in RETIRED_STRUCTS:
        assert mirror is None and found is None
        return
    body = re.sub(r"//[^\n]*", "", found.group(1))
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            ctype = (ctypes.c_void_p if "*" in decl else
                     ctypes.c_int if decl.startswith("int") else
                     ctypes.c_float)
            rest = re.sub(r"^(const )?(float4|float|int)\*?", "", decl)
            for n in rest.split(","):
                n = n.strip(" *")
                dim = re.fullmatch(r"(\w+)\[(\w+)\]", n)
                if dim:
                    n = dim.group(1)
                    size = re.search(rf"constexpr int {dim.group(2)} = "
                                     r"(\d+);", text).group(1)
                    fields.append((n, ctype * int(size)))
                else:
                    fields.append((n, ctype))
    assert fields == list(mirror._fields_)


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        engine.build_library(build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()
