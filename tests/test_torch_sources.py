"""The port's source files, read as text (wcsph_tpu_torch, chip_smoke.py).

No file of the port imports ``jax``, ``flax`` or the JAX package
``wcsph_tpu``: the machine with the card has none of them; nor ``PIL``,
which it does not have either (the port writes its PNG frames with the
standard library).  One case per
source file; nothing is imported here, so a worker that runs only these
cases loads no torch.  (The same rule in a live interpreter:
tests/test_torch_package.py::test_port_imports_no_jax.)

The sweeps that run after a step's neighbour list is built walk that list
and have no cell-loop form: one case per list-walking ``__global__`` of
csrc/sweeps.cu, read with the device functions it calls, and one case for
csrc/solver_sweeps.cu (K7's two sweeps, IISPH's three K5 entries, K6 and
the unfused loops' entries of those sweeps walk the list, K8's
acceleration sweep the hits of its first sweep).

No kernel source copies to or from the host, allocates, or waits for the
card (every file of csrc/); the grid stage's list offsets, pack and unpack
are one launch each: the C entry launches once and resets nothing, and the
wrapper builds no ctypes pointer table per call; and the bin makes at most
four launches and clears nothing.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# listed, not globbed, so that every xdist worker collects the same cases;
# test_source_list_is_whole holds the list against the tree
SOURCES = [
    "chip_smoke.py",
    "wcsph_tpu_torch/__init__.py",
    "wcsph_tpu_torch/ab_list.py",
    "wcsph_tpu_torch/bench.py",
    "wcsph_tpu_torch/boundary.py",
    "wcsph_tpu_torch/config.py",
    "wcsph_tpu_torch/dense_ops.py",
    "wcsph_tpu_torch/engine.py",
    "wcsph_tpu_torch/examples/__init__.py",
    "wcsph_tpu_torch/examples/run_dam_break.py",
    "wcsph_tpu_torch/examples/run_live.py",
    "wcsph_tpu_torch/examples/run_mesh_scene.py",
    "wcsph_tpu_torch/examples/run_showcase.py",
    "wcsph_tpu_torch/examples/sample_boundary.py",
    "wcsph_tpu_torch/grid.py",
    "wcsph_tpu_torch/kernels.py",
    "wcsph_tpu_torch/ops.py",
    "wcsph_tpu_torch/parallel/__init__.py",
    "wcsph_tpu_torch/parallel/comm.py",
    "wcsph_tpu_torch/parallel/dryrun.py",
    "wcsph_tpu_torch/parallel/halo.py",
    "wcsph_tpu_torch/parallel/slab.py",
    "wcsph_tpu_torch/profile_paths.py",
    "wcsph_tpu_torch/render.py",
    "wcsph_tpu_torch/sampling.py",
    "wcsph_tpu_torch/scene.py",
    "wcsph_tpu_torch/simulation.py",
    "wcsph_tpu_torch/solvers/__init__.py",
    "wcsph_tpu_torch/solvers/common.py",
    "wcsph_tpu_torch/solvers/dfsph.py",
    "wcsph_tpu_torch/solvers/iisph.py",
    "wcsph_tpu_torch/solvers/pcisph.py",
    "wcsph_tpu_torch/solvers/sesph.py",
    "wcsph_tpu_torch/state.py",
    "wcsph_tpu_torch/surface/__init__.py",
    "wcsph_tpu_torch/surface/aniso.py",
    "wcsph_tpu_torch/surface/field.py",
    "wcsph_tpu_torch/surface/mc.py",
    "wcsph_tpu_torch/surface/reconstruction.py",
    "wcsph_tpu_torch/surface/tables.py",
    "wcsph_tpu_torch/utils/__init__.py",
    "wcsph_tpu_torch/utils/checkpoint.py",
    "wcsph_tpu_torch/utils/debug_export.py",
    "wcsph_tpu_torch/utils/mat3.py",
    "wcsph_tpu_torch/utils/meshgen.py",
    "wcsph_tpu_torch/utils/native.py",
    "wcsph_tpu_torch/utils/objio.py",
    "wcsph_tpu_torch/utils/profiling.py",
    "wcsph_tpu_torch/viewer.py",
    "wcsph_tpu_torch/viscosity.py",
]


def test_source_list_is_whole():
    """A module added to the port is added to the list above."""
    found = sorted(f.relative_to(ROOT).as_posix()
                   for f in (ROOT / "wcsph_tpu_torch").rglob("*.py"))
    assert SOURCES == ["chip_smoke.py", *found]


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    tree = ast.parse((ROOT / source).read_text())
    seen = 0
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            seen += 1
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                           "wcsph_tpu"), n
            assert n.split(".")[0] != "PIL", n
    # an __init__ may hold relative imports only
    assert seen or source.endswith("__init__.py")


CSRC = ROOT / "wcsph_tpu_torch" / "csrc"
# the kernel sources, as SOURCES lists the Python ones
CUDA_SOURCES = ["bin.cu", "common.cuh", "render.cu", "sampling.cu",
                "solver_sweeps.cu", "surface.cu", "sweeps.cu"]
# the C entries of csrc/bin.cu that launch once, and their Python wrappers
ONE_LAUNCH = ["nbr_list_offsets", "pack_rows", "unpack_rows"]
# the most launches of the bin's C entry, those of its static helpers
# counted in
BIN_LAUNCHES = 4


def test_cuda_sources_never_wait_for_the_card():
    """No kernel source copies to or from the host, allocates, or waits for
    the device: a launch only enqueues work, so the step's stage from the
    bin through the list makes no host read (chip_smoke.py runs it under
    torch.cuda.set_sync_debug_mode("error") on the card).  The list above
    is the tree's.

    Each entry of ONE_LAUNCH launches one kernel (directly, or through a
    static helper of bin.cu) and calls no cudaMemset; its wrapper in
    engine.py builds no pointer table (engine.py defines no ``_Fields``,
    ``_fields`` or ``_field_rows``, and bin.cu no ``struct Fields``).  The
    bin's entry calls no cudaMemset and launches at most BIN_LAUNCHES
    kernels, those of the static helpers it calls counted in."""
    assert CUDA_SOURCES == sorted(f.name for f in CSRC.glob("*.cu*"))
    for source in CUDA_SOURCES:
        text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
        assert not re.search(r"\bcudaMemcpy\w*\s*\(|Synchronize\s*\(|"
                             r"\bcudaMalloc\w*\s*\(|\bcudaFree\s*\(",
                             text), source

    text = re.sub(r"//[^\n]*", "", (CSRC / "bin.cu").read_text())
    launch = r"<<<|\bcudaLaunch\w*\s*\("
    helpers = {m.group(1): len(re.findall(launch, m.group(2)))
               for m in re.finditer(r"^static [^(=;]*?\b(\w+)\s*\((.*?)\n}",
                                    text, re.S | re.M)
               if re.search(launch, m.group(2))}
    tree = ast.parse((ROOT / "wcsph_tpu_torch" / "engine.py").read_text())
    wrappers = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    defined = {t.id for n in tree.body if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(t, ast.Name)}
    defined |= {n.name for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert defined.isdisjoint({"_Fields", "_FS", "_fields", "_field_rows"})
    assert not re.search(r"\bstruct\s+Fields\b", text)
    body = re.search(r'extern "C" int bin_cells\(.*?\n}', text, re.S).group(0)
    assert not re.search(r"\bcudaMemset\w*\s*\(", body)
    launches = len(re.findall(launch, body)) + sum(
        n for h, n in helpers.items() if re.search(rf"\b{h}\s*\(", body))
    assert 0 < launches <= BIN_LAUNCHES, launches
    for name in ONE_LAUNCH:
        body = re.search(rf'extern "C" int {name}\(.*?\n}}', text,
                         re.S).group(0)
        assert len(re.findall(launch, body)) == 1, name
        assert not re.search(r"\bcudaMemset\w*\s*\(", body), name
        assert not any(re.search(rf"\b{h}\s*\(", body) for h in helpers), name
        called = {c.func.id for c in ast.walk(wrappers[name])
                  if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
        assert called.isdisjoint({"_Fields", "_fields", "_field_rows"}), name
        assert "_launch" in called, name


# the C entries of csrc/surface.cu and the kernels each launches: the field
# kernel, plain or anisotropic (one of the two a call); the moments kernel
# once (both walks of a row in one launch); G's kernel once
SURFACE_ENTRIES = {
    "mc_field": ["mc_field_kernel<false>", "mc_field_kernel<true>"],
    "aniso_moments": ["aniso_moments_kernel"],
    "aniso_g": ["aniso_g_kernel"],
}


@pytest.mark.parametrize("entry", list(SURFACE_ENTRIES))
def test_surface_entry_launches(entry):
    """Each C entry of csrc/surface.cu launches its kernels and no other.
    The moments kernel writes its 11 rows and reads none of them back (no
    second pass reads the first one's sums from memory)."""
    text = re.sub(r"//[^\n]*", "", (CSRC / "surface.cu").read_text())
    body = re.search(rf'extern "C" int {entry}\(.*?\n}}', text,
                     re.S).group(0)
    launched = re.findall(r"\b([\w<>]+?)\s*<<<", body)
    assert sorted(launched) == sorted(SURFACE_ENTRIES[entry])
    if entry == "aniso_moments":
        kernel = re.search(r"\baniso_moments_kernel\(Geom g.*?\n}", text,
                           re.S).group(0)
        uses = re.findall(r"\bmom\[[^\]]*\]\s*(=?=?)", kernel)
        assert uses and set(uses) == {"="}, uses


# the __global__ functions of csrc/sweeps.cu that walk the step's list
LIST_WALKERS = [
    "k1_div_kernel", "k2_kappa_kernel", "k3_kappa_kernel", "k3_div_kernel",
    "k1_visc_init_kernel", "k1_vorticity_kernel", "k4_matvec_kernel",
    "k1_kappa_kernel", "k1_visc_acc_kernel",
]


def _bodies(text):
    """name -> body text of every function defined in a CUDA source."""
    out = {}
    for m in re.finditer(r"^(?:template <[^>]*>\s*)?(?:static )?"
                         r"(?:__global__|__device__)[^;{(]*?\b(\w+)\s*\(",
                         text, re.M):
        depth, k = 0, text.index("{", m.end())
        for n in range(k, len(text)):
            depth += {"{": 1, "}": -1}.get(text[n], 0)
            if depth == 0:
                out[m.group(1)] = text[k:n + 1]
                break
    return out


@pytest.mark.parametrize("kernel", LIST_WALKERS)
def test_list_walker_never_scans_the_cells(kernel):
    """The kernel's body, with the device functions it calls (transitively,
    those of sweeps.cu and common.cuh), calls for_each_listed and never
    the cell loop."""
    bodies = {**_bodies((CSRC / "common.cuh").read_text()),
              **_bodies((CSRC / "sweeps.cu").read_text())}
    seen, todo, text = set(), [kernel], ""
    while todo:
        name = todo.pop()
        if name in seen or name in ("for_each_listed", "for_each_neighbor",
                                    "for_each_neighbor_at"):
            continue
        seen.add(name)
        text += bodies[name]
        todo += [c for c in re.findall(r"\b(\w+)\s*[(<]", bodies[name])
                 if c in bodies]
    assert re.search(r"\bfor_each_listed(_record)?(<[^>]*>)?\s*\(", text)
    assert not re.search(r"\bfor_each_neighbor(_at)?\s*\(", text)


def _walk_depths(bodies, consts, name, depth=1):
    """The depths at which function ``name`` (its body in ``bodies``,
    called with the depth ``depth``) reaches the listed walk, following
    its calls: a call's template argument is the depth it passes (``D``
    forwards the caller's, a name is one of ``consts``), none the
    default 1."""
    out = set()
    for callee, arg in re.findall(r"\b(\w+)\s*(?:<\s*(\w+)\s*>)?\s*\(",
                                  bodies[name]):
        walk = callee in ("for_each_listed", "for_each_listed_record")
        if not walk and (callee not in bodies or callee == name):
            continue
        d = (1 if not arg else depth if arg == "D"
             else consts[arg] if arg in consts else int(arg))
        out |= {d} if walk else _walk_depths(bodies, consts, callee, d)
    return out


def test_one_listed_walk_with_a_depth():
    """common.cuh holds one loop over a row's listed slots,
    for_each_listed_record, with a compile-time depth D (1 by default;
    D > 1 loads D of the row's slots ahead of their sums), which
    for_each_listed forwards: no other function of the CUDA sources reads
    the list's slots (Geom.nl_idx)."""
    common = _bodies((CSRC / "common.cuh").read_text())
    for src in CUDA_SOURCES:
        readers = [n for n, b in _bodies((CSRC / src).read_text()).items()
                   if re.search(r"\bnl_idx\b", b)]
        assert readers == (["for_each_listed_record"]
                           if src == "common.cuh" else []), (src, readers)
    assert re.search(r"template <int D = 1, class F>\s*__device__ "
                     r"__forceinline__ void for_each_listed_record\(",
                     (CSRC / "common.cuh").read_text())
    assert re.search(r"\bfor_each_listed_record<D>\s*\(",
                     common["for_each_listed"])


# the emits that solver_sweeps.cu's listed sweep kernel runs (K5's IISPH
# three, K6's two, K7's two, and the unfused loops' entries: IISPH's two
# and the tension's two, each of its own)
LISTED_EMITS = ["IisphAdv", "IisphAii", "IisphForce", "SurfaceNormals",
                "TensionAccel", "IisphDij", "IisphS", "IisphDijFac",
                "IisphSFields", "SurfaceNormalsK1", "TensionAccelK1"]
# the walkers that walk the list at a depth above 1: the six K1 entries of
# the unfused loops (the unfused kappa and viscosity kernels of sweeps.cu;
# the emits of the unfused IISPH and tension entries, k1_iisph_dij,
# k1_iisph_s, k1_surface_normals and k1_tension_accel, in
# solver_sweeps.cu's listed sweep kernel)
DEEP_WALKERS = ["k1_kappa_kernel", "k1_visc_acc_kernel",
                "k5_list_kernel<IisphDijFac>", "k5_list_kernel<IisphSFields>",
                "k5_list_kernel<SurfaceNormalsK1>",
                "k5_list_kernel<TensionAccelK1>"]


def _emit_depth(text, consts, emit):
    """The walk depth that emit ``emit`` of ``text`` sets (its struct's, or
    for an alias its template's, ``static constexpr int kDepth``), or 1
    where it sets none."""
    alias = re.search(rf"^using {emit} = (\w+)<", text, re.M)
    name = alias.group(1) if alias else emit
    body = re.search(rf"^struct {name}\b[^{{;]*\{{.*?\n\}};", text,
                     re.S | re.M).group(0)
    depth = re.findall(r"static constexpr int kDepth = (\w+);", body)
    assert len(depth) <= 1, depth
    return (1 if not depth else consts[depth[0]] if depth[0] in consts
            else int(depth[0]))


@pytest.mark.parametrize("kernel", LIST_WALKERS + ["k5_list_kernel"] + [
    f"k5_list_kernel<{e}>" for e in LISTED_EMITS])
def test_listed_walk_depth(kernel):
    """The walker reaches the listed walk at one depth: above 1, a
    constant of its source (no switch), for DEEP_WALKERS; the default 1 for
    every other walker of sweeps.cu and every other emit of
    solver_sweeps.cu's listed sweep kernel, which walks at its emit's depth
    (``WalkDepth<E>``: the emit's kDepth, or 1 where it sets none; the
    kernel alone, ``k5_list_kernel``, at 1)."""
    listed = kernel.startswith("k5_list_kernel")
    text = (CSRC / ("solver_sweeps.cu" if listed else "sweeps.cu")).read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}
    bodies = {**_bodies((CSRC / "common.cuh").read_text()),
              **_bodies(text)}
    depth = 1
    if listed:
        assert re.search(r"\bconstexpr int D = WalkDepth<E>::value;",
                         bodies["k5_list_kernel"])
        assert re.search(r"struct WalkDepth<E, std::void_t<decltype\("
                         r"E::kDepth\)>> \{\s*static constexpr int value = "
                         r"E::kDepth;", text)
        if "<" in kernel:
            depth = _emit_depth(text, consts, kernel[len("k5_list_kernel<"):-1])
    depths = _walk_depths(bodies, consts, kernel.split("<")[0], depth)
    assert len(depths) == 1, depths
    assert (min(depths) > 1) == (kernel in DEEP_WALKERS), depths


def test_listed_emits_are_whole():
    """LISTED_EMITS lists every emit that an entry of solver_sweeps.cu hands
    to the listed sweep kernel."""
    text = (CSRC / "solver_sweeps.cu").read_text()
    launched = set(re.findall(r"\blaunch_list_sweep\(\s*&?\w+,\s*(\w+)\{",
                              text))
    assert launched == set(LISTED_EMITS)


# the K5 entries of the steps that build no list (SESPH, PCISPH; IISPH's
# density sweep builds it), with their emits: they cut, then sum
LISTLESS_K5 = {"k5_density_alpha": "DensityAlpha",
               "k5_sesph_force": "SesphForce"}
# the wrappers of engine.py whose solver_sweeps.cu kernels walk the list
LISTED_SOLVER_WRAPPERS = ["k5_iisph_adv", "k5_iisph_aii", "k5_iisph_force",
                          "k6_fused_tension", "k1_iisph_dij", "k1_iisph_s",
                          "k1_surface_normals", "k1_tension_accel"]
# the wrappers of engine.py whose sweeps.cu kernels walk the list
LISTED_WRAPPERS = ["k1_kappa_acc", "k1_visc_acc"]


def test_solver_walkers_never_scan_the_cells():
    """K7's two sweeps, IISPH's three K5 entries, both launches of K6 and
    the unfused loops' entries of those four sweeps run the listed sweep
    kernel, which walks the step's list, and K8's acceleration sweep walks
    the hits of its first sweep: none scans a candidate cell.  The unfused
    PCISPH prediction's cut cuts the cells' candidates at x* into register
    masks and keeps its hits, which its walk sums, scanning again only a
    row of more hits than their width.  K5's entries of the steps without
    a list launch the cut sweep kernel, which cuts the cells' candidates
    into register masks before it sums (for_each_neighbor_masked) and
    never runs the single cell loop; no single-loop sweep kernel is
    left.
    Each listed wrapper (those of sweeps.cu's unfused entries too) asks
    ``_geom`` for the list (``listed=True``), so that on the card it raises
    where the grid has none."""
    text = (CSRC / "solver_sweeps.cu").read_text()
    bodies = _bodies(text)

    def entry(name):
        return re.search(rf'extern "C" int {name}\(.*?\n}}', text,
                         re.S).group(0)

    def launched(name):
        return re.findall(r"\blaunch_(\w*)sweep\(\s*&?\w+, (\w+)\{",
                          entry(name))

    assert launched("k7_fused_jacobi_iter") == [
        ("list_", "IisphDij"), ("list_", "IisphS")]
    assert launched("k5_iisph_adv") == [("list_", "IisphAdv")]
    assert launched("k5_iisph_aii") == [("list_", "IisphAii")]
    assert launched("k5_iisph_force") == [("list_", "IisphForce")]
    assert launched("k6_fused_tension") == [
        ("list_", "SurfaceNormals"), ("list_", "TensionAccel")]
    # ... at depth 1: the unfused entries walk emits of their own
    consts = {k: int(v) for k, v in
              re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}
    for emit in ("SurfaceNormals", "TensionAccel"):
        assert _emit_depth(text, consts, emit) == 1, emit
    # K1's emits of the unfused loops: the same list sweeps alone; dij's
    # after a pack of its walk's own records (x, y, z, fac), which it walks
    # in place of the list's; the tension's after a pack of its neighbours'
    # rows (n, rho)
    assert launched("k1_iisph_dij") == [("list_", "IisphDijFac")]
    assert launched("k1_iisph_s") == [("list_", "IisphSFields")]
    body = entry("k1_iisph_dij")
    assert re.findall(r"\b(\w+)<<<", body) == ["k1_fac_records_kernel"]
    assert (body.index("k1_fac_records_kernel")
            < body.index("nl_rec = ") < body.index("launch_list_sweep"))
    assert not re.search(r"<<<", entry("k1_iisph_s"))
    assert launched("k1_surface_normals") == [("list_", "SurfaceNormalsK1")]
    assert launched("k1_tension_accel") == [("list_", "TensionAccelK1")]
    assert not re.search(r"<<<", entry("k1_surface_normals"))
    body = entry("k1_tension_accel")
    assert re.findall(r"\b(\w+)<<<", body) == ["k1_tension_rows_kernel"]
    assert (body.index("k1_tension_rows_kernel")
            < body.index("launch_list_sweep"))
    # the unfused PCISPH prediction cuts the cells' candidates at x* into
    # register masks (no list holds the pairs at x*) and keeps its hits;
    # its walk sums them, and scans the cells again (into register masks)
    # only for a row of more hits than their width
    assert re.search(r"\bk1_pcisph_predict_kernel<<<",
                     entry("k1_pcisph_predict"))
    assert re.search(r"\bk1_pcisph_walk_kernel<<<", entry("k1_pcisph_walk"))
    for kernel in ("k1_pcisph_predict_kernel", "k1_pcisph_walk_kernel"):
        assert re.search(r"\bfor_each_neighbor_masked\s*\(", bodies[kernel])
        assert not re.search(r"\bfor_each_neighbor\s*\(", bodies[kernel])
    assert re.search(r"\bhits\[k \* M \+ i\] = j;",
                     bodies["k1_pcisph_predict_kernel"])
    walk = bodies["k1_pcisph_walk_kernel"]
    assert walk.index("n <= width") < walk.index("for_each_neighbor_masked")
    for name, emit in LISTLESS_K5.items():
        assert launched(name) == [("cut_", emit)], name
    launch = re.search(r"static int launch_cut_sweep\(.*?\n}", text,
                       re.S).group(0)
    assert re.search(r"\bk5_cut_kernel<E><<<", launch)
    assert re.search(r"\bfor_each_neighbor_masked\s*\(",
                     bodies["k5_cut_kernel"])
    assert not re.search(r"\bfor_each_neighbor\s*\(",
                         bodies["k5_cut_kernel"])
    assert "k5_sweep_kernel" not in bodies
    launch = re.search(r"static int launch_list_sweep\(.*?\n}", text,
                       re.S).group(0)
    assert re.search(r"\bk5_list_kernel<E><<<", launch)
    assert re.search(r"\bfor_each_listed(_record)?(<[^>]*>)?\s*\(",
                     bodies["k5_list_kernel"])
    assert re.search(r"\bk8_acc_kernel<<<", entry("k8_fused_pcisph_iter"))
    for walker in ("k5_list_kernel", "k8_acc_kernel"):
        assert not re.search(r"\bfor_each_neighbor\w*\s*\(|\.start\[",
                             bodies[walker]), walker
    # TensionAccel takes the neighbour's position from the walk's record
    # (in its pair, tension_pair, which the unfused entry's emit shares)
    tension = re.search(r"struct TensionAccel \{.*?\n\};", text,
                        re.S).group(0)
    assert re.search(r"\btension_pair\(", tension)
    assert re.search(r"\brj\.x\b", bodies["tension_pair"])
    assert not re.search(r"\bg\.pos\[", tension + bodies["tension_pair"])

    tree = ast.parse((ROOT / "wcsph_tpu_torch" / "engine.py").read_text())
    wrappers = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def asks_for_the_list(name):
        return any(k.arg == "listed" and isinstance(k.value, ast.Constant)
                   and k.value.value is True
                   for c in ast.walk(wrappers[name])
                   if isinstance(c, ast.Call) for k in c.keywords)

    for name in LISTED_SOLVER_WRAPPERS + LISTED_WRAPPERS:
        assert asks_for_the_list(name), name
    for name in [*LISTLESS_K5, "k1_pcisph_predict", "k1_pcisph_walk"]:
        assert not asks_for_the_list(name), name
