"""The port's source files, read as text (wcsph_tpu_torch, chip_smoke.py).

No file of the port imports ``jax``, ``flax`` or the JAX package
``wcsph_tpu``: the machine with the card has none of them.  One case per
source file; nothing is imported here, so a worker that runs only these
cases loads no torch.  (The same rule in a live interpreter:
tests/test_torch_package.py::test_port_imports_no_jax.)

The sweeps that run after a step's neighbour list is built walk that list
and have no cell-loop form: one case per list-walking ``__global__`` of
csrc/sweeps.cu, read with the device functions it calls.
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
    "wcsph_tpu_torch/grid.py",
    "wcsph_tpu_torch/kernels.py",
    "wcsph_tpu_torch/ops.py",
    "wcsph_tpu_torch/profile_paths.py",
    "wcsph_tpu_torch/scene.py",
    "wcsph_tpu_torch/simulation.py",
    "wcsph_tpu_torch/solvers/__init__.py",
    "wcsph_tpu_torch/solvers/common.py",
    "wcsph_tpu_torch/solvers/dfsph.py",
    "wcsph_tpu_torch/solvers/iisph.py",
    "wcsph_tpu_torch/solvers/pcisph.py",
    "wcsph_tpu_torch/solvers/sesph.py",
    "wcsph_tpu_torch/state.py",
    "wcsph_tpu_torch/utils/__init__.py",
    "wcsph_tpu_torch/utils/mat3.py",
    "wcsph_tpu_torch/utils/objio.py",
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
    # an __init__ may hold relative imports only
    assert seen or source.endswith("__init__.py")


CSRC = ROOT / "wcsph_tpu_torch" / "csrc"
# the __global__ functions of csrc/sweeps.cu that walk the step's list
LIST_WALKERS = [
    "k1_div_kernel", "k2_kappa_kernel", "k3_kappa_kernel", "k3_div_kernel",
    "k1_vorticity_kernel", "k4_matvec_kernel",
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
    assert re.search(r"\bfor_each_listed\s*\(", text)
    assert not re.search(r"\bfor_each_neighbor(_at)?\s*\(", text)
