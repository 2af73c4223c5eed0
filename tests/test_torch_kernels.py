"""The port's small host and tensor functions against the JAX package's,
function by function (wcsph_tpu_torch, CPU): the smoothing kernels of
kernels.py, the symmetric 3x3 helpers of utils/mat3.py, the boundary
volume scale, PCISPH's stiffness coefficient and the solvers' default
configs.

Inputs come from numpy with a fixed seed and go through both.  The kernels
are held at rtol 1e-5 of max|ref| (float32 on both sides; the port writes
cubes as products and the fourth root as two square roots, the arithmetic
of its CUDA kernels), mat3 at rtol 1e-5, the boundary scale at rel 2e-5,
the host numbers exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = wt = None   # bound by _port

H = 0.1   # support radius of the default particle radius 0.025


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt
    import torch
    import wcsph_tpu_torch as wt
    torch.set_num_threads(1)


def _distances():
    """Distances on both sides of every branch: 0, below eps, the inner
    and outer halves, h/2 and h themselves, and beyond h."""
    rng = np.random.RandomState(3)
    d = np.concatenate([[0.0, 5e-6, 0.5 * H, H, 1.5 * H],
                        rng.uniform(0.0, 1.2 * H, 251)])
    return d.astype(np.float32)


def _close(got, ref, rtol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0.0
    assert float(np.abs(got - ref).max()) <= rtol * scale


@pytest.mark.parametrize("name", ["cubic_w_scalar", "cubic_grad_scale",
                                  "cohesion_w_scalar", "adhesion_w_scalar"])
def test_scalar_kernel_matches_jax(name):
    import jax.numpy as jnp
    from wcsph_tpu import kernels as jk
    from wcsph_tpu_torch import kernels as tk

    d = _distances()
    ref = np.asarray(getattr(jk, name)(jnp.asarray(d), H))
    got = getattr(tk, name)(torch.as_tensor(d), H).numpy()
    _close(got, ref)
    # both branches and the cut are exercised
    assert (ref[d > H] == 0.0).all() and (got[d > H] == 0.0).all()
    assert np.count_nonzero(ref[d <= 0.5 * H]) or name == "adhesion_w_scalar"
    assert np.count_nonzero(ref[(d > 0.5 * H) & (d < H)])


@pytest.mark.parametrize("name", ["cohesion_w", "adhesion_w"])
def test_vector_kernel_matches_jax(name):
    import jax.numpy as jnp
    from wcsph_tpu import kernels as jk
    from wcsph_tpu_torch import kernels as tk

    rng = np.random.RandomState(4)
    r = (0.5 * H * rng.randn(200, 3)).astype(np.float32)
    ref = np.asarray(getattr(jk, name)(jnp.asarray(r), H))
    _close(getattr(tk, name)(torch.as_tensor(r), H).numpy(), ref)


def test_cubic_w_q_and_w0_match_jax():
    import jax.numpy as jnp
    from wcsph_tpu import kernels as jk
    from wcsph_tpu_torch import kernels as tk

    q = (_distances() / np.float32(H)).astype(np.float32)
    _close(tk.cubic_w_q(torch.as_tensor(q), H).numpy(),
           np.asarray(jk.cubic_w_q(jnp.asarray(q), H)))
    assert tk.cubic_w0(H) == jk.cubic_w0(H)
    assert tk.cubic_w0(H) == pytest.approx(
        float(tk.cubic_w_scalar(torch.zeros(1), H)[0]), rel=1e-6)


def _sym3_fields(seed, n=64):
    """Six (n,) fields of well-conditioned symmetric matrices, the last
    two rows singular (all zero, and rank one)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 3, 3).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    m[-2] = 0.0
    m[-1] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])
    return [m[:, i, j].copy() for i, j in
            ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]


@pytest.mark.parametrize("fn", ["sym3_inverse", "sym3_identity_minus",
                                "matvec"])
def test_sym3_matches_jax(fn):
    import jax.numpy as jnp
    from wcsph_tpu.utils import mat3 as jm
    from wcsph_tpu_torch.utils import mat3 as tm

    f = _sym3_fields(6)
    mj = jm.Sym3(*(jnp.asarray(x) for x in f))
    mt = tm.Sym3(*(torch.as_tensor(x) for x in f))
    rng = np.random.RandomState(7)
    if fn == "matvec":
        v = rng.randn(3, len(f[0])).astype(np.float32)
        _close(mt.matvec(torch.as_tensor(v)).numpy(),
               np.asarray(mj.matvec(jnp.asarray(v))))
        return
    if fn == "sym3_inverse":
        outj, outt = jm.sym3_inverse(mj), tm.sym3_inverse(mt)
        # the singular rows fall back to the identity on both sides
        assert [float(c[-2]) for c in outt] == [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
        assert [float(c[-1]) for c in outt] == [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    else:
        s = rng.rand(len(f[0])).astype(np.float32)
        outj = jm.sym3_identity_minus(mj, jnp.asarray(s))
        outt = tm.sym3_identity_minus(mt, torch.as_tensor(s))
    for cj, ct in zip(outj, outt):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("radius", [0.025, 0.02, 0.01])
def test_pci_coefficient_matches_jax(radius):
    from wcsph_tpu.solvers import pcisph as jp
    from wcsph_tpu_torch.solvers import pcisph as tp

    assert tp.pci_coefficient(radius) == jp.pci_coefficient(radius)
    assert tp.pci_coefficient(radius) > 0.0


@pytest.mark.parametrize("solver", ["dfsph", "sesph", "pcisph", "iisph"])
def test_default_config_matches_jax(solver):
    """Each solver's defaults, and an override on top of them."""
    from wcsph_tpu.simulation import default_config, get_solver

    over = dict(particle_radius=0.02, viscosity=3.0)
    for kw in ({}, over):
        assert dataclasses.asdict(wt.default_config(solver, **kw)) == \
            dataclasses.asdict(default_config(solver, **kw))
    assert wt.get_solver(solver).__name__.endswith(solver)
    assert get_solver(solver).__name__.endswith(solver)


@pytest.mark.parametrize("pitch,layers,clamped", [
    (1.2, 1, False), (1.4, 2, False), (2.0, 1, True)],
    ids=["dense-1-layer", "dense-2-layers", "sparse-clamped"])
def test_boundary_volume_scale_matches_jax(pitch, layers, clamped):
    """akinci_solid_volume_scale of a box shell at a pitch of ``pitch``
    radii: the port's pair-list sum against the JAX package's window sweep,
    rel 2e-5 (a median of float32 sums taken in two orders).  The dense
    shells land between the clamps, so the sum decides; the shell at the
    liquid's own pitch sits at the upper clamp on both sides."""
    import jax.numpy as jnp
    from wcsph_tpu import boundary as jb
    from wcsph_tpu.config import SimConfig
    from wcsph_tpu_torch import boundary as tb

    r = 0.025
    b = wt.scene.SceneBuilder()
    b.add_liquid_block((2, 2, 2), 2 * r)
    b.add_box_shell(0.4, pitch * r, layers=layers)
    sc = b.build()
    lo, hi = sc.domain(pad=4 * r)
    cfg = SimConfig(particle_radius=r, domain_min=lo, domain_max=hi)
    solid = sc.positions[sc.n_liquid:].T.copy()
    ref = jb.akinci_solid_volume_scale(jnp.asarray(solid), cfg)
    got = tb.akinci_solid_volume_scale(
        torch.as_tensor(solid), wt.config_from_dict(dataclasses.asdict(cfg)))
    assert (ref == 3.0) if clamped else (0.75 < ref < 3.0)
    assert got == pytest.approx(ref, rel=2e-5)
