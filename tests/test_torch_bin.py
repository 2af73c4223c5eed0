"""The step's grid stage and its kept list buffer (wcsph_tpu_torch, CPU
plain versions).

On the card the bin, pack, unpack and the list's slice offsets are kernels
(csrc/bin.cu); these cases hold their plain twins, which chip_smoke.py
holds the kernels to bit for bit:

* the bin gives the JAX package's stable argsort (``wcsph_tpu.grid.
  build_grid``'s cells and their particles, in order) on a scene with a
  liquid and a boundary particle outside the domain, whose rows come last
  and are inert (no cell, no pair, liquid flag 0, finite sweep outputs);
* pack then unpack gives the fields back, and the liquid particle outside
  the domain keeps its defaults; the packed fields and the unpacked ones
  are each row views of one block, and the packed equal the JAX package's
  pack (``wcsph_tpu.grid.pack_liquid_many``, one stacked gather);
* the list honours a slot capacity: clamped offsets, the need and the
  flag, raised at the step's first read (``Grid.read``), which also brings
  the liquid count; the offsets written into a kept ``ListSlots`` are its
  kept tensors, overwritten by each call, and equal a fresh call's;
* a DFSPH, PCISPH or IISPH step whose buffer is forced too small runs
  once more and gives the bits of the unforced step; ``Simulation`` keeps
  the buffer;
* K8's plain twin keeps at most its buffer's width of hits a row, flags a
  row with more, and otherwise gives the bits of the twin that keeps every
  hit.
"""

import dataclasses

import numpy as np
import pytest

torch = wt = dense_ops = engine = grid_mod = None   # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when this module's first test runs, not
    at collection: pytest-xdist collects every test module in every
    worker, and a worker that runs only the JAX package's tests then
    never loads torch beside XLA."""
    global torch, wt, dense_ops, engine, grid_mod
    import torch
    import wcsph_tpu_torch as wt
    from wcsph_tpu_torch import dense_ops, engine, grid as grid_mod
    torch.set_num_threads(1)


R = 0.025


def _scene(side=6, squeeze=0.92):
    """A squeezed dam break (numpy only) with liquid particle 0 past the
    domain's top corner and the last boundary particle below its floor:
    (scene, cfg with cell capacity 64, planar positions)."""
    sc = wt.dam_break(particle_radius=R, fluid_dims=(side,) * 3,
                      box_extent=side * 2 * R * 1.35)
    liq = sc.positions[: sc.n_liquid]
    centre = liq.mean(axis=0, keepdims=True)
    sc.positions[: sc.n_liquid] = centre + (liq - centre) * squeeze
    lo, hi = sc.domain(pad=4 * R)
    cfg = wt.default_config("dfsph", particle_radius=R, domain_min=lo,
                            domain_max=hi, cell_capacity=64)
    pos = sc.positions.T.astype(np.float32).copy()
    pos[:, 0] = np.asarray(hi, np.float32) + 0.3
    pos[1, -1] = np.float32(lo[1]) - 0.2
    return sc, cfg, pos


@pytest.fixture(scope="module")
def case(_port):
    sc, cfg, pos = _scene()
    g = grid_mod.build_grid(torch.as_tensor(pos), sc.n_liquid, cfg)
    return sc, cfg, pos, g


def test_bin_is_the_jax_stable_argsort(case):
    import jax.numpy as jnp

    from wcsph_tpu.config import SimConfig as JaxConfig
    from wcsph_tpu.grid import build_grid, cell_of_positions

    sc, cfg, pos, g = case
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jg = build_grid(jnp.asarray(pos), sc.n_liquid, jcfg)
    assert int(jg.overflow) == 0
    pid = np.asarray(jg.pid)                  # (capacity, cells)
    k, c = np.nonzero(pid >= 0)
    start = g.cell_start.numpy().astype(np.int64)
    order = g.order.numpy()
    # each cell's particles, in particle order, from its offset
    np.testing.assert_array_equal(np.diff(start), (pid >= 0).sum(0))
    np.testing.assert_array_equal(order[start[c] + k], pid[k, c])
    np.testing.assert_array_equal(
        g.liquid.numpy()[start[c] + k], np.asarray(jg.liquid)[k, c])
    # then the particles outside the domain, in particle order
    _, inbox = cell_of_positions(jnp.asarray(pos), jcfg)
    outside = np.nonzero(~np.asarray(inbox))[0]
    np.testing.assert_array_equal(outside, [0, sc.n_total - 1])
    m_in = int(start[-1])
    assert m_in == sc.n_total - 2 == g.n - 2
    np.testing.assert_array_equal(order[m_in:], outside)
    np.testing.assert_array_equal(np.sort(order), np.arange(sc.n_total))
    # every row's cell, position, flags; each particle's row
    np.testing.assert_array_equal(g.cell.numpy()[start[c] + k], c)
    np.testing.assert_array_equal(g.pos.numpy(), pos[:, order])
    row_of = g.row_of.numpy()
    np.testing.assert_array_equal(row_of[order[:m_in]], np.arange(m_in))
    np.testing.assert_array_equal(row_of[outside], -1)
    assert int(g.n_liquid) == int(np.asarray(jg.liquid).sum()) \
        == sc.n_liquid - 1
    assert torch.equal(g.liq, g.liquid.float())

    # the rows outside the domain are inert
    assert not bool(g.liquid[m_in:].any())
    assert bool((g.cell[m_in:] == grid_mod.outside_cell(cfg)).all())
    # in no cell's range, and their own window holds no cell: no pair
    p = dense_ops.pairs_of(g)
    assert int(p.i.shape[0]) > 10 * m_in
    assert bool((p.i < m_in).all()) and bool((p.j < m_in).all())
    # the sweeps that receive at every row give them finite values
    vel = torch.zeros((3, g.n))
    out = dense_ops.density_alpha_drho(g, vel)
    assert bool(torch.isfinite(out).all())
    assert bool((out[:, m_in:] == 0).all())
    # they take no slots of the list
    count = out[1].to(torch.int32)
    nl = dense_ops.neighbor_list(g, count)
    walked = dense_ops.list_pairs(g, nl)
    assert int(walked.i.shape[0]) == int(count[g.liquid].sum())
    assert bool((walked.i < m_in).all())


def test_pack_then_unpack_gives_the_fields_back(case):
    sc, cfg, pos, g = case
    nl = sc.n_liquid
    rng = np.random.RandomState(0)
    fields = [torch.as_tensor(rng.randn(3, nl).astype(np.float32)),
              torch.as_tensor(rng.randn(nl).astype(np.float32))]
    packed = grid_mod.pack(g, fields)
    assert [p.shape for p in packed] == [(3, g.n), (g.n,)]
    for x, p in zip(fields, packed):
        want = torch.zeros_like(p)
        rows = torch.nonzero(g.liquid).flatten()
        want[..., rows] = x[..., g.order[rows]]
        assert torch.equal(p, want)
    # row views, in order, of one (4, M) block
    block = packed[0]._base
    assert block is not None and block.shape == (4, g.n)
    assert packed[1]._base is block and packed[1].is_contiguous()
    assert packed[0].data_ptr() == block.data_ptr()
    assert packed[1].data_ptr() == block[3].data_ptr()
    # the JAX package's pack, in its (C, NC) layout: slot (k, c) is row
    # cell_start[c] + k here; the rows outside the domain hold 0
    import jax.numpy as jnp

    from wcsph_tpu.config import SimConfig as JaxConfig
    from wcsph_tpu.grid import build_grid, pack_liquid_many

    jg = build_grid(jnp.asarray(pos), nl, JaxConfig(**dataclasses.asdict(cfg)))
    jpacked = pack_liquid_many(jg, [jnp.asarray(x.numpy()) for x in fields])
    k, c = np.nonzero(np.asarray(jg.pid) >= 0)
    start = g.cell_start.numpy()
    m_in = int(start[-1])
    for p, jp in zip(packed, jpacked):
        np.testing.assert_array_equal(p.numpy()[..., start[c] + k],
                                      np.asarray(jp)[..., k, c])
        assert bool((p[..., m_in:] == 0).all())
    defaults = [torch.full_like(x, 7.0) for x in fields]
    back = grid_mod.unpack(g, packed, defaults)
    for x, y in zip(fields, back):
        assert torch.equal(y[..., 1:], x[..., 1:])
        assert bool((y[..., 0] == 7.0).all())   # outside: its default
    # row views, in order, of one (4, N_L) block
    block = back[0]._base
    assert block is not None and block.shape == (4, nl)
    assert back[1]._base is block and back[1].is_contiguous()
    assert back[0].data_ptr() == block.data_ptr()
    assert back[1].data_ptr() == block[3].data_ptr()


def test_list_honours_its_capacity(case):
    sc, cfg, pos, g = case
    vel = torch.zeros((3, g.n))
    count = dense_ops.density_alpha_drho(g, vel)[1].to(torch.int32)
    full = dense_ops.neighbor_list(g, count)
    need = int(full.need)
    assert need == int(full.off[-1]) == full.capacity
    off, need_t = dense_ops.list_offsets(count, g.liquid, 4 * 32)
    assert int(need_t) == need and int(off.max()) == 4 * 32
    assert torch.equal(off, torch.clamp(full.off, max=4 * 32))
    # into a kept ListSlots (a step's form): two calls of different counts
    # write the same kept tensors, each equal to a fresh call's
    kept = grid_mod.ListSlots(capacity=need)
    more = torch.where(g.liquid, count + 3, count)
    held = engine.nbr_list_offsets(count, g.liquid, kept.capacity, kept)
    assert held[0] is kept.offsets(g.n, g.device)[0]
    assert torch.equal(held[0], full.off) and int(held[1]) == need
    for cnt in (more, count):
        want_off, want_need = dense_ops.list_offsets(cnt, g.liquid,
                                                     kept.capacity)
        got = engine.nbr_list_offsets(cnt, g.liquid, kept.capacity, kept)
        assert got[0] is held[0] and got[1] is held[1]
        assert torch.equal(got[0], want_off)
        assert int(got[1]) == int(want_need)
        if cnt is more:      # the first result now holds the second's
            assert int(held[1]) > need
            assert int(held[0][-1]) == kept.capacity
    # a list filled into kept slots carries the kept offsets
    assert dense_ops.neighbor_list(g, count, kept).off is held[0]
    assert torch.equal(held[0], full.off)
    # a short buffer: clamped, flagged, and no slot past it is walked
    slots = grid_mod.ListSlots(capacity=need // 2)
    short = dense_ops.neighbor_list(g, count, slots)
    assert short.capacity == slots.capacity < need
    assert int(short.off[-1]) == slots.capacity and int(short.flag) == 1
    walked = dense_ops.list_pairs(g, short)
    assert 0 < int(walked.i.shape[0]) < int(count[g.liquid].sum())
    # the grid's first read brings the count and raises on the short list
    g.nbr = short
    with pytest.raises(grid_mod.ListOverflow) as err:
        g.read(torch.tensor(2.5))
    assert err.value.need == need
    assert g.liquid_count == sc.n_liquid - 1
    assert g.read(torch.tensor(3.5)) == 3.5     # checked once
    g.nbr, g.n_liquid_read = full, None
    assert g.read(torch.tensor(0.25)) == 0.25 and full.checked
    g.nbr = None


def _pressurized_state(solver):
    sc, cfg, pos = _scene(side=6)
    cfg = wt.default_config(solver, **{
        k: getattr(cfg, k) for k in ("particle_radius", "domain_min",
                                     "domain_max")})
    sim = wt.Simulation(sc, cfg, solver=solver, device="cpu")
    liq = sc.positions[: sc.n_liquid]
    vel = (-10.0 * (liq - liq.mean(0, keepdims=True))).T.astype(np.float32)
    return sim, sim.state.replace(pos=torch.as_tensor(pos),
                                  vel=torch.as_tensor(vel))


def test_k8_twin_flags_a_row_over_its_width(case):
    """K8's hits at x*: the twin with a buffer of exactly the widest row's
    hits gives the bits of the twin that keeps every hit, and its hits; one
    of half that width flags the widest row, keeps adv, p and the error sum
    and the acceleration of every row within the width, and raises at the
    grid's next read."""
    sc, cfg, pos, g0 = case
    m = g0.n
    rng = np.random.RandomState(5)
    liq = sc.positions[: sc.n_liquid]
    vel = grid_mod.pack(g0, [torch.as_tensor(
        (-10.0 * (liq - liq.mean(0, keepdims=True))).T.astype(np.float32))])[0]
    p0 = torch.as_tensor(rng.rand(m).astype(np.float32) * 1e3) * g0.liq
    dt, factor = np.float32(1e-3), np.float32(1e5)

    def run(slots):
        g = dataclasses.replace(g0, nbr=None, star=None, n_liquid_read=None)
        p = p0.clone()
        return g, p, dense_ops.fused_pcisph_iter(g, vel, p, dt, factor, slots)

    g, p, (adv, acc, err) = run(None)
    full = g.star
    width = full.width
    assert int(full.over) == 0 and width > 4
    assert int(full.count.max()) == width and int(full.count.sum()) > 10 * m
    g, pw, out = run(grid_mod.ListSlots(width * m))
    assert g.star.width == width and int(g.star.over) == 0
    assert torch.equal(g.star.count, full.count)
    assert torch.equal(g.star.idx[: width * m], full.idx)
    for a, b in zip((pw, *out), (p, adv, acc, err)):
        assert torch.equal(a, b)
    g, ps, (adv_s, acc_s, err_s) = run(grid_mod.ListSlots(width // 2 * m))
    short = g.star
    assert short.width == width // 2 and int(short.over) == width
    assert torch.equal(short.count, torch.clamp(full.count, max=width // 2))
    fits = full.count <= width // 2
    assert 0 < int(fits.sum()) < m and not bool(fits.all())
    assert torch.equal(acc_s[:, fits], acc[:, fits])
    assert not torch.equal(acc_s, acc)
    assert torch.equal(ps, p) and torch.equal(adv_s, adv)
    assert torch.equal(err_s, err)
    with pytest.raises(grid_mod.ListOverflow) as e:
        g.read(err_s)
    assert e.value.need == width * m
    assert g.read(err_s) == float(err_s)      # checked once


def test_a_short_buffer_replays_to_the_same_bits():
    """DFSPH, PCISPH (K8's hits) and IISPH: a step whose buffer holds 64
    slots replays once and gives the unforced step's bits; Simulation keeps
    its buffer."""
    from wcsph_tpu_torch.simulation import get_solver

    for solver in ("dfsph", "pcisph", "iisph"):
        sim, state = _pressurized_state(solver)
        step = get_solver(solver).step
        engine.reset_launch_counts()
        want = step(state, sim.cfg)
        assert engine.LIST_REPLAYS == 0
        slots = grid_mod.ListSlots(capacity=64)
        got = step(state, sim.cfg, slots)
        assert engine.LIST_REPLAYS == 1, solver
        assert slots.capacity > 64
        for f in ("pos", "vel", "omega", "vel_guess", "pressure", "kappa",
                  "kappa_v"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (solver,
                                                                   f)
        assert float(got.dt) == float(want.dt)
        assert (dataclasses.astuple(got.diag)
                == dataclasses.astuple(want.diag))
        assert got.diag.pressure_iters > 0
        # the liquid particle outside the domain kept its velocity
        assert torch.equal(got.vel[:, 0], state.vel[:, 0])

    sim.state = state
    engine.reset_launch_counts()
    sim.step()
    slots = sim.list_slots
    cap = slots.capacity
    assert cap % grid_mod.SLICE == 0 and cap > 0
    sim.step()
    assert sim.list_slots is slots and slots.capacity == cap
    assert engine.LIST_REPLAYS == 0
    sim.check_health()
