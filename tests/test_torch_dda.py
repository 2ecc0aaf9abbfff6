"""K4's host side (ops/dda.py) against the JAX package's, and its plain
version against the JAX kernel run in the Pallas interpreter and against
K2's plain version, on tests/test_dda.py's five cases.

Tolerances:
- the grid (part A, perm_a, the overflow table, K, nb, lo, cell, the
  local eps and counts, and the cell table against the JAX bf16x3 split's
  sum): exact;
- against the JAX kernel: hit/miss identical, and the winner ids but for
  a few rays where a 1e5 wall is one of the two (1 of 2048 on
  procedural800 from inside: the light at t 59.8217, a wall at 59.8316 in
  float64, which the port's float32 wall test puts at 59.8203); t under
  the bar tests/test_torch_closest_hit.py holds K2 to across the
  packages on the small spheres (16 ulp of the scale plus the
  direct quadratic's conditioning), the median |dt| / max(t, 1) below
  1e-6, and where a 1e5 wall wins, the hit point on the wall to 2 ulp of
  the scale. tests/test_dda.py's rtol 1e-5 holds between the JAX
  package's two kernels, not across the packages: on procedural800 from
  inside, 563 of 2048 rays differ beyond it, the wall hits by up to 3.0e-3
  relative and the small spheres by up to 4.5e-5, with JAX's jit disabled
  too — XLA:CPU's arithmetic on the same (ray, sphere) pair, the
  difference K2's parity test already carries (ROADMAP.md, F3). From
  outside, 7 rays that graze a wall differ by more than 5e-3 in t (0.642
  against 0.879, 0.787 in float64) while both packages' hit points lie
  within 1.1 ulp of the wall's scale of its surface;
- against K2's plain version (ops/intersect_pallas.py): t bit-equal on
  every ray and the winner ids equal on every hit: both sweep part A in
  the stable form and the local spheres in the direct quadratic, op for
  op, and the grid only changes which pairs are tested;
- normals and uv against the JAX package's where t is bit-equal: 2 ulp of
  1.0 (measured: 1 ulp at most, procedural800 from inside).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import dda as jdda
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.ops import dda
from smallpt_tpu_torch.ops import intersect_pallas as tip

BIG = 3.0e38


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed, inside=True):
    """tests/test_dda.py::_rays."""
    rng = np.random.default_rng(seed)
    if inside:
        org = rng.uniform([5, 5, 20], [95, 75, 150], (n, 3))
    else:
        org = rng.uniform([-40, -40, 170], [140, 120, 320], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _axis_rays(lo):
    """tests/test_dda.py::test_axis_aligned_and_boundary_rays's rays:
    origins on the grid's corner and on its x face, axis directions."""
    rng = np.random.default_rng(4)
    n = 1024
    org = rng.uniform([5, 5, 20], [95, 75, 150], (n, 3))
    org[:64] = np.asarray(lo)
    org[64:128, 0] = lo[0]
    d = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))
    return org.astype(np.float32), d.astype(np.float32)


# name -> (sphere count or None for the Cornell box, grid arguments, rays)
_CASES = {
    "procedural800_inside": (800, dict(occ_target=16.0),
                             lambda lo: _rays(2048, 1, inside=True)),
    "procedural800_outside": (800, dict(occ_target=16.0),
                              lambda lo: _rays(2048, 1, inside=False)),
    "cornell_occ4": (None, dict(occ_target=4.0), lambda lo: _rays(1024, 2)),
    "overflow_nb222_k48": (600, dict(nb=(2, 2, 2), k_max=48),
                           lambda lo: _rays(1024, 3)),
    "axis_aligned_boundary": (400, dict(occ_target=16.0), _axis_rays),
}
_CACHE = {}


def _case(name):
    """(JAX scene, port scene, JAX grid, port grid, org, dirs, JAX hit)."""
    if name not in _CACHE:
        n, kw, rays = _CASES[name]
        if n is None:
            js, ts = jscene.cornell_box_scene(), tscene.cornell_box_scene()
        else:
            js = jscene.procedural_sphere_scene(n)
            ts = tscene.procedural_sphere_scene(n)
        jg = jdda.build_dda_grid(js, **kw)
        tg = dda.build_dda_grid(ts, device="cpu", **kw)
        o, d = rays(jg.lo)
        hj = jdda.intersect_spheres_dda(jnp.asarray(o), jnp.asarray(d), js,
                                        jg, want_uv=True)
        _CACHE[name] = (js, ts, jg, tg, o, d,
                        tuple(np.asarray(x) for x in hj))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(_CASES))
def test_grid_equals_jax(name):
    js, ts, jg, tg, *_ = _case(name)
    assert (tg.k, tg.nb, tg.lo, tg.cell) == (jg.k, jg.nb, jg.lo, jg.cell)
    assert (tg.eps_local, tg.n_local, tg.n_overflow) == (
        jg.eps_local, jg.n_local, jg.n_overflow)
    np.testing.assert_array_equal(tg.part_a.numpy(), np.asarray(jg.part_a))
    np.testing.assert_array_equal(tg.perm_a.numpy(), np.asarray(jg.perm_a))
    np.testing.assert_array_equal(tg.overflow.numpy(),
                                  np.asarray(jg.overflow))
    v = np.asarray(jg.cells3)
    want = (v[0] + v[1] + v[2]).reshape(5, jg.k, jg.n_cells)
    np.testing.assert_array_equal(tg.cells[..., :5].permute(2, 1, 0).numpy(),
                                  want)
    assert not tg.cells[..., 5:].any()
    if name.startswith("overflow"):
        assert tg.n_overflow > 0


def _ulp_scale(o, c, r):
    scale = np.linalg.norm(c.astype(np.float64) - o, axis=-1) + r
    return np.spacing(scale.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("name", list(_CASES))
def test_intersect_matches_jax_kernel(name):
    js, ts, jg, tg, o, d, (t_j, inst_j, _, _, n_j, uv_j) = _case(name)
    launches = dda.closest_hit_dda.launches
    h = dda.intersect_spheres_dda(torch.from_numpy(o), torch.from_numpy(d),
                                  ts, tg, want_uv=True)
    assert dda.closest_hit_dda.launches == launches  # the CPU: plain
    t_p, inst_p = h.t.numpy(), h.inst.numpy()
    hit = np.isfinite(t_j)
    np.testing.assert_array_equal(hit, np.isfinite(t_p))
    c, r = ts.center.numpy(), ts.radius.numpy()
    # a winner may move only where a 1e5 wall is one of the two, as K2's
    # winners move across the packages
    moved = hit & (inst_j != inst_p)
    assert ((r[inst_j] >= 1e4) | (r[inst_p] >= 1e4))[moved].all()
    assert moved.sum() <= max(2, o.shape[0] // 200)
    wall = hit & (r[inst_p] >= 1e4)
    small = hit & ~wall
    small &= ~moved
    cw = c[inst_p].astype(np.float64)
    op = cw - o
    b = (op * d).sum(-1)
    op2 = (op * op).sum(-1)
    s = np.sqrt(np.maximum(r[inst_p].astype(np.float64) ** 2 - (op2 - b * b),
                           0))
    tol = (16 * _ulp_scale(o, cw, r[inst_p])
           + 16 * np.spacing(op2.astype(np.float32)) / (2 * np.maximum(s,
                                                                     1e-6)))
    assert (np.abs(t_p - t_j)[small] <= tol[small]).all()
    same = hit & ~moved
    rel = np.abs(t_p - t_j)[same] / np.maximum(t_j[same], 1.0)
    assert np.median(rel) < 1e-6
    # a wall's hit point lies on the wall to 2 ulp of the scale (both
    # packages put every one within 1.1 ulp)
    x = o + np.where(hit, t_p, 0.0)[:, None].astype(np.float64) * d
    surf = np.abs(np.linalg.norm(x - cw, axis=1) - r[inst_p])
    assert (surf[wall & ~moved] <= 2 * _ulp_scale(o, cw, r[inst_p])[
        wall & ~moved]).all()
    # where the winner and t are the same, the normal and the uv (unit
    # scale) are within 2 ulp of 1.0
    same &= t_p == t_j
    assert same.sum() > hit.sum() // 2
    ulp = float(np.spacing(np.float32(1.0)))
    for got, want in ((h.n.numpy(), n_j), (h.uv.numpy(), uv_j)):
        assert (np.abs(got - want)[same] <= 2 * ulp).all()


@pytest.mark.parametrize("name", list(_CASES))
def test_plain_equals_k2_plain(name):
    """The grid changes which pairs are tested, never the arithmetic of a
    tested pair: K4's plain version and K2's give the same t on every ray
    and the same winner on every hit."""
    _, ts, _, tg, o, d, _ = _case(name)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    counts = {}
    t4, code = dda.closest_hit_dda_plain(to.T.contiguous(), td.T.contiguous(),
                                         tg, counts=counts)
    h4 = dda.intersect_spheres_dda(to, td, ts, tg, want_uv=False)
    h2 = tip.intersect_spheres_pallas(to, td, ts, want_uv=False)
    np.testing.assert_array_equal(h4.t.numpy(), h2.t.numpy())
    hit = np.isfinite(h2.t.numpy())
    np.testing.assert_array_equal(h4.inst.numpy()[hit], h2.inst.numpy()[hit])
    assert (code.numpy()[~hit] == 0).all() and (t4.numpy()[~hit] == BIG).all()
    # the walk tests a fraction of what the brute sweep tests
    assert counts["rays"] == o.shape[0] and counts["walk_steps"] > 0
    assert counts["slot_tests"] < o.shape[0] * tg.n_local
    assert 0 < counts["max_steps"] <= sum(tg.nb) + 3


def test_codes_name_part_a_slots_and_ids():
    """A part-A winner encodes as -(slot + 1), a local one as its id: both
    name K2's winner."""
    _, ts, _, tg, o, d, _ = _case("procedural800_inside")
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    t, code = dda.closest_hit_dda(to.T.contiguous(), td.T.contiguous(), tg)
    code = code.numpy()
    want = tip.intersect_spheres_pallas(to, td, ts, want_uv=False).inst
    want = want.numpy()
    hit = t.numpy() < BIG
    part_a = hit & (code < 0)
    assert part_a.any() and (hit & (code > 0)).any()
    np.testing.assert_array_equal(tg.perm_a.numpy()[-code[part_a] - 1],
                                  want[part_a])
    np.testing.assert_array_equal(code[hit & (code >= 0)],
                                  want[hit & (code >= 0)])


def test_closest_hit_dda_rejects_bad_inputs():
    _, _, _, tg, o, d, _ = _case("cornell_occ4")
    ot = torch.from_numpy(o.T.copy())
    with pytest.raises(ValueError, match="org and dirs must be"):
        dda.closest_hit_dda(ot, ot[:2].contiguous(), tg)
    with pytest.raises(TypeError, match="float32"):
        dda.closest_hit_dda(ot.double(), ot.double(), tg)
    with pytest.raises(ValueError, match="cells must be"):
        dda.closest_hit_dda(ot, ot, dda.DDAGrid(**{
            **tg.__dict__, "cells": tg.cells[:, :8].contiguous(), "k": 16}))
    with pytest.raises(ValueError, match="no local spheres"):
        dda.build_dda_grid(tscene.make_sphere_scene(
            [(1e5, (0, 0, 0), (0, 0, 0), (0.5, 0.5, 0.5), 0)]), device="cpu")
    with pytest.raises(ValueError, match="uniform local-class eps"):
        dda.build_dda_grid(tscene.cornell_box_scene(), eps=1e-6,
                           device="cpu")
    empty = torch.zeros((3, 0))
    t, code = dda.closest_hit_dda(empty, empty, tg)
    assert t.shape == (0,) and code.shape == (0,)
