"""K5's host side (ops/intersect_pallas.py: build_sphere_table_mxu,
closest_hit_mxu, closest_hit_mxu_plain, intersect_spheres_mxu) against the
JAX package's: the tables, the plain version against the JAX kernel
(``_closest_hit_mxu``) run in the Pallas interpreter on the same shifted
rays, and the entry point against JAX's and against the port's plain
intersector.

Tolerances:
- the recentring shift: within 2 ulp a component (JAX sums in XLA's order,
  which no other summation gives bit for bit);
- the tables and perm, built from JAX's shift: exact;
- K5's winner and t across the packages: the JAX kernel is not bit-exact
  to K2 either (its docstring), so the gates are
  tests/test_intersect_pallas.py::test_mxu_matches_pure_jax's: hit/miss
  agreement above 0.998, winner flips below 3e-3, and on the refined hit
  (the replay) the 0.999 quantile of |dt| / max(t, 1) below 2e-2, its
  median below 1e-6, normals within 1e-2 of each other;
- the plain version against the same arithmetic written in numpy float32:
  bit for bit (the op order is the kernel's).
On a CPU tensor closest_hit_mxu runs the plain version and counts no
launch (tests/test_torch_isolation.py checks the CUDA binding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import intersect_pallas as jip
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.ops import intersect as tisect
from smallpt_tpu_torch.ops import intersect_pallas as tip

BIG = np.float32(3.0e38)

_SCENES = {
    "cornell": (jscene.cornell_box_scene, tscene.cornell_box_scene),
    "procedural2000": (lambda: jscene.procedural_sphere_scene(2000),
                       lambda: tscene.procedural_sphere_scene(2000)),
    # part A holds the 7 big spheres and 121 small ones
    "procedural300": (lambda: jscene.procedural_sphere_scene(300),
                      lambda: tscene.procedural_sphere_scene(300)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed=3, hi_z=290):
    """test_mxu_matches_pure_jax's rays: origins out to the camera's
    distance (the recentring's worst case), isotropic unit directions."""
    r = np.random.default_rng(seed)
    o = r.uniform([5, 5, 20], [95, 75, hi_z], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", ["cornell", "procedural2000"])
def test_shift_within_2_ulp_of_jax(name):
    js, ts = (f() for f in _SCENES[name])
    want = np.asarray(jip.build_sphere_table_mxu(js)[6])
    got = tip.build_sphere_table_mxu(ts)[6]
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert (_ulps(got.numpy(), want) <= 2).all(), (got, want)


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_tables_equal_jax_from_its_shift(name):
    js, ts = (f() for f in _SCENES[name])
    want = jip.build_sphere_table_mxu(js)
    c, r = ts.center.numpy(), ts.radius.numpy()
    stable, mxu, perm, n_sc = tip._mxu_tables(
        c, r, np.asarray(want[6]), 1e-4, 5e-7, tip.STABLE_RADIUS)
    np.testing.assert_array_equal(stable, np.asarray(want[0]))
    np.testing.assert_array_equal(mxu, np.asarray(want[1]))
    np.testing.assert_array_equal(perm, np.asarray(want[2]))
    got = tip.build_sphere_table_mxu(ts)
    assert (got[3], got[4], got[5]) == (want[3], want[4], want[5]) == (
        2, n_sc, 1e-4)
    assert got[1].shape == (2 * 64 * n_sc, 8) and got[2].dtype == torch.int64
    # masked rows: big spheres and padding carry q = 1e30 and no -1
    row2 = got[1].view(n_sc, 2, 64, 8)[:, 1].reshape(-1, 8).numpy()
    masked = np.ones(64 * n_sc, bool)
    masked[:ts.n_spheres] = r >= tip.STABLE_RADIUS
    assert (row2[masked, 6] == -1e30).all() and (row2[masked, 7] == 0).all()
    assert (row2[~masked, 7] == -1).all()


def test_eps_check_and_big_capacity_raise():
    scene = tscene.cornell_box_scene()
    with pytest.raises(ValueError, match="uniform small-class eps"):
        tip.build_sphere_table_mxu(scene, eps=1e-5, eps_rel=5e-7)
    with pytest.raises(ValueError, match="uniform small-class eps"):
        jip.build_sphere_table_mxu(jscene.cornell_box_scene(), eps=1e-5,
                                   eps_rel=5e-7)
    tip.build_sphere_table_mxu(scene, eps=1e-4, eps_rel=1e-6)  # at the edge
    many = tscene.make_sphere_scene(
        [(1e3, (float(i), 0, 0), (0, 0, 0), (0.5, 0.5, 0.5), 0)
         for i in range(tip.MAX_BIG + 1)])
    with pytest.raises(ValueError, match="MAX_BIG"):
        tip.build_sphere_table_mxu(many)


def _plain_numpy(oc, d, stable, mxu, n_b, eps):
    """K5's function written in numpy float32, pair by pair in the kernel's
    order: the stable form over part A's live rows, then b and det from the
    8-term dots, the sequential strict-< fold."""
    n = oc.shape[0]
    bt = np.full(n, BIG, np.float32)
    bi = np.zeros(n, np.int32)
    t_a, s_a = tip.closest_hit_plain(
        torch.from_numpy(oc.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(stable), stable.shape[0], 0)
    bt, bi = t_a.numpy().copy(), s_a.numpy().copy()
    ox, oy, oz = oc.T
    dx, dy, dz = d.T
    f = [dx, dy, dz, ox, oy, oz, np.ones_like(ox), (ox * ox + oy * oy)
         + oz * oz]
    od = (ox * dx + oy * dy) + oz * dz
    rows = mxu.reshape(-1, 2, 64, 8)
    e = np.float32(eps)
    with np.errstate(invalid="ignore"):
        for j in range(n_b):
            r1, r2 = rows[j // 64, 0, j % 64], rows[j // 64, 1, j % 64]
            p1, p2 = r1[0] * f[0], r2[0] * f[0]
            for k in range(1, 8):
                p1 = p1 + r1[k] * f[k]
                p2 = p2 + r2[k] * f[k]
            b = p1 - od
            det = b * b + p2
            s = np.sqrt(det)
            t0, t1 = b - s, b + s
            tt = np.where(t0 > e, t0, np.where(t1 > e, t1, BIG))
            better = tt < bt
            bt = np.where(better, tt, bt)
            bi = np.where(better, stable.shape[0] + j, bi)
    return bt, bi


def test_plain_is_the_kernels_arithmetic_in_numpy():
    ts = tscene.procedural_sphere_scene(300)
    stable, mxu, perm, n_big, n_sc, eps, shift = tip.build_sphere_table_mxu(
        ts)
    o, d = _rays(96, seed=5)
    oc = o - shift.numpy()[None]
    got = tip.closest_hit_mxu_plain(
        torch.from_numpy(oc.T.copy()), torch.from_numpy(d.T.copy()), stable,
        mxu, 64 * n_big, 64 * n_sc, eps)
    want = _plain_numpy(oc, d, stable.numpy(), mxu.numpy(), 64 * n_sc, eps)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert (got[0].numpy() < BIG).mean() > 0.3  # the rays hit something


@pytest.mark.parametrize("name", ["cornell", "procedural2000"])
def test_plain_matches_jax_kernel(name):
    """The plain version and the JAX kernel on the same shifted rays:
    hit/miss and the winner (perm[slot]) under test_mxu_matches_pure_jax's
    bars; a small sphere that part A and part B both hold may answer from
    either copy, so winners are compared as sphere ids."""
    js, ts = (f() for f in _SCENES[name])
    jt = jip.build_sphere_table_mxu(js)
    shift = np.asarray(jt[6])
    stable, mxu, perm, _ = tip._mxu_tables(
        ts.center.numpy(), ts.radius.numpy(), shift, 1e-4, 5e-7,
        tip.STABLE_RADIUS)
    n = 2048
    o, d = _rays(n)
    oc = (o - shift[None]).astype(np.float32)
    t_j, s_j = jip._closest_hit_mxu(jnp.asarray(oc.T), jnp.asarray(d.T),
                                    jt[0], jt[1], jt[3], jt[4], jt[5],
                                    interpret=True)
    t_j, s_j = np.asarray(t_j), np.asarray(s_j)
    launches = tip.closest_hit_mxu.launches
    t_p, s_p = tip.closest_hit_mxu(
        torch.from_numpy(oc.T.copy()), torch.from_numpy(d.T.copy()),
        torch.from_numpy(stable), torch.from_numpy(mxu), 64 * jt[3],
        64 * jt[4], jt[5])
    assert tip.closest_hit_mxu.launches == launches  # the CPU: plain
    assert t_p.dtype == torch.float32 and s_p.dtype == torch.int32
    t_p, s_p = t_p.numpy(), s_p.numpy()
    hit_j, hit_p = t_j < BIG, t_p < BIG
    assert (hit_j == hit_p).mean() > 0.998
    assert (s_p[~hit_p] == 0).all() and (s_j[~hit_j] == 0).all()
    both = hit_j & hit_p
    assert (perm[s_j][both] != perm[s_p][both]).mean() < 3e-3
    same = both & (perm[s_j] == perm[s_p])
    rel = np.abs(t_j - t_p)[same] / np.maximum(t_j[same], 1.0)
    assert np.median(rel) < 1e-6 and np.quantile(rel, 0.999) < 2e-2


def _gates(h_ref, h_mxu):
    """tests/test_intersect_pallas.py::test_mxu_matches_pure_jax's gates
    (lines 126-149): returns the winner-flip share."""
    tr, tm = np.asarray(h_ref.t), np.asarray(h_mxu.t)
    hit_r, hit_m = np.isfinite(tr), np.isfinite(tm)
    assert (hit_r == hit_m).mean() > 0.998
    both = hit_r & hit_m
    ir, im = np.asarray(h_ref.inst)[both], np.asarray(h_mxu.inst)[both]
    flips = float((ir != im).mean())
    assert flips < 3e-3
    same = ir == im
    rel = np.abs(tr[both] - tm[both])[same] / np.maximum(tr[both][same], 1.0)
    assert np.quantile(rel, 0.999) < 2e-2
    assert np.median(rel) < 1e-6
    nr = np.asarray(h_ref.n)[both][same]
    nm = np.asarray(h_mxu.n)[both][same]
    assert np.abs((nr * nm).sum(-1) - 1.0).max() < 1e-2
    return flips


@pytest.mark.parametrize("name", ["cornell", "procedural2000"])
def test_intersect_spheres_mxu_matches_jax_and_plain_route(name):
    """The entry point against JAX's intersect_spheres_mxu and against the
    port's plain intersector, under every gate of
    test_mxu_matches_pure_jax (4,000 rays, its seed)."""
    js, ts = (f() for f in _SCENES[name])
    o, d = _rays(4000)
    h = tip.intersect_spheres_mxu(torch.from_numpy(o), torch.from_numpy(d),
                                  ts)
    assert h.t.shape == (4000,) and h.uv.shape == (4000, 2)
    h_jax = jip.intersect_spheres_mxu(jnp.asarray(o), jnp.asarray(d), js)
    h_ref = tisect.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                                     ts)
    _gates(h_jax, h)
    _gates(h_ref, h)
    # the tables built once by a caller give the same hits
    tables = tip.build_sphere_table_mxu(ts)
    h2 = tip.intersect_spheres_mxu(torch.from_numpy(o), torch.from_numpy(d),
                                   ts, tables=tables, precision="highest")
    np.testing.assert_array_equal(h2.t.numpy(), h.t.numpy())
    np.testing.assert_array_equal(h2.inst.numpy(), h.inst.numpy())


def test_padding_and_misses():
    """test_mxu_padding_and_misses's case: 77 rays along +z from the
    camera, hit/miss as the plain intersector's and as JAX's."""
    o = np.tile(np.float32([[50.0, 52.0, 295.6]]), (77, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (77, 1))
    h = tip.intersect_spheres_mxu(torch.from_numpy(o), torch.from_numpy(d),
                                  tscene.cornell_box_scene())
    assert h.t.shape == (77,)
    h_ref = tisect.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                                     tscene.cornell_box_scene())
    h_jax = jip.intersect_spheres_mxu(jnp.asarray(o), jnp.asarray(d),
                                      jscene.cornell_box_scene())
    np.testing.assert_array_equal(torch.isfinite(h.t).numpy(),
                                  torch.isfinite(h_ref.t).numpy())
    np.testing.assert_array_equal(torch.isfinite(h.t).numpy(),
                                  np.isfinite(np.asarray(h_jax.t)))
    # the wrapper's own answer: a hit where the entry point reports one
    tables = tip.build_sphere_table_mxu(tscene.cornell_box_scene())
    oc = torch.from_numpy(o) - tables[6][None]
    t, s = tip.closest_hit_mxu(oc.T.contiguous(),
                               torch.from_numpy(d.T.copy()), tables[0],
                               tables[1], 128, 64 * tables[4], tables[5])
    assert ((t < BIG) == torch.isfinite(h.t)).all()
    assert (s[t >= BIG] == 0).all()


def test_closest_hit_mxu_rejects_bad_inputs():
    stable, mxu, _, _, n_sc, eps, _ = tip.build_sphere_table_mxu(
        tscene.cornell_box_scene())
    o = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="n_b"):
        tip.closest_hit_mxu(o, o, stable, mxu, 128, 64 * n_sc + 64, eps)
    with pytest.raises(ValueError, match="n_b"):
        tip.closest_hit_mxu(o, o, stable, mxu, 128, 32, eps)
    with pytest.raises(ValueError, match="n_a"):
        tip.closest_hit_mxu(o, o, stable, mxu, 129, 64 * n_sc, eps)
    with pytest.raises(ValueError, match=r"\(3, N\)"):
        tip.closest_hit_mxu(o.T.contiguous(), o.T.contiguous(), stable, mxu,
                            128, 64, eps)
    with pytest.raises(TypeError, match="float32"):
        tip.closest_hit_mxu(o.double(), o, stable, mxu, 128, 64, eps)
    with pytest.raises(TypeError, match="float32"):
        tip.closest_hit_mxu(o, o, stable, mxu.double(), 128, 64, eps)
    with pytest.raises(ValueError, match="contiguous"):
        tip.closest_hit_mxu(torch.zeros((8, 3)).T, o, stable, mxu, 128, 64,
                            eps)
