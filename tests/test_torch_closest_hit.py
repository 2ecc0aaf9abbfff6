"""The host sides of the closest-hit kernels K2 (ops/intersect_pallas.py)
and K6 (ops/mesh_pallas.py) against the JAX package's, and the kernels'
plain versions against the JAX kernels run in the Pallas interpreter
(``_closest_hit``, ``_closest_tri``) on the same seeded rays.

Tolerances:
- tables, permutations and chunk counts: exact;
- K2: the sphere ids (perm[slot]) equal except where the two nearest t lie
  within 8 ulp of the scale or a 1e5 wall is involved; the slot may name
  the other copy of a small sphere that part A and part B both hold, whose
  t is the lesser of the stable and the direct form; t under the JAX
  suite's bar between intersectors (|dt| / max(t, 1) below 5e-3, its
  median below 1e-6; XLA:CPU contracts multiply-adds into FMAs, torch does
  not) and within 16 ulp of the scale on the small spheres, plus the
  direct quadratic's conditioning where part B answers;
- K6: the triangle ids equal except near ties and shared edges (a few
  rays); t, u and v within 1e-5 relative (iq's formulation has no 1e5
  scale in it).
On a CPU tensor each wrapper runs its plain version and counts no launch;
on a CUDA tensor it launches the kernel or raises (tests/test_torch_
isolation.py checks the binding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import intersect_pallas as jip
from smallpt_tpu.ops import mesh_pallas as jmp
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.ops import intersect_pallas as tip
from smallpt_tpu_torch.ops import mesh_pallas as tmp

BIG = 3.0e38


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed, lo=(5, 5, 20), hi=(95, 75, 150)):
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _planes(o, d, pad=1024):
    """The JAX kernels' (3, N_pad) planes (padded dirs point along x) and
    the port's (3, N) ones."""
    n = o.shape[0]
    n_pad = -(-n // pad) * pad
    ot = np.zeros((3, n_pad), np.float32)
    dt = np.zeros((3, n_pad), np.float32)
    dt[0] = 1.0
    ot[:, :n], dt[:, :n] = o.T, d.T
    return ((jnp.asarray(ot), jnp.asarray(dt)),
            (torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())))


_SPHERES = {
    "cornell": (jscene.cornell_box_scene, tscene.cornell_box_scene),
    "procedural200": (lambda: jscene.procedural_sphere_scene(200),
                      lambda: tscene.procedural_sphere_scene(200)),
    # 7 big spheres and 293 small ones: part A holds 128 rows and truncates
    "procedural300": (lambda: jscene.procedural_sphere_scene(300),
                      lambda: tscene.procedural_sphere_scene(300)),
}


@pytest.mark.parametrize("name", sorted(_SPHERES))
def test_build_sphere_table_equals_jax(name):
    js, ts = (f() for f in _SPHERES[name])
    want = jip.build_sphere_table(js, eps=2e-4, eps_rel=1e-6)
    got = tip.build_sphere_table(ts, eps=2e-4, eps_rel=1e-6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[2:] == want[2:]
    assert got[0].shape[0] == tip.MAX_BIG + 64 * got[3]
    if name == "procedural300":
        # part A: the 7 big spheres first, then the first 121 small ones
        perm_a = got[1][:tip.MAX_BIG].numpy()
        assert (ts.radius.numpy()[perm_a[:7]] >= 100).all()
        np.testing.assert_array_equal(perm_a[7:], [6, 7, *range(9, 128)])


def test_more_than_max_big_big_spheres_raise():
    scene = tscene.make_sphere_scene(
        [(1e3, (float(i), 0, 0), (0, 0, 0), (0.5, 0.5, 0.5), 0)
         for i in range(tip.MAX_BIG + 1)])
    with pytest.raises(ValueError, match="MAX_BIG"):
        tip.build_sphere_table(scene)
    tip.build_sphere_table(tscene.make_sphere_scene(
        [(1e3, (float(i), 0, 0), (0, 0, 0), (0.5, 0.5, 0.5), 0)
         for i in range(tip.MAX_BIG)]))


def _scale_ulp(o, c, r):
    scale = np.linalg.norm(c.astype(np.float64) - o, axis=-1) + r
    return np.spacing(scale.astype(np.float32)).astype(np.float64)


def _t64(o, d, c, r):
    op = c.astype(np.float64) - o
    b = (op * d).sum(-1)
    det = r.astype(np.float64) ** 2 - ((op * op).sum(-1) - b * b)
    s = np.sqrt(np.maximum(det, 0))
    return np.where(b - s > 1e-4, b - s, b + s), b, (op * op).sum(-1), s


def _check_k2(ts, o, d, t_j, slot_j, t_p, slot_p, table_perm):
    perm = table_perm.numpy()
    c, r = ts.center.numpy(), ts.radius.numpy()
    hit_j, hit_p = t_j < BIG, t_p < BIG
    assert (hit_j == hit_p).all()
    assert (slot_j[~hit_j] == 0).all() and (slot_p[~hit_p] == 0).all()
    id_j, id_p = perm[slot_j], perm[slot_p]
    moved = hit_j & (id_j != id_p)
    ta, _, _, _ = _t64(o, d, c[id_j], r[id_j])
    tb, _, _, _ = _t64(o, d, c[id_p], r[id_p])
    excused = ((np.abs(ta - tb) <= 8 * _scale_ulp(o, c[id_j], r[id_j]))
               | (r[id_j] >= 1e4) | (r[id_p] >= 1e4))
    assert excused[moved].all()
    same = hit_j & ~moved
    rel = np.abs(t_p - t_j)[same] / np.maximum(t_j[same], 1.0)
    assert rel.max() < 5e-3 and np.median(rel) < 1e-6
    small = same & (r[id_p] < 100)
    _, b, op2, s = _t64(o, d, c[id_p], r[id_p])
    tol = (16 * _scale_ulp(o, c[id_p], r[id_p])
           + 16 * np.spacing(op2.astype(np.float32)) / (2 * np.maximum(s,
                                                                     1e-6)))
    assert (np.abs(t_p - t_j)[small] <= tol[small]).all()
    return int(moved.sum())


@pytest.mark.parametrize("name,n", [("cornell", 1500), ("procedural200", 1500),
                                    ("procedural300", 1500), ("cornell", 77)])
def test_closest_hit_plain_matches_jax_kernel(name, n):
    js, ts = (f() for f in _SPHERES[name])
    table_j, perm_j, nbc, nsc = jip.build_sphere_table(js)
    table, perm, _, _ = tip.build_sphere_table(ts)
    o, d = _rays(n, 7)
    (oj, dj), (ot, dt) = _planes(o, d)
    t_j, slot_j = jip._closest_hit(oj, dj, table_j, nbc, nsc, interpret=True)
    t_j, slot_j = np.asarray(t_j)[:n], np.asarray(slot_j)[:n]
    launches = tip.closest_hit.launches
    t_p, slot_p = tip.closest_hit(ot, dt, table, 64 * nbc, 64 * nsc)
    assert tip.closest_hit.launches == launches  # the CPU runs the plain one
    assert t_p.dtype == torch.float32 and slot_p.dtype == torch.int32
    moved = _check_k2(ts, o, d, t_j, slot_j, t_p.numpy(), slot_p.numpy(),
                      perm)
    assert moved <= max(2, n // 200)


def test_closest_hit_all_miss_and_table_order():
    """Rays from beyond every wall sphere, pointing away, miss them all:
    t = 3e38 and slot 0, as the JAX kernel answers. And the fold's tie
    rule: of two identical rows the first slot wins."""
    scene = tscene.cornell_box_scene()
    table, _, nbc, nsc = tip.build_sphere_table(scene)
    o = np.tile(np.float32([[50.0, 40.0, 1e6]]), (77, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (77, 1))
    (oj, dj), (ot, dt) = _planes(o, d)
    t_j, s_j = jip._closest_hit(oj, dj, jip.build_sphere_table(
        jscene.cornell_box_scene())[0], nbc, nsc, interpret=True)
    t, s = tip.closest_hit_plain(ot, dt, table, 64 * nbc, 64 * nsc)
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j)[:77])
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j)[:77])
    assert (t.numpy() == np.float32(BIG)).all() and (s.numpy() == 0).all()

    dup = torch.cat([table[:1], table[:1], table[1:]])  # slots 0 and 1 equal
    o, d = _rays(200, 3)
    _, (ot, dt) = _planes(o, d)
    t1, s1 = tip.closest_hit_plain(ot, dt, dup, 1 + 64 * nbc, 64 * nsc)
    t0, s0 = tip.closest_hit_plain(ot, dt, table, 64 * nbc, 64 * nsc)
    np.testing.assert_array_equal(t1.numpy(), t0.numpy())
    assert ((s1 == 0) == (s0 == 0)).all()


def test_closest_hit_rejects_bad_inputs():
    table, _, nbc, nsc = tip.build_sphere_table(tscene.cornell_box_scene())
    o = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="n_a"):
        tip.closest_hit(o, o, table, 64 * nbc, 64 * nsc + 1)
    with pytest.raises(ValueError, match=r"\(3, N\)"):
        tip.closest_hit(o.T.contiguous(), o.T.contiguous(), table, 0, 0)
    with pytest.raises(TypeError, match="float32"):
        tip.closest_hit(o.double(), o, table, 0, 0)


def test_build_tri_table_equals_jax():
    jm = jscene.procedural_mesh_scene(60, seed=3)
    tm = tscene.procedural_mesh_scene(60, seed=3)
    got = tmp.build_tri_table(tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmp.build_tri_table(jm)))
    assert got.shape == (3872, 16) and float(got[3854:].abs().sum()) == 0.0
    np.testing.assert_array_equal(
        tmp.build_tri_table(tscene.single_triangle_scene()).numpy(),
        np.asarray(jmp.build_tri_table(jscene.single_triangle_scene())))


def _check_k6(got, want, n_excused):
    t_p, i_p, u_p, v_p = (x.numpy() for x in got)
    t_j, i_j, u_j, v_j = want
    hit = t_j < BIG
    assert ((t_p < BIG) == hit).mean() >= 1 - n_excused / hit.size
    same = hit & (i_p == i_j)
    assert (~same & hit).sum() <= n_excused
    np.testing.assert_allclose(t_p[same], t_j[same], rtol=1e-5)
    np.testing.assert_allclose(u_p[same], u_j[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v_p[same], v_j[same], rtol=1e-5, atol=1e-6)
    miss = ~hit & (t_p >= BIG)
    assert (i_p[miss] == 0).all() and (u_p[miss] == 0).all() \
        and (v_p[miss] == 0).all()


@pytest.mark.parametrize("n", [1500, 77])
def test_closest_tri_plain_matches_jax_kernel(n):
    jm = jscene.procedural_mesh_scene(60, seed=3)
    tm = tscene.procedural_mesh_scene(60, seed=3)
    table = tmp.build_tri_table(tm)
    o, d = _rays(n, 11)
    (oj, dj), (ot, dt) = _planes(o, d)
    want = [np.asarray(x)[:n] for x in jmp._closest_tri(
        oj, dj, jnp.asarray(table.numpy()), table.shape[0] // 32, 0.0,
        interpret=True)]
    launches = tmp.closest_tri.launches
    got = tmp.closest_tri(ot, dt, table)
    assert tmp.closest_tri.launches == launches
    assert got[1].dtype == torch.int32
    _check_k6(got, want, n_excused=max(2, n // 300))


def test_closest_tri_single_triangle_and_eps():
    """The debug triangle from the origin: some rays hit it (u, v inside the
    barycentric bounds), the rest miss with (3e38, 0, 0, 0); eps rejects
    hits at t <= eps."""
    jm, tm = jscene.single_triangle_scene(), tscene.single_triangle_scene()
    table = tmp.build_tri_table(tm)
    r = np.random.default_rng(2)
    d = np.stack([r.uniform(-0.4, 0.4, 300), r.uniform(-0.4, 0.4, 300),
                  -np.ones(300)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros_like(d)
    (oj, dj), (ot, dt) = _planes(o, d)
    for eps in (0.0, 2.5):
        want = [np.asarray(x)[:300] for x in jmp._closest_tri(
            oj, dj, jnp.asarray(table.numpy()), table.shape[0] // 32, eps,
            interpret=True)]
        got = tmp.closest_tri_plain(ot, dt, table, eps=eps)
        _check_k6(got, want, n_excused=1)
        hits = int((got[0] < BIG).sum())
        assert (hits == 0) if eps else (0 < hits < 300)


def test_intersect_pallas_routes_match_the_plain_routes():
    """intersect_spheres_pallas and intersect_mesh_pallas complete the hit
    as the plain routes do (same winner: same x, n, inst), and skip uv when
    asked."""
    from smallpt_tpu_torch.ops import intersect as tisect

    scene = tscene.cornell_box_scene()
    o, d = _rays(300, 5)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hp = tip.intersect_spheres_pallas(o, d, scene)
    hj = tisect.intersect_spheres(o, d, scene)
    same = (hp.inst == hj.inst) & hp.valid
    assert float(same.float().mean()) > 0.99
    torch.testing.assert_close(hp.x[same], hj.x[same], atol=0.5, rtol=0)
    torch.testing.assert_close(hp.uv[same], hj.uv[same], atol=1e-2, rtol=0)
    assert float(tip.intersect_spheres_pallas(
        o, d, scene, want_uv=False).uv.abs().sum()) == 0.0

    mesh = tscene.procedural_mesh_scene(10, seed=1)
    hp = tmp.intersect_mesh_pallas(o, d, mesh)
    hj = tisect.intersect_mesh(o, d, mesh)
    same = (hp.prim == hj.prim) & hp.valid
    assert float(same.float().mean()) > 0.99
    torch.testing.assert_close(hp.x[same], hj.x[same], atol=1e-3, rtol=0)
    torch.testing.assert_close(hp.n[same], hj.n[same], atol=1e-4, rtol=0)
