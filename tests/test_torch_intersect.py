"""The port's plain closest-hit route and mesh scenes against the JAX
package's (ops/intersect.py, core/scene.py's mesh half), on the same numpy
inputs.

Tolerances:
- scene arrays: exact (the same numpy draws and float32 roundings);
- sphere_hit_t: XLA:CPU contracts a*b + c into fused multiply-adds and
  torch does not, so the two round differently. The stable form: within
  16 ulp of the sphere's scale |o - c| + r on the small spheres; on the 1e5
  walls (one ulp of |op| is ~0.008, and the citardauq quotient amplifies
  it on grazing rays) the JAX suite's own bar between two intersectors
  (tests/test_intersect_pallas.py): |dt| / max(t, 1) below 5e-3, its
  median below 1e-6. The direct quadratic: 16 ulp of the scale plus its
  own conditioning, 16 ulp of |op|^2 over the root's slope 2 sqrt(det);
- intersect_spheres and intersect_mesh: the same winner wherever the two
  nearest candidates are not a near tie (8 ulp of the scale) and no 1e5
  wall is involved; t under the same bars;
- sphere_uv: 2e-6 (atan2 and asin differ by a few ulp between XLA and
  torch), u compared circularly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import intersect as jisect
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.ops import intersect as tisect


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform([5, 5, 20], [95, 75, 150], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _mesh_eq(jm, tm):
    for f in ("positions", "normals", "indices", "tri_inst"):
        _eq(getattr(jm, f), getattr(tm, f))
    for f in ("emission", "albedo", "refl"):
        _eq(getattr(jm.material, f), getattr(tm.material, f))
    assert tm.n_triangles == jm.n_triangles


@pytest.mark.parametrize("name", ["triangle", "procedural60", "spheres4",
                                  "instanced"])
def test_mesh_builders_equal_jax(name):
    if name == "triangle":
        jm, tm = jscene.single_triangle_scene(), tscene.single_triangle_scene()
    elif name == "procedural60":
        jm = jscene.procedural_mesh_scene(60, seed=3)
        tm = tscene.procedural_mesh_scene(60, seed=3)
        assert tm.n_triangles == 14 + 60 * 64
    elif name == "spheres4":
        jm = jscene.mesh_scene_from_spheres(jscene.cornell_box_scene(), 4)
        tm = tscene.mesh_scene_from_spheres(tscene.cornell_box_scene(), 4)
    else:
        p, n, t = tscene.make_sphere_tri_mesh((1.0, 2.0, 3.0), 2.5, 3)
        xf = [[2.0, 0.1, 0.0, 5.0], [0.0, 1.0, 0.3, -1.0], [0.0, 0.0, 0.5, 2.0]]
        inst = [(p, n, t, xf, ((1, 2, 3), (0.5, 0.25, 0.75), 2)),
                (p, n, t, None, ((0, 0, 0), (0.1, 0.2, 0.3), 0))]
        jm = jscene.make_instanced_mesh_scene(inst)
        tm = tscene.make_instanced_mesh_scene(inst)
        np.testing.assert_array_equal(tscene.transform_points(xf, p),
                                      jscene.transform_points(xf, p))
        with pytest.raises(ValueError, match="transform"):
            tscene.make_instanced_mesh_scene([(p, n, t, np.eye(3), inst[0][4])])
    _mesh_eq(jm, tm)


def _scale_ulp(o, c, r):
    scale = np.linalg.norm(c.astype(np.float64) - o, axis=-1) + r
    return np.spacing(scale.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("stable", [True, False])
def test_sphere_hit_t_matches_jax(stable):
    scene = tscene.procedural_sphere_scene(60)
    c, r = scene.center.numpy(), scene.radius.numpy()
    if not stable:  # the direct quadratic serves the small spheres only
        c, r = c[9:], r[9:]
    o, d = _rays(300, 1)
    eps = np.maximum(1e-4, np.float32(5e-7) * r)
    got = tisect.sphere_hit_t(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(c), torch.from_numpy(r),
                              torch.from_numpy(eps), stable=stable).numpy()
    want = np.asarray(jisect.sphere_hit_t(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(c), jnp.asarray(r),
                                          jnp.asarray(eps), stable=stable))
    fin = np.isfinite(want)
    # a hit/miss flip only at a grazing ray (det within rounding of 0)
    assert (np.isfinite(got) == fin).mean() > 0.999
    both = fin & np.isfinite(got)
    op = c[None].astype(np.float64) - o[:, None]
    tol = 16 * _scale_ulp(o[:, None], c[None], r[None])
    err = np.zeros(got.shape)
    err[both] = np.abs(got[both] - want[both])
    if stable:
        small = both & (r[None] < 100)
        assert (err[small] <= tol[small]).all()
        _jax_suite_bar(got[both], want[both])
    else:
        b = (op * d[:, None]).sum(-1)
        op2 = (op * op).sum(-1)
        s = np.sqrt(np.maximum(b * b - op2 + r[None] ** 2, 1e-12))
        tol = tol + 16 * np.spacing(op2.astype(np.float32)) / (2 * s)
        assert (err[both] <= tol[both]).all()


def _jax_suite_bar(got, want):
    """tests/test_intersect_pallas.py::test_matches_pure_jax's bar on t."""
    rel = np.abs(got - want) / np.maximum(want, 1.0)
    assert rel.max() < 5e-3 and np.median(rel) < 1e-6, (rel.max(),
                                                         np.median(rel))


def _tie_or_wall(o, d, c, r, ia, ib):
    """The winners ia, ib (sphere ids) differ only where their float64 t
    lie within 8 ulp of the scale, or a 1e5 wall is one of them."""
    def t64(i):
        op = c[i].astype(np.float64) - o
        b = (op * d).sum(-1)
        det = r[i].astype(np.float64) ** 2 - ((op * op).sum(-1) - b * b)
        s = np.sqrt(np.maximum(det, 0))
        return np.where(b - s > 1e-4, b - s, b + s)

    ta, tb = t64(ia), t64(ib)
    near = np.abs(ta - tb) <= 8 * _scale_ulp(o, c[ia], r[ia])
    return near | (r[ia] >= 1e4) | (r[ib] >= 1e4)


@pytest.mark.parametrize("n", [1500, 77])
def test_intersect_spheres_matches_jax(n):
    jsc, tsc = jscene.procedural_sphere_scene(200), \
        tscene.procedural_sphere_scene(200)
    o, d = _rays(n, 2)
    hj = jisect.intersect_spheres(jnp.asarray(o), jnp.asarray(d), jsc,
                                  chunk=64)
    ht = tisect.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                                  tsc, chunk=64)
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    assert (np.isfinite(tj) == np.isfinite(tt)).all()
    ij, it = np.asarray(hj.inst), ht.inst.numpy()
    c, r = tsc.center.numpy(), tsc.radius.numpy()
    moved = ij != it
    assert _tie_or_wall(o, d, c, r, ij, it)[moved].all()
    same = ~moved & np.isfinite(tj)
    _jax_suite_bar(tt[same], tj[same])
    small = same & (r[it] < 100)
    ulp = _scale_ulp(o, c[it], r[it])
    assert (np.abs(tj - tt)[small] <= 16 * ulp[small]).all()
    np.testing.assert_allclose(ht.n.numpy()[same], np.asarray(hj.n)[same],
                               atol=2e-3)
    np.testing.assert_array_equal(ht.prim.numpy(), it)


def test_sphere_uv_matches_jax():
    n = np.random.default_rng(3).normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    got = tisect.sphere_uv(torch.from_numpy(n)).numpy()
    want = np.asarray(jisect.sphere_uv(jnp.asarray(n)))
    du = np.abs(got[:, 0] - want[:, 0])
    assert np.minimum(du, 1.0 - du).max() <= 2e-6
    assert np.abs(got[:, 1] - want[:, 1]).max() <= 2e-6
    assert (got >= 0).all() and (got < 1).all()


def test_intersect_mesh_matches_jax():
    jm = jscene.procedural_mesh_scene(20, seed=2)
    tm = tscene.procedural_mesh_scene(20, seed=2)
    o, d = _rays(400, 4)
    hj = jisect.intersect_mesh(jnp.asarray(o), jnp.asarray(d), jm, chunk=128)
    ht = tisect.intersect_mesh(torch.from_numpy(o), torch.from_numpy(d), tm,
                               chunk=128)
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    assert (np.isfinite(tj) == np.isfinite(tt)).mean() > 0.99
    both = np.isfinite(tj) & np.isfinite(tt)
    same = both & (np.asarray(hj.prim) == ht.prim.numpy())
    # a different winner only at a shared edge or a near tie
    assert same.sum() >= both.sum() - 4
    np.testing.assert_allclose(tt[same], tj[same], rtol=1e-5, atol=1e-4)
    for f in ("x", "n", "uv"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[same],
                                   np.asarray(getattr(hj, f))[same],
                                   atol=2e-4)
    np.testing.assert_array_equal(ht.inst.numpy()[same],
                                  np.asarray(hj.inst)[same])


def test_complete_mesh_hit_matches_jax():
    jm = jscene.procedural_mesh_scene(5, seed=1)
    tm = tscene.procedural_mesh_scene(5, seed=1)
    r = np.random.default_rng(5)
    n = 64
    bi = r.integers(0, tm.n_triangles, n).astype(np.int32)
    bu = r.random(n).astype(np.float32) * 0.5
    bv = r.random(n).astype(np.float32) * 0.5
    bt = r.random(n).astype(np.float32) * 50
    bt[::7] = np.inf
    hj = jisect.complete_mesh_hit(jm, jnp.asarray(bt), jnp.asarray(bi),
                                  jnp.asarray(bu), jnp.asarray(bv))
    ht = tisect.complete_mesh_hit(tm, torch.from_numpy(bt),
                                  torch.from_numpy(bi), torch.from_numpy(bu),
                                  torch.from_numpy(bv))
    for f in ("t", "inst", "prim"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)))
    for f in ("x", "n", "uv"):
        np.testing.assert_allclose(getattr(ht, f).numpy(),
                                   np.asarray(getattr(hj, f)), rtol=1e-6,
                                   atol=1e-5)


def test_scene_to_moves_every_tensor():
    m = tscene.procedural_mesh_scene(2, seed=0)
    moved = tscene.scene_to(m, "cpu")
    assert isinstance(moved, tscene.MeshScene)
    _mesh_eq(jscene.procedural_mesh_scene(2, seed=0), moved)
    s = tscene.scene_to(tscene.cornell_box_scene(), torch.device("cpu"))
    assert isinstance(s, tscene.SphereScene) and s.n_spheres == 9
