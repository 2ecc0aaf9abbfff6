"""The port's grid-culled triangle sweep (ops/accel.py, ops/mesh_accel.py,
K7's host side and plain version in ops/mesh_pallas.py) against the JAX
package's, on the CPU. K7 itself runs only on the card (chip_smoke.py);
here its wrapper runs the plain version.

Gates:
- the accel: every field equal to build_mesh_grid_accel's, exactly;
- the tile lists (lists, dlo, stops): equal to mesh_tile_lists's, exactly;
- the culled sweep against the port's brute sweep (K6's plain version) on
  the same rays: t bit-equal on every lane, triangle, u and v bit-equal on
  hit lanes, and K6's miss outputs (t 3e38, 0, 0, 0) on miss lanes;
- against the JAX culled sweep (its kernel in interpret mode): the bars of
  tests/test_torch_closest_hit.py for K6 against the JAX kernel (XLA:CPU
  contracts a*b + c into one rounding, torch does not): the same hit or
  miss, the same triangle, t within 1e-5 relative and u, v within 1e-5
  relative + 1e-6, on all but max(2, N / 300) lanes;
- the FLAT render with the culled route forced: bit-equal to the brute
  route's image.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import mesh_accel as jma
from smallpt_tpu.ops import mesh_pallas as jmp
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.ops import accel as tacc
from smallpt_tpu_torch.ops import mesh_accel as tma
from smallpt_tpu_torch.ops import mesh_pallas as tmp

BIG = 3e38


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    # 60 balls x 64 triangles + 14 wall and light triangles = 3,854
    return (jscene.procedural_mesh_scene(n_balls=60, seed=3),
            tscene.procedural_mesh_scene(n_balls=60, seed=3))


@pytest.fixture(scope="module")
def accels(meshes):
    return (jma.build_mesh_grid_accel(meshes[0]),
            tma.build_mesh_grid_accel(meshes[1]))


def _rays(kind: str, n: int, seed: int, mesh=None):
    """(org, dirs) (N, 3) f32 numpy: random origins in the box and
    directions; a coherent camera-like bundle; or origins on the surfaces
    a coherent bundle hits (through the port's brute sweep), with random
    directions (bounce rays)."""
    r = np.random.default_rng(seed)
    if kind == "random":
        org = r.uniform((5, 5, 25), (95, 75, 145), (n, 3))
        d = r.normal(size=(n, 3))
    else:
        org = np.asarray([50.0, 52.0, 155.0]) + r.uniform(-0.5, 0.5, (n, 3))
        d = np.asarray([0.0, -0.04, -1.0]) + r.uniform(-0.08, 0.08, (n, 3))
    org = org.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    if kind == "surface":
        h = tmp.intersect_mesh_pallas(torch.from_numpy(org),
                                      torch.from_numpy(d), mesh)
        tt = torch.where(torch.isfinite(h.t), h.t, 1.0).numpy()[:, None]
        org = (org + d * tt * np.float32(0.999)).astype(np.float32)
        d = r.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return org, d


def _planes(org, d):
    """The padded (3, N_pad) planes and valid mask of both packages."""
    n = org.shape[0]
    n_pad = -(-n // tma.RAY_TILE) * tma.RAY_TILE
    ot, dt = tmp._ray_planes(torch.from_numpy(org), torch.from_numpy(d),
                             n_pad)
    valid = torch.arange(n_pad) < n
    return ot, dt, valid


def test_accel_helpers_equal_jax():
    """_dir_bin and _cell_lin on random and out-of-grid points (clipped to
    the border cells) equal the JAX package's, exactly."""
    from smallpt_tpu.ops import accel as jacc

    r = np.random.default_rng(0)
    d = r.normal(size=(3, 500)).astype(np.float32)
    d[:, :20] = 0.0  # ties of the dominant axis
    p = r.uniform(-40, 140, (3, 500)).astype(np.float32)
    lo = np.asarray([1.0, 0.5, 20.0], np.float32)
    inv = np.asarray([0.1, 0.2, 0.05], np.float32)
    np.testing.assert_array_equal(
        tacc._dir_bin(*torch.from_numpy(d)).numpy(),
        np.asarray(jacc._dir_bin(*jnp.asarray(d))))
    np.testing.assert_array_equal(
        tacc._cell_lin(*torch.from_numpy(p), torch.from_numpy(lo),
                       torch.from_numpy(inv), (7, 6, 13)).numpy(),
        np.asarray(jacc._cell_lin(*jnp.asarray(p), jnp.asarray(lo),
                                  jnp.asarray(inv), (7, 6, 13))))


@pytest.mark.parametrize("l_max", [None, 16])
def test_accel_build_equals_jax(meshes, l_max):
    ja = jma.build_mesh_grid_accel(meshes[0], l_max=l_max)
    ta = tma.build_mesh_grid_accel(meshes[1], l_max=l_max)
    for f in ("table", "order", "lo", "inv_cell", "masks", "k_lo", "k_hi"):
        want, got = np.asarray(getattr(ja, f)), getattr(ta, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("n_glob_chunks", "n_chunks", "nb", "l_max", "d0"):
        assert getattr(ta, f) == getattr(ja, f), f
    assert ta.n_bins == ja.n_bins
    # the walls and the light are the one global chunk; ball rows carry
    # their original ids in column 13
    assert ta.n_glob_chunks == 1 and ta.l_max == (16 if l_max else 241)
    live = ta.table[:, 12] > 0.5
    np.testing.assert_array_equal(ta.table[live, 13].numpy(),
                                  ta.order[live].numpy().astype(np.float32))


def test_accel_refuses_a_mesh_with_no_local_triangles():
    """The six quad walls alone (the first 12 triangles of the procedural
    mesh, each far above GLOBAL_TRI_EXTENT) are all global: the build
    raises ValueError, as the JAX package's does, and the renderer takes
    the brute sweep."""
    walls = tscene.procedural_mesh_scene(n_balls=0)
    walls = walls._replace(indices=walls.indices[:12],
                           tri_inst=walls.tri_inst[:12])
    jwalls = jscene.procedural_mesh_scene(n_balls=0)
    jwalls = jwalls._replace(indices=jwalls.indices[:12],
                             tri_inst=jwalls.tri_inst[:12])
    with pytest.raises(ValueError, match="no local triangles"):
        tma.build_mesh_grid_accel(walls)
    with pytest.raises(ValueError, match="no local triangles"):
        jma.build_mesh_grid_accel(jwalls)
    old = renderer.MESH_ACCEL_MIN_TRIS
    try:
        renderer.MESH_ACCEL_MIN_TRIS = 1
        assert renderer._mesh_accel_for(walls) is None
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old


@pytest.mark.parametrize("kind,n", [("random", 2048), ("coherent", 2048),
                                    ("surface", 2048), ("ragged", 3 * 1024
                                                        + 17)])
def test_tile_lists_equal_jax(meshes, accels, kind, n):
    org, d = _rays("random" if kind == "ragged" else kind, n, 21,
                   meshes[1])
    ot, dt, valid = _planes(org, d)
    want = jma.mesh_tile_lists(jnp.asarray(ot.numpy()),
                               jnp.asarray(dt.numpy()),
                               jnp.asarray(valid.numpy()), accels[0])
    got = tma.mesh_tile_lists(ot, dt, valid, accels[1])
    for name, g, w in zip(("lists", "dlo", "stops"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    lists, dlo, stops = (x.numpy() for x in got)
    # nearest-first: the bounds never fall; +inf past the reachable count
    for t in range(lists.shape[0]):
        fin = np.isfinite(dlo[t])
        assert (np.diff(dlo[t][fin]) >= 0).all()
        assert fin.sum() == abs(stops[t])
    if kind == "coherent":
        assert 0 < stops[0] < accels[1].n_chunks  # the tile culls


def _check_vs_brute(got, org, d, mesh):
    """The culled sweep against K6's plain version on the same rays: t on
    every lane, triangle and u, v on hit lanes, bit-equal."""
    ot, dt, _ = _planes(org, d)
    n = org.shape[0]
    want = [x[:n] for x in tmp.closest_tri_plain(ot, dt,
                                                 tmp.build_tri_table(mesh))]
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    hit = want[0] < BIG
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[hit].numpy(), w[hit].numpy())
        assert (g[~hit] == 0).all()  # K6's miss outputs
    return hit


def _check_vs_jax(got, want, n_excused):
    """tests/test_torch_closest_hit.py::_check_k6's bars, with every lane
    outside them counted: hit or miss, triangle, t (1e-5 relative) and u, v
    (1e-5 relative + 1e-6) agree on all but n_excused lanes."""
    t_p, i_p, u_p, v_p = (x.numpy() for x in got)
    t_j, i_j, u_j, v_j = (np.asarray(x) for x in want)
    hit = t_j < BIG

    def close(a, b, atol=0.0):
        return np.abs(a - b) <= atol + 1e-5 * np.abs(b)

    agree = np.where(hit, (i_p == i_j) & close(t_p, t_j)
                     & close(u_p, u_j, 1e-6) & close(v_p, v_j, 1e-6),
                     t_p >= BIG)
    assert (~agree).sum() <= n_excused, np.nonzero(~agree)[0]


@pytest.mark.parametrize("kind", ["random", "coherent", "surface"])
def test_culled_sweep_matches_jax_and_the_brute_sweep(meshes, accels, kind):
    org, d = _rays(kind, 2048, 11, meshes[1])
    ot, dt, valid = _planes(org, d)
    lists, dlo, stops = tma.mesh_tile_lists(ot, dt, valid, accels[1])
    ta = accels[1]
    launches = tmp.closest_tri_culled.launches
    got = tmp.closest_tri_culled(ot, dt, 2048, ta.table, ta.boxes,
                                 ta.slivers, ta.cones, ta.cone_rows, lists,
                                 dlo, stops, ta.n_glob_chunks, ta.n_chunks)
    assert tmp.closest_tri_culled.launches == launches  # the plain version
    assert got[1].dtype == torch.int32
    hit = _check_vs_brute(got, org, d, meshes[1])
    assert hit.sum() > 1000  # closed scene: nearly everything hits
    # the JAX kernel in interpret mode, on the same lists
    ja = accels[0]
    jh = jmp.intersect_mesh_culled(jnp.asarray(org), jnp.asarray(d),
                                   meshes[0], ja)
    th = tmp.intersect_mesh_culled(torch.from_numpy(org), torch.from_numpy(d),
                                   meshes[1], ta)
    jt = np.asarray(jh.t)
    j_big = np.where(np.isfinite(jt), jt, BIG)
    _check_vs_jax((torch.where(torch.isfinite(th.t), th.t, BIG), th.prim,
                   th.uv[:, 0], th.uv[:, 1]),
                  (j_big, jh.prim, jh.uv[:, 0], jh.uv[:, 1]),
                  n_excused=max(2, 2048 // 300))
    # the launcher completes the hit from the kernel's outputs
    np.testing.assert_array_equal(
        torch.where(torch.isfinite(th.t), th.t, BIG).numpy(),
        got[0].numpy())


def test_overflow_fallback_is_exact(meshes):
    """l_max far below the reachable count: every group of 32 rays tests
    the boxes of its tile's 16 listed chunks nearest-first, then of every
    local chunk (the exit bound is not met), and sweeps only the chunks
    its rays enter; still bit-equal to the brute sweep and within the JAX
    bars."""
    ta = tma.build_mesh_grid_accel(meshes[1], l_max=16)
    org, d = _rays("random", 2048, 41)
    ot, dt, valid = _planes(org, d)
    lists, dlo, stops = tma.mesh_tile_lists(ot, dt, valid, ta)
    assert (stops == -16).all()
    got, (tests, chunks, live) = tmp.closest_tri_culled_plain(
        ot, dt, 2048, ta.table, ta.boxes, ta.slivers, ta.cones,
        ta.cone_rows, lists, dlo, stops, ta.n_glob_chunks, ta.n_chunks,
        return_work=True)
    _check_vs_brute(got, org, d, meshes[1])
    # 16 listed boxes + every local chunk's box again; the global chunk
    # and the chunks the lanes enter swept, their live rows counted
    assert tests.tolist() == [16 + ta.n_chunks] * (2048 // tmp.GROUP)
    assert (chunks >= 1).all() and (chunks < 1 + tests).all()
    assert (live > 0).all()
    assert (live <= 16 * chunks + ta.slivers.shape[0]).all()
    ja = jma.build_mesh_grid_accel(meshes[0], l_max=16)
    jh = jmp.intersect_mesh_culled(jnp.asarray(org), jnp.asarray(d),
                                   meshes[0], ja)
    th = tmp.intersect_mesh_culled(torch.from_numpy(org),
                                   torch.from_numpy(d), meshes[1], ta)
    _check_vs_jax((torch.where(torch.isfinite(th.t), th.t, BIG), th.prim,
                   th.uv[:, 0], th.uv[:, 1]),
                  (np.where(np.isfinite(np.asarray(jh.t)),
                            np.asarray(jh.t), BIG),
                   jh.prim, jh.uv[:, 0], jh.uv[:, 1]), n_excused=6)


def test_ragged_tile_and_all_miss(meshes, accels):
    """A ragged last tile (3 x 1024 + 17 rays): the padding lanes neither
    vote nor come back. Rays from outside the box pointing away miss
    everything and return K6's miss outputs."""
    ta = accels[1]
    org, d = _rays("random", 3 * 1024 + 17, 51)
    got = tmp.intersect_mesh_culled(torch.from_numpy(org),
                                    torch.from_numpy(d), meshes[1], ta)
    ot, dt, valid = _planes(org, d)
    lists, dlo, stops = tma.mesh_tile_lists(ot, dt, valid, ta)
    raw = tmp.closest_tri_culled(ot, dt, org.shape[0], ta.table, ta.boxes,
                                 ta.slivers, ta.cones, ta.cone_rows, lists,
                                 dlo, stops, ta.n_glob_chunks, ta.n_chunks)
    assert raw[0].shape == (3 * 1024 + 17,)
    _check_vs_brute(raw, org, d, meshes[1])
    assert torch.equal(torch.where(torch.isfinite(got.t), got.t, BIG),
                       raw[0])
    far = np.tile(np.float32([50.0, 40.0, 1e4]), (77, 1))
    away = np.tile(np.float32([0.0, 0.0, 1.0]), (77, 1))
    ot, dt, valid = _planes(far, away)
    lists, dlo, stops = tma.mesh_tile_lists(ot, dt, valid, ta)
    miss = tmp.closest_tri_culled(ot, dt, 77, ta.table, ta.boxes,
                                  ta.slivers, ta.cones, ta.cone_rows, lists,
                                  dlo, stops, ta.n_glob_chunks, ta.n_chunks)
    assert (miss[0] == BIG).all() and (miss[1] == 0).all()
    assert (miss[2] == 0).all() and (miss[3] == 0).all()


def test_culled_wrapper_checks_its_inputs(accels):
    ta = accels[1]
    o = torch.zeros((3, 1024))
    lists = torch.zeros((1, ta.l_max), dtype=torch.int32)
    dlo = torch.zeros((1, ta.l_max))
    stops = torch.zeros((1,), dtype=torch.int32)
    args = (ta.table, ta.boxes, ta.slivers, ta.cones, ta.cone_rows, lists,
            dlo, stops, ta.n_glob_chunks, ta.n_chunks)
    tables = (ta.table, ta.boxes, ta.slivers, ta.cones, ta.cone_rows)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tmp.closest_tri_culled(o[:, :1000].contiguous(),
                               o[:, :1000].contiguous(), 10, *args)
    with pytest.raises(ValueError, match="for 1 tiles"):
        tmp.closest_tri_culled(o, o, 10, *tables, lists[:, :3], dlo, stops,
                               ta.n_glob_chunks, ta.n_chunks)
    with pytest.raises(TypeError, match="stops"):
        tmp.closest_tri_culled(o, o, 10, *tables, lists, dlo, stops.long(),
                               ta.n_glob_chunks, ta.n_chunks)
    with pytest.raises(ValueError, match="chunks of 16"):
        tmp.closest_tri_culled(o, o, 10, *tables, lists, dlo, stops,
                               ta.n_glob_chunks, ta.n_chunks + 1)


def test_render_routes_through_the_culled_sweep(meshes):
    """tests/test_mesh_accel.py::test_renderer_routes_and_matches's
    counterpart: with MESH_ACCEL_MIN_TRIS = 1 the FLAT render (render() and
    a ProgressiveRenderer, which builds the accel once) runs the culled
    wrapper and its image equals the brute route's bit for bit."""
    cam = smallpt_camera()
    cfg = RenderConfig(width=12, height=8, spp_per_cell=1, max_depth=3,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS,
                       scheduler=Scheduler.FLAT)
    mesh = meshes[1]
    calls, builds = [], []
    real_plain = tmp.closest_tri_culled_plain
    real_build = tma.build_mesh_grid_accel
    old = renderer.MESH_ACCEL_MIN_TRIS
    try:
        tmp.closest_tri_culled_plain = (
            lambda *a, **k: calls.append(1) or real_plain(*a, **k))
        tma.build_mesh_grid_accel = (
            lambda *a, **k: builds.append(1) or real_build(*a, **k))
        key = rng.base_key(7)
        img_brute = renderer.render(mesh, cam, cfg, key, device="cpu")
        assert not calls and not builds
        renderer.MESH_ACCEL_MIN_TRIS = 1
        img_accel = renderer.render(mesh, cam, cfg, key, device="cpu")
        assert calls and builds == [1]
        r = ProgressiveRenderer(mesh, cam, cfg, seed=7, device="cpu")
        n_calls = len(calls)
        r.step(2)
        assert builds == [1, 1] and len(calls) > n_calls
    finally:
        tmp.closest_tri_culled_plain = real_plain
        tma.build_mesh_grid_accel = real_build
        renderer.MESH_ACCEL_MIN_TRIS = old
    np.testing.assert_array_equal(img_brute.numpy(), img_accel.numpy())
    assert float(img_accel.max()) > 0.0
