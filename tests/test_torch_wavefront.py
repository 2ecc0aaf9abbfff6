"""The port's FLAT and REGEN wavefront schedulers (ops/wavefront.py) and
their routes (engine/renderer.py, engine/progressive.py, cli.py) against
the JAX package, its f64 numpy oracle and the stored goldens, on the CPU.
The closest-hit kernels run as their plain versions here.

Gates:
- bounce_step, one step from the same state and key as the JAX package's
  bounce_step: alive, depth, hist and the suppression bits bit-equal on
  every lane whose hit did not move (a different winner, or a hit-point
  gap beyond the JAX suite's t bar, 5e-3 * max(t, 1); in a split budget
  group, the whole group); there, origins within that t bar, directions,
  throughputs and radiance within 1e-4 relative, except lanes whose NEE
  shadow ray changed its verdict (at most 2%);
- images against the goldens under tests/test_golden.py's gates (at most
  5% of values off by more than 10% at Cornell 48x36, 2% elsewhere; means
  within 5%); against the oracle under tests/test_render_parity.py's and
  tests/test_nee_mesh.py's gates; REGEN against the megakernel's plain
  version on the same key under tests/test_megakernel.py::_compare's gate
  (2% of values, means within 5%, rays within max(64, 0.1%));
- INST_ID through the ids: the colour hash _int2color within 2^-7 of the
  JAX package's (it multiplies sin by 43758.5453, so a 1-ulp sin moves it
  by one ulp of the product, 2^-8 below 65536), and the image against the
  JAX package's hash of its own first hits to that tolerance per sample,
  except razor flips (2%).
"""

import dataclasses
import enum
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import renderer as jrenderer
from smallpt_tpu.ops import intersect as jisect
from smallpt_tpu.ops import wavefront as jwf
from smallpt_tpu.oracle.numpy_oracle import Oracle, PrecomputedUniformProvider
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.ops import intersect as tisect
from smallpt_tpu_torch.ops import intersect_pallas as tip
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.ops import mesh_pallas as tmp
from smallpt_tpu_torch.ops import wavefront as twf
from smallpt_tpu_torch.utils import image as img_io

DATA = os.path.join(os.path.dirname(__file__), "data")
LEG = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
PALLAS, JAX = Intersector.PALLAS, Intersector.JAX
REGEN, FLAT, MEGA = Scheduler.REGEN, Scheduler.FLAT, Scheduler.MEGA


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(cfg: RenderConfig):
    """The JAX package's RenderConfig with the port config's values."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


def _gate(img, ref, max_frac, max_mean=0.05):
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    assert np.isfinite(img).all()
    assert frac <= max_frac, f"{frac:.4f} of values diverge >10%"
    assert abs(img.mean() - ref.mean()) < max_mean * (abs(ref.mean()) + 0.1)
    return frac


# -- one bounce against the JAX package's ------------------------------------

def _state(rng_, lanes, budget, aim=None):
    """A random path state: origins in the Cornell box, unit directions
    (toward ``aim`` (centre, radius) when given), random throughput,
    radiance, depth 0-7 (0-2 with a budget), NEE suppression bits; every
    slot-0 lane alive, other slots alive at random."""
    o = rng_.uniform([5, 5, 20], [95, 75, 150], (lanes, 3))
    if aim is None:
        d = rng_.normal(size=(lanes, 3))
    else:
        d = (np.asarray(aim[0]) + rng_.uniform(-aim[1], aim[1], (lanes, 3))
             - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    slot0 = (np.arange(lanes) % budget) == 0
    return dict(
        org=o.astype(np.float32), dir=d.astype(np.float32),
        weight=rng_.uniform(0.2, 1.0, (lanes, 3)).astype(np.float32),
        depth=rng_.integers(0, 3 if budget > 1 else 8, lanes).astype(
            np.int32),
        hist=np.zeros(lanes, np.int32),
        alive=slot0 | (rng_.random(lanes) < 0.4),
        radiance=rng_.uniform(0, 1, (lanes, 3)).astype(np.float32),
        suppress=rng_.integers(0, 2, lanes).astype(np.int32))


_SMALL_MESH = dict(n_balls=2, subdiv_longitude=3, seed=1)

_BOUNCE = {
    # budget 1 with NEE on the small light and an environment light
    "b1_nee_env": ("small_light", 1, dict(nee_lights=(8,),
                                          env_emission=(0.2, 0.3, 0.4)),
                   None),
    # budget 8 with rays aimed at the glass sphere, most of which split
    "b8_split": ("cornell", 8, {}, ((73.0, 16.5, 78.0), 12.0)),
    # a mesh scene with NEE on its ceiling light quad (instance 6)
    "b1_mesh_nee": ("mesh", 1, dict(nee_lights=(6,)), None),
}


@pytest.mark.parametrize("case", sorted(_BOUNCE))
def test_bounce_step_matches_jax(case):
    scene_name, budget, kw, aim = _BOUNCE[case]
    if scene_name == "mesh":
        js = jscene.procedural_mesh_scene(**_SMALL_MESH)
        ts = tscene.procedural_mesh_scene(**_SMALL_MESH)
        jfn = lambda o, d: jisect.intersect_mesh(o, d, js)  # noqa: E731
        tfn = lambda o, d: tisect.intersect_mesh(o, d, ts)  # noqa: E731
    else:
        js, ts = ((jscene.cornell_box_small_light_scene(),
                   tscene.cornell_box_small_light_scene())
                  if scene_name == "small_light" else
                  (jscene.cornell_box_scene(), tscene.cornell_box_scene()))
        jfn = lambda o, d: jisect.intersect_spheres(o, d, js)  # noqa: E731
        tfn = lambda o, d: tisect.intersect_spheres(o, d, ts)  # noqa: E731
    cfg = RenderConfig(width=8, height=8, split_budget=budget, scheduler=FLAT,
                       max_depth=12, **LEG, **kw)
    jc = _jax_config(cfg)
    lanes = 512
    st = _state(np.random.default_rng(5), lanes, budget, aim)
    sids = (np.arange(lanes) // budget).astype(np.int32)
    jstate = jwf.PathState(**{k: jnp.asarray(v) for k, v in st.items()})
    tstate = twf.PathState(**{k: torch.from_numpy(np.array(v))
                              for k, v in st.items()})
    jnee = tnee = None
    if cfg.nee_lights:
        jnee = jrenderer._nee_scene_for(js, jc, jrenderer._mesh_nee_for(js, jc))
        tnee = renderer._nee_scene_for(ts, cfg,
                                       renderer._mesh_nee_for(ts, cfg))
    out_j = jwf.bounce_step(jstate, jfn, js.material, jc, jrng.base_key(3),
                            jnp.asarray(sids), nee_scene=jnee)
    out_t = twf.bounce_step(tstate, tfn, ts.material, cfg, rng.base_key(3),
                            torch.from_numpy(sids), nee_scene=tnee)
    out_j = {k: np.asarray(v) for k, v in out_j._asdict().items()}
    out_t = {k: v.numpy() for k, v in out_t._asdict().items()}

    # lanes whose own hit moved: another winner, or t beyond the bar
    hj = jfn(jnp.asarray(st["org"]), jnp.asarray(st["dir"]))
    ht = tfn(torch.from_numpy(st["org"]), torch.from_numpy(st["dir"]))
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    fin = np.isfinite(tj) & np.isfinite(tt)
    gap = np.where(fin, np.abs(np.where(fin, tj - tt, 0.0)), 0.0)
    moved = ((np.isfinite(tj) != np.isfinite(tt))
             | (np.asarray(hj.inst) != ht.inst.numpy())
             | (gap > 5e-3 * np.maximum(np.where(fin, tj, 1.0), 1.0)))
    moved = np.repeat(moved.reshape(-1, budget).any(axis=1), budget)
    keep = ~moved
    assert keep.mean() > 0.9
    for k in ("alive", "depth", "hist"):
        np.testing.assert_array_equal(out_t[k][keep], out_j[k][keep])
    if budget > 1:
        assert (out_t["hist"] > 0).sum() > 20  # splits happened
    assert out_t["alive"].sum() > lanes // 4
    live = keep & out_t["alive"]
    tbar = 5e-3 * np.maximum(np.where(np.isfinite(tt), tt, 1.0), 1.0) + 1e-3
    assert (np.abs(out_t["org"] - out_j["org"])[live].max(axis=1)
            <= tbar[live]).all()
    close = lambda k: np.isclose(out_t[k], out_j[k], rtol=1e-4,  # noqa: E731
                                 atol=1e-5).all(axis=1)
    for k in ("dir", "weight"):
        assert close(k)[live].all(), k
    np.testing.assert_array_equal(out_t["suppress"][keep],
                                  out_j["suppress"][keep])
    # radiance: a shadow ray may change its verdict on a near-grazing path
    assert close("radiance")[keep].mean() >= 0.98


# -- images ------------------------------------------------------------------

_GOLDENS = {
    "cornell48_regen_pallas": ("golden_cornell_48x36", "cornell", dict(
        width=48, height=36, spp_per_cell=4, max_depth=24, scheduler=REGEN,
        intersector=PALLAS), 7, 0.05),
    "cornell48_flat_jax": ("golden_cornell_48x36", "cornell", dict(
        width=48, height=36, spp_per_cell=4, max_depth=24, scheduler=FLAT,
        intersector=JAX), 7, 0.05),
    "nee32_regen_jax": ("golden_nee_smalllight_32x24", "small_light", dict(
        width=32, height=24, spp_per_cell=2, max_depth=16, nee_lights=(8,),
        scheduler=REGEN, intersector=JAX), 11, 0.02),
    "nee32_flat_pallas": ("golden_nee_smalllight_32x24", "small_light", dict(
        width=32, height=24, spp_per_cell=2, max_depth=16, nee_lights=(8,),
        scheduler=FLAT, intersector=PALLAS), 11, 0.02),
    "dof32_regen_pallas": ("golden_dof_32x24", "cornell", dict(
        width=32, height=24, spp_per_cell=2, max_depth=12, aperture=4.0,
        focal_distance=120.0, scheduler=REGEN, intersector=PALLAS), 13,
        0.02),
    "mesh32_flat_pallas": ("golden_mesh_32x24", "mesh60", dict(
        width=32, height=24, spp_per_cell=2, max_depth=10, scheduler=FLAT,
        intersector=PALLAS), 19, 0.02),
}

_SCENES = {
    "cornell": tscene.cornell_box_scene,
    "small_light": tscene.cornell_box_small_light_scene,
    "mesh60": lambda: tscene.procedural_mesh_scene(60, seed=3),
}


@pytest.mark.parametrize("case", sorted(_GOLDENS))
def test_wavefront_matches_golden(case):
    name, scene, kw, seed, frac = _GOLDENS[case]
    data = np.load(os.path.join(DATA, f"{name}.npz"))
    cfg = RenderConfig(**LEG, **kw)
    assert (int(data["width"]), int(data["height"])) == (cfg.width,
                                                         cfg.height)
    img = renderer.render(_SCENES[scene](), smallpt_camera(), cfg,
                          rng.base_key(seed), device="cpu").numpy()
    _gate(img, data["image"], frac)


def _oracle(jscene_, cfg, seed):
    jc = _jax_config(cfg)
    key = jrng.base_key(seed)
    return Oracle(jscene_, jcam.smallpt_camera(), jc,
                  PrecomputedUniformProvider(key, cfg.n_pixels * cfg.spp)
                  ).render()


@pytest.mark.parametrize("intersector", [JAX, PALLAS])
def test_splitting_matches_oracle(intersector):
    """tests/test_render_parity.py::test_cornell_parity_with_splitting's
    config and gate (3% of values, mean abs diff below 0.2, means within
    15%): refraction splitting at depth <= 2 into an 8-lane budget."""
    cfg = RenderConfig(width=10, height=10, spp_per_cell=1, split_budget=8,
                       split_depth=2, max_depth=12, intersector=intersector,
                       **LEG)
    img = renderer.render(tscene.cornell_box_scene(), smallpt_camera(), cfg,
                          rng.base_key(3), device="cpu").numpy()
    oimg = _oracle(jscene.cornell_box_scene(), cfg, 3)
    diff = np.abs(img - oimg)
    assert ((diff / (1.0 + np.abs(oimg))) > 0.1).mean() <= 0.03
    assert diff.mean() < 0.2
    assert abs(img.mean() - oimg.mean()) < 0.15 * (abs(oimg.mean()) + 0.1)


@pytest.mark.parametrize("mode,intersector", [
    (Mode.NORMAL, PALLAS), (Mode.EMISSION, JAX), (Mode.UV, PALLAS),
    (Mode.INST_ID, JAX), (Mode.INST_ID, PALLAS)])
def test_aov_modes_match_reference(mode, intersector):
    """The four AOV modes through REGEN. Against the oracle
    (tests/test_render_parity.py's AOV tests): NORMAL with the reference's
    unflipped normals under the 2% gate; EMISSION exact to 1e-5 on 98% of
    values; UV within 5e-3 on 98% (u circularly). INST_ID through the ids:
    against the JAX package's own first hits of the same camera samples,
    hashed by its _int2color, per sample within the hash's 2^-7 on 98% of
    values (the oracle's f64 hash differs from any f32 one)."""
    kw = dict(flip_normals=False) if mode == Mode.NORMAL else {}
    cfg = RenderConfig(width=12, height=12, spp_per_cell=1, mode=mode,
                       max_depth=4, scheduler=REGEN, intersector=intersector,
                       **LEG, **kw)
    seed = {Mode.NORMAL: 4, Mode.EMISSION: 6, Mode.UV: 5,
            Mode.INST_ID: 6}[mode]
    img = renderer.render(tscene.cornell_box_scene(), smallpt_camera(), cfg,
                          rng.base_key(seed), device="cpu").numpy()
    if mode == Mode.INST_ID:
        jc = _jax_config(cfg)
        sid, _, col, row, cx, cy = jcam.sample_indices(jc, cfg.n_pixels)
        o, d = jcam.generate_rays(
            jcam.smallpt_camera(),
            jrng.camera_uniforms(jrng.base_key(seed), sid), jc, col, row, cx,
            cy)
        hit = jisect.intersect_spheres(o, d, jscene.cornell_box_scene())
        ref = np.where(np.asarray(hit.valid)[:, None],
                       np.asarray(jwf._int2color(hit.prim, jnp.float32)), 0)
        ref = ref.reshape(cfg.n_pixels, cfg.spp, 3).sum(1).reshape(img.shape)
        assert (np.abs(img - ref) <= 2.0 ** -7 * cfg.spp).mean() > 0.98
        assert 0 < np.abs(img).max() <= cfg.spp
        return
    oimg = _oracle(jscene.cornell_box_scene(), cfg, seed)
    if mode == Mode.NORMAL:
        _gate(img, oimg, 0.02)
        assert np.abs(img).max() <= cfg.spp + 1e-3
    elif mode == Mode.EMISSION:
        assert np.isclose(img, oimg, rtol=1e-5, atol=1e-5).mean() > 0.98
        assert img.max() > 1.0
    else:
        img, oimg = img / cfg.spp, oimg / cfg.spp
        assert img[..., :2].max() > 0.1
        du = np.abs(img[..., 0] - oimg[..., 0])
        assert (np.minimum(du, 1.0 - du) < 5e-3).mean() > 0.98
        assert (np.abs(img[..., 1] - oimg[..., 1]) < 5e-3).mean() > 0.98


def test_int2color_matches_jax():
    ids = np.arange(0, 4000, dtype=np.int32)  # up to procedural mesh sizes
    got = twf._int2color(torch.from_numpy(ids), torch.float32).numpy()
    want = np.asarray(jwf._int2color(jnp.asarray(ids), jnp.float32))
    d = np.abs(got - want)
    d = np.minimum(d, np.abs(1.0 - d))  # fract wraps near an integer
    assert d.max() <= 2.0 ** -7, d.max()


@pytest.mark.parametrize("intersector", [JAX, PALLAS])
def test_mesh_nee_matches_oracle(intersector):
    """tests/test_nee_mesh.py::test_mesh_nee_oracle_parity's scene, config
    and gate (3% of values, means within 10%): triangle area-light NEE on
    the ceiling quad (instance 6) through FLAT."""
    cfg = RenderConfig(width=12, height=10, spp_per_cell=1, max_depth=8,
                       nee_lights=(6,), scheduler=FLAT,
                       intersector=intersector, **LEG)
    img = renderer.render(tscene.procedural_mesh_scene(**_SMALL_MESH),
                          smallpt_camera(), cfg, rng.base_key(0),
                          device="cpu").numpy()
    oimg = _oracle(jscene.procedural_mesh_scene(**_SMALL_MESH), cfg, 0)
    _gate(img, oimg, 0.03, max_mean=0.1)
    assert img.mean() > 0.01


def test_regen_matches_the_megakernel_on_one_key():
    """REGEN and the megakernel share their sample streams bit for bit
    (tests/test_megakernel.py::_compare, the other way round): the REGEN
    image and rays against the megakernel's plain version on one key."""
    cfg = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=10,
                       **LEG)
    scene, cam = tscene.cornell_box_scene(), smallpt_camera()
    key = rng.base_key(0)
    for intersector in (JAX, PALLAS):
        img, rays = renderer.render_with_stats(
            scene, cam, cfg.replace(scheduler=REGEN, intersector=intersector),
            key, device="cpu")
        ref, ref_rays = tmk.render_pass_megakernel(scene, cam, cfg, key,
                                                   device="cpu")
        _gate(img.numpy(), ref.numpy(), 0.02)
        assert abs(int(rays) - int(ref_rays)) <= max(64, 0.001 * int(ref_rays))
        assert rays.dtype == torch.int64


# -- routing -------------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Counts of the closest-hit plain versions and the two wavefront
    loops."""
    calls = {"k2": 0, "k6": 0, "regen": 0, "flat": 0, "mega": 0}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[key] += 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    spy(tip, "closest_hit_plain", "k2")
    spy(tmp, "closest_tri_plain", "k6")
    spy(twf, "run_wavefront_regen", "regen")
    spy(twf, "run_wavefront", "flat")
    spy(renderer, "render_pass_megakernel", "mega")
    return calls


_TINY = RenderConfig(width=6, height=4, spp_per_cell=1, max_depth=3, **LEG)
_ROUTES = {
    # (scene, config changes) -> (loop, kernel or None)
    "mega_cornell": ("cornell", {}, "mega", None),
    "aov_regen_jax": ("cornell", dict(mode=Mode.NORMAL), "regen", None),
    "regen_pallas": ("cornell", dict(scheduler=REGEN, intersector=PALLAS),
                     "regen", "k2"),
    "regen_big_spheres": ("p2049", dict(scheduler=REGEN,
                                        intersector=PALLAS), "regen", "k2"),
    "aov_big_spheres_nee": ("p2049", dict(mode=Mode.NORMAL,
                                          nee_lights=(8,)), "regen", None),
    "flat_jax": ("cornell", dict(scheduler=FLAT), "flat", None),
    "split_pallas": ("cornell", dict(split_budget=2, intersector=PALLAS),
                     "flat", "k2"),
    "mesh_mega_pallas": ("mesh", dict(intersector=PALLAS), "regen", "k6"),
    "mesh_flat_jax": ("mesh", dict(scheduler=FLAT), "flat", None),
}


@pytest.mark.parametrize("case", sorted(_ROUTES))
def test_routing_follows_the_jax_package(case, spies):
    scene_name, kw, loop, kernel = _ROUTES[case]
    scene = {"cornell": tscene.cornell_box_scene,
             "p2049": lambda: tscene.procedural_sphere_scene(2049),
             "mesh": lambda: tscene.procedural_mesh_scene(1, seed=0)}[
        scene_name]()
    cfg = _TINY.replace(**kw)
    jc = _jax_config(cfg)
    jsc = {"cornell": jscene.cornell_box_scene,
           "p2049": lambda: jscene.procedural_sphere_scene(2049),
           "mesh": lambda: jscene.procedural_mesh_scene(1, seed=0)}[
        scene_name]()
    # the JAX package's own predicates on the same config
    want = ("mega" if jrenderer._use_mega(jsc, jc, False) else
            "regen" if jrenderer._use_regen(jc, False) else "flat")
    assert not jrenderer._use_binned(jsc, jc, False)
    assert renderer._route(scene, cfg, False) == want == loop
    img, rays = renderer.render_with_stats(scene, smallpt_camera(), cfg,
                                           rng.base_key(1), device="cpu")
    assert img.shape == (4, 6, 3) and int(rays) > 0
    assert spies[loop] == 1
    others = {"regen", "flat", "mega"} - {loop}
    assert all(spies[k] == 0 for k in others)
    if kernel:
        assert spies[kernel] > 0
    assert spies["k2" if kernel == "k6" else "k6"] == 0
    if kernel is None:
        assert spies["k2"] == spies["k6"] == 0


@pytest.mark.parametrize("case,match", [
    ("differentiable", "item 8"), ("float64", "float32 only"),
])
def test_unported_routes_raise_citing_their_item(case, match, monkeypatch):
    """Both cases raised until they were ported. The differentiable case
    raised citing item 8 until the flat loop became differentiable: now
    render(differentiable=True) runs run_wavefront(differentiable=True)
    through the hybrid intersector, whose image is the forward flat
    pass's. float64 raised citing "float32 only" until the CPU's float64
    route: now it renders on the CPU (tests/test_torch_float64.py holds it
    to the oracle) and only the card refuses it, with that reason."""
    scene, cfg = tscene.cornell_box_scene(), _TINY
    if case == "differentiable":
        seen = []
        real = twf.run_wavefront

        def spy(*a, **k):
            seen.append(k.get("differentiable"))
            return real(*a, **k)

        monkeypatch.setattr(twf, "run_wavefront", spy)
        img = renderer.render(scene, smallpt_camera(), cfg, rng.base_key(0),
                              differentiable=True, device="cpu")
        ref = renderer.render(scene, smallpt_camera(),
                              cfg.replace(scheduler=FLAT), rng.base_key(0),
                              device="cpu")
        assert seen == [True, False]
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        return
    cfg = cfg.replace(dtype="float64")
    img = renderer.render(scene, smallpt_camera(), cfg, rng.base_key(0),
                          device="cpu")
    assert img.dtype == torch.float64 and torch.isfinite(img).all()
    r = ProgressiveRenderer(scene, smallpt_camera(), cfg, device="cpu")
    assert r.route == "regen" and r.accum.dtype == torch.float64
    with pytest.raises(NotImplementedError, match=match):
        renderer.render(scene, smallpt_camera(), cfg, rng.base_key(0))
    with pytest.raises(NotImplementedError, match=match):
        ProgressiveRenderer(scene, smallpt_camera(), cfg)


def test_mesh_accel_route_runs(monkeypatch):
    """The grid-culled mesh sweep (K7; once a refusal citing item 10): with
    MESH_ACCEL_MIN_TRIS at 64, a 78-triangle mesh through
    Intersector.PALLAS renders through the culled wrapper, per pass and
    through a ProgressiveRenderer, and the image equals the brute sweep's
    (K6) bit for bit."""
    scene = tscene.procedural_mesh_scene(1, seed=0)
    cfg = _TINY.replace(intersector=PALLAS)
    key = rng.base_key(0)
    brute = renderer.render(scene, smallpt_camera(), cfg, key, device="cpu")
    brute_pass = ProgressiveRenderer(scene, smallpt_camera(), cfg,
                                     device="cpu")
    brute_pass.step()
    calls = []
    real = tmp.closest_tri_culled_plain
    monkeypatch.setattr(tmp, "closest_tri_culled_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(renderer, "MESH_ACCEL_MIN_TRIS", 64)
    culled = renderer.render(scene, smallpt_camera(), cfg, key, device="cpu")
    assert calls
    np.testing.assert_array_equal(culled.numpy(), brute.numpy())
    r = ProgressiveRenderer(scene, smallpt_camera(), cfg, device="cpu")
    n = len(calls)
    r.step()
    assert len(calls) > n
    np.testing.assert_array_equal(r.image, brute_pass.image)


def test_progressive_builds_the_kernel_table_once(monkeypatch):
    """A wavefront ProgressiveRenderer builds its K2 table when it is made,
    never per pass or per bounce; its passes equal render_image's."""
    builds = []
    real = renderer.build_sphere_table
    monkeypatch.setattr(renderer, "build_sphere_table",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    cfg = _TINY.replace(scheduler=REGEN, intersector=PALLAS, max_depth=6)
    scene, cam = tscene.cornell_box_scene(), smallpt_camera()
    r = ProgressiveRenderer(scene, cam, cfg, seed=3, device="cpu")
    assert r.route == "regen" and builds == [1]
    r.step(2)
    assert builds == [1] and r.stats.passes == 2 and r.stats.rays > 0
    want = renderer.render_image(scene, cam, cfg, seed=3, n_passes=2,
                                 device="cpu")
    np.testing.assert_allclose(r.image, want.numpy(), rtol=1e-6)


# -- the CLI -----------------------------------------------------------------

_CLI = ["--width", "12", "--height", "8", "--max-depth", "4", "--device",
        "cpu", "--quiet"]


def test_cli_scheduler_and_intersector_flags(tmp_path):
    out = str(tmp_path / "r.ppm")
    assert cli.main(["4", *_CLI, "--scheduler", "regen", "--intersector",
                     "pallas", "--out", out]) == 0
    cfg = RenderConfig(width=12, height=8, max_depth=4, scheduler=REGEN,
                       intersector=PALLAS, **LEG)
    r = ProgressiveRenderer(tscene.cornell_box_scene(), smallpt_camera(),
                            cfg, device="cpu")
    r.step()
    np.testing.assert_array_equal(img_io.read_ppm(out),
                                  img_io.to_int(r.image[::-1]))
    for extra in (["--split-budget", "2"], ["--mode", "normal"],
                  ["--mode", "uv", "--scheduler", "flat"],
                  ["--mode", "inst_id"], ["--mode", "emission"]):
        assert cli.main(["4", *_CLI, *extra, "--out", out]) == 0


def test_cli_mesh_scenes(tmp_path, monkeypatch):
    out = str(tmp_path / "m.ppm")
    # the debug triangle: matrix camera, box filter, the plain route
    assert cli.main(["4", *_CLI, "--scene", "triangle", "--mode", "normal",
                     "--out", out]) == 0
    assert img_io.read_ppm(out).max() > 0
    monkeypatch.setitem(cli.SCENES, "mesh",
                        lambda: tscene.procedural_mesh_scene(1, seed=0))
    calls = []
    real = tmp.closest_tri_plain
    monkeypatch.setattr(tmp, "closest_tri_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--scheduler", "flat",
                     "--out", out]) == 0
    assert calls  # 78 triangles: the kernel route by default
    # full transport without --scheduler, and --streaming: the mesh
    # streaming routes (once refusals citing item 10), through K6 too
    n = len(calls)
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--out", out]) == 0
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--streaming", "--out",
                     out]) == 0
    assert len(calls) > n and img_io.read_ppm(out).max() > 0
    with pytest.raises(SystemExit):
        cli.main(["4", *_CLI, "--scene", "mesh", "--scheduler", "flat",
                  "--nee", "99", "--out", out])


def test_cli_big_sphere_scenes_take_the_binned_route(tmp_path, monkeypatch):
    """The JAX CLI sends big sphere scenes in full transport to its binned
    renderer whatever the scheduler, and so does the port's
    (BinnedProgressiveRenderer, run in tests/test_torch_binned.py); an AOV
    mode stays per pass."""
    monkeypatch.setitem(cli.SCENES, "procedural",
                        lambda: tscene.procedural_sphere_scene(2049))

    class Routed(Exception):
        pass

    def binned(*a, **k):
        raise Routed

    monkeypatch.setattr(cli, "BinnedProgressiveRenderer", binned)
    for sched in ("mega", "regen"):
        with pytest.raises(Routed):
            cli.main(["4", *_CLI, "--scene", "procedural", "--scheduler",
                      sched, "--out", str(tmp_path / "p.ppm")])
    assert cli.main(["4", *_CLI, "--scene", "procedural", "--mode", "normal",
                     "--scheduler", "regen", "--intersector", "pallas",
                     "--out", str(tmp_path / "p.ppm")]) == 0
