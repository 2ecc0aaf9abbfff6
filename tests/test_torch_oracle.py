"""The port's float64 oracle (smallpt_tpu_torch/oracle/numpy_oracle.py)
against the JAX package's (smallpt_tpu/oracle/numpy_oracle.py), on the CPU:

- the providers' uniforms bit for bit, each against its JAX twin (classic
  and streaming keying, split histories, NEE slots 0 and 1, the lens);
- Oracle.render bit for bit (np.array_equal) on one machine: Cornell 8x6 at
  4 spp, each AOV mode, the unflipped normals, NEE on the small light, the
  environment light, the thin lens, splitting, the MATRIX camera with the
  BOX filter, a small procedural mesh with triangle NEE, and
  StreamUniformProvider on a few pixels of procedural_sphere_scene(2100,
  seed=7), where the sphere screen drops most spheres;
- the sphere screen alone equal to the full scalar loop on rays built at its
  edges: tangent rays, origins inside a sphere, roots within a few ulp of
  eps, twin spheres;
- the streaming keying, with and without NEE: StreamingRenderer's plain
  version at 2 spp replayed by StreamUniformProvider under the Cornell gate
  (what lets chip_smoke.py's oracle_stream_cornell_1024x768_nee carry NEE);
- chip_smoke.py::oracle_gate on REGEN through K2's plain version, and
  uniforms_card_vs_cpu run on the CPU (the wiring of the card's oracle_*
  phases).
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import chip_smoke
from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.oracle import numpy_oracle as jo
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import camera as pcam
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core import scene as pscene
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.oracle import numpy_oracle as po

LEG = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
_SMALL_MESH = dict(n_balls=2, subdiv_longitude=3, seed=1)


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


def _draws(provider, sids, hists, depths=range(6), slots=(0, 1)):
    return chip_smoke.provider_draws(provider, sids, hists, depths, slots)


# -- the providers ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["per_sample", "precomputed", "stream"])
def test_providers_equal_the_jax_providers(kind):
    """Every method of each provider gives the JAX provider's bits: camera,
    lens, shade and NEE (slots 0 and 1) at depths 0-5, split histories 0-2
    on the classic keying, on a few hundred sids (spp 4, so that the
    streaming words (pixel, ip) differ from the classic sid)."""
    cfg = RenderConfig(width=40, height=30, jitter_size=2, spp_per_cell=1,
                       **LEG)
    seed = 5
    rs = np.random.default_rng(0)
    sids = np.sort(rs.choice(cfg.n_pixels * cfg.spp, 300, replace=False))
    jkey, pkey = jrng.base_key(seed), prng.base_key(seed)
    hists = (0, 1, 2)
    if kind == "per_sample":
        sids, hists = sids[:12], (0, 2)
        jmake = jo.JaxUniformProvider
        pmake = lambda k: po.UniformProvider(k, device="cpu")  # noqa: E731
    elif kind == "precomputed":
        jmake = lambda k: jo.PrecomputedUniformProvider(k, sids=sids)  # noqa
        pmake = lambda k: po.PrecomputedUniformProvider(  # noqa: E731
            k, sids=sids, device="cpu")
    else:
        hists = (0,)
        jmake = lambda k: jo.StreamUniformProvider(  # noqa: E731
            k, _jax_config(cfg), sids)
        pmake = lambda k: po.StreamUniformProvider(  # noqa: E731
            k, cfg, sids, device="cpu")
    got = pmake(pkey)
    a, b = _draws(got, sids, hists), _draws(jmake(jkey), sids, hists)
    assert a.dtype == np.float64 and a.size == b.size
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64))
    # a seed is taken as the key it names
    assert np.array_equal(_draws(pmake(seed), sids[:4], (0,)),
                          _draws(got, sids[:4], (0,)))


def test_stream_provider_refuses_a_split_history():
    cfg = RenderConfig(width=4, height=4, **LEG)
    p = po.StreamUniformProvider(0, cfg, np.arange(4), device="cpu")
    with pytest.raises(NotImplementedError):
        p.shade(0, 1, 0)
    with pytest.raises(NotImplementedError):
        p.nee(0, 2, 0, 0)


# -- Oracle.render against the JAX oracle -------------------------------------

def _cornell(**kw):
    return (jscene.cornell_box_scene, pscene.cornell_box_scene,
            jcam.smallpt_camera, pcam.smallpt_camera,
            {**dict(width=8, height=6, spp_per_cell=1, max_depth=12, **LEG),
             **kw})


_AOV = dict(width=12, height=12, jitter_size=1, max_depth=4)

RENDER_CASES = {
    "cornell_8x6_4spp": _cornell(),
    "normal": _cornell(mode=Mode.NORMAL, flip_normals=False, **_AOV),
    "uv": _cornell(mode=Mode.UV, **_AOV),
    "emission": _cornell(mode=Mode.EMISSION, **_AOV),
    "inst_id": _cornell(mode=Mode.INST_ID, **_AOV),
    "unflipped_normals": _cornell(flip_normals=False, jitter_size=1),
    "nee_small_light": (jscene.cornell_box_small_light_scene,
                        pscene.cornell_box_small_light_scene,
                        jcam.smallpt_camera, pcam.smallpt_camera,
                        dict(width=8, height=6, jitter_size=1, max_depth=12,
                             nee_lights=(8,), **LEG)),
    "env_light": _cornell(env_emission=(0.4, 0.5, 0.6), jitter_size=1),
    "thin_lens": _cornell(aperture=4.0, focal_distance=120.0,
                          jitter_size=1),
    "split": _cornell(split_budget=8, split_depth=2, jitter_size=1),
    "matrix_box": (jscene.two_sphere_scene, pscene.two_sphere_scene,
                   jcam.default_matrix_camera, pcam.default_matrix_camera,
                   dict(width=8, height=8, jitter_size=2, max_depth=12,
                        camera_model=CameraModel.MATRIX,
                        filter=Filter.BOX)),
    "mesh_nee": (lambda: jscene.procedural_mesh_scene(**_SMALL_MESH),
                 lambda: pscene.procedural_mesh_scene(**_SMALL_MESH),
                 jcam.smallpt_camera, pcam.smallpt_camera,
                 dict(width=6, height=5, jitter_size=1, max_depth=8,
                      nee_lights=(6,), **LEG)),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_equals_the_jax_oracle(case):
    jmake, pmake, jcmake, pcmake, kw = RENDER_CASES[case]
    cfg = RenderConfig(**kw)
    n = cfg.n_pixels * cfg.spp
    want = jo.Oracle(jmake(), jcmake(), _jax_config(cfg),
                     jo.PrecomputedUniformProvider(jrng.base_key(3), n)
                     ).render()
    got = po.Oracle(pmake(), pcmake(), cfg, po.PrecomputedUniformProvider(
        prng.base_key(3), n, device="cpu")).render()
    assert np.abs(want).max() > 0
    assert np.array_equal(got, want)


def test_stream_keyed_pixels_of_a_dense_scene_equal_the_jax_oracle():
    """tests/test_golden.py's binned gate configuration (512x384, 1 spp,
    procedural_sphere_scene(2100, seed=7), StreamUniformProvider) on 8 of
    its pixels: the screened sphere loop against the JAX oracle's full
    loop, bit for bit, the screen keeping a few of the 2,100 spheres."""
    cfg = RenderConfig(width=512, height=384, jitter_size=1, spp_per_cell=1,
                       max_depth=12, **LEG)
    pixels = np.arange(0, cfg.n_pixels, 1051, dtype=np.int64)[40:160:15]
    key = 21
    want = jo.Oracle(jscene.procedural_sphere_scene(2100, seed=7),
                     jcam.smallpt_camera(), _jax_config(cfg),
                     jo.StreamUniformProvider(jrng.base_key(key),
                                              _jax_config(cfg), pixels)
                     ).render_pixels(pixels)
    oracle = po.Oracle(pscene.procedural_sphere_scene(2100, seed=7),
                       pcam.smallpt_camera(), cfg,
                       po.StreamUniformProvider(key, cfg, pixels,
                                                device="cpu"))
    kept = []
    screen = oracle._screen
    oracle._screen = lambda o, d: kept.append(len(screen(o, d))) or screen(
        o, d)
    got = oracle.render_pixels(pixels)
    assert want.max() > 0
    assert np.array_equal(got, want)
    assert len(kept) > 20 and max(kept) < 100


# -- the sphere screen against the full scalar loop ---------------------------

def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _perp(rs, d):
    p = np.cross(d, _unit(rs, len(d)))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _edge_scene(rs, twins: bool):
    """40 spheres, radii from 0.01 to 1e5 (log-uniform), centres within
    100 of the origin; with twins, sphere 2k+1 repeats sphere 2k exactly
    or one float32 ulp larger."""
    n = 40
    center = rs.uniform(-100, 100, (n, 3))
    radius = 10.0 ** rs.uniform(-2, 5, n)
    if twins:
        center[1::2] = center[0::2]
        r32 = radius[0::2].astype(np.float32)
        radius[1::2] = np.where(rs.random(n // 2) < 0.5, r32,
                                np.nextafter(r32, np.float32(np.inf)))
    zeros = np.zeros((n, 3))
    return pscene.sphere_scene_from_arrays(center, radius, zeros, zeros + 0.5,
                                           np.zeros(n, np.int32))


def _edge_rays(kind, oracle, rs):
    """(origins, directions) at one edge of the sphere test, built around
    each sphere of the scene in float64."""
    c, r = oracle.center, oracle.radius
    n = len(r)
    d = _unit(rs, n)
    eps = np.maximum(oracle.config.intersect_eps,
                     oracle.config.intersect_eps_rel * r)
    if kind == "tangent":
        # o + t d grazes the sphere: det within a few ulp of 0
        s = rs.uniform(-2, 3, n)[:, None] * r[:, None]
        o = c + r[:, None] * _perp(rs, d) - s * d
        ks = np.arange(-3, 4)[:, None, None]
        o = o[None] + ks * np.spacing(np.abs(o))[None] * _perp(rs, d)[None]
        return o.reshape(-1, 3), np.tile(d, (len(ks), 1))
    if kind == "inside":
        f = np.concatenate([rs.uniform(0, 0.99, n), 1 - 2.0 ** -rs.integers(
            30, 52, n)])[:, None]
        o = np.tile(c, (2, 1)) + f * np.tile(r[:, None], (2, 1)) * _unit(
            rs, 2 * n)
        return o, np.tile(d, (2, 1))
    if kind == "root_at_eps":
        # the near root (entering) or the far root (leaving from just
        # inside) within a few ulp of the sphere's eps
        nrm = _unit(rs, n)
        x = c + r[:, None] * nrm
        din = -np.sign((d * nrm).sum(1))[:, None] * d       # entering
        os_, ds = [], []
        for k in range(-3, 4):
            t0 = eps + k * np.spacing(eps)
            os_ += [x - t0[:, None] * din, x + t0[:, None] * din]
            ds += [din, -din]
        return np.concatenate(os_), np.concatenate(ds)
    assert kind == "twins"
    o = rs.uniform(-300, 300, (4 * n, 3))
    aim = np.tile(c, (4, 1)) + rs.normal(size=(4 * n, 3)) * np.tile(
        r[:, None], (4, 1))
    dd = aim - o
    return o, dd / np.linalg.norm(dd, axis=1, keepdims=True)


@pytest.mark.parametrize("kind", ["tangent", "inside", "root_at_eps",
                                  "twins"])
def test_screen_equals_the_full_loop(kind):
    rs = np.random.default_rng(["tangent", "inside", "root_at_eps",
                                "twins"].index(kind))
    scene = _edge_scene(rs, twins=kind == "twins")
    cfg = RenderConfig(width=4, height=4, **LEG)
    oracle = po.Oracle(scene, pcam.smallpt_camera(), cfg,
                       po.UniformProvider(0, device="cpu"))
    full = po.Oracle(scene, pcam.smallpt_camera(), cfg,
                     po.UniformProvider(0, device="cpu"))
    every = list(range(len(oracle.radius)))
    full._screen = lambda o, d: every
    origins, dirs = _edge_rays(kind, oracle, rs)
    hits = dropped = 0
    for o, d in zip(origins, dirs):
        got, want = oracle.intersect(o, d), full.intersect(o, d)
        assert got == want and type(got[1]) is type(want[1]), (o, d)
        hits += want[1] >= 0
        dropped += len(oracle._screen(o, d)) < len(every)
    # the edge is reached: rays hit, and the screen decides for most
    assert hits > len(origins) // 8
    assert dropped > len(origins) // 2


def test_screen_keeps_a_non_finite_ray_whole():
    cfg = RenderConfig(width=4, height=4, **LEG)
    oracle = po.Oracle(pscene.cornell_box_scene(), pcam.smallpt_camera(),
                       cfg, po.UniformProvider(0, device="cpu"))
    o = np.array([50.0, 40.0, 80.0])
    assert oracle._screen(o, np.array([np.nan, 0.0, 1.0])) == list(range(9))
    assert oracle.intersect(o, np.array([np.nan, 0.0, 1.0]))[1] == -1


# -- the streaming keying, and the card phases' wiring ------------------------

def _gate(img, ref, max_frac):
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    assert np.isfinite(img).all()
    assert frac <= max_frac, frac
    assert abs(img.mean() - ref.mean()) < 0.1 * (abs(ref.mean()) + 0.1)
    return rel


@pytest.mark.parametrize("nee", [(), (8,)], ids=["no_nee", "nee"])
def test_stream_keying_replays_the_streaming_renderer(nee):
    """StreamingRenderer's plain version (the classic stream, K1c's plain
    version) at 16x12 with a budget of 2 samples (ip 0 and 1, so that the
    streaming words differ from the classic sid), against the oracle with
    StreamUniformProvider: the Cornell gate of oracle_stream_cornell_*, and
    most values path for path to 1e-3. With NEE this is what lets the
    card's oracle_stream_cornell_1024x768_nee phase carry NEE."""
    cfg = RenderConfig(width=16, height=12, jitter_size=1, spp_per_cell=2,
                       max_depth=12, nee_lights=nee, **LEG)
    scene = pscene.cornell_box_scene()
    r = StreamingRenderer(scene, pcam.smallpt_camera(), cfg,
                          seed=chip_smoke.ORACLE_SEED, device="cpu")
    r.step(n_iters=cfg.max_depth + 16, add_samples=cfg.spp)
    r.flush()
    rad, w = r.accumulators()
    assert bool((w == cfg.spp).all())
    pixels = np.arange(cfg.n_pixels)
    sids = (pixels[:, None] * cfg.spp + np.arange(cfg.spp)).reshape(-1)
    ovals = po.Oracle(scene, pcam.smallpt_camera(), cfg,
                      po.StreamUniformProvider(chip_smoke.ORACLE_SEED, cfg,
                                               sids, device="cpu")
                      ).render_pixels(pixels)
    rel = _gate(rad.numpy().reshape(-1, 3), ovals, chip_smoke.ORACLE_MAX_FRAC)
    assert (rel < 1e-3).mean() > 0.95


def test_oracle_gate_holds_regen_through_k2_plain():
    """chip_smoke.py::oracle_gate, the card phases' gate, on the port's own
    CPU render: REGEN through K2's plain version (Intersector.PALLAS) of
    the Cornell box at 32x24, 1 spp, jitter 1, max_depth 12, key 21, every
    3rd pixel, classic keying, under the Cornell gate; the same image
    scaled by 1.3 fails it. Then uniforms_card_vs_cpu's comparison, run
    with the CPU on both sides."""
    cfg = RenderConfig(width=32, height=24, jitter_size=1, spp_per_cell=1,
                       max_depth=12, scheduler=Scheduler.REGEN,
                       intersector=Intersector.PALLAS, **LEG)
    scene, cam = pscene.cornell_box_scene(), pcam.smallpt_camera()
    key = prng.base_key(chip_smoke.ORACLE_SEED)
    img = renderer.render(scene, cam, cfg, key, device="cpu").numpy()
    out = chip_smoke.oracle_gate(img, scene, cam, cfg, key, 3, False,
                                 chip_smoke.ORACLE_MAX_FRAC, "cpu")
    assert out["pixels"] == 256 and out["keying"] == "classic"
    assert out["frac_div"] <= chip_smoke.ORACLE_MAX_FRAC
    with pytest.raises(AssertionError, match="image gate failed"):
        chip_smoke.oracle_gate(img * 1.3, scene, cam, cfg, key, 3, False,
                               chip_smoke.ORACLE_MAX_FRAC, "cpu")
    drawn = chip_smoke.uniforms_card_vs_cpu(
        key, cfg.replace(max_depth=3), np.arange(0, cfg.n_pixels, 97),
        "cpu")
    assert drawn["precomputed"]["equal"] and drawn["stream"]["sids"] == 8
