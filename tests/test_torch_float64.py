"""dtype="float64" on the CPU (the JAX package's x64 route for parity with
its float64 oracle) against smallpt_tpu/oracle/numpy_oracle.py, not against
JAX with x64 switched on inside a shared pytest worker.

- REGEN, FLAT (and MEGA, which falls through to REGEN), refraction
  splitting, an AOV mode and the mesh stream render their path state,
  camera, BSDF and intersection in float64: each passes
  tests/test_render_parity.py::_compare's gate (tests/test_mesh_stream.py's
  oracle gate for the stream), and its mean absolute difference from the
  oracle is below the float32 image's on the same key.
- The kernel-only streams keep their float32 state, as the JAX package's
  do under x64 (measured in a separate process: its StreamingRenderer
  returns the float32 sums in float64, its BinnedStreamingRenderer in
  float32).
- float64 on the card raises (the kernels compute in float32 only).
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.oracle.numpy_oracle import (
    Oracle, PrecomputedUniformProvider, StreamUniformProvider,
)
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.mesh_stream import WavefrontStreamingRenderer
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.ops import intersect_pallas as tip
from smallpt_tpu_torch.utils.device import check_dtype

LEG = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(cfg: RenderConfig):
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


def _compare(img, oimg, max_frac_div, mean_tol):
    """tests/test_render_parity.py::_compare's gate."""
    diff = np.abs(img - oimg)
    rel = diff / (1.0 + np.abs(oimg))
    assert np.isfinite(img).all()
    assert (rel > 0.1).mean() <= max_frac_div, (rel > 0.1).mean()
    assert diff.mean() < mean_tol, diff.mean()
    assert abs(img.mean() - oimg.mean()) < 0.15 * (abs(oimg.mean()) + 0.1)


# test_render_parity.py's configs and gates: (config, seed, max_frac_div,
# mean_tol, the route the float64 config takes)
CASES = {
    "regen_full": (dict(width=16, height=16, max_depth=16,
                        scheduler=Scheduler.REGEN), 0, 0.02, 0.2, "regen"),
    "mega_falls_to_regen": (dict(width=16, height=16, max_depth=16), 0,
                            0.02, 0.2, "regen"),
    "flat_full": (dict(width=16, height=16, max_depth=16,
                       scheduler=Scheduler.FLAT), 2, 0.02, 0.2, "flat"),
    "splitting": (dict(width=10, height=10, split_budget=8, split_depth=2,
                       max_depth=12), 3, 0.03, 0.2, "flat"),
    "normal_aov": (dict(width=12, height=12, mode=Mode.NORMAL,
                        flip_normals=False), 4, 0.02, 0.05, "regen"),
    "kernel_route_pallas": (dict(width=12, height=12, max_depth=10,
                                 scheduler=Scheduler.REGEN,
                                 intersector=Intersector.PALLAS), 1, 0.02,
                            0.2, "regen"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_matches_oracle_closer_than_float32(case):
    kw, seed, frac, tol, route = CASES[case]
    cfg = RenderConfig(spp_per_cell=1, dtype="float64", **LEG, **kw)
    scene, cam = tscene.cornell_box_scene(), smallpt_camera()
    assert renderer._route(scene, cfg, False) == route
    img64 = renderer.render(scene, cam, cfg, rng.base_key(seed),
                            device="cpu")
    assert img64.dtype == torch.float64
    img32 = renderer.render(scene, cam, cfg.replace(dtype="float32"),
                            rng.base_key(seed), device="cpu")
    key = jrng.base_key(seed)
    oimg = Oracle(jscene.cornell_box_scene(), jcam.smallpt_camera(),
                  _jax_config(cfg.replace(dtype="float32")),
                  PrecomputedUniformProvider(key, cfg.n_pixels * cfg.spp)
                  ).render()
    _compare(img64.numpy(), oimg, frac, tol)
    d64 = np.abs(img64.numpy() - oimg).mean()
    d32 = np.abs(img32.numpy().astype(np.float64) - oimg).mean()
    assert d64 < d32, (d64, d32)


def test_mesh_stream_float64_matches_oracle_closer_than_float32():
    """The mesh stream's state, camera, BSDF and intersection in float64
    (the JAX package's stream state takes the config's dtype): the f64
    oracle replaying the streaming decisions (StreamUniformProvider) under
    tests/test_mesh_stream.py's gate, closer than the float32 stream.
    With triangle-light NEE and the environment light, whose shading reads
    the hit geometry (without them this scene's values are its emitters'
    exactly in both dtypes)."""
    mesh = dict(n_balls=2, subdiv_longitude=3, seed=1)
    cfg = RenderConfig(width=12, height=10, spp_per_cell=1, max_depth=8,
                       dtype="float64", nee_lights=(6,),
                       env_emission=(0.1, 0.15, 0.25), **LEG)
    out = {}
    for dt in ("float64", "float32"):
        r = WavefrontStreamingRenderer(tscene.procedural_mesh_scene(**mesh),
                                       smallpt_camera(),
                                       cfg.replace(dtype=dt), seed=0,
                                       device="cpu")
        r.step(n_bounces=24, add_samples=cfg.spp)
        r.flush()
        rad, w = r.accumulators()
        assert rad.dtype == getattr(torch, dt) and (w == cfg.spp).all()
        out[dt] = rad.numpy().astype(np.float64)
    jcfg = _jax_config(cfg.replace(dtype="float32"))
    sids = np.arange(cfg.n_pixels * cfg.spp, dtype=np.int64)
    oimg = Oracle(jscene.procedural_mesh_scene(**mesh), jcam.smallpt_camera(),
                  jcfg, StreamUniformProvider(jrng.base_key(0), jcfg, sids)
                  ).render()
    rel = np.abs(out["float64"] - oimg) / (1.0 + np.abs(oimg))
    assert (rel > 0.1).mean() <= 0.03
    assert abs(out["float64"].mean() - oimg.mean()) < 0.1 * (
        abs(oimg.mean()) + 0.1)
    d64 = np.abs(out["float64"] - oimg).mean()
    d32 = np.abs(out["float32"] - oimg).mean()
    assert d64 < d32, (d64, d32)


def test_kernel_route_takes_float32_rays_and_gives_float64_t():
    """K2's plain version takes the float64 rays rounded to float32 and t
    comes back in float64, the hit point computed in float64 from it (the
    JAX package's intersect_spheres_pallas)."""
    scene = tscene.cornell_box_scene(torch.float64)
    r = np.random.default_rng(2)
    o = torch.from_numpy(r.uniform([5, 5, 20], [95, 75, 150], (64, 3)))
    d = torch.from_numpy(r.normal(size=(64, 3)))
    d = d / d.norm(dim=1, keepdim=True)
    h = tip.intersect_spheres_pallas(o, d, scene)
    assert h.t.dtype == torch.float64 and h.x.dtype == torch.float64
    table, perm, nbc, nsc = tip.build_sphere_table(scene)
    t32, slot = tip.closest_hit_plain(o.float().T.contiguous(),
                                      d.float().T.contiguous(), table,
                                      64 * nbc, 64 * nsc)
    np.testing.assert_array_equal(h.t.numpy(), t32.double().numpy())
    np.testing.assert_array_equal(h.inst.numpy(),
                                  perm[slot.long()].numpy())
    np.testing.assert_allclose(h.x.numpy(), (o + h.t[:, None] * d).numpy())


def test_kernel_only_streams_keep_float32_state():
    """StreamingRenderer (classic and DDA) and BinnedStreamingRenderer at
    float64 trace their kernels' float32 state, as the JAX package's do
    under x64: the same sums as float32, in float64 for the stream and in
    float32 for the binned renderer."""
    base = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                        **LEG)
    for scene, budget in ((tscene.cornell_box_scene(), 3),
                          (tscene.procedural_sphere_scene(2100), 2)):
        sums = {}
        for dt in ("float32", "float64"):
            r = StreamingRenderer(scene, smallpt_camera(),
                                  base.replace(dtype=dt), device="cpu")
            r.step(n_iters=32, add_samples=budget)
            r.flush()
            sums[dt] = r.accumulators()
            assert sums[dt][0].dtype == getattr(torch, dt)
            assert r.image.dtype == getattr(np, dt)
        for a, b in zip(sums["float32"], sums["float64"]):
            np.testing.assert_array_equal(a.double().numpy(), b.numpy())
    sums = {}
    for dt in ("float32", "float64"):
        r = BinnedStreamingRenderer(tscene.procedural_sphere_scene(80, seed=3),
                                    smallpt_camera(), base.replace(dtype=dt),
                                    device="cpu")
        r.step(add_samples=2, n_bounces=6)
        r.flush()
        sums[dt] = r.accumulators()
        assert sums[dt][0].dtype == torch.float32
    for a, b in zip(sums["float32"], sums["float64"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_float64_on_the_card_raises(monkeypatch):
    """Every entry point refuses float64 on the card (device None means
    CUDA), before it looks for one; other dtypes raise everywhere."""
    cfg = RenderConfig(width=8, height=8, dtype="float64", **LEG)
    with pytest.raises(NotImplementedError, match="float32 only"):
        check_dtype(cfg, "cuda")
    check_dtype(cfg, "cpu")
    check_dtype(cfg.replace(dtype="float32"), None)
    with pytest.raises(NotImplementedError, match="float16"):
        check_dtype(cfg.replace(dtype="float16"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    scene, cam = tscene.cornell_box_scene(), smallpt_camera()
    for call in (
            lambda: renderer.render(scene, cam, cfg, rng.base_key(0)),
            lambda: renderer.render_image(scene, cam, cfg),
            lambda: ProgressiveRenderer(scene, cam, cfg),
            lambda: StreamingRenderer(scene, cam, cfg),
            lambda: BinnedStreamingRenderer(
                tscene.procedural_sphere_scene(80, seed=3), cam, cfg),
            lambda: WavefrontStreamingRenderer(
                tscene.procedural_mesh_scene(n_balls=2), cam, cfg)):
        with pytest.raises(NotImplementedError, match="float32 only"):
            call()
