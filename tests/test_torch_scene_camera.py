"""The PyTorch port's config, scenes, cameras and packed kernel tables
against the JAX package's: same config fields and defaults, scene arrays and
(S, 16) tables exact, camera vectors within 2 ulp, primary rays within a
few ulp."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jcfg
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import megakernel as jmk
from smallpt_tpu_torch import config as tcfg
from smallpt_tpu_torch.core import camera as tcam
from smallpt_tpu_torch.core import rng as trng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.ops import megakernel as tmk


def _plain(v):
    return v.value if hasattr(v, "value") else v


def test_config_fields_and_defaults_equal():
    jf = {f.name: f for f in dataclasses.fields(jcfg.RenderConfig)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.RenderConfig)}
    assert list(jf) == list(tf)
    j, t = jcfg.RenderConfig(), tcfg.RenderConfig()
    for name in jf:
        assert _plain(getattr(j, name)) == _plain(getattr(t, name)), name
    assert t.spp == j.spp and t.n_pixels == j.n_pixels
    for enum in ("Mode", "Filter", "CameraModel", "Scheduler", "Intersector"):
        assert ([e.value for e in getattr(jcfg, enum)]
                == [e.value for e in getattr(tcfg, enum)])


@pytest.mark.parametrize("kw", [
    dict(split_budget=3), dict(nee_lights=(1.5,)), dict(aperture=-1.0),
    dict(env_emission=(1.0, 2.0)), dict(jitter_size=0),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        jcfg.RenderConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.RenderConfig(**kw)


def test_config_coercions_match():
    j = jcfg.RenderConfig(nee_lights=(np.int64(8),), env_emission=(1, 0, 2))
    t = tcfg.RenderConfig(nee_lights=(np.int64(8),), env_emission=(1, 0, 2))
    assert j.nee_lights == t.nee_lights == (8,)
    assert type(t.nee_lights[0]) is int
    assert j.env_emission == t.env_emission == (1.0, 0.0, 2.0)
    assert t.has_env and t.spp == 4


_SCENES = ["two_sphere_scene", "cornell_box_scene",
           "cornell_box_dim_light_scene", "cornell_box_small_light_scene"]


def _arrays(scene):
    return [np.asarray(a) for a in (scene.center, scene.radius,
                                    scene.material.emission,
                                    scene.material.albedo,
                                    scene.material.refl)]


@pytest.mark.parametrize("name", _SCENES)
def test_scene_constructors_equal(name):
    for a, b in zip(_arrays(getattr(jscene, name)()),
                    _arrays(getattr(tscene, name)())):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_procedural_scene_equal_and_round_trip():
    js = jscene.procedural_sphere_scene(n=40, seed=3)
    ts = tscene.procedural_sphere_scene(n=40, seed=3)
    for a, b in zip(_arrays(js), _arrays(ts)):
        np.testing.assert_array_equal(a, b)
    back = tscene.sphere_scene_from_arrays(*[np.asarray(a) for a in (
        js.center, js.radius, js.material.emission, js.material.albedo,
        js.material.refl)])
    assert back.n_spheres == js.n_spheres == 40
    for a, b in zip(_arrays(js), _arrays(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", _SCENES + ["procedural_sphere_scene"])
@pytest.mark.parametrize("eps", [(1e-4, 5e-7), (3e-3, 2e-5)])
def test_scene_table_exact(name, eps):
    kw = {"n": 37, "seed": 1} if name.startswith("procedural") else {}
    js = getattr(jscene, name)(**kw)
    ts = tscene.sphere_scene_from_arrays(*_arrays(js))
    jc = jcfg.RenderConfig(intersect_eps=eps[0], intersect_eps_rel=eps[1])
    tc = tcfg.RenderConfig(intersect_eps=eps[0], intersect_eps_rel=eps[1])
    want = np.asarray(jmk.build_scene_table(js, jc))
    got = tmk.build_scene_table(ts, tc).numpy()
    assert got.shape == want.shape and got.shape[0] % 8 == 0
    np.testing.assert_array_equal(got, want)


def _legacy_pair():
    jc = jcam.smallpt_camera()
    tc = tcam.camera_from_arrays(
        origin=np.asarray(jc.origin), direction=np.asarray(jc.direction),
        fov_scale=np.asarray(jc.fov_scale),
        push_forward=np.asarray(jc.push_forward))
    return jc, tc


def _matrix_pair():
    jc = jcam.default_matrix_camera()
    tc = tcam.camera_from_arrays(local_to_world=np.asarray(jc.local_to_world),
                                 near_plane=np.asarray(jc.near_plane))
    return jc, tc


def _ulp_close(got, want, n_ulp):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    tol = n_ulp * np.spacing(np.maximum(np.abs(want), np.abs(got)))
    assert (np.abs(got - want) <= tol).all(), (got, want)


@pytest.mark.parametrize("wh", [(1024, 768), (48, 36), (17, 31)])
def test_camera_vec_within_2ulp(wh):
    w, h = wh
    jc, tc = _legacy_pair()
    kw = dict(width=w, height=h)
    want = jmk.build_camera_vec(
        jc, jcfg.RenderConfig(camera_model=jcfg.CameraModel.LEGACY, **kw))
    got = tmk.build_camera_vec(
        tc, tcfg.RenderConfig(camera_model=tcfg.CameraModel.LEGACY, **kw))
    assert tuple(got.shape) == (1, 16)
    _ulp_close(got.numpy(), want, 2)
    jm, tm = _matrix_pair()
    want = jmk.build_camera_vec(jm, jcfg.RenderConfig(**kw))
    got = tmk.build_camera_vec(tm, tcfg.RenderConfig(**kw))
    _ulp_close(got.numpy(), want, 2)


def test_port_cameras_equal_jax_cameras():
    jc, _ = _legacy_pair()
    tc = tcam.smallpt_camera()
    for a, b in zip(jc, tc):
        _ulp_close(b.numpy(), np.asarray(a), 1)
    jm, tm = jcam.default_matrix_camera(), tcam.default_matrix_camera()
    np.testing.assert_array_equal(tm.local_to_world.numpy(),
                                  np.asarray(jm.local_to_world))


@pytest.mark.parametrize("model,filt,aperture", [
    ("legacy", "tent", 0.0), ("matrix", "box", 0.0), ("legacy", "box", 3.0),
    ("matrix", "tent", 0.5),
])
def test_primary_rays_match(model, filt, aperture):
    kw = dict(width=12, height=8, spp_per_cell=2, aperture=aperture,
              focal_distance=90.0)
    jc_cfg = jcfg.RenderConfig(camera_model=jcfg.CameraModel(model),
                               filter=jcfg.Filter(filt), **kw)
    tc_cfg = tcfg.RenderConfig(camera_model=tcfg.CameraModel(model),
                               filter=tcfg.Filter(filt), **kw)
    jc, tc = _legacy_pair() if model == "legacy" else _matrix_pair()
    key = jax.random.PRNGKey(4)
    jidx = jcam.sample_indices(jc_cfg, jc_cfg.n_pixels)
    tidx = tcam.sample_indices(tc_cfg, tc_cfg.n_pixels)
    for a, b in zip(jidx, tidx):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sid, _, col, row, cx, cy = jidx
    u = np.array(jrng.camera_uniforms(key, sid))
    ul = np.array(jrng.lens_uniforms(key, sid))
    jo, jd = jcam.generate_rays(jc, jnp.asarray(u), jc_cfg, col, row, cx, cy,
                                u_lens=jnp.asarray(ul))
    _, _, tcol, trow, tcx, tcy = tidx
    to, td = tcam.generate_rays(tc, torch.from_numpy(u), tc_cfg, tcol, trow,
                                tcx, tcy, u_lens=torch.from_numpy(ul))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-6,
                               atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        tcam.filter_offsets(torch.from_numpy(u), tc_cfg, tcx, tcy).numpy(),
        np.asarray(jcam.filter_offsets(jnp.asarray(u), jc_cfg, cx, cy)),
        rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        trng.camera_uniforms(trng.base_key(4), tidx[0]).numpy(), u)
