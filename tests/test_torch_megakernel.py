"""The port's per-pass megakernel (ops/megakernel.py) on the CPU, where the
wrapper runs its plain PyTorch version, against the JAX package's
render_pass_megakernel in the Pallas interpreter, on the same scene, camera
and key.

Gate: tests/test_megakernel.py::_compare's — at most 2% of values with
|a-b|/(1+|b|) > 0.1, means within 5%, ray counts within max(64, 0.1%).
The two share every random stream bit for bit, so paths agree except where
float32 op ordering flips a razor-edge decision (a glass choice, a sphere
rim); each flip moves a whole sample, hence a statistical gate.
"""

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


def _port_scene(js):
    return tscene.sphere_scene_from_arrays(
        np.asarray(js.center), np.asarray(js.radius),
        np.asarray(js.material.emission), np.asarray(js.material.albedo),
        np.asarray(js.material.refl))


def _port_camera(jc):
    if isinstance(jc, jcam.MatrixCamera):
        return tcam.camera_from_arrays(
            local_to_world=np.asarray(jc.local_to_world),
            near_plane=np.asarray(jc.near_plane))
    return tcam.camera_from_arrays(
        origin=np.asarray(jc.origin), direction=np.asarray(jc.direction),
        fov_scale=np.asarray(jc.fov_scale),
        push_forward=np.asarray(jc.push_forward))


def _port_config(jc: jcfg.RenderConfig) -> tcfg.RenderConfig:
    kw = {}
    for name in jc.__dataclass_fields__:
        v = getattr(jc, name)
        kw[name] = getattr(tcfg, type(v).__name__)(v.value) if hasattr(
            v, "value") else v
    return tcfg.RenderConfig(**kw)


def _compare(cfg, js, jc, seed, frac=0.02):
    key = jrng.base_key(seed)
    ref, rays_ref = jmk.render_pass_megakernel(js, jc, cfg, key)
    img, rays = tmk.render_pass_megakernel(
        _port_scene(js), _port_camera(jc), _port_config(cfg),
        trng.base_key(seed), device="cpu")
    ref, img = np.asarray(ref), img.numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert abs(int(rays) - int(rays_ref)) <= max(64, 0.001 * int(rays_ref))
    rel = np.abs(ref - img) / (1.0 + np.abs(ref))
    assert (rel > 0.1).mean() <= frac, f"{(rel > 0.1).mean():.4f} diverge"
    assert abs(img.mean() - ref.mean()) < 0.05 * (abs(ref.mean()) + 0.1)


_LEG = dict(camera_model=jcfg.CameraModel.LEGACY, filter=jcfg.Filter.TENT)
_MAT = dict(camera_model=jcfg.CameraModel.MATRIX, filter=jcfg.Filter.BOX)

_CASES = {
    "cornell_24x16": (jcfg.RenderConfig(width=24, height=16, spp_per_cell=1,
                                        max_depth=10, **_LEG),
                      "cornell", 0),
    "two_sphere_matrix_box_16x16": (
        jcfg.RenderConfig(width=16, height=16, spp_per_cell=1, max_depth=6,
                          **_MAT), "two_sphere", 2),
    "thin_lens": (jcfg.RenderConfig(width=16, height=12, spp_per_cell=1,
                                    max_depth=8, aperture=4.0,
                                    focal_distance=120.0, **_LEG),
                  "cornell", 13),
    "env_on": (jcfg.RenderConfig(width=16, height=16, spp_per_cell=1,
                                 max_depth=6, env_emission=(0.2, 0.3, 0.4),
                                 **_MAT), "two_sphere", 3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_matches_jax_megakernel(case):
    cfg, scene, seed = _CASES[case]
    if scene == "cornell":
        js, jc = jscene.cornell_box_scene(), jcam.smallpt_camera()
    else:
        js, jc = jscene.two_sphere_scene(), jcam.default_matrix_camera()
    _compare(cfg, js, jc, seed)


_T_LEG = dict(camera_model=tcfg.CameraModel.LEGACY, filter=tcfg.Filter.TENT)


def test_row_band_equals_full_frame_slice():
    """row_offset/n_rows: a band equals the same rows of the full frame,
    exactly (keying is placement-invariant). Lane counts are multiples of
    32 so every lane takes the same vectorized CPU code path."""
    cfg = tcfg.RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                            **_T_LEG)
    scene, cam = tscene.cornell_box_scene(), tcam.smallpt_camera()
    key = trng.base_key(5)
    full, rays_full = tmk.render_pass_megakernel(scene, cam, cfg, key,
                                                 device="cpu")
    band, rays_band = tmk.render_pass_megakernel(scene, cam, cfg, key,
                                                 row_offset=6, n_rows=6,
                                                 device="cpu")
    assert tuple(band.shape) == (6, 16, 3)
    np.testing.assert_array_equal(full.numpy()[6:], band.numpy())
    assert 0 < int(rays_band) < int(rays_full)


def test_sample_slices_sum_to_full():
    """ip_offset/k_samples splits of the in-pixel sample axis sum to the
    full pass (the 'sample' mesh axis contract)."""
    cfg = tcfg.RenderConfig(width=12, height=8, spp_per_cell=1, max_depth=8,
                            **_T_LEG)
    scene, cam = tscene.cornell_box_scene(), tcam.smallpt_camera()
    key = trng.base_key(9)
    full, rays_full = tmk.render_pass_megakernel(scene, cam, cfg, key,
                                                 device="cpu")
    a, ra = tmk.render_pass_megakernel(scene, cam, cfg, key, ip_offset=0,
                                       k_samples=2, device="cpu")
    b, rb = tmk.render_pass_megakernel(scene, cam, cfg, key, ip_offset=2,
                                       k_samples=2, device="cpu")
    np.testing.assert_allclose(a.numpy() + b.numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert int(ra) + int(rb) == int(rays_full)


def test_reproducible_and_key_sensitive():
    cfg = tcfg.RenderConfig(width=8, height=8, spp_per_cell=1, max_depth=6,
                            **_T_LEG)
    scene, cam = tscene.cornell_box_scene(), tcam.smallpt_camera()
    run = lambda s: tmk.render_pass_megakernel(  # noqa: E731
        scene, cam, cfg, trng.base_key(s), device="cpu")[0].numpy()
    np.testing.assert_array_equal(run(3), run(3))
    assert not np.array_equal(run(3), run(4))


def _tables(scene, cfg):
    return (tmk.build_scene_table(scene, cfg),
            tmk.build_camera_vec(tcam.smallpt_camera(), cfg))


@pytest.mark.parametrize("bad,exc", [
    (dict(nee_lights=tuple(range(8)) * 4), ValueError),  # 32 > 31 slots
    (dict(split_budget=2), ValueError),
    (dict(mode=tcfg.Mode.NORMAL), ValueError),
])
def test_wrapper_rejects_unsupported_configs(bad, exc):
    cfg = tcfg.RenderConfig(width=8, height=8, **_T_LEG, **bad)
    table, cam = _tables(tscene.cornell_box_scene(), cfg)
    with pytest.raises(exc):
        tmk.mega_pass(table, cam, cfg, trng.base_key(0))


def test_wrapper_rejects_big_tables_and_bad_tensors():
    cfg = tcfg.RenderConfig(width=8, height=8, **_T_LEG)
    big = tscene.procedural_sphere_scene(n=tmk.MEGA_MAX_SPHERES + 1)
    table, cam = _tables(big, cfg)
    with pytest.raises(ValueError, match="at most 2048"):
        tmk.mega_pass(table, cam, cfg, trng.base_key(0))
    table, cam = _tables(tscene.cornell_box_scene(), cfg)
    with pytest.raises(TypeError):
        tmk.mega_pass(table.double(), cam, cfg, trng.base_key(0))
    with pytest.raises(ValueError):
        tmk.mega_pass(table.t(), cam, cfg, trng.base_key(0))
    with pytest.raises(ValueError):
        tmk.mega_pass(table.to("meta"), cam.to("meta"), cfg,
                      trng.base_key(0))


def test_sweep_skips_table_padding():
    """n_spheres: the sweep visits the scene's rows only. Cornell's 9
    spheres pad to 16 rows; sweeping 9 gives the padded sweep's image and
    rays exactly, and a count past the table or the limit raises."""
    cfg = tcfg.RenderConfig(width=8, height=4, spp_per_cell=1, max_depth=6,
                            **_T_LEG)
    scene = tscene.cornell_box_scene()
    table, cam = _tables(scene, cfg)
    assert table.shape[0] == 16 and scene.n_spheres == 9
    key = trng.base_key(4)
    want = tmk.mega_pass(table, cam, cfg, key)
    got = tmk.mega_pass(table, cam, cfg, key, n_spheres=scene.n_spheres)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="17"):
        tmk.mega_pass(table, cam, cfg, key, n_spheres=17)
    big = tscene.procedural_sphere_scene(n=tmk.MEGA_MAX_SPHERES + 1)
    table, cam = _tables(big, cfg)
    with pytest.raises(ValueError, match="at most 2048"):
        tmk.mega_pass(table, cam, cfg, key, n_spheres=big.n_spheres)


def test_cpu_tensors_run_plain_and_count_no_launch():
    cfg = tcfg.RenderConfig(width=8, height=4, spp_per_cell=1, max_depth=4,
                            **_T_LEG)
    table, cam = _tables(tscene.cornell_box_scene(), cfg)
    before = tmk.mega_pass.launches
    rad, rays = tmk.mega_pass(table, cam, cfg, trng.base_key(1))
    assert tmk.mega_pass.launches == before
    k0, k1 = trng.key_words(trng.base_key(1))
    want, want_rays = tmk.render_pass_plain(table, cam, cfg, k0, k1)
    assert rad.dtype == torch.float32 and tuple(rad.shape) == (32, 3)
    assert rays.dtype == torch.int32 and tuple(rays.shape) == (32,)
    np.testing.assert_array_equal(rad.numpy(), want.numpy())
    np.testing.assert_array_equal(rays.numpy(), want_rays.numpy())


def test_launch_args_layout():
    """The integer and float launch arguments the kernel reads by position
    (csrc/megakernel.cu's IP_*/FP_* enums): 20 ints and 31 light slots, 7
    floats; the key words travel as their uint32 bit patterns."""
    cfg = tcfg.RenderConfig(width=64, height=48, spp_per_cell=2,
                            max_depth=12, env_emission=(1.0, 2.0, 3.0),
                            aperture=2.0, nee_lights=(8, 3), **_T_LEG)
    ints, floats = tmk._launch_args(cfg, 64 * 48, 16, 2467461003,
                                    3840466878, 4, 8, 3)
    assert ints.dtype == np.int32 and ints.shape == (20 + 31,)
    assert ints[20:].tolist() == [8, 3] + [0] * 29
    assert floats.dtype == np.float32 and floats.shape == (7,)
    named = dict(zip(tmk._IP_NAMES, ints.view(np.uint32).tolist()))
    assert named["k0"] == 2467461003 and named["k1"] == 3840466878
    assert named["max_it"] == 3 * 12 and named["spp"] == 8
    assert named["tent"] == 1 and named["matrix"] == 0
    assert named["has_env"] == 1 and named["row_offset"] == 8
    assert named["n_lights"] == 2
    stream_ints, _ = tmk._launch_args(cfg, 8192, 16, 0, 0, 0, 0, 0,
                                      max_it=10_000_000)
    assert dict(zip(tmk._IP_NAMES, stream_ints))["max_it"] == 10_000_000
    np.testing.assert_array_equal(
        floats, np.float32([1.5, 0.05, 2.0, 100.0, 1.0, 2.0, 3.0]))
