"""Next-event estimation in the port's megakernel body, per pass and
streaming, on the CPU (the plain PyTorch version), against the JAX package
and the stored f64 golden image.

- Per pass, against tests/data/golden_nee_smalllight_32x24.npz (seed 11,
  spp_per_cell 2, max_depth 16) under tests/test_golden.py's gate: at most
  2% of values with |a-b|/(1+|b|) > 0.1, mean within 5%.
- Per pass, against JAX render_pass_megakernel with NEE (Pallas
  interpreter) under tests/test_nee.py::test_nee_megakernel_matches_regen's
  gate: at most 1% divergent, means within 2%.
- Streaming, against JAX stream_step with NEE at 16x12: two partial
  launches and a drain, under test_torch_streaming.py's state gate.
"""

import os

import numpy as np
import pytest

from smallpt_tpu import config as jcfg
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.ops import megakernel as jmk
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng as trng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, cornell_box_small_light_scene,
)
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.renderer import render
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.utils import image as img_io

from test_torch_streaming import LAUNCHES, _jax_run, _state_gate

DATA = os.path.join(os.path.dirname(__file__), "data")
_LEG = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
_JLEG = dict(camera_model=jcfg.CameraModel.LEGACY, filter=jcfg.Filter.TENT)


def _gate(img, ref, max_frac, mean_tol):
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert (rel > 0.1).mean() <= max_frac, f"{(rel > 0.1).mean():.4f}"
    assert abs(img.mean() - ref.mean()) < mean_tol * (ref.mean() + 0.1)


def test_per_pass_nee_matches_golden():
    data = np.load(os.path.join(DATA, "golden_nee_smalllight_32x24.npz"))
    assert (int(data["width"]), int(data["height"])) == (32, 24)
    cfg = RenderConfig(width=32, height=24, spp_per_cell=2, max_depth=16,
                       nee_lights=(8,), **_LEG)
    img = render(cornell_box_small_light_scene(), smallpt_camera(), cfg,
                 trng.base_key(11), device="cpu").numpy()
    _gate(img, data["image"], 0.02, 0.05)


def test_per_pass_nee_matches_jax_megakernel():
    jc = jcfg.RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=8,
                           nee_lights=(8,), **_JLEG)
    ref, rays_ref = jmk.render_pass_megakernel(
        jscene.cornell_box_small_light_scene(), jcam.smallpt_camera(), jc,
        jrng.base_key(0))
    cfg = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=8,
                       nee_lights=(8,), **_LEG)
    img, rays = tmk.render_pass_megakernel(
        cornell_box_small_light_scene(), smallpt_camera(), cfg,
        trng.base_key(0), device="cpu")
    _gate(img.numpy(), np.asarray(ref), 0.01, 0.02)
    assert abs(int(rays) - int(rays_ref)) <= max(64, 0.001 * int(rays_ref))


def test_streaming_nee_matches_jax():
    jc = jcfg.RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                           nee_lights=(8,), **_JLEG)
    chain = _jax_run(jc, jscene.cornell_box_small_light_scene(), 0, LAUNCHES)
    cfg = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                       nee_lights=(8,), **_LEG)
    scene = cornell_box_small_light_scene()
    table = tmk.build_scene_table(scene, cfg)
    cam = tmk.build_camera_vec(smallpt_camera(), cfg)
    f, i = tmk.init_stream_state(cfg, device="cpu")
    for (budget, n_iters), (jf, ji, jrays) in zip(LAUNCHES, chain):
        _, _, rays = tmk.stream_step(table, cam, cfg, trng.base_key(0), f, i,
                                     budget, n_iters, n_spheres=9)
        assert abs(int(rays) - jrays) <= max(64, 0.001 * jrays)
        _state_gate(jf, ji, f, i, drained=n_iters == LAUNCHES[-1][1])


def test_nee_moves_the_image_and_counts_shadow_rays():
    """NEE on the Cornell light changes the per-lane estimate (the shadow
    rays add light, the suppression bits take the BSDF-sampled light hits
    away) but not the ray count of the paths; the plain version counts one
    shadow ray per sampled light at a surviving diffuse vertex."""
    cfg = RenderConfig(width=8, height=6, spp_per_cell=1, max_depth=8, **_LEG)
    scene = cornell_box_scene()
    table = tmk.build_scene_table(scene, cfg)
    cam = tmk.build_camera_vec(smallpt_camera(), cfg)
    k0, k1 = trng.key_words(trng.base_key(3))
    plain, rays = tmk.render_pass_plain(table, cam, cfg, k0, k1, n_spheres=9)
    counts = {}
    nee, nee_rays = tmk.render_pass_plain(
        table, cam, cfg.replace(nee_lights=(8,)), k0, k1, n_spheres=9,
        counts=counts)
    np.testing.assert_array_equal(rays.numpy(), nee_rays.numpy())
    assert not np.array_equal(plain.numpy(), nee.numpy())
    assert 0 < counts["shadow_rays"] < int(rays.sum())
    assert counts["iterations"] > 0


@pytest.mark.parametrize("lights,match", [
    (tuple(range(9)) * 3 + (0, 1, 2, 3, 4), "at most 31"),
    ((9,), "out of range"),
])
def test_wrapper_rejects_bad_lights(lights, match):
    cfg = RenderConfig(width=8, height=4, nee_lights=lights, **_LEG)
    table = tmk.build_scene_table(cornell_box_scene(), cfg)
    cam = tmk.build_camera_vec(smallpt_camera(), cfg)
    with pytest.raises(ValueError, match=match):
        tmk.mega_pass(table, cam, cfg, trng.base_key(0), n_spheres=9)


_CLI = ["--scene", "cornell_small_light", "--width", "16", "--height", "12",
        "--max-depth", "8", "--seed", "4", "--device", "cpu", "--quiet"]


@pytest.mark.parametrize("streaming", [False, True])
def test_cli_nee(streaming, tmp_path):
    """--nee 8 per pass and streaming: the file holds the renderer's
    image, exactly."""
    out = str(tmp_path / "n.ppm")
    argv = ["8", "--nee", "8", *_CLI, "--out", out]
    assert cli.main(argv + (["--streaming"] if streaming else [])) == 0
    cfg = RenderConfig(width=16, height=12, spp_per_cell=2, max_depth=8,
                       nee_lights=(8,), **_LEG)
    args = (cornell_box_small_light_scene(), smallpt_camera(), cfg)
    if streaming:
        r = StreamingRenderer(*args, seed=4, device="cpu")
        r.step(n_iters=1_000_000, add_samples=8)
        r.flush()
    else:
        r = ProgressiveRenderer(*args, seed=4, device="cpu")
        r.step()
    np.testing.assert_array_equal(img_io.read_ppm(out),
                                  img_io.to_int(r.image[::-1]))


def test_cli_nee_checks_the_lights(tmp_path, capsys):
    out = str(tmp_path / "n.ppm")
    with pytest.raises(SystemExit):
        cli.main(["4", "--nee", "9", *_CLI, "--out", out])
    assert "out of range (scene has 9 spheres)" in capsys.readouterr().err
    assert cli.main(["4", "--nee", "0", *_CLI, "--out", out]) == 0
    assert "--nee light 0 has zero emission" in capsys.readouterr().err
