"""The port's entry points end to end on the CPU: render, ProgressiveRenderer
and the CLI at 48x36 against the stored f64 golden image
(tests/data/golden_cornell_48x36.npz, made by scripts/gen_goldens.py), and
the rules of the slice: entry points run on the card unless asked for the
CPU, and every config outside the slice raises NotImplementedError.

Gate (tests/test_golden.py): at most 5% of values with
|img-golden|/(1+|golden|) > 0.1 and the means within 5%. The golden shares
render()'s key streams (base_key(7)), so render() is compared value for
value. ProgressiveRenderer keys its first pass with fold_in(base_key(7), 0),
so its image is held to the golden's mean and, exactly, to render() with
that key; the CLI's file is held exactly to ProgressiveRenderer's image.
"""

import os

import numpy as np
import pytest
import torch

from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import cornell_box_scene, procedural_sphere_scene
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.renderer import (
    render, render_image, render_with_stats,
)
from smallpt_tpu_torch.utils import image as img_io

DATA = os.path.join(os.path.dirname(__file__), "data")
CFG = RenderConfig(width=48, height=36, spp_per_cell=4, max_depth=24,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(DATA, "golden_cornell_48x36.npz"))
    assert (int(data["width"]), int(data["height"])) == (48, 36)
    return data["image"]


def _mean_ok(img, golden):
    return abs(img.mean() - golden.mean()) < 0.05 * (golden.mean() + 0.1)


def test_render_matches_golden(golden):
    img = render(cornell_box_scene(), smallpt_camera(), CFG, rng.base_key(7),
                 device="cpu").numpy()
    rel = np.abs(img - golden) / (1.0 + np.abs(golden))
    frac = (rel > 0.1).mean()
    assert frac <= 0.05, f"{frac:.4f} of values diverge >10%"
    assert _mean_ok(img, golden)


def test_progressive_and_cli_end_to_end(golden, tmp_path):
    scene, cam = cornell_box_scene(), smallpt_camera()
    r = ProgressiveRenderer(scene, cam, CFG, seed=7, device="cpu")
    r.step()
    assert r.sample_count == 1 and r.stats.passes == 1
    want, rays = render_with_stats(scene, cam, CFG,
                                   rng.fold_in(rng.base_key(7), 0),
                                   device="cpu")
    np.testing.assert_array_equal(r.accum.numpy(), want.numpy())
    assert r.stats.rays == int(rays) > CFG.n_pixels * CFG.spp
    img = r.image
    np.testing.assert_allclose(img, want.numpy() / CFG.spp, rtol=1e-6)
    assert np.isfinite(img).all() and _mean_ok(img * CFG.spp, golden)

    out = tmp_path / "c.ppm"
    rc = cli.main(["16", "--scene", "cornell", "--width", "48", "--height",
                   "36", "--max-depth", "24", "--seed", "7", "--device",
                   "cpu", "--quiet", "--out", str(out)])
    assert rc == 0
    got = img_io.read_ppm(str(out))
    assert got.shape == (36, 48, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, img_io.to_int(img[::-1]))

    r.reset_accumulation()
    assert r.sample_count == 0 and float(r.accum.abs().sum()) == 0.0


def test_image_writers_round_trip(tmp_path):
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    for name, writer in (("a.ppm", img_io.write_ppm),
                         ("b.p6.ppm", img_io.write_ppm_binary)):
        writer(str(tmp_path / name), img)
        np.testing.assert_array_equal(img_io.read_ppm(str(tmp_path / name)),
                                      img_io.to_int(img[::-1]))
    img_io.write_png(str(tmp_path / "c.png"), img)
    assert (tmp_path / "c.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_render_image_keys_passes_like_jax():
    cfg = RenderConfig(width=8, height=4, spp_per_cell=1, max_depth=4,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    scene, cam = cornell_box_scene(), smallpt_camera()
    mean = render_image(scene, cam, cfg, seed=3, n_passes=2, device="cpu")
    base = rng.base_key(3)
    want = sum(render(scene, cam, cfg, rng.fold_in(base, p), device="cpu")
               for p in range(2)) / (2 * cfg.spp)
    np.testing.assert_allclose(mean.numpy(), want.numpy(), rtol=1e-6)


def test_progressive_builds_pass_inputs_once(monkeypatch):
    """ProgressiveRenderer builds the scene table and the camera vector once,
    when it is made; each step is one mega_pass on them, sweeping the
    scene's spheres and not the table's padding."""
    from smallpt_tpu_torch.engine import progressive, renderer

    cfg = RenderConfig(width=8, height=4, spp_per_cell=1, max_depth=4,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    scene, cam = cornell_box_scene(), smallpt_camera()
    builds, sweeps = [], []
    build = renderer.build_scene_table
    monkeypatch.setattr(renderer, "build_scene_table",
                        lambda *a: builds.append(1) or build(*a))
    real_pass = progressive.mega_pass

    def counting_pass(*a, **kw):
        sweeps.append(kw["n_spheres"])
        return real_pass(*a, **kw)

    monkeypatch.setattr(progressive, "mega_pass", counting_pass)
    r = ProgressiveRenderer(scene, cam, cfg, seed=3, device="cpu")
    r.step(3)
    assert builds == [1] and sweeps == [scene.n_spheres] * 3
    want = render_image(scene, cam, cfg, seed=3, n_passes=3, device="cpu")
    np.testing.assert_array_equal(r.image, want.numpy())
    assert r.stats.passes == 3 and r.stats.rays > 0


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(0)
    for call in (
        lambda: render(scene, cam, CFG, key),
        lambda: render_with_stats(scene, cam, CFG, key),
        lambda: render_image(scene, cam, CFG),
        lambda: ProgressiveRenderer(scene, cam, CFG),
        lambda: cli.main(["--quiet", "--out", str(tmp_path / "x.ppm")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "x.ppm").exists()


@pytest.mark.parametrize("kw", [
    dict(scheduler=Scheduler.REGEN), dict(scheduler=Scheduler.FLAT),
    dict(split_budget=2), dict(mode=Mode.NORMAL), dict(mode=Mode.UV),
    dict(mode=Mode.INST_ID), dict(dtype="float64"),
])
def test_unported_configs_raise(kw):
    cfg = RenderConfig(width=8, height=8, **kw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        render(cornell_box_scene(), smallpt_camera(), cfg, rng.base_key(0),
               device="cpu")


def test_unported_scenes_and_gradients_raise():
    cfg = RenderConfig(width=8, height=8)
    key = rng.base_key(0)
    with pytest.raises(NotImplementedError, match="above 2048 spheres"):
        render(procedural_sphere_scene(n=2049), smallpt_camera(), cfg, key,
               device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        render(object(), smallpt_camera(), cfg, key, device="cpu")
    with pytest.raises(NotImplementedError, match="differentiable"):
        render(cornell_box_scene(), smallpt_camera(), cfg, key, device="cpu",
               differentiable=True)


@pytest.mark.parametrize("flag", [["--frames", "f_%04d.ppm"], ["--binned"],
                                  ["--interactive"],
                                  ["--checkpoint", "ck.npz"]])
def test_cli_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(flag + ["--device", "cpu", "--out", str(tmp_path / "x.ppm")])
