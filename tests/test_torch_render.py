"""The port's entry points end to end on the CPU: render, ProgressiveRenderer
and the CLI at 48x36 against the stored f64 golden image
(tests/data/golden_cornell_48x36.npz, made by scripts/gen_goldens.py), and
the rules of the port: entry points run on the card unless asked for the
CPU, and float64 renders on the CPU only (NotImplementedError on the
card).

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


def test_render_matches_golden_dof():
    """The thin lens against its golden (tests/test_golden.py::
    test_golden_dof): aperture 4, focus 120, seed 13; at most 2% of values
    diverge, means within 5%."""
    data = np.load(os.path.join(DATA, "golden_dof_32x24.npz"))
    cfg = RenderConfig(width=32, height=24, spp_per_cell=2, max_depth=12,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       aperture=4.0, focal_distance=120.0)
    img = render(cornell_box_scene(), smallpt_camera(), cfg,
                 rng.base_key(13), device="cpu").numpy()
    golden = data["image"]
    rel = np.abs(img - golden) / (1.0 + np.abs(golden))
    assert (rel > 0.1).mean() <= 0.02, (rel > 0.1).mean()
    assert _mean_ok(img, golden)


def test_render_matches_golden_shallow_tight():
    """tests/test_golden.py::test_golden_cornell_shallow_tight's gate, the
    JAX suite's detector of a systematic shift: max_depth 4, seed 17; at
    most 2.5% of values diverge by more than 10%, at most 0.5% lie in the
    1-10% band, means within 2%."""
    data = np.load(os.path.join(DATA, "golden_cornell_shallow_48x36.npz"))
    cfg = CFG.replace(max_depth=4)
    img = render(cornell_box_scene(), smallpt_camera(), cfg,
                 rng.base_key(17), device="cpu").numpy()
    golden = data["image"]
    rel = np.abs(img - golden) / (1.0 + np.abs(golden))
    assert (rel > 0.1).mean() <= 0.025, (rel > 0.1).mean()
    band = ((rel > 0.01) & (rel <= 0.1)).mean()
    assert band <= 0.005, band
    assert abs(img.mean() - golden.mean()) < 0.02 * (golden.mean() + 0.1)


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
    dict(dtype="float64"), dict(dtype="float64", scheduler=Scheduler.REGEN),
    dict(dtype="float64", scheduler=Scheduler.FLAT),
    dict(dtype="float64", split_budget=2),
    dict(dtype="float64", mode=Mode.NORMAL),
    dict(dtype="float64", mode=Mode.UV),
    dict(dtype="float64", mode=Mode.INST_ID),
])
def test_unported_configs_raise(kw):
    """float64 raised on every route until the CPU's float64 route was
    ported (tests/test_torch_float64.py holds it to the oracle): now each
    of these configs renders a finite float64 image on the CPU, and what
    still raises is float64 on the card (the kernels are float32 only)."""
    from smallpt_tpu_torch.core.camera import default_matrix_camera

    cfg = RenderConfig(width=8, height=8, **kw)  # the MATRIX camera model
    img = render(cornell_box_scene(), default_matrix_camera(), cfg,
                 rng.base_key(0), device="cpu")
    assert img.dtype == torch.float64 and img.shape == (8, 8, 3)
    assert torch.isfinite(img).all()
    with pytest.raises(NotImplementedError, match="float32 only"):
        render(cornell_box_scene(), default_matrix_camera(), cfg,
               rng.base_key(0))


def test_unported_scenes_and_gradients_raise():
    """What still raises: an unknown scene type. Sphere scenes above 2048
    spheres once raised here; they take the binned drain now
    (tests/test_torch_binned.py). Gradients raised here too; a
    differentiable render now takes the flat wavefront, as in the JAX
    package (tests/test_torch_grad.py), and gives the forward flat pass's
    image."""
    from smallpt_tpu_torch.engine.renderer import _route

    cfg = RenderConfig(width=8, height=8)
    key = rng.base_key(0)
    assert _route(procedural_sphere_scene(n=2049), cfg, False) == "binned"
    with pytest.raises(TypeError, match="unknown scene type"):
        render(object(), smallpt_camera(), cfg, key, device="cpu")
    assert _route(cornell_box_scene(), cfg, True) == "flat"
    cfg = cfg.replace(camera_model=CameraModel.LEGACY)
    img = render(cornell_box_scene(), smallpt_camera(), cfg, key,
                 device="cpu", differentiable=True)
    ref = render(cornell_box_scene(), smallpt_camera(),
                 cfg.replace(scheduler=Scheduler.FLAT), key, device="cpu")
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("flag", [["--frames", "f_%04d.ppm"],
                                  ["--interactive"],
                                  ["--checkpoint", "ck.npz"]])
def test_cli_unported_flags_raise(flag, tmp_path, monkeypatch):
    """The three flags the port once refused now run on the per-pass
    route: --frames writes a frame a pass, --interactive reads the request
    protocol from stdin, --checkpoint saves a per-pass checkpoint that
    resumes byte-equal to one run."""
    import io

    import smallpt_tpu_torch.interactive as interactive

    sessions = []
    real = interactive.InteractiveSession
    monkeypatch.setattr(interactive, "InteractiveSession",
                        lambda *a, **k: sessions.append(real(*a, **k))
                        or sessions[-1])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("sys.stdin", io.StringIO('{"action": "quit"}\n'))
    common = ["4", "--width", "8", "--height", "6", "--max-depth", "4",
              "--device", "cpu", "--quiet"]
    out, one = str(tmp_path / "x.ppm"), str(tmp_path / "one.ppm")
    assert cli.main(common + flag + ["--passes", "2", "--out", out]) == 0
    assert img_io.read_ppm(out).shape == (6, 8, 3)
    for session in sessions:  # the reader thread ended with the stream
        session.reader.join(timeout=30)
        assert not session.reader.is_alive()
    assert len(sessions) == (flag[0] == "--interactive")
    if flag[0] == "--frames":
        assert sorted(os.listdir(tmp_path)) == [
            "f_0001.ppm", "f_0002.ppm", "x.ppm"]
    elif flag[0] == "--checkpoint":
        again = str(tmp_path / "again.ppm")
        assert cli.main(common + ["--passes", "2", "--resume", flag[1],
                                  "--out", again]) == 0
        assert cli.main(common + ["--passes", "4", "--out", one]) == 0
        with open(again, "rb") as fa, open(one, "rb") as fo:
            assert fa.read() == fo.read()
