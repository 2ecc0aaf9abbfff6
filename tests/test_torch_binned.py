"""The port's binned scheduler (engine/binned.py, BinnedProgressiveRenderer,
the "binned" route of render and ProgressiveRenderer, the CLI's binned
routes) against itself, the classic streaming route and the JAX package,
on the CPU through K8's plain version (tests/test_binned.py's scene and
config: procedural_sphere_scene(80, seed=3), 24x16, max_depth 10).

Gates:
- invariances, bit-exact: the culled sweep equals the all-chunks sweep (a
  list capacity of 2 overflows every tile) in full transport, every AOV
  mode and with NEE; runs repeat bit for bit; a checkpoint resumed equals
  the uninterrupted run;
- weights exactly the budgets after a flush (inflight 2, two streams,
  adaptive budgets, NEE at max_depth 2);
- against the classic streaming route (the same sample streams with one
  lane a pixel): tests/test_binned.py's gate (97% of values within 5% +
  0.02, means within 1%);
- against the JAX package: a checkpoint of either package resumes in the
  other (the state loaded bit-equal, the weights exact, the images under
  the same gate); render's binned route against the JAX package's on the
  same key;
- routing as the JAX package: above 2048 spheres under MEGA "binned" (NEE
  with an AOV mode: REGEN), a scene the accel cannot index REGEN, the
  CLI's default big-scene route and --binned with --quality, --checkpoint
  and --resume (byte-equal to one run); the refusals of
  tests/test_binned.py:83 and tests/test_binned_aov.py:124, and
  sort_every > 0 and fused=False citing ROADMAP.md item 11b.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import binned as jb
from smallpt_tpu.engine import renderer as jrenderer
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import progressive, renderer
from smallpt_tpu_torch.engine.binned import (
    BinnedStreamingRenderer, build_accel_for_camera,
)
from smallpt_tpu_torch.engine.progressive import (
    BinnedProgressiveRenderer, ProgressiveRenderer,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.utils import image as img_io

CFG = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=10,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
SCENE = tscene.procedural_sphere_scene(80, seed=3)
JSCENE = jscene.procedural_sphere_scene(80, seed=3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big():
    """2,100 spheres: above MEGA_MAX_SPHERES (tests/test_binned.py:153)."""
    return (tscene.procedural_sphere_scene(2100, seed=5),
            jscene.procedural_sphere_scene(2100, seed=5))


def _jax_config(cfg: RenderConfig):
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


def _binned(cfg=CFG, spp=2, scene=SCENE, seed=0, n_bounces=4, **kw):
    r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg, seed=seed,
                                device="cpu", **kw)
    r.step(add_samples=spp, n_bounces=n_bounces)
    r.flush()
    return r


def _sums(r):
    rad, w = r.accumulators()
    return rad.numpy(), w.numpy()


def _close_gate(img, ref, frac=0.97):
    """tests/test_binned.py's gate between two sample-for-sample
    estimators: 97% of values within 5% + 0.02, means within 1%."""
    close = np.isclose(img, ref, rtol=0.05, atol=0.02)
    assert close.mean() > frac, close.mean()
    assert abs(img.mean() - ref.mean()) < 0.01 * (ref.mean() + 0.05)


# -- the renderer ------------------------------------------------------------

def test_weights_exact_after_flush():
    r = _binned(spp=3)
    _, w = _sums(r)
    assert (w == 3).all()
    assert r.pending() == (0, 0)
    assert r.stats.rays > 0 and r.stats.passes >= 2


def test_nee_weights_exact_at_max_depth_2():
    """A sample ending at a max-depth diffuse vertex still owes its
    deferred shadow: regeneration holds the lane and the flush counts it
    (tests/test_binned.py::test_binned_nee_weights_exact_after_flush)."""
    _, w = _sums(_binned(CFG.replace(nee_lights=(8,), max_depth=2), spp=3))
    assert (w == 3).all()


@pytest.mark.parametrize("kw", [{}, {"nee_lights": (8,)}],
                         ids=["full", "nee"])
def test_matches_classic_streaming(kw):
    """One lane a pixel, the same (pixel, ip) streams as the classic
    streaming route on the same scene: tests/test_binned.py's gate."""
    cfg = CFG.replace(**kw)
    rad_b, w_b = _sums(_binned(cfg, spp=8))
    c = StreamingRenderer(SCENE, smallpt_camera(), cfg, seed=0, dda=False,
                          device="cpu")
    c.step(n_iters=4 * cfg.max_depth, add_samples=8)
    c.flush()
    rad_c, w_c = (x.numpy() for x in c.accumulators())
    assert (w_b == w_c).all() and (w_b == 8).all()
    _close_gate(rad_b / 8, rad_c / 8)


@pytest.mark.parametrize("kw", [
    {}, {"mode": Mode.NORMAL}, {"mode": Mode.EMISSION},
    {"mode": Mode.INST_ID}, {"mode": Mode.UV}, {"nee_lights": (8, 3)}],
    ids=["full", "normal", "emission", "inst_id", "uv", "nee_two_lights"])
def test_culled_equals_full_sweep(kw):
    """A list capacity of 2 puts every tile on the all-chunks fallback
    (tests/test_binned.py:69, tests/test_binned_aov.py:47): the image and
    the weights are bit-equal to the culled sweep's."""
    cfg = CFG.replace(**kw)
    a, wa = _sums(_binned(cfg, spp=2))
    accel = dataclasses.replace(
        build_accel_for_camera(SCENE, smallpt_camera(), cfg), l_max=2)
    b, wb = _sums(_binned(cfg, spp=2, accel=accel))
    assert (wa == 2).all() and (wa == wb).all()
    assert (a == b).all()
    assert np.abs(a).sum() > 0


def test_inflight_and_streams_exact_weights():
    """Two lanes a pixel (6 samples split 3/3) and two sample streams
    (8 split 4/4): weights exact, runs deterministic, the images
    statistically those of one lane and one stream."""
    cfg = CFG.replace(width=16, height=12, max_depth=8)
    rad2a, w2a = _sums(_binned(cfg, spp=6, inflight=2))
    rad2b, _ = _sums(_binned(cfg, spp=6, inflight=2))
    rad1, w1 = _sums(_binned(cfg, spp=6))
    assert (w2a == 6).all() and (rad2a == rad2b).all()
    assert abs(rad2a.mean() - rad1.mean()) < 0.15 * (rad1.mean() + 0.05) * 6
    rs, ws = _sums(_binned(cfg, spp=8, n_streams=2))
    assert (ws == 8).all()
    assert np.isfinite(rs).all()
    with pytest.raises(ValueError, match="power of two"):
        BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, inflight=3,
                                device="cpu")


def test_step_adaptive_budgets():
    cfg = CFG.replace(width=16, height=12, max_depth=8)
    r = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=0,
                                device="cpu")
    r.step(add_samples=2, n_bounces=6)
    r.step_adaptive(n_bounces=4, add_samples_total=3 * cfg.n_pixels)
    r.flush()
    _, w = _sums(r)
    budgets = np.asarray(r._budgets)
    assert budgets.min() >= 3
    assert budgets.sum() == 5 * cfg.n_pixels
    assert (w.reshape(-1) == budgets).all()


def test_step_to_quality():
    cfg = CFG.replace(width=12, height=8, max_depth=6)
    r = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=9,
                                device="cpu")
    q = r.step_to_quality(rel_err=0.3, quantile=0.9, max_spp=16, min_spp=4,
                          n_bounces=4)
    assert q["spp_min"] >= 4
    _, w = _sums(r)
    assert w.min() >= q["spp_min"]
    mean, var, nn = r._combined_moments()
    stderr = np.sqrt(np.maximum(var, 0) / np.maximum(nn, 1)) / (
        np.abs(mean) + 1e-2)
    hit = float(np.quantile(stderr[nn >= 2], 0.9)) <= 0.3
    assert hit or q["spp_max"] >= 16, q


def test_step_timed_advances():
    r = BinnedStreamingRenderer(SCENE, smallpt_camera(), CFG, seed=0,
                                device="cpu")
    assert r.step_timed(target_ms=50.0, add_samples=2) > 0
    first = r._bounces_per_s
    r.step_timed(target_ms=50.0, add_samples=0)
    assert r._bounces_per_s > 0 and r._bounces_per_s != first
    r.flush()
    assert (_sums(r)[1] == 2).all()


@pytest.mark.parametrize("case", [
    ("split_budget", dict(cfg=dict(split_budget=2)), ValueError,
     "split_budget"),
    ("nee_not_fused", dict(cfg=dict(nee_lights=(8,)), fused=False),
     ValueError, "fused"),
    ("nee_aov", dict(cfg=dict(mode=Mode.NORMAL, nee_lights=(8,))),
     ValueError, "Mode.FULL"),
    ("sort_every", dict(sort_every=1), None, None),
    ("three_program", dict(fused=False), None, None),
    ("mesh", dict(scene="mesh"), TypeError, "SphereScene"),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_refusals(case):
    """The configs the renderer refuses. The bin sort (sort_every > 0) and
    the three-program bounce (fused=False) were refused until they were
    ported (ROADMAP.md item 11b); they now render, and drain to exact
    weights (tests/test_torch_binned_sort.py holds their bits)."""
    _, kw, exc, match = case
    kw = dict(kw)
    cfg = CFG.replace(**kw.pop("cfg", {}))
    scene = (tscene.single_triangle_scene() if kw.pop("scene", None)
             else SCENE)
    if exc is None:
        r = _binned(cfg, spp=2, scene=scene, **kw)
        assert (_sums(r)[1] == 2).all()
        return
    with pytest.raises(exc, match=match):
        BinnedStreamingRenderer(scene, smallpt_camera(), cfg, device="cpu",
                                **kw)


def test_checkpoint_resume_bit_equal(tmp_path):
    """Mid-stream save, load into a new renderer, continue: bit-equal to
    the uninterrupted run; a layout mismatch refuses."""
    cfg = CFG.replace(nee_lights=(8,))
    ref = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=2,
                                  device="cpu")
    ref.step(add_samples=3, n_bounces=3)
    ck = str(tmp_path / "ck.npz")
    ref.save_checkpoint(ck)
    ref.flush()
    r = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=7,
                                device="cpu")
    r.load_checkpoint(ck)
    r.flush()
    a, wa = _sums(ref)
    b, wb = _sums(r)
    assert (wa == 3).all() and (a == b).all() and (wa == wb).all()
    other = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg,
                                    inflight=2, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        other.load_checkpoint(ck)


def test_checkpoint_across_packages(tmp_path):
    """A mid-stream checkpoint of the JAX renderer resumes in the port
    (state bit-equal, weights exact, the image under the gate against the
    JAX continuation), and one of the port in the JAX renderer."""
    jcfg = _jax_config(CFG)
    j = jb.BinnedStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                   seed=3)
    j.step(add_samples=3, n_bounces=3)
    ck_j = str(tmp_path / "jax.npz")
    j.save_checkpoint(ck_j)
    t = BinnedStreamingRenderer(SCENE, smallpt_camera(), CFG, device="cpu")
    t.load_checkpoint(ck_j)
    np.testing.assert_array_equal(t.f.numpy(), np.asarray(j.f))
    np.testing.assert_array_equal(t.i.numpy(), np.asarray(j.i))
    assert t.stats.rays == j.stats.rays
    t.flush()
    j.flush()
    a, wa = _sums(t)
    rad_j, w_j = (np.asarray(x) for x in j.accumulators())
    assert (wa == 3).all() and (w_j == 3).all()
    _close_gate(a / 3, rad_j / 3)

    t2 = BinnedStreamingRenderer(SCENE, smallpt_camera(), CFG, seed=5,
                                 device="cpu")
    t2.step(add_samples=2, n_bounces=3)
    ck_t = str(tmp_path / "torch.npz")
    t2.save_checkpoint(ck_t)
    j.load_checkpoint(ck_t)
    np.testing.assert_array_equal(np.asarray(j.f), t2.f.numpy())
    np.testing.assert_array_equal(np.asarray(j.i), t2.i.numpy())
    j.flush()
    assert (np.asarray(j.accumulators()[1]) == 2).all()


def test_flush_counts_the_march_as_progress(big):
    """ROADMAP.md hazard H7: on 2,100 spheres at 8x6, max_depth 3, seed 0,
    a drain round of 8 launches finalizes no ray while every pending lane
    marches its frontier; the JAX package's flush raises there ("flush made
    no progress"), the port's drains to exact weights."""
    cfg = CFG.replace(width=8, height=6, max_depth=3)
    r = BinnedStreamingRenderer(big[0], smallpt_camera(), cfg, seed=0,
                                device="cpu")
    r.step(add_samples=4, n_bounces=6)
    r.flush()
    assert (_sums(r)[1] == 4).all()
    j = jb.BinnedStreamingRenderer(big[1], jcam.smallpt_camera(),
                                   _jax_config(cfg), seed=0)
    j.step(add_samples=4, n_bounces=6)
    with pytest.raises(RuntimeError, match="no progress"):
        j.flush()


def test_update_scene_is_exception_safe():
    """A scene the accel cannot index leaves the renderer on the old one;
    a camera update restarts the stream."""
    r = _binned(spp=1)
    bad = SCENE._replace(radius=torch.clamp(SCENE.radius, min=600.0))
    with pytest.raises(ValueError, match="no local"):
        r.update_scene(bad)
    assert r.scene is SCENE and r.accel.n_chunks > 0
    r.update_camera(smallpt_camera())
    assert r.budget == 0 and r.stats.rays == 0
    r.step(add_samples=1, n_bounces=4)
    r.flush()
    assert (_sums(r)[1] == 1).all()


# -- routing -----------------------------------------------------------------

def test_render_routes_big_scenes_through_binned(big):
    """render and render_with_stats above MEGA_MAX_SPHERES take the binned
    drain (tests/test_binned.py:153): the image equals a manual drain bit
    for bit, and repeats."""
    scene, _ = big
    cfg = CFG.replace(max_depth=3)
    assert renderer._route(scene, cfg, False) == "binned"
    key = rng.base_key(3)
    img1 = renderer.render(scene, smallpt_camera(), cfg, key, device="cpu")
    img2, rays = renderer.render_with_stats(scene, smallpt_camera(), cfg,
                                            key, device="cpu")
    assert (img1 == img2).all() and int(rays) > 0
    r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg, device="cpu")
    r.key = key
    r.step(add_samples=cfg.spp, n_bounces=3)
    r.flush()
    rad, w = r.accumulators()
    assert (w == cfg.spp).all() and (rad == img1).all()


def test_render_matches_jax_binned_route(big):
    """The port's render and the JAX package's on the same big scene and
    key both take the binned drain with one lane a pixel, the same sample
    streams: the JAX suite's gate for a dense procedural scene
    (tests/test_golden.py:139-172: at most 5% of values off by 10%, means
    within 5%), its thousands of sphere rims razoring the paths that
    XLA:CPU's fused multiply-adds move (ROADMAP.md F3, F8)."""
    scene, jscene_ = big
    cfg = CFG.replace(max_depth=6)
    jcfg = _jax_config(cfg)
    assert jrenderer._use_binned(jscene_, jcfg, False)
    want = np.asarray(jrenderer.render(jscene_, jcam.smallpt_camera(), jcfg,
                                       jrng.base_key(3))) / cfg.spp
    got = renderer.render(scene, smallpt_camera(), cfg, rng.base_key(3),
                          device="cpu").numpy() / cfg.spp
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert (rel > 0.1).mean() <= 0.05, (rel > 0.1).mean()
    assert abs(got.mean() - want.mean()) < 0.05 * (abs(want.mean()) + 0.1)


def test_routes_of_big_scenes(big):
    """Every mode rides the binned route; NEE with an AOV mode and a
    non-MEGA scheduler take REGEN (tests/test_binned_aov.py::
    test_router_gates_modes)."""
    scene, _ = big
    for kw in ({}, {"mode": Mode.NORMAL}, {"mode": Mode.UV},
               {"nee_lights": (8,)}):
        assert renderer._route(scene, CFG.replace(**kw), False) == "binned"
    assert renderer._route(scene, CFG.replace(mode=Mode.NORMAL,
                                              nee_lights=(8,)),
                           False) == "regen"
    assert renderer._route(scene, CFG.replace(scheduler=Scheduler.REGEN),
                           False) == "regen"
    assert renderer._route(SCENE, CFG, False) == "mega"


def test_accel_unsupported_falls_to_regen():
    """A big scene with no wall-class sphere routes to binned, whose accel
    refuses it: render and ProgressiveRenderer take REGEN, as the JAX
    package does (tests/test_binned.py:210)."""
    n = 2100
    r = np.random.default_rng(7)
    emission = np.where(np.arange(n)[:, None] == 0, 10.0, 0.0) * np.ones(
        (1, 3))
    scene = tscene.sphere_scene_from_arrays(
        r.uniform(0, 100, (n, 3)), r.uniform(0.5, 1.5, n), emission,
        np.full((n, 3), 0.5), np.zeros(n, np.int32))
    cfg = CFG.replace(width=8, height=6, max_depth=2)
    assert renderer._route(scene, cfg, False) == "binned"
    img = renderer.render(scene, smallpt_camera(), cfg, rng.base_key(0),
                          device="cpu")
    assert torch.isfinite(img).all()
    p = ProgressiveRenderer(scene, smallpt_camera(), cfg, device="cpu")
    assert p.route == "regen"
    p.step()
    assert np.isfinite(p.image).all()


def test_progressive_renderers_on_the_binned_route(big, tmp_path):
    """ProgressiveRenderer drains a binned pass per step on its own
    renderer (its image equals render_image's); BinnedProgressiveRenderer
    carries one wavefront across passes, finalizes to exact weights and
    resumes from its checkpoint bit-equal."""
    scene, _ = big
    cfg = CFG.replace(max_depth=2)
    p = ProgressiveRenderer(scene, smallpt_camera(), cfg, seed=1,
                            device="cpu")
    assert p.route == "binned"
    p.step()
    assert p.stats.rays > 0
    ref = renderer.render_image(scene, smallpt_camera(), cfg, seed=1,
                                n_passes=1, device="cpu")
    assert np.array_equal(p.image, ref.numpy())

    b = BinnedProgressiveRenderer(SCENE, smallpt_camera(), CFG, seed=1,
                                  device="cpu", n_bounces=3)
    b.step(2)
    ck = str(tmp_path / "p.npz")
    b.save_checkpoint(ck)
    b.step()
    b.finalize()
    assert (b._r.accumulators()[1] == 3 * CFG.spp).all()
    c = BinnedProgressiveRenderer(SCENE, smallpt_camera(), CFG, seed=1,
                                  device="cpu", n_bounces=3)
    c.load_checkpoint(ck)
    assert c.sample_count == c.stats.passes
    c.step()
    c.finalize()
    assert np.array_equal(b.image, c.image)


# -- the CLI ------------------------------------------------------------------

def test_cli_default_big_scene_route(tmp_path, monkeypatch, big):
    """A sphere scene above MEGA_MAX_SPHERES in full transport takes
    BinnedProgressiveRenderer per pass, whatever the scheduler, as the JAX
    CLI routes it (a 2,100-sphere scene stands in for --scene procedural);
    its checkpoint resumes."""
    monkeypatch.setitem(cli.SCENES, "procedural", lambda: big[0])
    made = []
    real = progressive.BinnedProgressiveRenderer

    def spy(*a, **k):
        made.append(k)
        return real(*a, **k)

    monkeypatch.setattr(cli, "BinnedProgressiveRenderer", spy)
    out = str(tmp_path / "p.ppm")
    args = ["2", "--scene", "procedural", "--width", "24", "--height",
            "16", "--max-depth", "2", "--device", "cpu", "--quiet", "--out",
            out]
    assert cli.main(args + ["--scheduler", "regen",
                            "--checkpoint", str(tmp_path / "ck.npz")]) == 0
    assert len(made) == 1 and os.path.getsize(out) > 0
    assert cli.main(args + ["--resume", str(tmp_path / "ck.npz")]) == 0
    assert len(made) == 2


def test_cli_binned_checkpoint_resume_byte_equal(tmp_path):
    """--binned with NEE: 2 spp with --checkpoint, then 2 more with
    --resume, byte-equal to one run of --passes 2; --quality runs."""
    common = ["2", "--binned", "--nee", "8", "--width", "16", "--height",
              "12", "--max-depth", "6", "--device", "cpu", "--quiet"]
    ck = str(tmp_path / "ck.npz")
    a, b, one = (str(tmp_path / n) for n in ("a.ppm", "b.ppm", "one.ppm"))
    assert cli.main(common + ["--out", a, "--checkpoint", ck]) == 0
    assert cli.main(common + ["--out", b, "--resume", ck]) == 0
    assert cli.main(common + ["--out", one, "--passes", "2"]) == 0
    with open(b, "rb") as fb, open(one, "rb") as fo:
        assert fb.read() == fo.read()
    q = str(tmp_path / "q.ppm")
    assert cli.main(["4", "--binned", "--quality", "0.5", "--width", "8",
                     "--height", "6", "--max-depth", "4", "--device", "cpu",
                     "--quiet", "--out", q]) == 0
    assert img_io.read_ppm(q).shape == (6, 8, 3)


def test_cli_refusals(tmp_path):
    """--quality without a stream is refused; a per-pass --checkpoint, once
    refused, now saves the progressive state."""
    with pytest.raises(SystemExit):
        cli.main(["4", "--quality", "0.1", "--device", "cpu"])
    ck = str(tmp_path / "x.npz")
    assert cli.main(["4", "--checkpoint", ck, "--width", "8", "--height",
                     "6", "--max-depth", "4", "--device", "cpu", "--quiet",
                     "--out", str(tmp_path / "x.ppm")]) == 0
    assert int(np.load(ck)["sample_count"]) == 1
