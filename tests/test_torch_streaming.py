"""The port's streaming route (ops/megakernel.py stream_step and its
host-side helpers, engine/streaming.py, engine/quality.py) on the CPU,
where the wrappers run the plain PyTorch version.

Parity with the JAX package at Cornell 16x12 (one 8192-lane tile, 192 image
lanes), same scene, camera and key:
- init_stream_state and set_sample_budget: equal arrays;
- stream_step_plain against JAX stream_step (Pallas interpreter), two
  partial launches and a drain, plane by plane (``_state_gate``);
- a JAX state continued in the port (state_from_jax), and a checkpoint of
  either package resumed in the other.

Gates. The budget, alive and s_idx planes are bit-equal on every lane after
every launch. The two share every random stream bit for bit, but XLA:CPU
rounds some ops differently from torch (rsqrt, sin, cos, the 1e5-radius
walls' intersections), and a razor-edge decision (a corner of two walls, a
sphere rim) can flip and move one lane's path: the per-lane ray counter is
therefore equal on all but 2% of the lanes (16x12 at seed 0 moves lanes 93
and 119 by one ray each; ROADMAP.md section 3 traces both), with its sum
within max(64, 0.1%). depth and sup are compared on lanes alive in both:
the JAX tile keeps stepping an idle lane (depth + 1, sup = 0) where the
port's lane stops, and regeneration resets both. Radiance, m1 and m2 use
tests/test_megakernel.py::_compare's gate: at most 2% of values with
|a-b|/(1+|b|) > 0.1, means within 5%. test_one_iteration_from_jax_state
holds the port to bit-equal discrete state one iteration at a time, from
JAX's own state, where no rounding difference has accumulated.

The behaviour cases mirror tests/test_streaming.py on the port alone.
"""

import os

import numpy as np
import pytest
import torch

from smallpt_tpu import config as jcfg
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import quality as jquality
from smallpt_tpu.engine import streaming as jstreaming
from smallpt_tpu.ops import megakernel as jmk
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng as trng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, cornell_box_small_light_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.engine import quality as tquality
from smallpt_tpu_torch.engine.renderer import render_image
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.utils import image as img_io

CFG = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
JCFG = jcfg.RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                         camera_model=jcfg.CameraModel.LEGACY,
                         filter=jcfg.Filter.TENT)
G = CFG.n_pixels
MAX_FRAC = 0.02
# (sample budget, n_iters) of each launch: two partial launches, a drain
LAUNCHES = ((4, 16), (None, 16), (None, 10_000))


def _planes(f, i):
    return (np.asarray(f).reshape(14, -1)[:, :G],
            np.asarray(i).reshape(6, -1)[:, :G])


def _image_gate(got, ref):
    rel = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert np.isfinite(got).all()
    assert (rel > 0.1).mean() <= MAX_FRAC, f"{(rel > 0.1).mean():.4f}"
    assert abs(got.mean() - ref.mean()) < 0.05 * (abs(ref.mean()) + 0.1)


def _state_gate(jf, ji, tf, ti, drained):
    """The port's state (tf, ti) against the JAX package's (jf, ji): see
    the module docstring."""
    np.testing.assert_array_equal(np.asarray(ji).reshape(6, -1)[4],
                                  ti.numpy().reshape(6, -1)[4])
    fj, ij = _planes(jf, ji)
    fp, ip = _planes(tf, ti.numpy())
    np.testing.assert_array_equal(ip[1], ij[1])  # s_idx
    np.testing.assert_array_equal(ip[2], ij[2])  # alive
    if drained:
        assert not ij[2].any()
    assert (ij[3] != ip[3]).sum() <= MAX_FRAC * G
    assert abs(int(ij[3].sum()) - int(ip[3].sum())) <= max(
        64, 0.001 * int(ij[3].sum()))
    both = (ij[2] != 0) & (ip[2] != 0)
    assert ((ij[0] != ip[0]) | (ij[5] != ip[5]))[both].sum() <= MAX_FRAC * G
    _image_gate(fp[9:12].T, fj[9:12].T)
    for plane in (12, 13):  # m1, m2
        _image_gate(fp[plane], fj[plane])


def _jax_run(jcfg_, jscene_, seed, launches, f=None, i=None):
    """JAX stream_step through the launches; returns the state after each
    one as numpy (f, i, rays)."""
    key = jrng.base_key(seed)
    if f is None:
        f, i = jmk.init_stream_state(jcfg_)
    out = []
    for budget, n_iters in launches:
        f, i, rays = jmk.stream_step(jscene_, jcam.smallpt_camera(), jcfg_,
                                     key, f, i, budget, n_iters)
        out.append((np.asarray(f), np.asarray(i), int(rays)))
    return out


@pytest.fixture(scope="module")
def jax_chain():
    return _jax_run(JCFG, jscene.cornell_box_scene(), 0, LAUNCHES)


def _port_inputs(cfg, scene):
    return (tmk.build_scene_table(scene, cfg),
            tmk.build_camera_vec(smallpt_camera(), cfg))


def jax_iterations(seed, nee=False):
    """JAX stream_step on Cornell 16x12 (the small-light scene with NEE on
    its light), one iteration a launch from a fresh state with a budget of
    4 samples until drained: the list of numpy (f, i) after each
    iteration, and the port's (config, scene)."""
    if nee:
        js, scene = (jscene.cornell_box_small_light_scene(),
                     cornell_box_small_light_scene())
        lights = dict(nee_lights=(8,))
    else:
        js, scene, lights = jscene.cornell_box_scene(), cornell_box_scene(), {}
    jc = jcfg.RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=8,
                           camera_model=jcfg.CameraModel.LEGACY,
                           filter=jcfg.Filter.TENT, **lights)
    key = jrng.base_key(seed)
    f, i = jmk.init_stream_state(jc)
    out = []
    while not out or jmk.stream_pending(i) != (0, 0):
        f, i, _ = jmk.stream_step(js, jcam.smallpt_camera(), jc, key, f, i,
                                  None if out else 4, 1)
        out.append((np.asarray(f), np.asarray(i)))
    return out, CFG.replace(**lights), scene


@pytest.mark.parametrize("seed,nee", [(0, False), (1, False), (0, True)],
                         ids=["seed0", "seed1", "nee_seed0"])
def test_one_iteration_from_jax_state(seed, nee):
    """From JAX's state after every iteration of a drain, one port
    iteration (state_from_jax, then stream_step with n_iters=1) gives JAX's
    next state bit for bit in budget, alive, s_idx and the per-lane ray
    counter on every lane, and in depth and sup on the lanes alive after
    the step. Directions agree within 1e-4 on all but 0.1% of the live
    lane-steps: a ray that reaches a corner of two 1e5-radius walls hits
    the wall that XLA:CPU's rounding does not pick (one lane-step at seed 0,
    lane 93 after iteration 28); radiance and moments under the image
    gate."""
    steps, cfg, scene = jax_iterations(seed, nee)
    table, cam = _port_inputs(cfg, scene)
    live_steps = off_dir = 0
    for (jf0, ji0), (jf, ji) in zip(steps, steps[1:]):
        tf, ti = tmk.state_from_jax(jf0, ji0, device="cpu")
        tmk.stream_step(table, cam, cfg, trng.base_key(seed), tf, ti, None,
                        1, n_spheres=scene.n_spheres)
        fj, ij = _planes(jf, ji)
        fp, ip = _planes(tf, ti.numpy())
        np.testing.assert_array_equal(ip[1:5], ij[1:5])
        live = ij[2] != 0
        np.testing.assert_array_equal(ip[[0, 5]][:, live], ij[[0, 5]][:, live])
        live_steps += int(live.sum())
        off_dir += int((np.abs(fp[3:6] - fj[3:6]).max(0) > 1e-4)[live].sum())
        _image_gate(fp[9:12].T, fj[9:12].T)
        for plane in (12, 13):
            _image_gate(fp[plane], fj[plane])
    assert len(steps) > 16 and live_steps > 16 * G // 2
    assert off_dir <= 0.001 * live_steps, f"{off_dir} of {live_steps}"


def test_init_and_budget_equal_jax():
    jf, ji = jmk.init_stream_state(JCFG)
    tf, ti = tmk.init_stream_state(CFG, device="cpu")
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tf.shape == (8 * 14, 1024) and ti.dtype == torch.int32
    budgets = np.random.default_rng(0).integers(0, 9, G).astype(np.int32)
    for b, acc in ((3, True), (budgets, True), (2, True), (budgets, False),
                   (1, False)):
        ji = jmk.set_sample_budget(ji, b, JCFG, accumulate_max=acc)
        assert tmk.set_sample_budget(ti, b, CFG, accumulate_max=acc) is ti
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert not ti.numpy().reshape(6, -1)[4, G:].any()  # padding stays 0
    assert tmk.stream_pending(ti) == jmk.stream_pending(ji)


def test_stream_step_plain_matches_jax(jax_chain):
    table, cam = _port_inputs(CFG, cornell_box_scene())
    tf, ti = tmk.init_stream_state(CFG, device="cpu")
    key = trng.base_key(0)
    for (budget, n_iters), (jf, ji, jrays) in zip(LAUNCHES, jax_chain):
        _, _, rays = tmk.stream_step(table, cam, CFG, key, tf, ti, budget,
                                     n_iters, n_spheres=9)
        assert rays.dtype == torch.int64 and rays.dim() == 0
        assert abs(int(rays) - jrays) <= max(64, 0.001 * jrays)
        _state_gate(jf, ji, tf, ti, drained=n_iters == LAUNCHES[-1][1])
    jimg, jw = jmk.stream_image(jf, ji, JCFG)
    img, w = tmk.stream_image(tf, ti, CFG)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    _image_gate(img.numpy(), np.asarray(jimg))
    for got, want in zip(tmk.stream_variance(tf, ti, CFG),
                         jmk.stream_variance(jf, ji, JCFG)):
        _image_gate(got.numpy(), np.asarray(want))


def test_jax_state_continues_in_the_port(jax_chain):
    """state_from_jax: the JAX state after the first launch, continued in
    the port, matches JAX continuing; state_to_numpy gives the JAX shapes
    and types back."""
    jf0, ji0, _ = jax_chain[0]
    tf, ti = tmk.state_from_jax(jf0, ji0, device="cpu")
    f_back, i_back = tmk.state_to_numpy(tf, ti)
    np.testing.assert_array_equal(f_back, jf0)
    np.testing.assert_array_equal(i_back, ji0)
    assert f_back.dtype == np.float32 and i_back.dtype == np.int32
    table, cam = _port_inputs(CFG, cornell_box_scene())
    for (budget, n_iters), (jf, ji, _) in zip(LAUNCHES[1:], jax_chain[1:]):
        tmk.stream_step(table, cam, CFG, trng.base_key(0), tf, ti, budget,
                        n_iters, n_spheres=9)
        _state_gate(jf, ji, tf, ti, drained=budget is None and n_iters > 16)
    with pytest.raises(ValueError, match="not a streaming state"):
        tmk.state_from_jax(jf0[:8], ji0, device="cpu")


@pytest.fixture(scope="module")
def cross_checkpoints(tmp_path_factory):
    """A checkpoint of each package after step(7, 4), and each package's
    own image after resuming with step(64, 2) and a flush."""
    d = tmp_path_factory.mktemp("ck")
    scene, cam = jscene.cornell_box_scene(), jcam.smallpt_camera()
    a = jstreaming.StreamingRenderer(scene, cam, JCFG, seed=11)
    a.step(n_iters=7, add_samples=4)
    a.save_checkpoint(str(d / "jax.npz"))
    a.step(n_iters=64, add_samples=2)
    a.flush()
    b = StreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                          seed=11, device="cpu")
    b.step(n_iters=7, add_samples=4)
    b.save_checkpoint(str(d / "port.npz"))
    j = jstreaming.StreamingRenderer(scene, cam, JCFG, seed=11)
    j.load_checkpoint(str(d / "port.npz"))
    j.step(n_iters=64, add_samples=2)
    j.flush()
    return d, a, j


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(cross_checkpoints, direction):
    d, jax_own, jax_from_port = cross_checkpoints
    port = StreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                             seed=11, device="cpu")
    if direction == "jax_to_port":
        port.load_checkpoint(str(d / "jax.npz"))
        assert port.budget == 4 and port.stats.passes == 1
        ref = jax_own
    else:
        port.step(n_iters=7, add_samples=4)
        ref = jax_from_port
    port.step(n_iters=64, add_samples=2)
    port.flush()
    _, w = port.accumulators()
    assert (w.numpy() == 6).all()
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref.accumulators()[1]))
    _image_gate(port.image, ref.image)


def test_adaptive_allocation_equals_jax():
    r = np.random.default_rng(5)
    for n, pool in ((192, 100), (192, 384), (192, 1000), (3000, 7777)):
        sigma = r.gamma(0.5, 1.0, size=n) + 1e-3
        got = tquality.adaptive_allocation(sigma, pool, n)
        want = jquality.adaptive_allocation(sigma, pool, n)
        np.testing.assert_array_equal(got, want)
        assert got.sum() == pool


# -- behaviour, the port alone (tests/test_streaming.py's cases) -------------

def _renderer(seed, cfg=CFG):
    return StreamingRenderer(cornell_box_scene(), smallpt_camera(), cfg,
                             seed=seed, device="cpu")


def test_flush_exact_weights():
    r = _renderer(0)
    r.step(n_iters=16, add_samples=4)
    r.step(n_iters=16, add_samples=4)
    r.flush()
    _, w = r.accumulators()
    assert (w.numpy() == 8).all()


def test_streaming_matches_perpass_statistically():
    """Other sample streams, the same estimator: at 32 spp the streaming and
    per-pass renderers agree within Monte Carlo noise."""
    r = _renderer(0)
    r.step(n_iters=8, add_samples=32)
    r.flush()
    a = r.image
    b = render_image(cornell_box_scene(), smallpt_camera(), CFG, seed=1,
                     n_passes=8, device="cpu").numpy()
    assert abs(a.mean() - b.mean()) < 0.08 * (b.mean() + 0.05)
    assert np.isclose(a, b, rtol=0.5, atol=0.25).mean() > 0.75


def test_partial_step_shows_progress():
    r = _renderer(3)
    rays1 = r.step(n_iters=4, add_samples=100)
    img1 = r.image
    rays2 = r.step(n_iters=4, add_samples=0)
    assert rays1 >= 0.99 * 4 * G and rays2 >= 0.99 * 4 * G
    assert not np.array_equal(img1, r.image)


def test_checkpoint_resume_bitexact(tmp_path):
    a = _renderer(11)
    a.step(n_iters=7, add_samples=4)
    path = str(tmp_path / "stream.npz")
    a.save_checkpoint(path)
    a.step(n_iters=64, add_samples=2)
    a.flush()
    b = _renderer(11)
    b.load_checkpoint(path)
    b.step(n_iters=64, add_samples=2)
    b.flush()
    np.testing.assert_array_equal(a.image, b.image)


def test_camera_update_resets():
    r = _renderer(1)
    r.step(n_iters=8, add_samples=2)
    assert r.budget == 2
    cam = smallpt_camera()
    r.update_camera(cam._replace(origin=cam.origin + 1.0))
    assert r.budget == 0 and int(r.accumulators()[1].sum()) == 0
    r.update_scene(cornell_box_scene())
    assert tmk.stream_pending(r.i) == (0, 0)


def test_adaptive_sampling_allocates_by_variance():
    r = _renderer(4)
    r.step(n_iters=64, add_samples=4)
    r.flush()
    _, var, n = tmk.stream_variance(r.f, r.i, r.config)
    var = var.numpy()
    assert (n.numpy() == 4).all() and var.max() > 0
    for _ in range(2):
        r.step_adaptive(n_iters=400, add_samples_total=2 * G)
    r.flush()
    w = r.accumulators()[1].numpy()
    assert w.min() >= 4 and w.max() > w.min()
    flat_v, flat_w = var.reshape(-1), w.reshape(-1)
    hi = flat_w[np.argsort(flat_v)[-len(flat_v) // 10:]]
    lo = flat_w[np.argsort(flat_v)[: len(flat_v) // 10]]
    assert hi.mean() > lo.mean() + 0.5, (hi.mean(), lo.mean())
    assert np.isfinite(r.image).all() and r.image.mean() > 0.05


def test_weights_monotone_and_capped():
    r = _renderer(5)
    r.step(n_iters=6, add_samples=2)
    w1 = r.accumulators()[1].numpy()
    r.step(n_iters=6, add_samples=2)
    w2 = r.accumulators()[1].numpy()
    assert (w2 >= w1).all() and w2.max() <= 4


def test_step_timed_equal_time_mode():
    r = _renderer(0)
    total = sum(r.step_timed(target_ms=50.0, add_samples=2) for _ in range(3))
    assert total > 0 and r._iters_per_s > 0
    r.flush()
    assert (r.accumulators()[1].numpy() == 6).all()


@pytest.mark.parametrize("case", ["reaches_target_or_budget",
                                  "respects_max_spp"])
def test_step_to_quality(case):
    if case == "respects_max_spp":
        # an unreachable target stops at the pool, drained
        r = _renderer(6)
        q = r.step_to_quality(rel_err=1e-5, quantile=0.95, max_spp=12,
                              min_spp=4, n_iters=2048)
        assert q["spp_max"] >= 12
        assert r.accumulators()[1].numpy().min() >= 4
        return
    r = _renderer(5)
    q = r.step_to_quality(rel_err=0.25, quantile=0.9, max_spp=64, min_spp=8,
                          n_iters=2048)
    assert q["spp_min"] >= 8
    w = r.accumulators()[1].numpy()
    assert w.min() >= q["spp_min"]
    mean, var, n = (t.numpy().reshape(-1)
                    for t in tmk.stream_variance(r.f, r.i, r.config))
    assert (n >= 2).all()
    stderr = np.sqrt(np.maximum(var, 0) / n) / (np.abs(mean) + 1e-2)
    assert float(np.quantile(stderr, 0.9)) <= 0.25 or q["spp_max"] >= 64, q
    if q["spp_max"] > q["spp_min"]:
        assert w.max() > w.min()


def test_launch_cap_bitexact(monkeypatch):
    """max_launch_iters re-chunks a step into chained launches without
    changing the result; a chunked step sums its rays on the device and
    reads them back once."""
    a = _renderer(5)
    rays_a = a.step(n_iters=24, add_samples=4)
    a.flush()
    b = _renderer(5)
    b.max_launch_iters = 5  # 24 -> 5+5+5+5+4, flush rounds capped too
    reads = []
    real_int = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "__int__",
                        lambda t: reads.append(1) or real_int(t))
    rays_b = b.step(n_iters=24, add_samples=4)
    assert len(reads) == 1 and rays_b == rays_a
    monkeypatch.undo()
    b.flush()
    for x, y in zip(a.accumulators(), b.accumulators()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert a.stats.rays == b.stats.rays


def test_v1_checkpoint_refused(tmp_path):
    r = _renderer(0)
    r.step(n_iters=4, add_samples=1)
    p = str(tmp_path / "ck.npz")
    r.save_checkpoint(p)
    data = dict(np.load(p))
    del data["stream_key_version"]  # a v1-era checkpoint
    np.savez(p, **data)
    with pytest.raises(ValueError, match="keying v1"):
        r.load_checkpoint(p)
    data["stream_key_version"], data["dda"] = 2, True
    np.savez(p, **data)
    with pytest.raises(ValueError, match="dda=True"):
        r.load_checkpoint(p)
    # the DDA route refuses a classic checkpoint the same way
    d = StreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                          dda=True, device="cpu")
    data["dda"] = False
    np.savez(p, **data)
    with pytest.raises(ValueError, match="dda=False"):
        d.load_checkpoint(p)


def test_checkpoint_wrong_resolution_refused(tmp_path):
    a = _renderer(2)
    a.step(n_iters=4, add_samples=1)
    path = str(tmp_path / "small.npz")
    a.save_checkpoint(path)
    b = _renderer(2, CFG.replace(width=128, height=96))  # 2 tiles, not 1
    with pytest.raises(ValueError, match="incompatible stream checkpoint"):
        b.load_checkpoint(path)


def test_capped_flush_drains_large_backlog():
    """Capped flush rounds against a large backlog: the pending counts sit
    still for many rounds while lanes owe samples; the drain must finish
    and match the uncapped one exactly."""
    a = _renderer(7)
    a.step(n_iters=2, add_samples=20)
    a.flush()
    b = _renderer(7)
    b.max_launch_iters = 3
    b.step(n_iters=2, add_samples=20)
    b.flush()
    for x, y in zip(a.accumulators(), b.accumulators()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (b.accumulators()[1].numpy() == 20).all()


# -- the wrapper and the route's limits --------------------------------------

def test_stream_step_wrapper_checks_and_counts_no_cpu_launch():
    table, cam = _port_inputs(CFG, cornell_box_scene())
    f, i = tmk.init_stream_state(CFG, device="cpu")
    before = tmk.stream_step.launches
    _, _, rays = tmk.stream_step(table, cam, CFG, trng.base_key(0), f, i, 1,
                                 4, n_spheres=9)
    assert tmk.stream_step.launches == before and 0 < int(rays) <= 4 * G
    for bad, exc in (((f[:8], i), ValueError), ((f.double(), i), TypeError),
                     ((f, i.long()), TypeError)):
        with pytest.raises(exc):
            tmk.stream_step(table, cam, CFG, trng.base_key(0), *bad, 1, 4)
    with pytest.raises(ValueError, match="out of range"):
        tmk.stream_step(table, cam, CFG.replace(nee_lights=(9,)),
                        trng.base_key(0), f, i, 1, 4, n_spheres=9)


def test_unported_streaming_routes_raise():
    """The streaming routes the port runs and the refusals that remain:
    dda=True and a scene the JAX package sends to its DDA route (above 2048
    spheres, at most one NEE light) take the DDA route; mesh scenes and
    refraction splitting raise."""
    cam = smallpt_camera()
    forced = StreamingRenderer(cornell_box_scene(), cam, CFG, dda=True,
                               device="cpu")
    assert forced._dda is not None and forced.f.shape[0] == 8 * 19
    big = StreamingRenderer(procedural_sphere_scene(n=2049), cam, CFG,
                            device="cpu")
    assert big._dda is not None and big.i.shape[0] == 8 * 9
    with pytest.raises(NotImplementedError, match="mesh"):
        StreamingRenderer(object(), cam, CFG, device="cpu")
    with pytest.raises(ValueError, match="split_budget"):
        StreamingRenderer(cornell_box_scene(), cam,
                          CFG.replace(split_budget=2), device="cpu")


def test_streaming_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmk.init_stream_state(CFG)


# -- the CLI's streaming route -------------------------------------------------

_CLI = ["--width", "16", "--height", "12", "--max-depth", "8", "--device",
        "cpu", "--quiet", "--streaming"]


def test_cli_streaming_checkpoint_resume_byte_equal(tmp_path):
    """--streaming renders spp x passes samples in one stream; a run saved
    with --checkpoint and continued with --resume writes the same bytes as
    the uninterrupted run (the same sample streams, summed in the same
    order)."""
    ck, a, b = (str(tmp_path / n) for n in ("ck.npz", "a.ppm", "b.ppm"))
    assert cli.main(["8", *_CLI, "--out", a, "--checkpoint", ck]) == 0
    assert cli.main(["8", *_CLI, "--out", b, "--resume", ck]) == 0
    whole = str(tmp_path / "whole.ppm")
    assert cli.main(["8", "--passes", "2", *_CLI, "--out", whole]) == 0
    assert open(b, "rb").read() == open(whole, "rb").read()
    r = _renderer(0, CFG.replace(spp_per_cell=2))
    r.step(n_iters=1_000_000, add_samples=8)
    r.flush()
    np.testing.assert_array_equal(img_io.read_ppm(a),
                                  img_io.to_int(r.image[::-1]))
    assert np.load(ck)["stream_key_version"] == 2


def test_cli_quality_stops_and_needs_streaming(tmp_path, capsys):
    out = str(tmp_path / "q.ppm")
    argv = ["16", *_CLI, "--quality", "0.5", "--out", out]
    assert cli.main(argv) == 0 and os.path.exists(out)
    with pytest.raises(SystemExit):
        cli.main(["16", "--quality", "0.5", "--device", "cpu", "--out", out])
    assert "--quality requires --streaming" in capsys.readouterr().err
