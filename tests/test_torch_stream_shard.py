"""parallel/stream_shard.py: the sharded continuous wavefront over (tile,
sample) meshes of CPU devices (K1c's and K3's plain versions) against the
port's single-device StreamingRenderer, and one JAX reference
(tests/test_stream_shard.py's gates).

Tolerances:
- against the port's own stream: bit for bit. Sample shard s streams with
  fold_in(key, s) and a tile's band of a stream equals the same rows of a
  whole-image stream lane for lane, so the sharded accumulators are the
  sum, in s order, of single-device streams keyed fold_in(key, s);
- DDA against classic, sharded: tests/test_stream_shard.py's (weights
  exact, radiance rtol 2e-4, atol 2e-3);
- against the JAX package's sharded stream on the same mesh shape: its
  test's gates (exact weights, means within 10%).
The flush tolerates DDA rounds that leave the pending counts unchanged
(ROADMAP.md hazard H9); the JAX package's sharded flush raises there.
"""

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu.config import CameraModel as JCameraModel
from smallpt_tpu.config import Filter as JFilter
from smallpt_tpu.config import RenderConfig as JRenderConfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.parallel import shard as jshard
from smallpt_tpu.parallel import stream_shard as jss
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer, drain_stream
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.parallel import ShardedStreamingRenderer, make_mesh
from smallpt_tpu_torch.parallel import stream_shard as tss

CFG = RenderConfig(width=16, height=8, spp_per_cell=1, max_depth=6,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
JCFG = JRenderConfig(width=16, height=8, spp_per_cell=1, max_depth=6,
                     camera_model=JCameraModel.LEGACY, filter=JFilter.TENT)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def big():
    return procedural_sphere_scene(2100), jscene.procedural_sphere_scene(2100)


def _mesh(n_tile, n_sample):
    return make_mesh(n_tile, n_sample, devices=["cpu"] * (n_tile * n_sample))


def _single_streams(scene, cfg, n_sample, seed, steps, dda=None):
    """The sum over s of single-device streams keyed fold_in(key, s)."""
    rad = w = None
    for s in range(n_sample):
        r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=seed,
                              dda=dda, device="cpu")
        r.key = rng.fold_in(rng.base_key(seed), s)
        for n_iters, add in steps:
            r.step(n_iters=n_iters, add_samples=add)
        r.flush()
        a, b = r.accumulators()
        rad = a if rad is None else rad + a
        w = b if w is None else w + b
    return rad.numpy(), w.numpy()


def test_drain_and_weights():
    r = ShardedStreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                                 _mesh(4, 2), seed=0)
    assert not r.dda
    r.step(n_iters=16, add_samples=2)
    r.step(n_iters=16, add_samples=2)
    r.flush()
    rad, w = r.accumulators()
    assert w.shape == (CFG.height, CFG.width)
    # 4 samples a shard x 2 sample shards = 8 spp everywhere
    assert (w == 8).all() and r.spp_total == 8
    img = r.image
    assert np.isfinite(img).all() and img.mean() > 0.05


@pytest.mark.parametrize("n_tile,n_sample", MESHES)
def test_bit_equal_to_single_device_streams(n_tile, n_sample):
    r = ShardedStreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                                 _mesh(n_tile, n_sample), seed=3)
    rays = r.step(n_iters=12, add_samples=2)
    rays += r.step(n_iters=12, add_samples=1)
    assert rays > 0
    r.flush()
    rad, w = (x.numpy() for x in r.accumulators())
    want_rad, want_w = _single_streams(cornell_box_scene(), CFG, n_sample, 3,
                                       [(12, 2), (12, 1)])
    np.testing.assert_array_equal(w, want_w)
    np.testing.assert_array_equal(rad, want_rad)
    assert (w == 3 * n_sample).all()


def test_deterministic():
    imgs = []
    for _ in range(2):
        r = ShardedStreamingRenderer(cornell_box_scene(), smallpt_camera(),
                                     CFG, _mesh(2, 2), seed=3)
        r.step(n_iters=100, add_samples=4)
        r.flush()
        imgs.append(r.image)
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_dda_auto_route_matches_classic_and_single(big):
    """A big scene auto-routes to the DDA kernel's plain version (the one
    routing rule, engine/streaming.py::dda_auto): bit-equal to the
    single-device DDA streams, and to the sharded classic route under
    tests/test_stream_shard.py's tolerance."""
    scene = big[0]
    mesh = _mesh(2, 2)
    r_dda = ShardedStreamingRenderer(scene, smallpt_camera(), CFG, mesh,
                                     seed=5)
    assert r_dda.dda
    r_cls = ShardedStreamingRenderer(scene, smallpt_camera(), CFG, mesh,
                                     seed=5, dda=False)
    for r in (r_dda, r_cls):
        r.step(n_iters=CFG.max_depth * 4, add_samples=2)
        r.flush()
    rad_a, w_a = (x.numpy() for x in r_dda.accumulators())
    rad_b, w_b = (x.numpy() for x in r_cls.accumulators())
    np.testing.assert_array_equal(w_a, w_b)
    np.testing.assert_allclose(rad_a, rad_b, rtol=2e-4, atol=2e-3)
    want_rad, want_w = _single_streams(scene, CFG, 2, 5,
                                       [(CFG.max_depth * 4, 2)])
    np.testing.assert_array_equal(w_a, want_w)
    np.testing.assert_array_equal(rad_a, want_rad)


def test_matches_jax_sharded_stream():
    """The JAX package's ShardedStreamingRenderer and the port's on a 2 x 2
    mesh, the same seed: the same per-shard keys, so the weights are
    equal; the images meet tests/test_stream_shard.py's mean gate."""
    mesh_j = jshard.make_mesh(2, 2, devices=jax.devices("cpu")[:4])
    rj = jss.ShardedStreamingRenderer(jscene.cornell_box_scene(),
                                      jcam.smallpt_camera(), JCFG, mesh_j,
                                      seed=0)
    rt = ShardedStreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                                  _mesh(2, 2), seed=0)
    for r in (rj, rt):
        r.step(n_iters=16, add_samples=3)
        r.flush()
    np.testing.assert_array_equal(rt.accumulators()[1].numpy(),
                                  np.asarray(rj.accumulators()[1]))
    a, b = rt.image, rj.image
    assert abs(a.mean() - b.mean()) < 0.1 * (b.mean() + 0.05)


def _stall_once(real, stalled):
    """A step that leaves the states as they are once (a flush round whose
    walks all run past its cap), then the real step."""
    def step(inputs, config, key, states, budget, n_iters, mesh, **kw):
        if not stalled:
            stalled.append(1)
            return states, 0
        return real(inputs, config, key, states, budget, n_iters, mesh, **kw)
    return step


def test_flush_tolerates_a_stalled_dda_round(big, monkeypatch):
    """Hazard H9: a DDA flush round can leave the pending counts unchanged
    (a walk longer than the round's cap). The port's sharded flush takes
    the capped tolerance and drains to the exact weights; the JAX
    package's raises "made no progress" on the same stall."""
    scene, jbig = big
    r = ShardedStreamingRenderer(scene, smallpt_camera(), CFG, _mesh(2, 1),
                                 seed=1)
    r.step(n_iters=2, add_samples=2)
    stalled = []
    monkeypatch.setattr(tss, "stream_step_sharded_dda",
                        _stall_once(tss.stream_step_sharded_dda, stalled))
    r.flush()
    assert stalled
    assert tss.stream_pending_sharded(r.states, CFG, r.mesh) == (0, 0)
    assert (r.accumulators()[1].numpy() == 2).all()

    rj = jss.ShardedStreamingRenderer(
        jbig, jcam.smallpt_camera(), JCFG,
        jshard.make_mesh(2, 1, devices=jax.devices("cpu")[:2]), seed=1)
    rj.step(n_iters=2, add_samples=2)
    real = jss.stream_step_sharded_dda
    j_stalled = []

    def j_step(scene_, camera, config, key, F, I, *a, **kw):
        if not j_stalled:
            j_stalled.append(1)
            return F, I, 0
        return real(scene_, camera, config, key, F, I, *a, **kw)

    monkeypatch.setattr(jss, "stream_step_sharded_dda", j_step)
    with pytest.raises(RuntimeError, match="no progress"):
        rj.flush()


def test_a_stuck_classic_flush_raises(monkeypatch):
    """The classic route drains in one uncapped round: a repeated pending
    count means a stuck stream and raises at once, as in both packages."""
    r = ShardedStreamingRenderer(cornell_box_scene(), smallpt_camera(), CFG,
                                 _mesh(2, 1), seed=1)
    r.step(n_iters=1, add_samples=2)
    monkeypatch.setattr(tss, "stream_step_sharded",
                        lambda inputs, config, key, states, *a, **k:
                        (states, 0))
    with pytest.raises(RuntimeError, match="no progress"):
        r.flush()


def test_functional_surface_and_checks():
    mesh = _mesh(2, 2)
    states = tss.init_sharded_stream(CFG, mesh)
    assert sorted(states) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    f, i = states[(1, 0)]
    assert f.shape == tmk.init_stream_state(CFG, 4, device="cpu")[0].shape
    inputs = tss.stream_inputs(cornell_box_scene(), smallpt_camera(), CFG,
                               mesh)
    states, rays = tss.stream_step_sharded(inputs, CFG, rng.base_key(0),
                                           states, 1, 64, mesh)
    assert rays > 0
    assert tss.stream_pending_sharded(states, CFG, mesh) == (0, 0)
    rad, w = tss.stream_accumulators_sharded(states, CFG, mesh)
    assert (w.numpy() == 2).all()
    with pytest.raises(ValueError, match="not divisible"):
        tss.init_sharded_stream(CFG.replace(height=6), _mesh(4, 1))


def test_drain_stream_tolerates_stall_limit_minus_one_repeats():
    """engine/streaming.py::drain_stream, the one drain of both flushes:
    stall_limit rounds in a row with the same pending counts raise, fewer
    pass, and a change resets the run."""
    def run(seq, limit):
        seq, rounds = list(seq), []
        drain_stream(lambda: seq[len(rounds)], lambda: rounds.append(1),
                     limit)
        return len(rounds)

    stalled = [(2, 0), (2, 0), (2, 0), (1, 0), (1, 0), (1, 0), (0, 0)]
    assert run(stalled, 3) == 6
    with pytest.raises(RuntimeError, match="no progress"):
        run(stalled, 2)
    assert run([(0, 0)], 1) == 0
