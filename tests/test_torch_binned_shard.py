"""parallel/binned_shard.py and the binned band hooks
(ops/megakernel.py: init_binned_state's pixel_lo/n_pix, set_binned_budget's
pixel_hi, binned_image's n_pix) over (tile, sample) meshes of CPU devices
(K8's plain version), against the port's single-device
BinnedStreamingRenderer, and one JAX reference.

Tolerances:
- against the port's own renderer: bit for bit, the JAX package's contract
  (tests/test_binned_shard.py): a T x S render equals n_streams = S, the
  tile axis is invisible, NEE included;
- against the JAX package's ShardedBinnedRenderer on the same mesh shape:
  the weights exactly (its test's own gate), the image under the JAX
  suite's gate for a dense procedural scene (tests/test_golden.py:
  139-172: at most 5% of values off by 10%, means within 5%).
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
from smallpt_tpu.parallel import binned_shard as jbs
from smallpt_tpu.parallel import shard as jshard
from smallpt_tpu_torch.config import CameraModel, Filter, Mode, RenderConfig
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    procedural_mesh_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.parallel import ShardedBinnedRenderer, make_mesh

CFG = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=8,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
SCENE = procedural_sphere_scene(80, seed=3)
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mesh(n_tile, n_sample):
    return make_mesh(n_tile, n_sample, devices=["cpu"] * (n_tile * n_sample))


def _drain(r, add, n_bounces=6):
    r.step(add_samples=add, n_bounces=n_bounces)
    r.flush()
    return tuple(x.numpy() for x in r.accumulators())


def test_drain_and_weights():
    r = ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(4, 2),
                              seed=0)
    rad, w = _drain(r, add=2)
    assert w.shape == (CFG.height, CFG.width)
    # 2 samples a shard x 2 sample shards = 4 spp everywhere, exact
    assert (w == 4).all() and r.spp_total == 4
    assert r.pending() == (0, 0)
    img = r.image
    assert np.isfinite(img).all() and img.mean() > 0.01


@pytest.mark.parametrize("n_tile,n_sample", MESHES)
def test_bit_equal_to_single_multistream(n_tile, n_sample):
    """T x S == single-device n_streams = S: shard s and stream s share
    ip_offset = s * IP_STRIDE, and 3 samples a shard are 3 S split over S
    streams."""
    rs = ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG,
                               _mesh(n_tile, n_sample), seed=0)
    rad_s, w_s = _drain(rs, add=3)
    r1 = BinnedStreamingRenderer(SCENE, smallpt_camera(), CFG, seed=0,
                                 n_streams=n_sample, inflight=1,
                                 device="cpu")
    rad_1, w_1 = _drain(r1, add=3 * n_sample)
    np.testing.assert_array_equal(w_s, w_1)
    np.testing.assert_array_equal(rad_s, rad_1)
    assert rs.stats.rays == r1.stats.rays


def test_tile_axis_invariance_and_inflight():
    """Re-sharding the tile axis never changes the image; two lanes a
    pixel (inflight 2) in the bands equal two in the whole image."""
    ra = ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(2, 2),
                               seed=0)
    rb = ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(4, 2),
                               seed=0)
    a, b = _drain(ra, add=2), _drain(rb, add=2)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    r2 = ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(4, 1),
                               seed=0, inflight=2)
    r1 = BinnedStreamingRenderer(SCENE, smallpt_camera(), CFG, seed=0,
                                 inflight=2, device="cpu")
    c, d = _drain(r2, add=3), _drain(r1, add=3)
    np.testing.assert_array_equal(c[1], d[1])
    np.testing.assert_array_equal(c[0], d[0])


def test_nee_bit_equal_to_single():
    cfg = CFG.replace(nee_lights=(8,))
    rs = ShardedBinnedRenderer(SCENE, smallpt_camera(), cfg, _mesh(4, 2),
                               seed=0)
    rad_s, w_s = _drain(rs, add=2)
    assert (w_s == 4).all()
    r1 = BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=0,
                                 n_streams=2, inflight=1, device="cpu")
    rad_1, w_1 = _drain(r1, add=4)
    np.testing.assert_array_equal(w_s, w_1)
    np.testing.assert_array_equal(rad_s, rad_1)


def test_band_hooks():
    """A band state's ids start at pixel_lo * inflight; the budget stops
    at the band's end; the band image is its rows; ids past int32 raise."""
    band = 4 * CFG.width
    f, i = tmk.init_binned_state(CFG, 2, pixel_lo=band, n_pix=band,
                                 device="cpu")
    q = tmk._plane(i, tmk._I_PIXEL)
    assert int(q.min()) == 2 * band
    assert q.shape[1] == tmk._binned_geometry(CFG, 2, band)[2]
    tmk.set_binned_budget(i, 5, CFG, inflight=2, pixel_hi=2 * band)
    bud = tmk._plane(i, tmk._I_BUDGET)
    inside = (q >> 1) < 2 * band
    assert (bud[inside] >= 2).all() and (bud[~inside] == 0).all()
    rad, w = tmk.binned_image(f, i, CFG, inflight=2, n_pix=band)
    assert rad.shape == (4, CFG.width, 3) and w.shape == (4, CFG.width)
    with pytest.raises(ValueError, match="int32"):
        tmk.init_binned_state(CFG, 1, pixel_lo=2 ** 31 - 100, n_pix=band,
                              device="cpu")


def test_guards():
    with pytest.raises(ValueError, match="Mode.FULL"):
        ShardedBinnedRenderer(SCENE, smallpt_camera(),
                              CFG.replace(mode=Mode.NORMAL), _mesh(2, 1))
    with pytest.raises(ValueError, match="power of two"):
        ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(2, 1),
                              inflight=3)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG, _mesh(3, 1))
    # float64 on the card raises (the CPU renders it in K8's float32
    # planes, as the single-device renderer)
    with pytest.raises(NotImplementedError, match="float32 only"):
        ShardedBinnedRenderer(SCENE, smallpt_camera(),
                              CFG.replace(dtype="float64"),
                              make_mesh(2, 1, devices=["cuda"] * 2))
    with pytest.raises(TypeError):
        ShardedBinnedRenderer(procedural_mesh_scene(n_balls=2),
                              smallpt_camera(), CFG, _mesh(2, 1))


def test_matches_jax_sharded_binned():
    """The JAX package's ShardedBinnedRenderer and the port's on a 2 x 2
    mesh: weights equal (4 spp everywhere), images under the dense
    procedural gate."""
    jcfg = JRenderConfig(width=24, height=16, spp_per_cell=1, max_depth=8,
                         camera_model=JCameraModel.LEGACY,
                         filter=JFilter.TENT)
    rj = jbs.ShardedBinnedRenderer(
        jscene.procedural_sphere_scene(80, seed=3), jcam.smallpt_camera(),
        jcfg, jshard.make_mesh(2, 2, devices=jax.devices("cpu")[:4]), seed=0)
    rj.step(add_samples=2, n_bounces=6)
    rj.flush()
    rad_j, w_j = (np.asarray(x) for x in rj.accumulators())
    rad, w = _drain(ShardedBinnedRenderer(SCENE, smallpt_camera(), CFG,
                                          _mesh(2, 2), seed=0), add=2)
    np.testing.assert_array_equal(w, w_j)
    a, b = rad / np.maximum(w, 1)[..., None], rad_j / np.maximum(
        w_j, 1)[..., None]
    rel = np.abs(a - b) / (1.0 + np.abs(b))
    assert (rel > 0.1).mean() <= 0.05, (rel > 0.1).mean()
    assert abs(a.mean() - b.mean()) < 0.05 * (abs(b.mean()) + 0.1)
