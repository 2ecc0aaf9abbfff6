"""The binned scheduler's options that are off by default (ops/accel.py's
bin sort and three-program lists, engine/binned.py's ``sort_every`` and
``fused=False``) against the JAX package's and against the port's own
fused, unsorted bounce, on the CPU (tests/test_binned.py's scenes and
config: procedural_sphere_scene(80, seed=3) and (300, seed=7), 24x16,
max_depth 10; K8 runs as its plain version).

Gates:
- on one marched state (the JAX renderer's, three-program, after a few
  bounces, so lanes carry frontiers and pending bounces), the sort keys,
  the shuffled state (every f32 and int32 plane) and the lists, stops and
  dcut of both list builders equal the JAX package's, exactly. The JAX
  side runs with jit disabled: XLA:CPU fuses o + ts * d into one rounding
  (ROADMAP.md F3), which moves a frontier by an ulp;
- sorting never and every bounce, and the fused and the three-program
  bounce, give the same accumulators bit for bit
  (tests/test_binned.py::test_binned_bitexact_with_sorting_disabled_and_frequent,
  ::test_binned_fused_bitexact_vs_three_program);
- the sort-free lists hold each tile's reach set in chunk order with exact
  stops (::test_nosort_lists_cover_reach_exactly).
"""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import binned as jb
from smallpt_tpu.ops import accel as jacc
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import binned as tb
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.ops import accel as tacc
from smallpt_tpu_torch.ops import megakernel as tmk

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


def _jax_config(cfg: RenderConfig):
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


@pytest.fixture(scope="module")
def marched():
    """The JAX three-program renderer's state on procedural_sphere_scene(
    300, seed=7) after 3 bounces of 2 samples a pixel (96x88: two tiles)
    with a one-chunk near prefix (k_near 1: a few hundred lanes still
    pending, marching), with the port's accel of the same scene and camera
    and the state moved across."""
    cfg = CFG.replace(width=96, height=88)
    jr = jb.BinnedStreamingRenderer(
        jscene.procedural_sphere_scene(300, seed=7), jcam.smallpt_camera(),
        _jax_config(cfg), fused=False, k_near=1)
    jr.step(add_samples=2, n_bounces=3)
    ta = tb.build_accel_for_camera(
        tscene.procedural_sphere_scene(300, seed=7), smallpt_camera(), cfg)
    tf, ti = tmk.state_from_jax(jr.f, jr.i, device="cpu")
    return cfg, jr, ta, tf, ti


def test_marched_state_is_a_real_test(marched):
    """The shared state has pending lanes and marched frontiers, so the
    keys' offsets and the lists' distances are exercised."""
    _, _, _, tf, ti = marched
    pend = tmk._plane(ti, tmk._I_PEND) != 0
    alive = tmk._plane(ti, tmk._I_ALIVE) != 0
    assert (pend & alive).any() and alive.any() and (~alive).any()
    assert (tmk._plane(tf, tmk._F_TS)[alive] > 0).any()


def test_state_bin_keys_and_shuffle_equal_jax(marched):
    cfg, jr, ta, tf, ti = marched
    with jax.disable_jit():
        jkeys = jacc.state_bin_keys(jr.f, jr.i, jr.accel)
        jf, ji = jacc.shuffle_state(jr.f, jr.i, jkeys)
    keys = tacc.state_bin_keys(tf, ti, ta)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    assert len(np.unique(keys.numpy())) > 8  # a real permutation
    sf, si = tacc.shuffle_state(tf, ti, keys)
    np.testing.assert_array_equal(sf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    # a permutation within each row: every lane id kept once
    q = tmk._plane(si, tmk._I_PIXEL)
    assert torch.equal(q.sort(dim=1).values,
                       tmk._plane(ti, tmk._I_PIXEL).sort(dim=1).values)


@pytest.mark.parametrize("kind", ["sort", "nosort"])
def test_tile_work_lists_equal_jax(kind, marched):
    cfg, jr, ta, tf, ti = marched
    jcfg = _jax_config(cfg)
    with jax.disable_jit():
        if kind == "sort":
            want = jacc.tile_work_lists(jr.f, jr.i, jcfg, jr.accel, k_near=1)
        else:
            want = jacc.tile_work_lists_nosort(jr.f, jr.i, jcfg, jr.accel)
    got = (tacc.tile_work_lists(tf, ti, cfg, ta, k_near=1) if kind == "sort"
           else
           tacc.tile_work_lists_nosort(tf, ti, cfg, ta))
    lists, stops, dcut = (np.asarray(w) for w in want)
    n = lists.shape[1]
    assert got[0].shape == (lists.shape[0], ta.l_max)
    np.testing.assert_array_equal(got[0].numpy()[:, :n], lists)
    np.testing.assert_array_equal(got[1].numpy(), stops)
    np.testing.assert_array_equal(got[2].numpy(), dcut)
    if kind == "sort":
        assert np.isfinite(dcut).any()  # a prefix, not all


def _sums(scene, cfg, spp, **kw):
    r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg, device="cpu",
                                **kw)
    r.step(add_samples=spp, n_bounces=4)
    r.flush()
    rad, w = r.accumulators()
    return rad.numpy(), w.numpy()


def test_binned_bitexact_with_sorting_disabled_and_frequent():
    a, wa = _sums(SCENE, CFG, 2, sort_every=0)
    b, wb = _sums(SCENE, CFG, 2, sort_every=1)
    assert (wa == 2).all() and (wb == 2).all()
    assert (a == b).all()


def test_binned_fused_bitexact_vs_three_program():
    cfg = CFG.replace(width=16, height=12, max_depth=8)
    a, wa = _sums(SCENE, cfg, 4, fused=True)
    b, wb = _sums(SCENE, cfg, 4, fused=False)
    assert (wa == wb).all() and (wa == 4).all()
    assert (a == b).all()


def test_nosort_lists_cover_reach_exactly():
    scene = tscene.procedural_sphere_scene(300, seed=7)
    accel = tacc.build_grid_accel(scene)
    cfg = CFG.replace(width=16, height=12)
    r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg, accel=accel,
                                fused=False, device="cpu")
    r.step(add_samples=2, n_bounces=3)
    lists, stops, dcut = tacc.tile_work_lists_nosort(r.f, r.i, cfg,
                                                     r.accel)
    assert torch.isinf(dcut).all()
    p = lambda buf, k: tmk._plane(buf, k)  # noqa: E731
    key_live = tacc.ray_bin_keys(p(r.f, 0), p(r.f, 1), p(r.f, 2),
                                 p(r.f, 3), p(r.f, 4), p(r.f, 5), r.accel)
    alive = p(r.i, tmk._I_ALIVE) != 0
    lo, hi = tacc._masked_minmax(key_live, alive, r.accel.n_bins)
    bins = np.arange(r.accel.n_bins)
    in1 = ((bins[None, :] >= lo.numpy()[:, None])
           & (bins[None, :] <= hi.numpy()[:, None]))
    reach = (in1.astype(np.float32) @ r.accel.masks.numpy()) > 0
    for t in range(reach.shape[0]):
        ids = np.nonzero(reach[t])[0]
        if ids.size > r.accel.l_max:
            assert stops[t] == -1
            continue
        assert stops[t] == ids.size
        assert (lists[t, :ids.size].numpy() == ids).all()
