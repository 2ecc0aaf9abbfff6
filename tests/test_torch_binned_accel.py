"""The binned scheduler's host side and K8's plain version (ops/accel.py,
ops/megakernel.py's binned section) against the JAX package's, on the CPU
(tests/test_binned.py's scene and config: procedural_sphere_scene(80,
seed=3), 24x16, max_depth 10). K8 itself runs only on the card
(chip_smoke.py); here its wrapper runs the plain version.

Gates:
- the grid accel: every field equal to build_grid_accel's, exactly (the
  80-sphere scene with the camera's points, Cornell, the thin lens);
- bin keys, and the tile lists (lists, stops, dcut) of a fresh state, with
  and without shadow keys: equal, exactly;
- regen_binned: every i32 plane and the moments bit-equal, the RNG words
  and camera uniforms bit-equal, camera rays within 2 ulp (XLA:CPU
  contracts a*b + c into one rounding, torch does not: ROADMAP.md F3);
- nee_shadow_prep: directions within 1e-6, bin keys equal on all but 1% of
  lanes;
- the polynomial trig: within 2e-6 of the JAX package's, the axis and
  origin conventions exact;
- stream_step_binned_plain against JAX's stream_step_binned (its kernel in
  interpret mode), from the same state and lists, launch after launch of a
  chain: every i32 plane bit-equal on all but 2% of lanes, the radiance
  within 1e-4 relative on 98% of values, and the carried winner of lanes
  pending in both equal except near ties (8 ulp) and walls; and each
  package chaining its own state: budget, s_idx and pixel bit-equal on
  every lane, alive, the pending flag and the ray counter on all but 2%.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import binned as jb
from smallpt_tpu.ops import accel as jacc
from smallpt_tpu.ops import megakernel as jmk
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import binned as tb
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
    """The JAX package's RenderConfig with the port config's values."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(jconfig, type(v).__name__)(v.value)
        kw[f.name] = v
    return jconfig.RenderConfig(**kw)


def _accel_equal(ja, ta):
    for f in ("order", "lo", "inv_cell", "masks", "k_lo", "k_hi"):
        a, b = np.asarray(getattr(ja, f)), getattr(ta, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_glob_chunks", "n_chunks", "nb", "l_max", "geo_lo",
              "geo_hi"):
        assert getattr(ja, f) == getattr(ta, f), f


@pytest.mark.parametrize("case", ["proc80_camera", "cornell", "thin_lens"])
def test_build_grid_accel_equals_jax(case):
    if case == "cornell":
        js_, ts_ = jscene.cornell_box_scene(), tscene.cornell_box_scene()
        _accel_equal(jacc.build_grid_accel(js_, l_max=64),
                     tacc.build_grid_accel(ts_, l_max=64))
        return
    cfg = CFG if case == "proc80_camera" else CFG.replace(
        aperture=3.0, focal_distance=112.0)
    _accel_equal(
        jb.build_accel_for_camera(JSCENE, jcam.smallpt_camera(),
                                  _jax_config(cfg)),
        tb.build_accel_for_camera(SCENE, smallpt_camera(), cfg))


def test_accel_refuses_unindexable_scenes():
    walls_only = tscene.cornell_box_scene()
    walls_only = walls_only._replace(
        radius=torch.clamp(walls_only.radius, min=600.0))
    with pytest.raises(tacc.AccelUnsupported, match="no local"):
        tacc.build_grid_accel(walls_only)
    with pytest.raises(tacc.AccelUnsupported, match="no global"):
        tacc.build_grid_accel(SCENE, global_radius=1e9)


def test_ray_bin_keys_equal_jax():
    ja = jb.build_accel_for_camera(JSCENE, jcam.smallpt_camera(),
                                   _jax_config(CFG))
    ta = tb.build_accel_for_camera(SCENE, smallpt_camera(), CFG)
    r = np.random.default_rng(1)
    o = r.uniform((-60, -60, -40), (160, 140, 220), (8, 512, 3)).astype(
        np.float32).transpose(2, 0, 1).copy()
    d = r.normal(size=(3, 8, 512)).astype(np.float32)
    d[:, :, :16] = 0.0
    want = np.asarray(jacc.ray_bin_keys(*jnp.asarray(o), *jnp.asarray(d),
                                        ja))
    got = tacc.ray_bin_keys(*torch.from_numpy(o), *torch.from_numpy(d), ta)
    np.testing.assert_array_equal(got.numpy(), want)


def _fresh(cfg, inflight=1, budget=2, seed=0):
    """A JAX binned state after one regen_binned from fresh, and the JAX
    renderer that built its accel and tables."""
    jcfg = _jax_config(cfg)
    r = jb.BinnedStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                   seed=seed, inflight=inflight)
    f, i = jmk.init_binned_state(jcfg, inflight)
    i = jmk.set_binned_budget(i, budget, jcfg, inflight)
    return r, jcfg, f, i


@pytest.mark.parametrize("kind", ["default", "knear1_inflight4",
                                  "shadow_keys"])
def test_tile_work_lists_equal_jax(kind):
    """Lists, stops and dcut of a fresh state (every lane at its camera
    ray's origin: o + ts d = o exactly in both packages) equal the JAX
    package's; with shadow keys (the JAX package's, the same for both) too.
    96x88 lanes make two tiles."""
    cfg = CFG.replace(width=96, height=88)
    inflight = 4 if kind == "knear1_inflight4" else 1
    k_near = 1 if kind == "knear1_inflight4" else None
    jr, jcfg, f, i = _fresh(cfg, inflight)
    f, i = jmk.regen_binned(f, i, jr.cam_vec, jcfg, jr.key,
                            inflight=inflight)
    ta = tb.build_accel_for_camera(SCENE, smallpt_camera(), cfg)
    tf, ti = tmk.state_from_jax(f, i, device="cpu")
    jsk = tsk = None
    if kind == "shadow_keys":
        r = np.random.default_rng(2)
        jsk, tsk = [], []
        for _ in range(2):
            o = jnp.asarray(np.asarray(f)[:24])
            d = r.normal(size=(3, 8) + o.shape[1:]).astype(np.float32)
            valid = r.random((8,) + o.shape[1:]) < 0.3
            k = jacc.ray_bin_keys(o[0:8], o[8:16], o[16:24],
                                  *jnp.asarray(d), jr.accel)
            jsk.append((k, jnp.asarray(valid)))
            tsk.append((torch.from_numpy(np.array(k)),
                        torch.from_numpy(valid)))
    want = jacc.tile_work_lists_bucketed(f, i, jcfg, jr.accel,
                                         k_near=k_near, shadow_keys=jsk)
    got = tacc.tile_work_lists_bucketed(tf, ti, cfg, ta, k_near=k_near,
                                        shadow_keys=tsk)
    assert got[0].shape[0] >= 2 and got[0].shape[1] == ta.l_max
    for name, w, g in zip(("lists", "stops", "dcut"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    if kind == "knear1_inflight4":
        assert np.isfinite(got[2].numpy()).any()  # a prefix, not all


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


@pytest.mark.parametrize("kw", [
    {}, {"inflight": 2, "aperture": 3.0, "focal_distance": 112.0}],
    ids=["pinhole", "inflight2_lens"])
def test_regen_binned_equals_jax(kw):
    """Mid-stream (after two JAX launches: lanes with s_idx past 0 and
    some alive), regen_binned against the JAX package's: i32 planes and
    m1/m2 bit-equal; the lane's RNG words and camera uniforms bit-equal;
    the regenerated rays within 2 ulp."""
    kw = dict(kw)
    inflight = kw.pop("inflight", 1)
    cfg = CFG.replace(**kw)
    jr, jcfg, f, i = _fresh(cfg, inflight, budget=3, seed=4)
    for _ in range(2):
        f, i = _jax_launch(jr, jcfg, f, i, inflight)[2]
    tf, ti = tmk.state_from_jax(f, i, device="cpu")
    jf, ji = jmk.regen_binned(f, i, jr.cam_vec, jcfg, jr.key,
                              inflight=inflight)
    tmk.regen_binned(tf, ti, tmk.build_camera_vec(smallpt_camera(), cfg),
                     cfg, rng.base_key(4), inflight=inflight)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jf = np.asarray(jf)
    np.testing.assert_array_equal(tf.numpy()[8 * 6:], jf[8 * 6:])
    assert _ulp_diff(tf.numpy()[:48], jf[:48]).max() <= 2
    # the words and uniforms of each lane's current sample
    q = ti.numpy()[8 * 6:8 * 7].reshape(-1).astype(np.int64)
    s_idx = ti.numpy()[8:16].reshape(-1).astype(np.int64)
    pix, ip = tmk._lane_sample(torch.from_numpy(q), torch.from_numpy(s_idx),
                               0, inflight)
    sub = q - (pix.numpy() << (inflight.bit_length() - 1))
    ip_np = s_idx + sub * (1 << 20)
    np.testing.assert_array_equal(ip.numpy(), ip_np)
    k0, k1 = rng.key_words(rng.base_key(4))
    wa, wb = rng.stream_key_words(rng.base_key(4), pix, ip)
    np.testing.assert_array_equal(wa.numpy(), (pix.numpy() ^ k0) & 0xFFFFFFFF)
    np.testing.assert_array_equal(
        wb.numpy(), (k1 ^ ((ip_np * 0x9E3779B1) & 0xFFFFFFFF)))
    want = np.asarray(jrng.stream_camera_uniforms(
        jr.key, jnp.asarray(pix.numpy(), jnp.int32),
        jnp.asarray(ip_np, jnp.int32)))
    np.testing.assert_array_equal(
        rng.stream_camera_uniforms(rng.base_key(4), pix, ip).numpy(), want)


def test_nee_shadow_prep_matches_jax():
    """After a JAX NEE launch (pending shadow bits set), the shadow
    directions drawn by both packages: within 1e-6, the dummy (0, 0, 1) on
    lanes without a bit; the shadow rays' bin keys equal on all but 1% of
    the pending lanes (a direction near a cone boundary may bin apart)."""
    cfg = CFG.replace(nee_lights=(8,))
    jr, jcfg, f, i = _fresh(cfg, budget=3)
    f, i = _jax_launch(jr, jcfg, f, i, 1)[2]
    f, i = jmk.regen_binned(f, i, jr.cam_vec, jcfg, jr.key)
    tf, ti = tmk.state_from_jax(f, i, device="cpu")
    jf, jkeys = jacc.nee_shadow_prep(f, i, jr.table, jcfg, jr.accel, jr.key,
                                     nee_rows=jr.nee_rows)
    tr = tb.BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg,
                                    device="cpu")
    assert tr.nee_rows == jr.nee_rows
    _, tkeys = tacc.nee_shadow_prep(tf, ti, tr.table, cfg, tr.accel,
                                    rng.base_key(0), nee_rows=tr.nee_rows)
    ld = slice(8 * tmk._F_LD0, 8 * (tmk._F_LD0 + 3))
    np.testing.assert_allclose(tf.numpy()[ld], np.asarray(jf)[ld], atol=1e-6)
    valid = np.asarray(jkeys[0][1])
    assert valid.sum() > 20
    np.testing.assert_array_equal(tkeys[0][1].numpy(), valid)
    dummy = tf.numpy()[ld].reshape(3, 8, -1)[:, ~valid]
    assert (dummy[:2] == 0).all() and (dummy[2] == 1).all()
    differ = (tkeys[0][0].numpy() != np.asarray(jkeys[0][0]))[valid]
    assert differ.mean() <= 0.01, differ.mean()


def test_polynomial_trig_matches_jax():
    """_atan2_poly and _asin_poly against the JAX package's (the kernel's
    copies are held to these on the card) and numpy: within 2e-6 of JAX's
    (XLA:CPU fuses the polynomial's multiply-adds), 2e-5 of the true
    functions, exact on the axes and at the poles."""
    r = np.random.RandomState(0)
    y = r.uniform(-2, 2, 4096).astype(np.float32)
    x = r.uniform(-2, 2, 4096).astype(np.float32)
    got = tmk._atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jmk._atan2_poly(jnp.asarray(y), jnp.asarray(x)))
    assert np.abs(got - want).max() < 2e-6
    assert np.abs(got - np.arctan2(y, x)).max() < 2e-5
    for yy, xx, w in [(0.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, -1.0, np.pi),
                      (1.0, 0.0, np.pi / 2), (-1.0, 0.0, -np.pi / 2)]:
        g = float(tmk._atan2_poly(torch.tensor(yy), torch.tensor(xx)))
        assert abs(g - w) < 2e-5, (yy, xx, g)
    s = r.uniform(-1, 1, 4096).astype(np.float32)
    ga = tmk._asin_poly(torch.from_numpy(s)).numpy()
    assert np.abs(ga - np.asarray(jmk._asin_poly(jnp.asarray(s)))).max() \
        < 2e-6
    assert np.abs(ga - np.arcsin(s)).max() < 2e-5
    assert float(tmk._asin_poly(torch.tensor(1.0))) == np.float32(np.pi / 2)
    assert float(tmk._asin_poly(torch.tensor(-1.0))) == -np.float32(
        np.pi / 2)


# -- K8's plain version against the JAX kernel (interpret mode) --------------

def _jax_launch(jr, jcfg, f, i, inflight):
    """regen, NEE prep and lists through the JAX package, then its
    stream_step_binned: (state in, lists, state out, rays)."""
    f, i = jmk.regen_binned(f, i, jr.cam_vec, jcfg, jr.key,
                            inflight=inflight)
    sk = None
    if jr.nee_rows:
        f, sk = jacc.nee_shadow_prep(f, i, jr.table, jcfg, jr.accel, jr.key,
                                     inflight=inflight, nee_rows=jr.nee_rows)
    lists = jacc.tile_work_lists_bucketed(f, i, jcfg, jr.accel,
                                          k_near=jr.k_near, shadow_keys=sk)
    fo, io, rays = jmk.stream_step_binned(
        jr.table, jcfg, jr.key, f, i, *lists,
        n_glob_chunks=jr.accel.n_glob_chunks, n_chunks=jr.accel.n_chunks,
        inflight=inflight, geo_lo=jr.accel.geo_lo, geo_hi=jr.accel.geo_hi,
        nee_rows=jr.nee_rows)
    return (f, i), lists, (fo, io), int(rays)


def _plane(buf, k):
    return np.asarray(buf)[8 * k:8 * k + 8]


@pytest.mark.parametrize("kw", [
    {}, {"nee_lights": (8,)}, {"k_near": 1, "inflight": 2}],
    ids=["full", "nee", "knear1_inflight2"])
def test_plain_k8_matches_jax_kernel(kw):
    kw = dict(kw)
    inflight = kw.pop("inflight", 1)
    k_near = kw.pop("k_near", None)
    cfg = CFG.replace(**kw)
    jcfg = _jax_config(cfg)
    jr = jb.BinnedStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                    seed=0, inflight=inflight,
                                    k_near=k_near)
    tr = tb.BinnedStreamingRenderer(SCENE, smallpt_camera(), cfg, seed=0,
                                    inflight=inflight, k_near=k_near,
                                    device="cpu")
    np.testing.assert_array_equal(tr.table.numpy(), np.asarray(jr.table))
    f, i = jmk.init_binned_state(jcfg, inflight)
    i = jmk.set_binned_budget(i, 2, jcfg, inflight)
    # the port chains its own state beside
    own_f, own_i = tmk.init_binned_state(cfg, inflight, device="cpu")
    tmk.set_binned_budget(own_i, 2, cfg, inflight)
    n_lanes = f.shape[1] * 8
    pending_seen = 0
    for launch in range(7):
        (fin, iin), lists, (fo, io), jrays = _jax_launch(jr, jcfg, f, i,
                                                         inflight)
        tf, ti = tmk.state_from_jax(fin, iin, device="cpu")
        tl = [torch.from_numpy(np.array(x)) for x in lists]
        _, _, trays = tmk.stream_step_binned(
            tr.table, cfg, rng.base_key(0), tf, ti, *tl,
            n_glob_chunks=tr.accel.n_glob_chunks,
            n_chunks=tr.accel.n_chunks, inflight=inflight,
            geo_lo=tr.accel.geo_lo, geo_hi=tr.accel.geo_hi,
            nee_rows=tr.nee_rows)
        # from the same state: the i32 planes, the radiance, the winners
        ti_, io_ = ti.numpy(), np.asarray(io)
        moved = (ti_ != io_).reshape(-1, 8, ti_.shape[1]).any(axis=0)
        assert moved.sum() <= 0.02 * n_lanes, (launch, moved.sum())
        assert abs(int(trays) - jrays) <= max(2, 0.02 * jrays)
        for k in range(9, 12):
            a, b = tf.numpy()[8 * k:8 * k + 8], _plane(fo, k)
            close = np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert close.mean() >= 0.98, (launch, k, close.mean())
        pend = (_plane(io, tmk._I_PEND) != 0) & (
            ti_[8 * tmk._I_PEND:8 * tmk._I_PEND + 8] != 0)
        pending_seen += int(pend.sum())
        bi_t, bi_j = (tf.numpy()[8 * tmk._F_BID:8 * tmk._F_BID + 8][pend],
                      _plane(fo, tmk._F_BID)[pend])
        bt_j = _plane(fo, tmk._F_BT)[pend]
        bt_t = tf.numpy()[8 * tmk._F_BT:8 * tmk._F_BT + 8][pend]
        wall = (tr.table.numpy()[np.maximum(bi_j, 0).astype(int), 3] >= 50)
        tie = np.abs(bt_t - bt_j) <= 8 * np.spacing(np.abs(bt_j))
        assert ((bi_t == bi_j) | tie | wall).all(), launch
        # each package on its own chain
        tmk.regen_binned(own_f, own_i, tr._camv, cfg, tr.key,
                         inflight=inflight)
        sk = None
        if tr.nee_rows:
            _, sk = tacc.nee_shadow_prep(own_f, own_i, tr._table_host, cfg,
                                         tr.accel, tr.key,
                                         inflight=inflight,
                                         nee_rows=tr.nee_rows)
        own_lists = tacc.tile_work_lists_bucketed(
            own_f, own_i, cfg, tr.accel, k_near=tr.k_near, shadow_keys=sk)
        tmk.stream_step_binned(
            tr.table, cfg, tr.key, own_f, own_i, *own_lists,
            n_glob_chunks=tr.accel.n_glob_chunks,
            n_chunks=tr.accel.n_chunks, inflight=inflight,
            geo_lo=tr.accel.geo_lo, geo_hi=tr.accel.geo_hi,
            nee_rows=tr.nee_rows)
        oi = own_i.numpy()
        for k in (tmk._I_BUDGET, tmk._I_SIDX, tmk._I_PIXEL):
            np.testing.assert_array_equal(oi[8 * k:8 * k + 8],
                                          _plane(io, k), err_msg=str(k))
        for k in (tmk._I_ALIVE, tmk._I_PEND, tmk._I_RAYS):
            differ = (oi[8 * k:8 * k + 8] != _plane(io, k)).sum()
            assert differ <= 0.02 * n_lanes, (launch, k, differ)
        f, i = fo, io
    if k_near == 1:
        assert pending_seen > 0  # the frontier march ran


def test_kernel_refuses_other_lane_widths(monkeypatch):
    """SMALLPT_TPU_BINNED_LANE reaches the plain version and the tile lists;
    K8 is built for 1,024-column tiles, so a launch off the CPU at another
    width raises a ValueError that names the knob (checked on "meta"
    tensors: the refusal comes before the library is loaded)."""
    monkeypatch.setattr(tmk, "_LANE_B", 512)
    nf, ni = tmk._nf_b(CFG), tmk._ni_b(CFG)
    f = torch.zeros((8 * nf, 512), dtype=torch.float32, device="meta")
    i = torch.zeros((8 * ni, 512), dtype=torch.int32, device="meta")
    table = torch.zeros((24, 16), dtype=torch.float32, device="meta")
    lists = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    stops = torch.zeros((1,), dtype=torch.int32, device="meta")
    dcut = torch.zeros((1,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="SMALLPT_TPU_BINNED_LANE=512"):
        tmk.stream_step_binned(table, CFG, rng.base_key(0), f, i, lists,
                               stops, dcut, n_glob_chunks=2, n_chunks=1)
