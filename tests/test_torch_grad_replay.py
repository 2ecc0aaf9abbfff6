"""The recorded-winner replay differentiator (grad/replay.py), its
recorder K1b (ops/megakernel.py::render_record_megakernel, here its plain
version) and the hybrid intersector's replay (ops/intersect_pallas.py::
_replay_winner, intersect_spheres_hybrid_diff) against the JAX package's,
on the CPU, at tests/test_grad_replay.py's shapes: Cornell 12x12, 4 spp,
max_depth 4, LEGACY, TENT, PALLAS. Inputs come from the seed through numpy
(grad/diff.py::params_from_numpy, grad/replay.py::winners_from_numpy).

Gates:
- _replay_winner and intersect_spheres_hybrid_diff on random rays against
  Cornell, walls included: t and the winner equal; x and n within 2 ulp of
  the sphere's scale; autograd gradients of a scalar of (t, x, n) with
  respect to center and radius within rtol 1e-5 of jax.grad;
- record_forward (K1b's plain version against the JAX kernel in interpret
  mode): winners equal on at least 98% of (depth, lane) entries, each
  differing lane's first difference on a wall (ROADMAP.md F3: XLA:CPU
  contracts FMAs and a 1e5-radius wall grows an ulp into another hit);
  rays within max(64, 0.1%); the image under tests/test_megakernel.py::
  _compare's gate;
- the replay on the JAX package's winners: replay_mean within atol 1e-6 of
  JAX's; gradients of the replay loss: albedo and emission within rtol
  1e-4, center and radius within rtol 1e-3 + 1e-3 max|g|
  (tests/test_grad_replay.py::test_geometry_gradients_match_scan_tight's
  bar);
- the port's replay reproduces its own record image (atol 1e-6), and the
  port alone holds tests/test_grad_replay.py's FD, remat, fallback and
  finiteness gates at their bars.
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu import config as jconfig
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.grad import diff as jdiff
from smallpt_tpu.grad import replay as jreplay
from smallpt_tpu.ops import intersect_pallas as jip
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, RenderConfig,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.grad import diff
from smallpt_tpu_torch.grad import replay
from smallpt_tpu_torch.ops import intersect_pallas as tip
from smallpt_tpu_torch.ops import megakernel as tmk

CFG = RenderConfig(width=12, height=12, spp_per_cell=1, max_depth=4,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                   intersector=Intersector.PALLAS)
FIELDS = ("albedo", "emission", "center", "radius")


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


def _scene_from_jax(jsc):
    """The port's scene with the JAX scene's parameters, through numpy."""
    params, refl = jdiff.split_scene(jsc)
    p = diff.params_from_numpy([np.asarray(x) for x in params], "cpu")
    return diff.merge_scene(p, torch.from_numpy(np.array(refl)))


@pytest.fixture(scope="module")
def ref():
    """Each JAX function once: the target (render_mean, key 99), the
    record (K1b in interpret mode), the replay image on its winners and the
    replay's loss and gradients."""
    jsc, jc, jcfg = jscene.cornell_box_scene(), jcam.smallpt_camera(), \
        _jax_config(CFG)
    key = jrng.base_key(0)
    target = np.array(jdiff.render_mean(jsc, jc, jcfg, jrng.base_key(99)))
    img, winners, rays = jreplay.record_forward(jsc, jc, jcfg, key)
    rimg = jax.jit(jreplay.replay_mean, static_argnames=("config",))(
        jsc, jc, jcfg, key, winners)
    loss, _, grads = jdiff.image_loss_and_grads(jsc, jc, jcfg, key, target)
    return dict(scene=_scene_from_jax(jsc), target=target,
                img=np.asarray(img), winners=np.asarray(winners),
                rays=int(rays), rimg=np.asarray(rimg), loss=float(loss),
                grads={n: np.asarray(getattr(grads, n)) for n in FIELDS})


def _rays(n=256, seed=0):
    """Random rays inside the Cornell box, every direction (walls, balls,
    the light and grazing hits)."""
    r = np.random.default_rng(seed)
    o = r.uniform([5, 5, 20], [95, 75, 150], (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _scale_ulp(center, radius, inst):
    """2 ulp of each lane's winner's scale, max(|c|, r)."""
    sc = np.maximum(np.abs(center[inst]).max(axis=1), radius[inst])
    return 2 * np.spacing(sc.astype(np.float32))


@pytest.mark.parametrize("fn", ["replay_winner", "hybrid"])
def test_replay_matches_jax(fn):
    jsc = jscene.cornell_box_scene()
    c0, r0 = np.asarray(jsc.center), np.asarray(jsc.radius)
    o, d = _rays()
    w = np.random.default_rng(1).normal(size=(7, o.shape[0])).astype(
        np.float32)
    hit_idx = jip.intersect_spheres_pallas(jnp.asarray(o), jnp.asarray(d),
                                           jsc).inst
    idx = np.array(hit_idx)
    t_k = np.asarray(jip.intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), jsc).t)

    def jax_hit(center, radius):
        if fn == "hybrid":
            s = jsc._replace(center=center, radius=radius)
            h = jip.intersect_spheres_hybrid_diff(jnp.asarray(o),
                                                  jnp.asarray(d), s)
            return h.t, h.inst, h.x, h.n
        t, x, n, _ = jip._replay_winner(
            jnp.asarray(o), jnp.asarray(d), center[idx], radius[idx],
            jnp.asarray(np.isfinite(t_k)), 1e-4, 5e-7)
        return t, jnp.asarray(idx), x, n

    def jax_scalar(center, radius):
        t, _, x, n = jax_hit(center, radius)
        tf = jnp.where(jnp.isfinite(t), t, 0.0)
        return (jnp.sum(w[0] * tf) + jnp.sum(w[1:4].T * x)
                + jnp.sum(w[4:7].T * n))

    jt, ji, jx, jn = (np.asarray(v) for v in jax_hit(jsc.center,
                                                      jsc.radius))
    jgc, jgr = jax.grad(jax_scalar, argnums=(0, 1))(jsc.center, jsc.radius)

    center = torch.from_numpy(c0.copy()).requires_grad_(True)
    radius = torch.from_numpy(r0.copy()).requires_grad_(True)
    ts = tscene.cornell_box_scene()._replace(center=center, radius=radius)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    if fn == "hybrid":
        h = tip.intersect_spheres_hybrid_diff(to, td, ts)
        t, inst, x, n = h.t, h.inst, h.x, h.n
    else:
        ii = torch.from_numpy(idx).long()
        t, x, n, _ = tip._replay_winner(
            to, td, center[ii], radius[ii],
            torch.from_numpy(np.isfinite(t_k)), 1e-4, 5e-7)
        inst = ii
    tf = torch.where(torch.isfinite(t), t, 0.0)
    wt = torch.from_numpy(w)
    scalar = (torch.sum(wt[0] * tf) + torch.sum(wt[1:4].T * x)
              + torch.sum(wt[4:7].T * n))
    gc, gr = torch.autograd.grad(scalar, (center, radius))

    np.testing.assert_array_equal(t.detach().numpy(), jt)
    np.testing.assert_array_equal(inst.numpy(), ji)
    hit = np.isfinite(jt)
    assert 0.5 < hit.mean() <= 1.0
    tol = _scale_ulp(c0, r0, ji)[:, None]
    assert (np.abs(x.detach().numpy() - jx) <= tol).all()
    assert (np.abs(n.detach().numpy() - jn) <= 2 * np.spacing(
        np.float32(1.0))).all()
    for g, jg in ((gc, jgc), (gr, jgr)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * np.abs(jg).max())


def test_routing():
    scene = tscene.cornell_box_scene()
    assert replay.use_replay(scene, CFG)
    assert not replay.use_replay(scene, CFG.replace(diff_replay=False))
    assert not replay.use_replay(scene, CFG.replace(nee_lights=(8,)))
    assert not replay.use_replay(scene, CFG.replace(split_budget=4))
    assert not replay.use_replay(scene,
                                 CFG.replace(intersector=Intersector.JAX))


def test_record_forward_matches_jax(ref):
    """K1b's plain version against the JAX kernel in interpret mode."""
    img, winners, rays = replay.record_forward(
        ref["scene"], smallpt_camera(), CFG, rng.base_key(0), device="cpu")
    w, jw = winners.numpy(), ref["winners"]
    assert w.shape == jw.shape == (CFG.max_depth, CFG.n_pixels * CFG.spp)
    assert (w >= 0).mean() > 0.3
    assert (w == jw).mean() >= 0.98, (w != jw).sum()
    big = np.asarray(jscene.cornell_box_scene().radius) >= tip.STABLE_RADIUS
    for lane in np.nonzero((w != jw).any(axis=0))[0]:
        d = int(np.nonzero(w[:, lane] != jw[:, lane])[0][0])
        involved = {int(v) for v in (w[d, lane], jw[d, lane],
                                     w[max(d - 1, 0), lane]) if v >= 0}
        assert any(big[v] for v in involved), (lane, d, involved)
    assert abs(int(rays) - ref["rays"]) <= max(64, 0.001 * ref["rays"])
    a, b = img.numpy(), ref["img"]
    rel = np.abs(a - b) / (1.0 + np.abs(b))
    assert np.isfinite(a).all() and (rel > 0.1).mean() <= 0.02
    assert abs(a.mean() - b.mean()) < 0.05 * (abs(b.mean()) + 0.1)


def _replay_loss_grads(scene, winners, target, cfg=CFG):
    params, refl = diff.split_scene(scene)
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    img = replay.replay_mean(diff.merge_scene(diff.SceneParams(*leaves),
                                              refl),
                             smallpt_camera(), cfg, rng.base_key(0),
                             winners, device="cpu")
    loss = torch.mean((img - torch.from_numpy(target)) ** 2)
    g = torch.autograd.grad(loss, leaves)
    return img.detach().numpy(), dict(zip(diff.SceneParams._fields, g))


def test_replay_on_jax_winners_matches_jax(ref):
    winners = replay.winners_from_numpy(ref["winners"], "cpu")
    img, g = _replay_loss_grads(ref["scene"], winners, ref["target"])
    np.testing.assert_allclose(img, ref["rimg"], rtol=0, atol=1e-6)
    for name in FIELDS:
        a, b = ref["grads"][name], g[name].numpy()
        assert np.isfinite(b).all(), name
        if name in ("albedo", "emission"):
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       atol=1e-4 * np.abs(a).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-3,
                                       atol=1e-8 + 1e-3 * np.abs(a).max(),
                                       err_msg=name)


def test_replay_reproduces_record_bitwise(ref):
    img_rec, winners, rays = replay.record_forward(
        ref["scene"], smallpt_camera(), CFG, rng.base_key(0), device="cpu")
    img_rep = replay.replay_mean(ref["scene"], smallpt_camera(), CFG,
                                 rng.base_key(0), winners, device="cpu")
    assert int(rays) > 0
    np.testing.assert_allclose(img_rep.numpy(), img_rec.numpy(), rtol=0,
                               atol=1e-6)


def _fd_record_loss(scene, cfg, target, field, idx, h):
    """Central difference of the replay surface's own loss (the record's
    image) along one scalar parameter."""
    def loss_at(delta):
        params, refl = diff.split_scene(scene)
        leaf = getattr(params, field).clone()
        leaf[idx] += delta
        s = diff.merge_scene(params._replace(**{field: leaf}), refl)
        img, _, _ = replay.record_forward(s, smallpt_camera(), cfg,
                                          rng.base_key(0), device="cpu")
        return float(torch.mean((img - torch.from_numpy(target)) ** 2))

    return (loss_at(h) - loss_at(-h)) / (2 * h)


def test_albedo_emission_gradients_match_fd(ref):
    scene, target = ref["scene"], ref["target"]
    loss, img, grads = diff.image_loss_and_grads(
        scene, smallpt_camera(), CFG, rng.base_key(0), target, device="cpu")
    assert np.isfinite(float(loss))
    assert abs(float(loss) - ref["loss"]) < 1e-3 * ref["loss"]
    for field, idx, tol in [("albedo", (0, 0), 1e-4),
                            ("albedo", (2, 1), 1e-4),
                            ("emission", (8, 0), 1e-5)]:
        fd = _fd_record_loss(scene, CFG, target, field, idx, 1e-3)
        an = float(getattr(grads, field)[idx])
        assert abs(an - fd) < 5e-3 * max(1.0, abs(fd)) + tol, (field, idx,
                                                               an, fd)


def test_replay_noremat_matches(ref):
    scene, target = ref["scene"], ref["target"]
    _, _, ga = diff.image_loss_and_grads(scene, smallpt_camera(), CFG,
                                         rng.base_key(0), target,
                                         device="cpu")
    _, _, gb = diff.image_loss_and_grads(scene, smallpt_camera(),
                                         CFG.replace(diff_remat=False),
                                         rng.base_key(0), target,
                                         device="cpu")
    for name in FIELDS:
        a, b = getattr(ga, name).numpy(), getattr(gb, name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-7 + 1e-4 * np.abs(a).max(),
                                   err_msg=name)


def test_fallback_recorder_above_mega_capacity(ref, monkeypatch):
    """Above MEGA_MAX_SPHERES (patched to 4) the record runs through the
    flat wavefront over the hybrid intersector; it shares the scan
    differentiator's hit arithmetic, so the two agree at
    tests/test_grad_replay.py's bars, and no K1b launch is made."""
    monkeypatch.setattr(tmk, "MEGA_MAX_SPHERES", 4)
    calls = []
    monkeypatch.setattr(tmk, "render_record_megakernel",
                        lambda *a, **k: calls.append(1))
    scene, cam = ref["scene"], smallpt_camera()
    cfg = CFG.replace(width=14, height=10)
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99),
                              device="cpu").numpy()
    loss_r, img_r, g_r = diff.image_loss_and_grads(
        scene, cam, cfg, rng.base_key(0), target, device="cpu")
    loss_s, img_s, g_s = diff.image_loss_and_grads(
        scene, cam, cfg.replace(diff_replay=False), rng.base_key(0), target,
        device="cpu")
    assert not calls
    assert np.allclose(float(loss_r), float(loss_s), rtol=1e-3)
    assert np.allclose(img_r.numpy(), img_s.numpy(), rtol=5e-3, atol=5e-3)
    for name in FIELDS:
        a, b = getattr(g_s, name).numpy(), getattr(g_r, name).numpy()
        assert np.allclose(b, a, rtol=0.05,
                           atol=1e-5 + 0.02 * np.abs(a).max()), name


def test_replay_finite_and_nonzero(ref):
    loss, img, grads = diff.image_loss_and_grads(
        ref["scene"], smallpt_camera(), CFG, rng.base_key(0), ref["target"],
        device="cpu")
    assert np.isfinite(float(loss)) and torch.isfinite(img).all()
    for name in FIELDS:
        assert torch.isfinite(getattr(grads, name)).all(), name
    assert grads.albedo.abs().max() > 0 and grads.emission.abs().max() > 0


def test_record_wrapper_counts_nothing_on_the_cpu(ref):
    """On a CPU tensor the K1b wrapper runs the plain version and counts
    no launch; its planes are K1a's band layout."""
    cfg = CFG.replace(width=6, height=4)
    table = tmk.build_scene_table(ref["scene"], cfg)
    cam = tmk.build_camera_vec(smallpt_camera(), cfg)
    before = tmk.mega_record.launches
    rad, rays, rec = tmk.mega_record(table, cam, cfg, rng.base_key(0), 1,
                                     n_spheres=9)
    assert tmk.mega_record.launches == before
    assert rad.shape == (24, 3) and rays.shape == (24,)
    assert rec.shape == (cfg.max_depth, 24) and rec.dtype == torch.int32
    assert ((rec >= -1) & (rec < 9)).all()
    # a lane records a hit at depth d only if it hit at every depth before
    hit = rec >= 0
    assert (hit[1:] <= hit[:-1]).all()
    assert int(rays.sum()) == int(hit.sum()) + int(
        (~hit & torch.cat([torch.ones_like(hit[:1]), hit[:-1]])).sum())


def test_record_and_wavefront_trace_the_same_paths(monkeypatch):
    """The wavefront's camera, frames and sums round as the megakernel's,
    so the paths K1b records (its plain version here) are the paths the
    flat wavefront over the hybrid intersector traces: every winner of
    every lane equal, the images equal, and the replay's gradients the
    scan's, up to summation order (ROADMAP.md H8: an ulp apart, the geometry
    gradients' cosine fell to 0.92 at config 4)."""
    cfg = CFG.replace(width=48, height=48, max_depth=8)
    scene, cam, key = tscene.cornell_box_scene(), smallpt_camera(), \
        rng.base_key(3)
    img_k, w_k, rays_k = replay.record_forward(scene, cam, cfg, key,
                                               device="cpu")
    monkeypatch.setattr(tmk, "MEGA_MAX_SPHERES", 0)
    img_f, w_f, rays_f = replay.record_forward(scene, cam, cfg, key,
                                               device="cpu")
    assert torch.equal(w_k, w_f) and int(rays_k) == int(rays_f)
    np.testing.assert_allclose(img_k.numpy(), img_f.numpy(), rtol=0,
                               atol=1e-6)
    monkeypatch.undo()
    target = np.zeros((48, 48, 3), np.float32)
    _, _, g_r = diff.image_loss_and_grads(scene, cam, cfg, key, target,
                                          device="cpu")
    _, _, g_s = diff.image_loss_and_grads(
        scene, cam, cfg.replace(diff_replay=False), key, target,
        device="cpu")
    for name in FIELDS:
        a, b = getattr(g_s, name).numpy(), getattr(g_r, name).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-6 * np.abs(a).max(),
                                   err_msg=name)
