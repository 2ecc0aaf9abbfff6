"""The port's mesh streaming engine (engine/mesh_stream.py), its progressive
driver (engine/progressive.py::MeshStreamProgressiveRenderer) and the
CLI's mesh routes against the JAX package, its f64 oracle and themselves,
on the CPU (tests/test_mesh_stream.py's SCENE and CFG: 12x10, 2 balls).
The closest-hit kernels run as their plain versions here.

Gates:
- one ``_bounce`` from a JAX StreamState against the JAX package's next
  state: tests/test_torch_wavefront.py's one-bounce bars (alive, depth,
  hist, suppression bits bit-equal on every lane whose hit did not move —
  another winner, or a hit-point gap beyond 5e-3 * max(t, 1); origins
  within that bar, directions and throughputs within 1e-4 relative,
  radiance on 98% of the kept lanes); the sample bookkeeping (s_idx,
  budget, completed counts and radiance sums, the ray count) bit-equal, the
  luminance moments within 1e-6 relative;
- against the oracle replaying the streaming keys (StreamUniformProvider):
  tests/test_mesh_stream.py's gate, at most 3% of values off by 10%, means
  within 10%;
- backend invariance: the image through K6's and K7's plain versions
  bit-equal; through the plain intersector route, the oracle gate against
  the K6 image (same sample streams; a different reduction order flips
  razor hits);
- a checkpoint of either package resumed in the other: the state loaded
  bit-equal, the weights exact and the oracle gate against the package's
  own continuation;
- checkpoint resume in one package, the CLI's checkpoint/resume: bit- and
  byte-equal.
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
from smallpt_tpu.engine import mesh_stream as jms
from smallpt_tpu.ops import intersect as jisect
from smallpt_tpu.oracle.numpy_oracle import Oracle, StreamUniformProvider
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core import scene as tscene
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.engine import mesh_stream as tms
from smallpt_tpu_torch.engine import renderer
from smallpt_tpu_torch.engine.progressive import (
    MeshStreamProgressiveRenderer,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.ops import intersect as tisect
from smallpt_tpu_torch.ops import mesh_pallas as tmp
from smallpt_tpu_torch.ops import wavefront as twf
from smallpt_tpu_torch.utils import image as img_io

_MESH = dict(n_balls=2, subdiv_longitude=3, seed=1)
SCENE = tscene.procedural_mesh_scene(**_MESH)
JSCENE = jscene.procedural_mesh_scene(**_MESH)
CFG = RenderConfig(width=12, height=10, spp_per_cell=1, max_depth=8,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
NEE_ENV = dict(nee_lights=(6,), env_emission=(0.1, 0.15, 0.25))


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


def _renderer(cfg=CFG, seed=0, scene=SCENE):
    return tms.WavefrontStreamingRenderer(scene, smallpt_camera(), cfg,
                                          seed=seed, device="cpu")


def _run(cfg=CFG, spp=2, seed=0, n_bounces=24, scene=SCENE):
    r = _renderer(cfg, seed, scene)
    r.step(n_bounces=n_bounces, add_samples=spp)
    r.flush()
    return r


def _oracle_gate(img, ref):
    """tests/test_mesh_stream.py's oracle gate: at most 3% of values off by
    10%, means within 10%."""
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    assert np.isfinite(img).all()
    assert (rel > 0.1).mean() <= 0.03, (rel > 0.1).mean()
    assert abs(img.mean() - ref.mean()) < 0.1 * (abs(ref.mean()) + 0.1)


def _sums(r):
    rad, w = r.accumulators()
    return rad.numpy(), w.numpy()


# -- one bounce against the JAX package's ------------------------------------

@pytest.mark.parametrize("kw", [{}, NEE_ENV], ids=["plain", "nee_env"])
def test_bounce_matches_jax(kw):
    cfg = CFG.replace(**kw)
    jcfg = _jax_config(cfg)
    j = jms.WavefrontStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                       seed=5)
    # mid-stream: after max_depth bounces every first-sample path has ended
    # and its lane regenerates in the next bounce
    j.step(n_bounces=cfg.max_depth, add_samples=3)
    st = {k: np.array(v) for k, v in j.st.ps._asdict().items()}
    rest = {k: np.array(getattr(j.st, k))
            for k in ("s_idx", "budget", "acc_rad", "acc_w", "m1", "m2")}
    jnext, jrays = jms._bounce(
        JSCENE, jcam.smallpt_camera(), j.key,
        jms.StreamState(jms.wavefront.PathState(
            **{k: jnp.asarray(v) for k, v in st.items()}),
            **{k: jnp.asarray(v) for k, v in rest.items()}),
        jcfg, None, jms._mesh_nee_for(JSCENE, jcfg))

    tst = tms.StreamState(
        twf.PathState(**{k: torch.from_numpy(v.copy())
                         for k, v in st.items()}),
        **{k: torch.from_numpy(v.copy()) for k, v in rest.items()})
    seen = []
    base = renderer.make_intersect_fn(SCENE, cfg)

    def spy(o, d):
        seen.append((o, d))
        return base(o, d)

    tnext, trays = tms._bounce(SCENE, smallpt_camera(), rng.base_key(5), tst,
                               cfg, spy, renderer._mesh_nee_for(SCENE, cfg))
    assert int(trays) == int(jrays) > 0
    for k in ("s_idx", "budget", "acc_w", "acc_rad"):
        np.testing.assert_array_equal(getattr(tnext, k).numpy(),
                                      np.asarray(getattr(jnext, k)), k)
    for k in ("m1", "m2"):
        np.testing.assert_allclose(getattr(tnext, k).numpy(),
                                   np.asarray(getattr(jnext, k)), rtol=1e-6)
    assert (rest["s_idx"] < tnext.s_idx.numpy()).any()  # regenerated lanes

    # lanes whose own hit moved (on the first intersect call, the bounce's
    # rays after regeneration): another winner, or t beyond the bar
    o, d = seen[0]
    hj = jisect.intersect_mesh(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                               JSCENE)
    ht = tisect.intersect_mesh(o, d, SCENE)
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    fin = np.isfinite(tj) & np.isfinite(tt)
    gap = np.where(fin, np.abs(np.where(fin, tj - tt, 0.0)), 0.0)
    moved = ((np.isfinite(tj) != np.isfinite(tt))
             | (np.asarray(hj.inst) != ht.inst.numpy())
             | (gap > 5e-3 * np.maximum(np.where(fin, tj, 1.0), 1.0)))
    keep = ~moved
    assert keep.mean() > 0.9
    out_j = {k: np.asarray(v) for k, v in jnext.ps._asdict().items()}
    out_t = {k: v.numpy() for k, v in tnext.ps._asdict().items()}
    for k in ("alive", "depth", "hist", "suppress"):
        np.testing.assert_array_equal(out_t[k][keep], out_j[k][keep], k)
    live = keep & out_t["alive"]
    assert live.sum() > 20
    tbar = 5e-3 * np.maximum(np.where(np.isfinite(tt), tt, 1.0), 1.0) + 1e-3
    assert (np.abs(out_t["org"] - out_j["org"])[live].max(axis=1)
            <= tbar[live]).all()

    def close(k):
        return np.isclose(out_t[k], out_j[k], rtol=1e-4,
                          atol=1e-5).all(axis=1)

    for k in ("dir", "weight"):
        assert close(k)[live].all(), k
    assert close("radiance")[keep].mean() >= 0.98


# -- the engine ----------------------------------------------------------------

def test_flush_exact_weights():
    r = _run(spp=3)
    rad, w = _sums(r)
    assert (w == 3).all() and np.isfinite(rad).all() and rad.sum() > 0
    assert r.pending() == (0, 0) and r.stats.rays > 0
    assert r.stats.passes == 1
    r.flush()  # nothing left: no round
    np.testing.assert_array_equal(_sums(r)[1], w)


@pytest.mark.parametrize("kw", [{}, NEE_ENV], ids=["plain", "nee_env"])
def test_oracle_stream_replay_parity(kw):
    """The f64 oracle replays the exact streaming decision streams
    (StreamUniformProvider): path-for-path agreement, with triangle-light
    NEE and the environment light too."""
    cfg = CFG.replace(**kw)
    r = _renderer(cfg, seed=0)
    assert (r.key == np.asarray(jrng.base_key(0))).all()
    r.step(n_bounces=24, add_samples=cfg.spp)  # budget == spp: ip < spp
    r.flush()
    rad, w = _sums(r)
    assert (w == cfg.spp).all()
    jcfg = _jax_config(cfg)
    sids = np.arange(cfg.n_pixels * cfg.spp, dtype=np.int64)
    oracle = Oracle(JSCENE, jcam.smallpt_camera(), jcfg,
                    StreamUniformProvider(jrng.base_key(0), jcfg, sids))
    _oracle_gate(rad, oracle.render())


def test_intersect_backend_invariance():
    """K6 and K7 find identical hits, so the stream's image is bit-equal
    under either (the culled route forced through the live module
    attribute); the plain intersector route meets the oracle gate against
    it."""
    cfg_p = CFG.replace(intersector=Intersector.PALLAS, max_depth=6)
    a, wa = _sums(_run(cfg_p, spp=4))
    calls = []
    real = tmp.closest_tri_culled_plain
    old = renderer.MESH_ACCEL_MIN_TRIS
    try:
        renderer.MESH_ACCEL_MIN_TRIS = 1
        tmp.closest_tri_culled_plain = (
            lambda *x, **k: calls.append(1) or real(*x, **k))
        r = _run(cfg_p, spp=4)
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old
        tmp.closest_tri_culled_plain = real
    assert calls
    b, wb = _sums(r)
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(a, b)
    c, wc = _sums(_run(cfg_p.replace(intersector=Intersector.JAX), spp=4))
    np.testing.assert_array_equal(wc, wa)
    _oracle_gate(c, a)


def test_sphere_scene_supported_too():
    """Geometry-agnostic: the engine streams sphere scenes through the same
    wavefront (StreamingRenderer stays the fast choice for them)."""
    rad, w = _sums(_run(scene=tscene.two_sphere_scene()))
    assert (w == 2).all() and rad.sum() > 0


def test_rejects_unsupported_configs():
    with pytest.raises(ValueError, match="split_budget"):
        _renderer(CFG.replace(split_budget=2))
    with pytest.raises(ValueError, match="Mode.FULL"):
        _renderer(CFG.replace(mode=Mode.NORMAL))
    # float64 streams on the CPU (tests/test_torch_float64.py); the card
    # refuses it
    assert _renderer(CFG.replace(dtype="float64")).st.acc_rad.dtype == (
        torch.float64)
    with pytest.raises(NotImplementedError, match="float32 only"):
        tms.WavefrontStreamingRenderer(SCENE, smallpt_camera(),
                                       CFG.replace(dtype="float64"))
    # the sphere streaming renderer sends mesh scenes here
    with pytest.raises(NotImplementedError,
                       match="WavefrontStreamingRenderer"):
        StreamingRenderer(SCENE, smallpt_camera(), CFG, device="cpu")


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tms.WavefrontStreamingRenderer(SCENE, smallpt_camera(), CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshStreamProgressiveRenderer(SCENE, smallpt_camera(), CFG)


def test_camera_and_scene_updates_reset():
    r = _renderer(seed=1)
    r.step(n_bounces=4, add_samples=2)
    assert r.budget == 2 and int(r.accumulators()[1].sum()) >= 0
    cam = smallpt_camera()
    r.update_camera(cam._replace(origin=cam.origin + 1.0))
    assert r.budget == 0 and r.pending() == (0, 0)
    r.update_scene(tscene.procedural_mesh_scene(n_balls=1, seed=2))
    assert r.scene.n_triangles != SCENE.n_triangles
    assert int(r.accumulators()[1].sum()) == 0
    r.step(n_bounces=24, add_samples=1)
    r.flush()
    assert (_sums(r)[1] == 1).all()


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_resume_bitexact(tmp_path):
    """Save mid-stream, resume, finish: bit-equal to rendering straight
    through."""
    ck = str(tmp_path / "ms_ck.npz")
    a = _renderer(seed=11)
    a.step(n_bounces=5, add_samples=3)
    a.save_checkpoint(ck)
    a.step(n_bounces=5, add_samples=1)
    a.flush()
    b = _renderer(seed=99)
    b.load_checkpoint(ck)
    assert b.budget == 3 and b.stats.passes == 1
    b.step(n_bounces=5, add_samples=1)
    b.flush()
    for x, y in zip(_sums(a), _sums(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.image, b.image)


def test_checkpoints_refused(tmp_path):
    """A v1 (unversioned keying) checkpoint, another resolution's, and a
    sphere streaming checkpoint are refused."""
    ck = str(tmp_path / "old.npz")
    a = _renderer()
    a.step(n_bounces=2, add_samples=1)
    a.save_checkpoint(ck)
    data = dict(np.load(ck))
    data["stream_key_version"] = np.asarray(1)
    np.savez(ck, **data)
    with pytest.raises(ValueError, match="keying"):
        _renderer().load_checkpoint(ck)
    a.save_checkpoint(ck)
    with pytest.raises(ValueError, match="incompatible stream checkpoint"):
        _renderer(CFG.replace(width=16)).load_checkpoint(ck)
    s = StreamingRenderer(tscene.cornell_box_scene(), smallpt_camera(), CFG,
                          device="cpu")
    s.save_checkpoint(ck)
    with pytest.raises(ValueError, match="not a mesh-streaming checkpoint"):
        _renderer().load_checkpoint(ck)


@pytest.fixture(scope="module")
def cross_checkpoints(tmp_path_factory):
    """A checkpoint of each package after step(5, 3); the JAX package's own
    continuation (step(5, 1) and a flush), and its continuation of the
    port's checkpoint."""
    d = tmp_path_factory.mktemp("mesh_ck")
    jcfg = _jax_config(CFG)
    a = jms.WavefrontStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                       seed=11)
    a.step(n_bounces=5, add_samples=3)
    a.save_checkpoint(str(d / "jax.npz"))
    a.step(n_bounces=5, add_samples=1)
    a.flush()
    b = _renderer(seed=11)
    b.step(n_bounces=5, add_samples=3)
    b.save_checkpoint(str(d / "port.npz"))
    j = jms.WavefrontStreamingRenderer(JSCENE, jcam.smallpt_camera(), jcfg,
                                       seed=0)
    j.load_checkpoint(str(d / "port.npz"))
    j.step(n_bounces=5, add_samples=1)
    j.flush()
    return d, a, j


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resumes_across_packages(cross_checkpoints, direction,
                                            tmp_path):
    d, jax_own, jax_from_port = cross_checkpoints
    port = _renderer(seed=0)
    if direction == "jax_to_port":
        src = str(d / "jax.npz")
        port.load_checkpoint(src)
        assert port.budget == 3 and port.stats.passes == 1
        # the loaded state saves back field for field
        again = str(tmp_path / "again.npz")
        port.save_checkpoint(again)
        want, got = np.load(src), np.load(again)
        assert set(want.files) == set(got.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if k != "key":  # the JAX package saves its key's raw data
                assert got[k].dtype == want[k].dtype, k
        ref = jax_own
    else:
        port = _renderer(seed=11)
        port.step(n_bounces=5, add_samples=3)
        ref = jax_from_port
    port.step(n_bounces=5, add_samples=1)
    port.flush()
    rad, w = _sums(port)
    jrad, jw = (np.asarray(x) for x in ref.accumulators())
    assert (w == 4).all()
    np.testing.assert_array_equal(w, jw)
    _oracle_gate(rad, jrad)


def test_step_to_quality_mesh():
    """The shared equal-quality driver on the mesh stream: terminates,
    drains, reaches the target or the pool cap, and the adaptive allocation
    gives some pixels more samples."""
    cfg = CFG.replace(max_depth=6)
    r = _renderer(cfg, seed=4)
    q = r.step_to_quality(rel_err=0.3, quantile=0.9, max_spp=48, min_spp=6,
                          n_bounces=14)
    assert q["spp_min"] >= 6
    w = _sums(r)[1]
    assert w.min() >= q["spp_min"] and r.pending() == (0, 0)
    mean, var, n = r.moments()
    stderr = np.sqrt(np.maximum(var, 0) / np.maximum(n, 1)) / (
        np.abs(mean) + 1e-2)
    hit = float(np.quantile(stderr[n >= 2], 0.9)) <= 0.3
    assert hit or int(n.sum()) >= 48 * cfg.n_pixels * 0.95, q
    if q["spp_max"] > q["spp_min"]:
        assert w.max() > w.min()  # adaptive budgets engaged


# -- the progressive driver ---------------------------------------------------

def test_progressive_steps_finalizes_and_checkpoints(tmp_path):
    """MeshStreamProgressiveRenderer: each step adds config.spp samples and
    runs 2 x max_depth bounces on one persistent wavefront; finalize
    drains; the image equals the stream's driven the same way; a
    checkpoint resumes bit-equal."""
    cam = smallpt_camera()
    r = MeshStreamProgressiveRenderer(SCENE, cam, CFG, seed=3, device="cpu")
    assert r.n_bounces == 16 and r.target_ms is None
    r.step(2)
    assert r.sample_count == 2 and r.stats.passes == 2
    ck = str(tmp_path / "prog.npz")
    r.save_checkpoint(ck)
    r.step()
    r.finalize()
    assert (r._r.accumulators()[1].numpy() == 3 * CFG.spp).all()
    s = _renderer(seed=3)
    for _ in range(3):
        s.step(n_bounces=16, add_samples=CFG.spp)
    s.flush()
    np.testing.assert_array_equal(r.image, s.image)
    b = MeshStreamProgressiveRenderer(SCENE, cam, CFG, seed=0, device="cpu")
    b.load_checkpoint(ck)
    assert b.sample_count == 2
    b.step()
    b.finalize()
    np.testing.assert_array_equal(b.image, r.image)
    b.reset_accumulation()
    assert b.sample_count == 0 and int(b._r.accumulators()[1].sum()) == 0
    t = MeshStreamProgressiveRenderer(SCENE, cam, CFG, seed=3, target_ms=5.0,
                                      device="cpu")
    t.step(2)
    t.finalize()
    assert (t._r.accumulators()[1].numpy() == 2 * CFG.spp).all()


# -- the CLI's mesh routes -------------------------------------------------------

_CLI = ["--width", "12", "--height", "8", "--max-depth", "4", "--device",
        "cpu", "--quiet"]


@pytest.fixture
def small_mesh_cli(monkeypatch):
    """The CLI's mesh scene replaced by the 2-ball mesh; the mesh stream
    drivers the CLI builds, counted."""
    monkeypatch.setitem(cli.SCENES, "mesh",
                        lambda: tscene.procedural_mesh_scene(**_MESH))
    made = []
    for name in ("MeshStreamProgressiveRenderer",
                 "WavefrontStreamingRenderer"):
        real = getattr(cli, name)

        def counted(*a, _real=real, _name=name, **k):
            made.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(cli, name, counted)
    return made


def test_cli_mesh_default_route(tmp_path, small_mesh_cli):
    """A mesh scene in full transport without --scheduler renders through
    MeshStreamProgressiveRenderer, as the JAX CLI does."""
    out = str(tmp_path / "m.ppm")
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--passes", "2",
                     "--out", out]) == 0
    assert small_mesh_cli == ["MeshStreamProgressiveRenderer"]
    cfg = RenderConfig(width=12, height=8, max_depth=4,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    r = MeshStreamProgressiveRenderer(SCENE, smallpt_camera(), cfg,
                                      device="cpu")
    r.step(2)
    r.finalize()
    np.testing.assert_array_equal(img_io.read_ppm(out),
                                  img_io.to_int(r.image[::-1]))


def test_cli_mesh_streaming_route(tmp_path, small_mesh_cli):
    out = str(tmp_path / "s.ppm")
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--streaming",
                     "--passes", "2", "--out", out]) == 0
    assert small_mesh_cli == ["WavefrontStreamingRenderer"]
    cfg = RenderConfig(width=12, height=8, max_depth=4,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    r = _renderer(cfg)
    r.step(n_bounces=8, add_samples=8)
    r.flush()
    np.testing.assert_array_equal(img_io.read_ppm(out),
                                  img_io.to_int(r.image[::-1]))
    q = str(tmp_path / "q.ppm")
    assert cli.main(["16", *_CLI, "--scene", "mesh", "--streaming",
                     "--quality", "0.5", "--out", q]) == 0


@pytest.mark.parametrize("route", [[], ["--streaming"]],
                         ids=["default", "streaming"])
def test_cli_mesh_checkpoint_resume_byte_equal(tmp_path, small_mesh_cli,
                                               route):
    """A run saved with --checkpoint and continued with --resume writes the
    same bytes as the uninterrupted run: the same sample streams, summed in
    the same order, whatever the flush in between."""
    ck, a, b = (str(tmp_path / n) for n in ("ck.npz", "a.ppm", "b.ppm"))
    base = ["4", *_CLI, "--scene", "mesh", *route]
    assert cli.main([*base, "--out", a, "--checkpoint", ck]) == 0
    assert cli.main([*base, "--out", b, "--resume", ck]) == 0
    whole = str(tmp_path / "whole.ppm")
    assert cli.main([*base, "--passes", "2", "--out", whole]) == 0
    assert open(b, "rb").read() == open(whole, "rb").read()
    assert np.load(ck)["stream_key_version"] == 2


@pytest.mark.parametrize("sched", ["flat", "regen"])
def test_cli_scheduler_pins_the_per_pass_engine(tmp_path, small_mesh_cli,
                                                sched, monkeypatch):
    """An explicit --scheduler keeps a mesh scene on the per-pass engine;
    so do the AOV modes. Its per-pass checkpoint (the progressive state,
    not the stream's) resumes byte-equal to one run."""
    made = []
    real = cli.ProgressiveRenderer

    def counted(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(cli, "ProgressiveRenderer", counted)
    out = str(tmp_path / "p.ppm")
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--scheduler", sched,
                     "--out", out]) == 0
    assert cli.main(["4", *_CLI, "--scene", "mesh", "--mode", "normal",
                     "--out", out]) == 0
    assert made == [1, 1] and small_mesh_cli == []
    ck, b, one = (str(tmp_path / n) for n in ("ck.npz", "b.ppm", "1.ppm"))
    pinned = ["4", *_CLI, "--scene", "mesh", "--scheduler", sched]
    assert cli.main(pinned + ["--checkpoint", ck, "--out", out]) == 0
    assert cli.main(pinned + ["--resume", ck, "--out", b]) == 0
    assert cli.main(pinned + ["--passes", "2", "--out", one]) == 0
    assert made == [1] * 5 and small_mesh_cli == []
    assert "camera_leaves" in np.load(ck)
    with open(b, "rb") as fb, open(one, "rb") as fo:
        assert fb.read() == fo.read()
