"""The progressive renderers' request queue, checkpoints and run
(engine/progressive.py) and the interactive session (interactive.py):
counterparts of tests/test_interactive.py's cases and tests/test_engine.py's
queue and checkpoint cases, on the CPU at toy sizes.

A pass after a request that changes the camera or the scene is held bit for
bit to a fresh renderer's first pass on the new camera or scene: the route
and its inputs are picked again, so nothing of the old scene or camera is
rendered. Every reader thread is joined with a timeout and checked to have
ended, so a hang fails at once."""

import io
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smallpt_tpu.config import (
    CameraModel as JCameraModel, Filter as JFilter, RenderConfig as JConfig,
)
from smallpt_tpu.core.camera import smallpt_camera as jcamera
from smallpt_tpu.core.scene import cornell_box_scene as jcornell
from smallpt_tpu.engine.progressive import (
    ProgressiveRenderer as JProgressive,
)
from smallpt_tpu_torch.config import (
    CameraModel, Filter, RenderConfig,
)
from smallpt_tpu_torch.core.camera import default_matrix_camera, smallpt_camera
from smallpt_tpu_torch.core.scene import (
    Material, SphereScene, cornell_box_scene, procedural_mesh_scene,
    procedural_sphere_scene, single_triangle_scene, two_sphere_scene,
)
from smallpt_tpu_torch.core.scene_io import save_scene, scene_to_dict
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.progressive import (
    BinnedProgressiveRenderer, MeshStreamProgressiveRenderer,
    ProgressiveRenderer,
)
from smallpt_tpu_torch.interactive import InteractiveSession
from smallpt_tpu_torch.ops.megakernel import MEGA_MAX_SPHERES
from smallpt_tpu_torch.utils import image as img_io
from smallpt_tpu_torch.utils import native

CFG = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=6,
                   camera_model=CameraModel.LEGACY, filter=Filter.TENT)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SlowStream:
    """Lines with a small delay each, so the render loop interleaves with
    the reader thread (the two-thread architecture)."""

    def __init__(self, lines, delay=0.02):
        self.lines = lines
        self.delay = delay

    def __iter__(self):
        for line in self.lines:
            time.sleep(self.delay)
            yield line


def _run(session, max_passes):
    passes = session.run(max_passes=max_passes)
    session.reader.join(timeout=30)
    assert not session.reader.is_alive()
    return passes


def _progressive(scene=None, camera=None, cfg=CFG, seed=0):
    return ProgressiveRenderer(scene or cornell_box_scene(),
                               camera or smallpt_camera(), cfg, seed=seed,
                               device="cpu")


def _fresh_first_pass(r):
    """A fresh renderer's first pass on r's scene and camera."""
    f = ProgressiveRenderer(r.scene, r.camera, r.config, seed=r.seed,
                            device="cpu")
    f.step()
    return f.accum


def _org(y):
    return json.dumps({"action": "update_camera", "org": [50.0, y, 295.6]})


# -- the per-pass renderer's queue --------------------------------------------

def test_session_camera_update_resets_accumulation(tmp_path):
    r = _progressive()
    snap = str(tmp_path / "snap.ppm")
    stream = SlowStream([_org(53.0),
                         json.dumps({"action": "snapshot", "path": snap}),
                         json.dumps({"action": "quit"})])
    assert _run(InteractiveSession(r, stream=stream), 200) >= 1
    assert os.path.exists(snap)
    assert float(r.camera.origin[1]) == 53.0


def test_camera_update_resets_accumulation_deterministic():
    r = _progressive()
    r.step()
    before = r.accum.clone()
    r.enqueue({"action": "update_camera", "org": [50.0, 53.0, 295.6]})
    r.step()
    assert r.sample_count == 1  # reset + exactly one fresh pass
    assert float(r.camera.origin[1]) == 53.0
    assert not torch.equal(before, r.accum)
    assert torch.equal(r.accum, _fresh_first_pass(r))


def test_command_queue_camera_update_resets_accum():
    """A request as JSON text; an unknown action raises, as in the JAX
    package (the session drops such lines before they reach the queue)."""
    r = _progressive()
    r.step(2)
    assert r.sample_count == 2
    r.enqueue('{"action": "update_camera", "org": [50.0, 52.0, 290.0]}')
    r.step()
    assert r.sample_count == 1
    np.testing.assert_allclose(r.camera.origin.numpy(), [50.0, 52.0, 290.0])
    r.enqueue({"action": "reset"})
    r.step()
    assert r.sample_count == 1 and torch.equal(r.accum, _fresh_first_pass(r))
    r.enqueue({"action": "zoom"})
    with pytest.raises(ValueError, match="unknown action"):
        r.step()


def test_matrix_camera_update_moves_the_frame_origin():
    cfg = CFG.replace(camera_model=CameraModel.MATRIX, filter=Filter.BOX)
    r = _progressive(two_sphere_scene(), default_matrix_camera(), cfg)
    r.step()
    r.enqueue({"action": "update_camera", "org": [0.0, -0.5, 1.0]})
    r.step()
    np.testing.assert_array_equal(r.camera.local_to_world[:3, 3].numpy(),
                                  np.float32([0.0, -0.5, 1.0]))
    assert torch.equal(r.accum, _fresh_first_pass(r))


def test_update_scene_fields_rerender_the_new_scene():
    base = cornell_box_scene()
    r = _progressive(base)
    r.step()
    center = base.center.numpy().copy()
    center[7, 0] += 5.0  # move the mirror ball
    albedo = base.material.albedo.numpy().copy()
    albedo[0] = (0.1, 0.7, 0.1)
    r.enqueue({"action": "update_scene", "center": center.tolist(),
               "albedo": albedo.tolist()})
    r.step()
    assert r.sample_count == 1
    np.testing.assert_array_equal(r.scene.center.numpy(), center)
    assert torch.equal(r.accum, _fresh_first_pass(r))
    # a field of the wrong shape is logged and dropped, the scene kept
    prev = r.scene
    r.enqueue({"action": "update_scene", "radius": [[1.0, 2.0]]})
    r.step()
    assert r.scene is prev


def test_session_keyboard_nudges():
    r = _progressive(seed=1)
    y0 = float(r.camera.origin[1])
    stream = SlowStream(["u", "u", "d", json.dumps({"action": "quit"})])
    _run(InteractiveSession(r, stream=stream), 300)
    assert abs(float(r.camera.origin[1]) - (y0 + 0.01)) < 1e-4


def test_session_eof_ends():
    r = _progressive(seed=2)
    assert _run(InteractiveSession(r, stream=SlowStream([])), 50) <= 50


def test_session_drops_bad_requests(capsys):
    """Malformed lines, unknown actions, a bad org and a non-object are
    logged as bad_request and never reach the queue; the render goes on."""
    r = _progressive(seed=3)
    lines = ["{not json", json.dumps({"action": "zoom"}),
             json.dumps({"action": "update_camera", "org": [1, 2]}),
             json.dumps([1, 2, 3]), json.dumps({"action": "quit"})]
    assert _run(InteractiveSession(r, stream=SlowStream(lines)), 100) >= 1
    bad = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
           if "bad_request" in ln]
    assert len(bad) == 4
    assert float(r.camera.origin[1]) == 52.0 and r.pending_requests == 0


def test_requests_just_before_quit_get_a_final_pass():
    """Requests queued with the quit take effect in one more pass, so the
    saved image shows them."""
    r = _progressive(seed=4)
    session = InteractiveSession(r, stream=iter([_org(54.0),
                                                  '{"action": "quit"}']))
    passes = _run(session, 50)
    assert passes >= 1 and float(r.camera.origin[1]) == 54.0
    assert r.pending_requests == 0 and r.sample_count >= 1


def test_session_frames_and_snapshot_png(tmp_path):
    r = _progressive(seed=5)
    frames = str(tmp_path / "f" / "f_%03d.ppm")
    png = str(tmp_path / "snap.png")
    stream = SlowStream([json.dumps({"action": "snapshot", "path": png}),
                         json.dumps({"action": "quit"})])
    passes = _run(InteractiveSession(r, stream=stream,
                                     frame_pattern=frames), 40)
    assert os.path.exists(png)
    assert sorted(os.listdir(tmp_path / "f")) == [
        f"f_{i:03d}.ppm" for i in range(1, passes + 1)]


def test_load_scene_action(tmp_path):
    """load_scene swaps the whole scene from a file or an inline spec and
    restarts the accumulation; a bad file or a missing payload is logged
    and dropped."""
    path = str(tmp_path / "two.json")
    save_scene(two_sphere_scene(), path)
    r = _progressive(seed=3)
    r.step()
    img_cornell = r.image.copy()
    r.enqueue({"action": "load_scene", "path": path})
    r.step()
    assert r.scene.n_spheres == 2 and r.sample_count == 1
    assert not np.allclose(r.image, img_cornell)
    assert torch.equal(r.accum, _fresh_first_pass(r))
    r.enqueue({"action": "load_scene",
               "scene": scene_to_dict(cornell_box_scene())})
    r.step()
    assert r.scene.n_spheres == 9
    for req in ({"action": "load_scene", "path": str(tmp_path / "no.json")},
                {"action": "load_scene"},
                {"action": "load_scene", "scene": {"type": "nurbs"}}):
        r.enqueue(req)
        r.step()
        assert r.scene.n_spheres == 9


def test_load_scene_nee_range_guard(tmp_path):
    path = str(tmp_path / "two.json")
    save_scene(two_sphere_scene(), path)
    r = _progressive(cfg=CFG.replace(nee_lights=(8,)), seed=4)
    r.enqueue({"action": "load_scene", "path": path})
    r.step()
    assert r.scene.n_spheres == 9  # rejected, still Cornell


def test_session_load_scene_through_protocol(tmp_path):
    path = str(tmp_path / "two.json")
    save_scene(two_sphere_scene(), path)
    r = _progressive(seed=5)
    stream = SlowStream([json.dumps({"action": "load_scene", "path": path}),
                         json.dumps({"action": "quit"})])
    _run(InteractiveSession(r, stream=stream), 200)
    assert r.scene.n_spheres == 2


def test_load_scene_reroutes_to_the_binned_drain(tmp_path):
    """A scene above MEGA_MAX_SPHERES takes the binned drain after
    load_scene, as the JAX package routes each pass (H4), and its pass is a
    fresh renderer's on that scene; back to the Cornell box, the
    megakernel route."""
    big = procedural_sphere_scene(MEGA_MAX_SPHERES + 52, seed=5)
    path = str(tmp_path / "big.json")
    save_scene(big, path)
    cfg = CFG.replace(width=8, height=6, max_depth=3)
    r = _progressive(cfg=cfg)
    r.step()
    assert r.route == "mega"
    r.enqueue({"action": "load_scene", "path": path})
    r.step()
    assert r.route == "binned" and r.sample_count == 1
    assert torch.equal(r.accum, _fresh_first_pass(r))
    r.enqueue({"action": "load_scene",
               "scene": scene_to_dict(cornell_box_scene())})
    r.step()
    assert r.route == "mega" and torch.equal(r.accum, _fresh_first_pass(r))


def test_update_scene_after_mesh_load_is_dropped(tmp_path):
    """After a mesh load, a sphere-field update_scene is logged and
    dropped; the mesh renders through the wavefront route."""
    path = str(tmp_path / "tri.json")
    save_scene(single_triangle_scene(), path)
    r = _progressive(seed=7)
    r.enqueue({"action": "load_scene", "path": path})
    r.step()
    assert hasattr(r.scene, "n_triangles") and r.route == "regen"
    r.enqueue({"action": "update_scene", "center": [[0.0, 0.0, 0.0]]})
    r.step()
    assert hasattr(r.scene, "n_triangles")


# -- checkpoints and run ---------------------------------------------------------

def test_checkpoint_resume_byte_equal(tmp_path):
    ck = str(tmp_path / "state.npz")
    a = _progressive(seed=5)
    a.step(2)
    a.save_checkpoint(ck)
    a.step(2)
    b = _progressive(seed=5)
    b.load_checkpoint(ck)
    assert b.sample_count == 2
    b.step(2)
    assert torch.equal(a.accum, b.accum)
    assert np.array_equal(a.image, b.image)
    with pytest.raises(ValueError, match="seed mismatch"):
        _progressive(seed=6).load_checkpoint(ck)


def test_checkpoint_restores_camera_and_scene(tmp_path):
    """The camera and scene leaves come back in field order; a resumed
    renderer re-routes on them."""
    ck = str(tmp_path / "state.npz")
    a = _progressive(seed=1)
    a.enqueue({"action": "update_camera", "org": [48.0, 50.0, 290.0]})
    center = cornell_box_scene().center.numpy().copy()
    center[8, 1] -= 3.0
    a.enqueue({"action": "update_scene", "center": center.tolist()})
    a.step(2)
    a.save_checkpoint(ck)
    b = _progressive(seed=1)
    b.load_checkpoint(ck)
    assert torch.equal(b.camera.origin, a.camera.origin)
    assert torch.equal(b.scene.center, a.scene.center)
    assert b.scene.material.refl.dtype == torch.int32
    a.step()
    b.step()
    assert torch.equal(a.accum, b.accum)


def test_checkpoint_from_jax_resumes_in_the_port(tmp_path):
    """The JAX package's per-pass checkpoint (fields, leaf order, refl
    promoted to float64) loads in the port."""
    ck = str(tmp_path / "jax.npz")
    jcfg = JConfig(width=16, height=12, spp_per_cell=1, max_depth=6,
                   camera_model=JCameraModel.LEGACY, filter=JFilter.TENT)
    jr = JProgressive(jcornell(), jcamera(), jcfg, seed=3)
    acc = np.random.default_rng(0).random((12, 16, 3)).astype(np.float32)
    jr.accum = jnp.asarray(acc)
    jr.sample_count = 3
    jr.camera = jr.camera._replace(origin=jnp.asarray([49.0, 51.0, 280.0],
                                                      jnp.float32))
    jr.save_checkpoint(ck)
    r = _progressive(seed=3)
    r.load_checkpoint(ck)
    assert r.sample_count == 3
    np.testing.assert_array_equal(r.accum.numpy(), acc)
    np.testing.assert_array_equal(r.camera.origin.numpy(),
                                  np.float32([49.0, 51.0, 280.0]))
    for got, want in ((r.scene.center, jr.scene.center),
                      (r.scene.material.refl, jr.scene.material.refl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r.step()
    assert r.sample_count == 4


def test_checkpoint_from_the_port_loads_in_jax(tmp_path):
    ck = str(tmp_path / "port.npz")
    r = _progressive(seed=2)
    r.enqueue({"action": "update_camera", "org": [51.0, 50.0, 292.0]})
    r.step(2)
    r.save_checkpoint(ck)
    jcfg = JConfig(width=16, height=12, spp_per_cell=1, max_depth=6,
                   camera_model=JCameraModel.LEGACY, filter=JFilter.TENT)
    jr = JProgressive(jcornell(), jcamera(), jcfg, seed=2)
    jr.load_checkpoint(ck)
    assert jr.sample_count == 2
    np.testing.assert_array_equal(np.asarray(jr.accum), r.accum.numpy())
    for a, b in ((jr.camera.origin, r.camera.origin),
                 (jr.camera.direction, r.camera.direction),
                 (jr.scene.radius, r.scene.radius),
                 (jr.scene.material.refl, r.scene.material.refl)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(jr.scene.material.refl).dtype == np.int32


def test_run_writes_frames_and_calls_on_frame(tmp_path):
    r = _progressive(seed=6)
    pattern = str(tmp_path / "frames" / "f_%02d.ppm")
    shown = []
    r.run(4, on_frame=lambda p: shown.append(p.image), frame_every=2,
          frame_pattern=pattern)
    assert r.sample_count == 4 and len(shown) == 2
    for i, img in zip((2, 4), shown):
        ref = str(tmp_path / "ref.ppm")
        if native.available():
            native.write_ppm(ref, img[::-1], binary=True)
        else:
            img_io.write_ppm(ref, img)
        with open(pattern % i, "rb") as fa, open(ref, "rb") as fb:
            assert fa.read() == fb.read()
    assert not os.path.exists(pattern % 1)


# -- the binned progressive renderer ------------------------------------------

BIG_CFG = RenderConfig(width=16, height=12, spp_per_cell=1, max_depth=4,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)


def _binned(scene=None, seed=0):
    return BinnedProgressiveRenderer(
        scene or procedural_sphere_scene(80, seed=3), smallpt_camera(),
        BIG_CFG, seed=seed, device="cpu")


def test_binned_session_protocol(tmp_path):
    r = _binned()
    snap = str(tmp_path / "snap_binned.ppm")
    stream = SlowStream([_org(53.0),
                         json.dumps({"action": "snapshot", "path": snap}),
                         json.dumps({"action": "quit"})], delay=0.05)
    assert _run(InteractiveSession(r, stream=stream), 60) >= 1
    assert os.path.exists(snap)
    assert float(r.camera.origin[1]) == 53.0
    assert r._r.camera is r.camera  # the wavefront was re-aimed


def test_binned_camera_update_resets_wavefront_deterministic():
    r = _binned()
    r.step()
    before = r.image.copy()
    cam_vec_before = r._r.cam_vec.clone()
    r.enqueue({"action": "update_camera", "org": [50.0, 53.0, 295.6]})
    r.step()
    assert r.sample_count == 1
    assert not torch.equal(cam_vec_before, r._r.cam_vec)
    assert not np.array_equal(before, r.image)
    assert r._r.budget == BIG_CFG.spp  # one pass of samples outstanding


def test_binned_scene_update_rebuilds_accel():
    scene = procedural_sphere_scene(80, seed=3)
    r = _binned(scene)
    r.step()
    accel_before = r._r.accel
    center = scene.center.numpy().copy()
    center[9:, 0] += 3.0  # move the small spheres, keep the walls
    r.enqueue({"action": "update_scene", "center": center.tolist()})
    r.step()
    assert r._r.accel is not accel_before and r.sample_count == 1
    np.testing.assert_array_equal(r._r.scene.center.numpy(), center)


def test_binned_progressive_checkpoint_roundtrip(tmp_path):
    ck = str(tmp_path / "binned_ck.npz")
    a = _binned()
    a.step()
    a.save_checkpoint(ck)
    b = _binned()
    b.load_checkpoint(ck)
    for s_a, s_b in zip(a._r.streams, b._r.streams):
        assert torch.equal(s_a.f, s_b.f) and torch.equal(s_a.i, s_b.i)
    a.step()
    b.step()
    a.finalize()
    b.finalize()
    assert np.array_equal(a.image, b.image)


def test_binned_checkpoint_layout_mismatch_refused(tmp_path):
    scene = procedural_sphere_scene(80, seed=3)
    ck = str(tmp_path / "binned_ck2.npz")
    a = BinnedStreamingRenderer(scene, smallpt_camera(), BIG_CFG, seed=0,
                                n_streams=1, inflight=1, device="cpu")
    a.step(add_samples=1, n_bounces=2)
    a.save_checkpoint(ck)
    b = BinnedStreamingRenderer(scene, smallpt_camera(), BIG_CFG, seed=0,
                                n_streams=2, inflight=1, device="cpu")
    with pytest.raises(ValueError, match="stream layout mismatch"):
        b.load_checkpoint(ck)


def test_binned_load_scene_unsupported_keeps_old():
    """A scene the grid accel cannot bin (no wall-class sphere) keeps the
    previous scene."""
    r = _binned(seed=6)
    prev = r.scene
    small = SphereScene(
        center=torch.tensor([[50.0, 40.0, 80.0]]),
        radius=torch.tensor([2.0]),
        material=Material(torch.zeros((1, 3)), torch.full((1, 3), 0.5),
                          torch.zeros((1,), dtype=torch.int32)))
    r.enqueue({"action": "load_scene", "scene": scene_to_dict(small)})
    r.step()
    assert r.scene is prev


def test_binned_load_mesh_scene_keeps_old():
    r = _binned(seed=8)
    prev = r.scene
    r.enqueue({"action": "load_scene",
               "scene": scene_to_dict(single_triangle_scene())})
    r.step()
    assert r.scene is prev


# -- the mesh stream's progressive renderer -----------------------------------

def _mesh_stream(seed=0):
    scene = procedural_mesh_scene(n_balls=2, subdiv_longitude=3, seed=1)
    cfg = RenderConfig(width=12, height=10, spp_per_cell=1, max_depth=6,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    return MeshStreamProgressiveRenderer(scene, smallpt_camera(), cfg,
                                         seed=seed, device="cpu")


def test_mesh_stream_session_protocol(tmp_path):
    r = _mesh_stream()
    snap = str(tmp_path / "snap_ms.ppm")
    stream = SlowStream([_org(53.0),
                         json.dumps({"action": "snapshot", "path": snap}),
                         json.dumps({"action": "quit"})], delay=0.05)
    assert _run(InteractiveSession(r, stream=stream), 60) >= 1
    assert os.path.exists(snap)
    assert float(r.camera.origin[1]) == 53.0
    assert r._r.camera is r.camera


def test_mesh_stream_camera_update_resets_deterministic():
    r = _mesh_stream()
    r.step()
    before = r.image.copy()
    r.enqueue({"action": "update_camera", "org": [50.0, 53.0, 295.6]})
    r.step()
    assert r.sample_count == 1
    assert not np.array_equal(before, r.image)
    assert r._r.budget == r.config.spp


def test_mesh_stream_load_scene_swaps_to_spheres():
    r = _mesh_stream(seed=3)
    r.step()
    r.enqueue({"action": "load_scene",
               "scene": scene_to_dict(two_sphere_scene())})
    r.step()
    assert hasattr(r.scene, "center") and r.sample_count == 1
    assert np.isfinite(r.image).all()


# -- the CLI --------------------------------------------------------------------

def test_cli_interactive_end_to_end(tmp_path):
    """The whole process: the protocol piped into ``python -m
    smallpt_tpu_torch --interactive`` on the CPU."""
    out = str(tmp_path / "inter.ppm")
    cmds = "\n".join([_org(52.5), "u", json.dumps({"action": "quit"})])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "smallpt_tpu_torch", "4", "--interactive",
         "--width", "12", "--height", "10", "--max-depth", "5", "--device",
         "cpu", "--quiet", "--out", out],
        input=cmds + "\n", text=True, env=env, capture_output=True,
        timeout=240, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert img_io.read_ppm(out).shape == (10, 12, 3)


def test_cli_interactive_in_process(tmp_path, monkeypatch):
    """--interactive with stdin replaced, --binned --interactive through the
    binned progressive renderer, with frames and a checkpoint; the refusals
    of the JAX CLI."""
    from smallpt_tpu_torch import cli

    import smallpt_tpu_torch.interactive as interactive

    made, sessions = [], []
    real = cli.BinnedProgressiveRenderer
    monkeypatch.setattr(cli, "BinnedProgressiveRenderer",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    monkeypatch.setattr(interactive, "InteractiveSession",
                        lambda *a, **k: sessions.append(
                            InteractiveSession(*a, **k)) or sessions[-1])
    out, ck = str(tmp_path / "b.ppm"), str(tmp_path / "ck.npz")
    frames = str(tmp_path / "fr" / "f_%02d.ppm")
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        _org(52.5) + "\n" + '{"action": "quit"}\n'))
    assert cli.main(["4", "--binned", "--interactive", "--scene",
                     "two_sphere", "--width", "8", "--height", "6",
                     "--max-depth", "3", "--device", "cpu", "--quiet",
                     "--out", out, "--frames", frames,
                     "--checkpoint", ck]) == 0
    # the quit may come before the first pass: the one pass that applies
    # the camera request writes no frame, as in the JAX package
    assert made == [1] and os.path.exists(ck) and os.path.isdir(
        tmp_path / "fr")
    sessions[0].reader.join(timeout=30)
    assert not sessions[0].reader.is_alive()
    for bad in (["--streaming", "--interactive"],
                ["--binned", "--interactive", "--quality", "0.1"]):
        with pytest.raises(SystemExit):
            cli.main(["4", "--device", "cpu", *bad])


@pytest.mark.parametrize("scene", ["cornell", "mesh"])
def test_cli_stream_frames_chunk_the_samples(scene, tmp_path, monkeypatch):
    """With --frames the streams take their samples in --passes chunks, a
    frame after each, as the JAX CLI does; the final image is the stream's
    stepped that way."""
    from smallpt_tpu_torch import cli
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer

    mesh = dict(n_balls=2, subdiv_longitude=3, seed=1)
    monkeypatch.setitem(cli.SCENES, "mesh",
                        lambda: procedural_mesh_scene(**mesh))
    out, frames = str(tmp_path / "s.ppm"), str(tmp_path / "f" / "f_%d.ppm")
    assert cli.main(["8", "--streaming", "--scene", scene, "--passes", "2",
                     "--width", "8", "--height", "6", "--max-depth", "3",
                     "--device", "cpu", "--quiet", "--out", out,
                     "--frames", frames]) == 0
    assert sorted(os.listdir(tmp_path / "f")) == ["f_1.ppm", "f_2.ppm"]
    cfg = RenderConfig(width=8, height=6, spp_per_cell=2, max_depth=3,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    if scene == "mesh":
        r = WavefrontStreamingRenderer(procedural_mesh_scene(**mesh),
                                       smallpt_camera(), cfg, device="cpu")
        step = dict(n_bounces=6)
    else:
        r = StreamingRenderer(cornell_box_scene(), smallpt_camera(), cfg,
                              device="cpu")
        step = dict(n_iters=1_000_000)
    for _ in range(2):
        r.step(add_samples=cfg.spp, **step)
    r.flush()
    ref = str(tmp_path / "ref.ppm")
    img_io.write_ppm(ref, r.image)
    with open(out, "rb") as fa, open(ref, "rb") as fb:
        assert fa.read() == fb.read()
