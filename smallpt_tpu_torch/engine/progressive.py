"""Progressive accumulation loop (PyTorch port of smallpt_tpu/engine/
progressive.py) — the interactive app's render-thread semantics
(smallpt.cpp:895-941) without a window.

Each step renders one pass keyed with fold_in(base_key(seed),
sample_count), adds it into an accumulation buffer on the device and bumps
the pass count; the display image divides by passes * spp
(smallpt.cpp:957). The JAX package routes every pass anew; here the route
(engine/renderer.py::_route) and its inputs on the device are picked when
the renderer is made and again whenever a request changes the scene or the
camera: on the megakernel route the scene table and camera vector, so a
step is one kernel launch and its accumulation; on the binned route
(MEGA sphere scenes above MEGA_MAX_SPHERES) one BinnedStreamingRenderer
built for the camera, each step one drain of it (kernel K8); on the
wavefront routes the scene, its K2 or K6 table (or K7 accel) and the mesh
NEE tables. ``MeshStreamProgressiveRenderer`` and
``BinnedProgressiveRenderer`` drive a streaming engine per pass instead
(engine/mesh_stream.py, engine/binned.py), its wavefront carried across
passes.

Every progressive renderer takes the reference's JSON requests
(smallpt.cpp:890-920, 978-985) through ``enqueue``: update_camera {"org":
[x, y, z]}, update_scene (any of center, radius, emission, albedo),
load_scene (a scene file's "path" or an inline "scene", core/scene_io.py),
reset. A request that changes what is rendered resets the accumulation at
the next step; a malformed scene request is logged as "bad_request" and
dropped, keeping the render going. ``run`` renders passes and streams
frames through the native frame writer. ``save_checkpoint`` and
``load_checkpoint`` write and read the JAX package's npz fields, so a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from smallpt_tpu_torch.config import RenderConfig
from smallpt_tpu_torch.core import rng as prng
from smallpt_tpu_torch.core.camera import MatrixCamera
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.mesh_stream import WavefrontStreamingRenderer
from smallpt_tpu_torch.engine.renderer import (
    _route, binned_pass, binned_route, pass_inputs, wavefront_inputs,
    wavefront_pass,
)
from smallpt_tpu_torch.ops.megakernel import mega_pass
from smallpt_tpu_torch.utils.device import (
    check_dtype, resolve_device, torch_dtype,
)
from smallpt_tpu_torch.utils.metrics import RenderStats, log_json

# what a malformed scene request or a scene a renderer cannot take raises
_BAD_SCENE = (TypeError, ValueError, AttributeError)


class _Progressive:
    """What every progressive renderer shares: the request queue and
    ``run``. A subclass sets scene, camera, config, seed, sample_count and
    log_stats, and defines step, image and reset_accumulation."""

    def _init_queue(self) -> None:
        self._requests: list[dict] = []
        self._req_lock = threading.Lock()

    # -- the command queue (smallpt.cpp:890-920) ---------------------------
    def enqueue(self, request: dict | str) -> None:
        """Queue a request (a dict, or its JSON text) for the next step;
        safe to call from another thread."""
        if isinstance(request, str):
            request = json.loads(request)
        with self._req_lock:
            self._requests.append(request)

    @property
    def pending_requests(self) -> int:
        with self._req_lock:
            return len(self._requests)

    def _apply_requests(self) -> bool:
        """Apply the queued requests to self.scene and self.camera; True
        when the accumulation must restart. Raises ValueError on an unknown
        action, as the JAX package does."""
        with self._req_lock:
            requests, self._requests = self._requests, []
        invalidate = False
        for req in requests:
            action = req.get("action")
            if action == "update_camera":
                org = torch.as_tensor(np.asarray(req["org"], np.float64))
                if isinstance(self.camera, MatrixCamera):
                    m = self.camera.local_to_world.clone()
                    m[:3, 3] = org.to(m.dtype)
                    self.camera = self.camera._replace(local_to_world=m)
                else:
                    self.camera = self.camera._replace(
                        origin=org.to(self.camera.origin.dtype))
                invalidate = True
            elif action == "update_scene":
                # any subset of the sphere scene's float fields; load_scene
                # may have swapped in a mesh since, so a field mismatch is
                # logged and dropped
                prev = self.scene
                try:
                    for k in ("center", "radius"):
                        if k in req:
                            self.scene = self.scene._replace(
                                **{k: _f32(req[k])})
                    mat = self.scene.material
                    for k in ("emission", "albedo"):
                        if k in req:
                            mat = mat._replace(**{k: _f32(req[k])})
                    self.scene = self.scene._replace(material=mat)
                    invalidate = True
                except _BAD_SCENE as e:
                    log_json("bad_request",
                             {"action": "update_scene", "error": str(e)})
                    self.scene = prev
            elif action == "load_scene":
                # a whole scene from a file ("path") or an inline spec
                # ("scene"); a bad file or spec is logged and dropped
                from smallpt_tpu_torch.core.scene_io import (
                    load_scene, scene_from_dict,
                )

                try:
                    if "path" in req:
                        new_scene = load_scene(req["path"])
                    elif "scene" in req:
                        new_scene = scene_from_dict(req["scene"])
                    else:
                        raise ValueError("load_scene needs path or scene")
                    n = getattr(new_scene, "n_spheres", None)
                    if self.config.nee_lights and (
                            n is None or max(self.config.nee_lights) >= n):
                        raise ValueError("config.nee_lights out of range "
                                         "for the loaded scene")
                    self.scene = new_scene
                    invalidate = True
                except (OSError, ValueError, KeyError, TypeError) as e:
                    log_json("bad_request",
                             {"action": "load_scene", "error": str(e)})
            elif action == "reset":
                invalidate = True
            else:
                raise ValueError(f"unknown action {action!r}")
        return invalidate

    # -- the headless interactive loop ---------------------------------------
    def run(self, n_passes: int,
            on_frame: Callable[["_Progressive"], Any] | None = None,
            frame_every: int = 1, frame_pattern: str | None = None) -> None:
        """Render n_passes passes, calling on_frame every frame_every passes
        (the UI thread's consumer slot, smallpt.cpp:946-988). With
        frame_pattern (printf-style, e.g. "frames/f_%05d.ppm"), the display
        image is written there every frame_every passes, pass number as the
        index, through the native async writer (utils/native.py::FrameSink),
        so the host encodes frame N while the card renders pass N+1."""
        from smallpt_tpu_torch.utils.native import FrameSink

        sink = (FrameSink(frame_pattern, self.config.width,
                          self.config.height)
                if frame_pattern is not None else None)
        try:
            for i in range(n_passes):
                self.step()
                if (i + 1) % frame_every == 0:
                    if sink is not None:
                        sink.push(self.image, i + 1)
                    if on_frame is not None:
                        on_frame(self)
        finally:
            if sink is not None:
                sink.close()


def _f32(values) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.float64)).to(torch.float32)


def _leaves(tree) -> list:
    """The tensors of a NamedTuple tree in field order (jax.tree.leaves'
    order for the JAX package's scenes and cameras)."""
    out = []
    for x in tree:
        if isinstance(x, tuple):
            out += _leaves(x)
        else:
            out.append(x)
    return out


def _flat(tree) -> np.ndarray:
    """The leaves raveled and concatenated as the JAX package saves them
    (numpy promotes int32 refl beside float32 to float64)."""
    return np.concatenate([np.ravel(x.detach().cpu().numpy())
                           for x in _leaves(tree)])


def _unflatten_like(template, flat: np.ndarray, off: int = 0):
    """template's NamedTuple tree with its leaves read from flat, each
    cast back to its template's dtype and device; returns (tree, end)."""
    out = []
    for x in template:
        if isinstance(x, tuple):
            x, off = _unflatten_like(x, flat, off)
        else:
            n = x.numel()
            x = torch.from_numpy(np.asarray(flat[off:off + n]).reshape(
                tuple(x.shape))).to(device=x.device, dtype=x.dtype)
            off += n
        out.append(x)
    return type(template)(*out), off


class ProgressiveRenderer(_Progressive):
    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 device=None):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.seed = seed
        check_dtype(config, device)
        self.device = resolve_device(device)
        self._base = prng.base_key(seed)
        self.accum = torch.zeros((config.height, config.width, 3),
                                 dtype=torch_dtype(config),
                                 device=self.device)
        self.sample_count = 0  # passes accumulated
        self._stats = RenderStats()
        self._rays_dev = None  # rays accumulated on the device (no sync)
        self._t_first_step: float | None = None
        self.log_stats = False  # emit a JSON log line per step when True
        self._init_queue()
        self._prepare()

    def _prepare(self) -> None:
        """Pick the route of (scene, config) and build its inputs on the
        device, for the scene and camera in force; the binned drain's
        renderer is owned here for every pass until the next change."""
        self.route, self._binned = binned_route(
            self.scene, self.camera, self.config,
            _route(self.scene, self.config, False), self.device)
        if self.route == "mega":
            self._table, self._cam = pass_inputs(self.scene, self.camera,
                                                 self.config, self.device)
        elif self.route != "binned":
            self._inputs = wavefront_inputs(self.scene, self.config,
                                            self.route, self.device)

    def _apply_requests(self) -> bool:
        """The queue's requests, then the route and inputs re-derived when
        the scene or the camera changed; a scene no route can render is
        logged and dropped, keeping the last one."""
        prev_scene, prev_camera = self.scene, self.camera
        invalidate = super()._apply_requests()
        if self.scene is not prev_scene or self.camera is not prev_camera:
            try:
                self._prepare()
            except (*_BAD_SCENE, NotImplementedError) as e:
                log_json("bad_request", {"action": "route",
                                         "error": str(e)})
                self.scene, self.camera = prev_scene, prev_camera
                self._prepare()
        return invalidate

    def step(self, n_passes: int = 1) -> None:
        """Apply the queued requests (restarting the accumulation if they
        changed anything), then run n_passes render passes and accumulate
        (one pass = config.spp samples/pixel, the reference's +1
        progressive sample, smallpt.cpp:922-926)."""
        if self._apply_requests():
            self.reset_accumulation()
        for _ in range(n_passes):
            key = prng.fold_in(self._base, self.sample_count)
            if self._t_first_step is None:
                self._t_first_step = time.perf_counter()
            if self.route == "mega":
                rad, rays = mega_pass(self._table, self._cam, self.config,
                                      key, n_spheres=self.scene.n_spheres)
                rays = rays.sum(dtype=torch.int64)
            elif self.route == "binned":
                rad, rays = binned_pass(self._binned, self.config, key)
            else:
                rad, rays = wavefront_pass(self._inputs, self.camera,
                                           self.config, key)
            self.accum += rad.view(self.accum.shape)
            self._rays_dev = (rays if self._rays_dev is None
                              else self._rays_dev + rays)
            self._stats.passes += 1
            self.sample_count += 1
            if self.log_stats:
                log_json("render_pass", {
                    "pass": self.sample_count, "pass_rays": int(rays),
                    **self.stats.as_dict(),
                })

    @property
    def stats(self) -> RenderStats:
        """Telemetry snapshot. Reading it synchronizes with the device;
        wall_s spans first step -> this read."""
        if self._rays_dev is not None:
            self._stats.rays = int(self._rays_dev)
            self._stats.wall_s = time.perf_counter() - self._t_first_step
        return self._stats

    def reset_accumulation(self) -> None:
        self.accum = torch.zeros_like(self.accum)
        self.sample_count = 0

    def finalize(self) -> None:
        """Nothing to drain: a pass's accumulation is complete when it
        returns (the streaming drivers flush here)."""

    @property
    def image(self) -> np.ndarray:
        """Normalized display image (smallpt.cpp:957): accum / (N * spp)."""
        n = max(self.sample_count, 1)
        return self.accum.cpu().numpy() / (n * self.config.spp)

    # -- checkpoint / resume: (accum, sample_count, seed, camera, scene), the
    # reference's implicit resumable state, in the JAX package's fields ------
    def save_checkpoint(self, path: str) -> None:
        np.savez(path, accum=self.accum.cpu().numpy(),
                 sample_count=self.sample_count, seed=self.seed,
                 camera_kind=type(self.camera).__name__,
                 camera_leaves=_flat(self.camera),
                 scene_leaves=_flat(self.scene))

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of this renderer's seed (of either
        package); the camera and scene take the checkpoint's values in the
        current ones' shapes, and the route is picked again."""
        data = np.load(path, allow_pickle=False)
        if int(data["seed"]) != self.seed:
            raise ValueError("checkpoint seed mismatch — resume would replay "
                             "different sample streams")
        accum = np.asarray(data["accum"],
                           self.accum.cpu().numpy().dtype)
        if accum.shape != tuple(self.accum.shape):
            raise ValueError(f"checkpoint image {accum.shape} != "
                             f"{tuple(self.accum.shape)}")
        self.accum = torch.from_numpy(accum).to(self.device)
        self.sample_count = int(data["sample_count"])
        self.camera = _unflatten_like(self.camera, data["camera_leaves"])[0]
        if "scene_leaves" in data:  # older checkpoints lack the scene
            self.scene = _unflatten_like(self.scene, data["scene_leaves"])[0]
        self._prepare()


class _StreamBackedProgressive(_Progressive):
    """The progressive surface over a persistent streaming engine
    (``self._r``): stepped per pass (each step adds config.spp samples a
    pixel and advances n_bounces) or at equal time (target_ms); the image,
    the drain and the checkpoint are the stream's. Requests reach the
    stream: a new scene rebuilds its tables (a scene it cannot take is
    logged and dropped, the stream re-aimed at the camera), a camera move
    re-aims it, a reset restarts it."""

    def __init__(self, r, scene, camera, config: RenderConfig, seed: int,
                 n_bounces: int | None, target_ms: float | None):
        self._r = r
        self.scene = scene
        self.camera = camera
        self.config = config
        self.seed = seed
        self.n_bounces = (2 * config.max_depth if n_bounces is None
                          else n_bounces)
        self.target_ms = target_ms
        self.sample_count = 0  # passes accumulated
        self.log_stats = False  # emit a JSON log line per step when True
        self._init_queue()

    def _sync_camera(self) -> None:
        """Hand the current camera to the stream (the binned one also
        rebuilds its camera vector)."""
        self._r.camera = self.camera

    def _apply_requests(self) -> bool:
        prev_scene, prev_camera = self.scene, self.camera
        invalidate = super()._apply_requests()
        if invalidate:
            if self.scene is not prev_scene:
                self._sync_camera()
                try:
                    self._r.update_scene(self.scene)
                except _BAD_SCENE as e:
                    # a mesh into the binned grid accel, say: keep the old
                    # scene rather than end the render
                    log_json("bad_request",
                             {"action": "update_scene", "error": str(e)})
                    self.scene = prev_scene
                    self._r.update_camera(self.camera)
            elif self.camera is not prev_camera:
                self._sync_camera()
                self._r.update_camera(self.camera)
            else:
                self._r.reset()
        return invalidate

    def step(self, n_passes: int = 1) -> None:
        if self._apply_requests():
            self.reset_accumulation()
        for _ in range(n_passes):
            if self.target_ms is not None:
                rays = self._r.step_timed(target_ms=self.target_ms,
                                          add_samples=self.config.spp)
            else:
                rays = self._r.step(add_samples=self.config.spp,
                                    n_bounces=self.n_bounces)
            self.sample_count += 1
            if self.log_stats:
                log_json("render_pass", {
                    "pass": self.sample_count, "pass_rays": rays,
                    **self.stats.as_dict(),
                })

    @property
    def stats(self) -> RenderStats:
        """The stream's telemetry."""
        return self._r.stats

    def reset_accumulation(self) -> None:
        # the accumulation lives in the stream state; reset() is idempotent
        self.sample_count = 0
        self._r.reset()

    def finalize(self) -> None:
        """Drain the wavefront: the image becomes the exact estimate over
        every budgeted sample."""
        self._r.flush()

    @property
    def image(self) -> np.ndarray:
        return self._r.image

    def save_checkpoint(self, path: str) -> None:
        self._r.save_checkpoint(path)

    def load_checkpoint(self, path: str) -> None:
        self._r.load_checkpoint(path)
        self.sample_count = self._r.stats.passes


class MeshStreamProgressiveRenderer(_StreamBackedProgressive):
    """Progressive renderer over the mesh streaming engine
    (engine/mesh_stream.py): one PERSISTENT wavefront carried across
    passes (accel, intersect tables and NEE tables built once). The JAX
    CLI's route for a mesh scene in full transport without --scheduler.
    A loaded sphere scene streams through the same engine."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 n_bounces: int | None = None,
                 target_ms: float | None = None, device=None):
        self.device = resolve_device(device)
        super().__init__(
            WavefrontStreamingRenderer(scene, camera, config, seed=seed,
                                       device=self.device),
            scene, camera, config, seed, n_bounces, target_ms)


class BinnedProgressiveRenderer(_StreamBackedProgressive):
    """Progressive renderer over the binned big-scene scheduler
    (engine/binned.py): one PERSISTENT BinnedStreamingRenderer (grid accel
    built once, the wavefront carried across passes, each pass adding
    config.spp samples a pixel), so a frame shown mid-wavefront is a
    consistent weighted estimate and ``finalize()`` drains for the exact
    image. The JAX CLI's route for a sphere scene above MEGA_MAX_SPHERES in
    full transport. binned_kwargs go to the renderer (accel, k_near,
    n_streams, inflight)."""

    def __init__(self, scene, camera, config: RenderConfig, seed: int = 0,
                 n_bounces: int | None = None,
                 target_ms: float | None = None, device=None,
                 **binned_kwargs):
        self.device = resolve_device(device)
        super().__init__(
            BinnedStreamingRenderer(scene, camera, config, seed=seed,
                                    device=self.device, **binned_kwargs),
            scene, camera, config, seed, n_bounces, target_ms)

    def _sync_camera(self) -> None:
        # the camera and its vector on the device (JAX: _binned_cam_vec)
        self._r._set_camera(self.camera)
