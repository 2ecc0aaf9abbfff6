"""Interactive render session — the reference's two-thread app, headless
(PyTorch port of smallpt_tpu/interactive.py).

The reference runs a render thread that loops Renderer::render and a UI
thread that polls keys, enqueues JSON render requests and shows the
accumulation (main(), smallpt.cpp:840-1005; request protocol
{"action": "update_camera", "org": [x,y,z]}, smallpt.cpp:978-985). Here:

- the calling thread is the render loop (progressive passes on the card);
- a reader thread consumes line-delimited JSON commands from a stream
  (stdin for ``python -m smallpt_tpu_torch --interactive``), checks them
  and enqueues them on the renderer's lock-guarded queue;
- frames stream to disk through the native async writer (a third, C++
  consumer thread), utils/native.py::FrameSink.

Protocol (one JSON object per line):
    {"action": "update_camera", "org": [50, 53, 295.6]}   # + accum reset
    {"action": "update_scene", "center": [...], "radius": [...]}
    {"action": "load_scene", "path": "scene.json"}        # or "scene": {...}
    {"action": "reset"}
    {"action": "snapshot", "path": "now.png"}             # saved after a pass
    {"action": "quit"}

Plus the reference's keyboard shortcuts as one-letter commands:
    "u" / "d"  — move the camera origin's y by +/- 0.01 (GLFW_KEY_UP/DOWN,
                 smallpt.cpp:968-976)
"""

from __future__ import annotations

import json
import sys
import threading

import numpy as np

from smallpt_tpu_torch.utils import image as img_io
from smallpt_tpu_torch.utils.metrics import log_json

_RENDER_ACTIONS = ("update_camera", "update_scene", "load_scene", "reset")


def _camera_org(camera) -> np.ndarray:
    if hasattr(camera, "origin"):
        return camera.origin.detach().cpu().numpy()
    return camera.local_to_world[:3, 3].detach().cpu().numpy()


def _save(path: str, img) -> None:
    (img_io.write_png if path.endswith(".png") else img_io.write_ppm)(path,
                                                                      img)


class InteractiveSession:
    def __init__(self, renderer, stream=None, frame_pattern: str | None = None,
                 frame_every: int = 1):
        """renderer: any progressive renderer (engine/progressive.py);
        stream: an iterable of lines (stdin by default)."""
        self.renderer = renderer
        self.stream = stream if stream is not None else sys.stdin
        self.frame_pattern = frame_pattern
        self.frame_every = frame_every
        self.reader = None  # the reader thread, once run() starts it
        self._quit = threading.Event()
        self._snapshots: list[str] = []
        self._snap_lock = threading.Lock()
        # the UI side's own copy of the camera origin: nudges move it and
        # enqueue absolute positions, as the reference's UI thread owns
        # cameraOrg (smallpt.cpp:885,968-985); reading renderer.camera from
        # the reader thread would race with the requests being applied
        self._ui_org = _camera_org(renderer.camera).copy()

    # -- the reader thread (the UI thread's input half) -----------------------
    def _reader(self) -> None:
        for line in self.stream:
            line = line.strip()
            if not line:
                continue
            if line in ("u", "d"):
                self._ui_org = self._ui_org + np.asarray(
                    [0.0, 0.01 if line == "u" else -0.01, 0.0])
                self.renderer.enqueue({"action": "update_camera",
                                       "org": self._ui_org.tolist()})
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                log_json("bad_request", {"error": str(e), "line": line[:200]})
                continue
            if not isinstance(req, dict):
                log_json("bad_request", {"error": "not a JSON object",
                                         "line": line[:200]})
                continue
            action = req.get("action")
            if action == "quit":
                self._quit.set()
                return
            if action == "snapshot":
                with self._snap_lock:
                    self._snapshots.append(req.get("path", "snapshot.png"))
                continue
            # checked before it is queued: a malformed message is logged
            # and dropped, never handed to the render loop
            if action not in _RENDER_ACTIONS:
                log_json("bad_request", {"error": f"unknown action {action!r}"})
                continue
            if action == "update_camera":
                org = req.get("org")
                if not (isinstance(org, (list, tuple)) and len(org) == 3):
                    log_json("bad_request",
                             {"error": "update_camera needs org=[x,y,z]"})
                    continue
                # later u/d nudges build on the position set here
                self._ui_org = np.asarray(org, dtype=np.float64)
            self.renderer.enqueue(req)
        self._quit.set()  # EOF ends the session (like closing the window)

    def _take_snapshots(self, passes: int) -> None:
        with self._snap_lock:
            snaps, self._snapshots = self._snapshots, []
        for path in snaps:
            _save(path, self.renderer.image)
            log_json("snapshot", {"path": path, "passes": passes})

    # -- the render loop (the reference's render thread) ------------------------
    def run(self, max_passes: int | None = None) -> int:
        """Render until quit or the stream's end (or max_passes); returns
        the passes rendered. Requests queued just before quit get one more
        pass, so the saved image shows them. The reader thread is a daemon:
        a stream that never ends does not keep the process alive."""
        from smallpt_tpu_torch.utils.native import FrameSink

        self.reader = threading.Thread(target=self._reader, daemon=True)
        self.reader.start()
        cfg = self.renderer.config
        sink = (FrameSink(self.frame_pattern, cfg.width, cfg.height)
                if self.frame_pattern else None)
        passes = 0
        try:
            while not self._quit.is_set():
                if max_passes is not None and passes >= max_passes:
                    break
                self.renderer.step()
                passes += 1
                self._take_snapshots(passes)
                if sink is not None and passes % self.frame_every == 0:
                    sink.push(self.renderer.image, passes)
            if self.renderer.pending_requests and (
                    max_passes is None or passes < max_passes):
                self.renderer.step()
                passes += 1
            self._take_snapshots(passes)
        finally:
            if sink is not None:
                sink.close()
        return passes
