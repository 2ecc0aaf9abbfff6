"""smallpt_tpu_torch — the PyTorch/CUDA port of smallpt_tpu.

A second package beside the JAX one, which stays the reference. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for the H100 (csrc/), built with nvcc at first use and
loaded with ctypes, beside a plain PyTorch version of the same function that
the CPU tests run. Entry points render on the card unless given
``device="cpu"``; they never fall back on their own. The port imports
neither JAX nor smallpt_tpu.

Ported, with next-event estimation (ROADMAP.md), all that the JAX package
does:
- the per-pass megakernel route: ProgressiveRenderer.step -> mega_pass ->
  one launch of csrc/megakernel.cu per pass, on a scene table and camera
  vector built once (render_with_stats -> render_pass_megakernel for a
  single pass);
- the per-pass REGEN and FLAT wavefronts (ops/wavefront.py), routed as in
  the JAX package, for the other schedulers, the AOV modes, refraction
  splitting and triangle-mesh scenes: plain PyTorch around one closest-hit
  launch a bounce, csrc/closest_hit.cu (K2) for spheres and
  csrc/closest_tri.cu (K6) for triangles with Intersector.PALLAS;
- the streaming route: StreamingRenderer.step/flush/image -> stream_step ->
  the streaming mode of the same kernel body, on path state that persists
  across launches;
- the DDA streaming route for big sphere scenes: StreamingRenderer (above
  2048 spheres, at most one NEE light) -> stream_step_dda -> one launch of
  csrc/stream_dda.cu, which walks each ray through a uniform grid;
- mesh streaming: WavefrontStreamingRenderer.step/flush/image (and
  MeshStreamProgressiveRenderer per pass) -> one wavefront bounce a launch
  of the closest-hit kernel, K6, or with the grid accel (meshes of at least
  MESH_ACCEL_MIN_TRIS triangles, opt-in) csrc/closest_tri_culled.cu (K7)
  over per-tile chunk lists (ops/mesh_accel.py);
- the binned scheduler for big sphere scenes: BinnedStreamingRenderer
  (and BinnedProgressiveRenderer, and render/ProgressiveRenderer's drain
  under MEGA above 2048 spheres) -> per bounce the tile work lists of the
  grid accel (ops/accel.py) and one launch of csrc/stream_binned.cu (K8),
  the culled frontier-marching bounce;
- scene gradients (grad/): image_loss_and_grads, sgd_train_step and
  adam_optimizer -> the recorded-winner replay (one launch of the
  recording megakernel, K1b in csrc/megakernel.cu, over the in-pixel
  samples, then torch autograd through the flat wavefront's bounce on the recorded
  winners), or the flat wavefront under autograd with K2 picking the
  winners;
- the per-ray DDA closest hit (ops/dda.py::intersect_spheres_dda ->
  csrc/dda.cu, K4) and the MXU-assisted sphere sweep
  (ops/intersect_pallas.py::intersect_spheres_mxu -> csrc/closest_hit_mxu.cu,
  K5), which no route calls, as in the JAX package;
- multi-device rendering (parallel/): a (tile, sample) mesh of shards
  over devices and torch.distributed ranks, render_sharded, the sharded
  stream, binned renderer and replay step;
- dtype="float64" on the CPU (the float64 oracle's parity route);
- the host surfaces: every progressive renderer's JSON request queue,
  run and checkpoints (engine/progressive.py), scene files
  (core/scene_io.py), the interactive session (interactive.py), the
  native frame writer (utils/native.py), trace and occupancy_profile
  (utils/metrics.py).
"""

from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core.camera import LegacyCamera, MatrixCamera
from smallpt_tpu_torch.core.scene import (
    DIFF, REFR, SPEC, Material, MeshScene, SphereScene,
)
from smallpt_tpu_torch.engine.accum import WeightedAccum
from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
from smallpt_tpu_torch.engine.mesh_stream import WavefrontStreamingRenderer
from smallpt_tpu_torch.engine.progressive import (
    BinnedProgressiveRenderer, MeshStreamProgressiveRenderer,
    ProgressiveRenderer,
)
from smallpt_tpu_torch.engine.renderer import (
    render, render_image, render_with_stats,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer
from smallpt_tpu_torch.grad.diff import (
    adam_optimizer, image_loss_and_grads, sgd_train_step,
)

__all__ = [
    "RenderConfig", "Mode", "Filter", "CameraModel", "Intersector",
    "Scheduler", "SphereScene", "MeshScene", "Material", "DIFF", "SPEC",
    "REFR",
    "LegacyCamera", "MatrixCamera", "render", "render_image",
    "render_with_stats", "ProgressiveRenderer", "StreamingRenderer",
    "WavefrontStreamingRenderer", "MeshStreamProgressiveRenderer",
    "BinnedStreamingRenderer", "BinnedProgressiveRenderer",
    "image_loss_and_grads", "sgd_train_step", "adam_optimizer",
    "WeightedAccum",
]
