"""smallpt_tpu_torch — the PyTorch/CUDA port of smallpt_tpu.

A second package beside the JAX one, which stays the reference. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package becomes a kernel
written by hand for the H100 (csrc/), built with nvcc at first use and
loaded with ctypes, beside a plain PyTorch version of the same function that
the CPU tests run. Entry points render on the card unless given
``device="cpu"``; they never fall back on their own. The port imports
neither JAX nor smallpt_tpu.

Ported so far, for sphere scenes, with next-event estimation (ROADMAP.md):
- the per-pass megakernel route: ProgressiveRenderer.step -> mega_pass ->
  one launch of csrc/megakernel.cu per pass, on a scene table and camera
  vector built once (render_with_stats -> render_pass_megakernel for a
  single pass);
- the streaming route: StreamingRenderer.step/flush/image -> stream_step ->
  the streaming mode of the same kernel body, on path state that persists
  across launches.
"""

from smallpt_tpu_torch.config import (
    CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core.camera import LegacyCamera, MatrixCamera
from smallpt_tpu_torch.core.scene import (
    DIFF, REFR, SPEC, Material, SphereScene,
)
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.renderer import (
    render, render_image, render_with_stats,
)
from smallpt_tpu_torch.engine.streaming import StreamingRenderer

__all__ = [
    "RenderConfig", "Mode", "Filter", "CameraModel", "Intersector",
    "Scheduler", "SphereScene", "Material", "DIFF", "SPEC", "REFR",
    "LegacyCamera", "MatrixCamera", "render", "render_image",
    "render_with_stats", "ProgressiveRenderer", "StreamingRenderer",
]
