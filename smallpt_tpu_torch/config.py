"""Render configuration (the PyTorch port's copy of smallpt_tpu/config.py).

Same fields, defaults and validation as the JAX package's RenderConfig, kept
as a copy so that the port imports nothing of smallpt_tpu. The reference
hardcodes every knob as a compile-time constant (SURVEY.md §5.6):
resolution (smallpt.cpp:274-275,844-845), jitterSize=2 (:285,703,847), Russian
roulette start depth 5 (:188), split depth <=2 (:201,248), glass IOR nt=1.5
(:227), shading epsilon 0.02 (:172), intersection root epsilon 1e-4
(scene.cpp:133), backend selection (:605), AOV mode (:179-183). Here every one
of those is a field of a hashable dataclass. In the port, the fields the
megakernel reads become launch arguments of the CUDA kernel
(ops/megakernel.py).
"""

from __future__ import annotations

import dataclasses
import enum
import numbers


class Mode(enum.Enum):
    """Shading mode / AOV selection.

    The reference switches these by editing shadePaths (smallpt.cpp:179-183):
    the active line accumulates the normal AOV; commented alternates are
    emission-only, uv, and instance/triangle false-color. FULL is the intended
    complete light transport (the dead-but-complete code smallpt.cpp:185-263).
    """

    FULL = "full"
    NORMAL = "normal"
    UV = "uv"
    INST_ID = "inst_id"
    EMISSION = "emission"


class Filter(enum.Enum):
    """Pixel reconstruction filter.

    BOX: the current engine's filter, 0.5*(2r-1) in [-0.5,0.5]
    (smallpt.cpp:753-755). TENT: the legacy cpuRender/smallpt tent filter,
    dx = r<1 ? sqrt(r)-1 : 1-sqrt(2-r) (smallpt.cpp:327-333).
    """

    BOX = "box"
    TENT = "tent"


class CameraModel(enum.Enum):
    """LEGACY: smallpt's cx/cy frame camera with origin pushed forward 140
    units (smallpt.cpp:277-279,331-333). MATRIX: the current engine's 4x4
    localToWorld clip-space camera (smallpt.cpp:607-641).
    """

    LEGACY = "legacy"
    MATRIX = "matrix"


class Scheduler(enum.Enum):
    """Wavefront scheduling strategy.

    FLAT: one lane per (sample x split-budget slot), lax.while_loop until all
    lanes die — the direct analog of the reference's trace-all-then-compact
    loop (smallpt.cpp:779-807) with masks instead of compaction. Required for
    split_budget > 1 and for the differentiable path.

    REGEN: persistent-lane path regeneration — one lane per pixel consumes
    its spp samples sequentially, regenerating a camera ray in-loop when its
    path dies. TPU-native occupancy fix (no sorts/scatters); ~3-4x faster on
    deep transports. Forward-only, split_budget == 1.

    MEGA: the REGEN schedule as ONE fused bounce kernel
    (ops/megakernel.py): regen + RNG + intersect + shade in a single
    kernel. Same sample streams as REGEN (bit-identical PCG4D keying). The
    port routes the three as the JAX package does
    (engine/renderer.py::_route).
    """

    FLAT = "flat"
    REGEN = "regen"
    MEGA = "mega"


class Intersector(enum.Enum):
    """Intersection backend, mirroring the reference's compile-time
    ``using Intersector = OptixIntersector`` switch (smallpt.cpp:605).

    JAX: plain chunked intersect (the CPUIntersector analog, also the
    differentiable-replay path), ops/intersect.py. PALLAS: the
    hand-written closest-hit kernels (the OptiX Prime analog), K2 for
    spheres and K6 for triangles. The sphere megakernel sweeps its own
    table, so neither value changes the MEGA route.
    """

    JAX = "jax"
    PALLAS = "pallas"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters. Hashable, like the JAX package's."""

    width: int = 256
    height: int = 256

    # Sampling: each pixel is subdivided into jitter_size^2 cells; each cell
    # gets spp_per_cell stratified samples per pass (smallpt.cpp:285,703-704).
    jitter_size: int = 2
    spp_per_cell: int = 1

    # Light transport.
    mode: Mode = Mode.FULL
    max_depth: int = 64  # hard cap on the wavefront loop (RR makes tails rare)
    rr_depth: int = 5  # kill with RR once depth > rr_depth (smallpt.cpp:188)
    ior: float = 1.5  # glass index of refraction nt (smallpt.cpp:227)

    # Refraction path splitting (smallpt.cpp:201,248-254): a REFR hit at
    # depth <= split_depth splits into reflect+refract. split_budget is the
    # number of statically allocated lanes per camera sample; 1 disables
    # splitting (probabilistic single-path selection everywhere, the
    # reference's own behavior for depth > 2, smallpt.cpp:256-263).
    split_depth: int = 2
    split_budget: int = 1

    # Geometry epsilons. shading_eps offsets continuation-ray origins along
    # the shading normal: +nl for reflected/diffuse rays, -nl for transmitted
    # (the reference offsets +0.02*n uniformly, smallpt.cpp:172; original
    # smallpt offsets nothing and relies on a 1e-4 root eps, scene.cpp:133 —
    # which only works in double precision). 0.05 is calibrated for float32
    # at smallpt's 1e5 scene scale, where hit-point placement noise is ~0.03.
    shading_eps: float = 0.05
    # Root-rejection eps: per sphere, max(intersect_eps, intersect_eps_rel*r)
    # — the relative term guards against f32 self-intersection on the
    # 1e5-radius wall spheres (f32 rel eps ~6e-8; 5e-7 gives ~8x margin).
    intersect_eps: float = 1e-4
    intersect_eps_rel: float = 5e-7

    # Normal orientation: the reference has the flip disabled
    # (nl = n, smallpt.cpp:174) which breaks glass; original smallpt flips nl
    # against the incoming ray. True restores the flip (the intended physics,
    # see SURVEY.md Appendix A).
    flip_normals: bool = True

    # Detached-sampling gradients: stop_gradient on sampled continuation
    # directions so reverse-mode grads flow through throughput, emission and
    # hit geometry but not through the Monte-Carlo direction choice (the
    # reparameterized path-replay estimator of BASELINE.json's north star).
    # Visibility discontinuities are not differentiated — the documented
    # bias envelope (SURVEY.md §7 hard part #3).
    detach_sampling: bool = True

    # Differentiable-scan rematerialization: True wraps each bounce body in
    # jax.checkpoint (backward recomputes the bounce — ~3x forward cost,
    # minimal HBM); False stores the bounce residuals instead (backward is
    # pure VJP — faster, ~60 MB x max_depth of residuals at 512x512, well
    # inside one chip's HBM for config-4 shapes). bench.py --diff reads the
    # measured winner; deep/huge shapes keep True.
    diff_remat: bool = True

    # Recorded-winner replay differentiation (grad/replay.py): the loss/grad
    # entry point runs a FAST non-differentiable forward that records each
    # lane's per-bounce winner sphere id, then differentiates a replay scan
    # that reconstructs the recorded winner's hit per lane (O(lanes), no
    # search) instead of differentiating through the per-bounce winner
    # search. Same estimator as the hybrid path (the discrete winner choice
    # is detached either way — RenderConfig.detach_sampling's bias
    # envelope); applies to eligible configs only (sphere scenes, Mode.FULL,
    # split_budget 1, no NEE) and falls back to the scan path otherwise.
    diff_replay: bool = True

    # Next-event estimation (explicit light sampling — the classic
    # smallpt-explicit variant of the reference's lineage): at every diffuse
    # hit, sample the solid-angle cone of each listed light sphere, cast a
    # shadow ray, and add the direct term; emission pickup of those lights is
    # then suppressed along diffuse continuations (specular chains keep it).
    # Empty tuple = off (the reference's pure BSDF-sampling estimator).
    # Indices are sphere ids in the scene (e.g. (8,) for the Cornell light).
    # Hit points INSIDE a light sphere fall back to plain path tracing for
    # that light (no suppression, no cone sample) — keeps the estimator
    # unbiased under smallpt's giant ceiling-light geometry.
    nee_lights: tuple = ()

    # Thin-lens depth of field (beyond the reference's pinhole cameras):
    # aperture is the lens radius in scene units (0 = pinhole), and
    # focal_distance is the along-ray distance to the plane in focus.
    aperture: float = 0.0
    focal_distance: float = 100.0

    # Environment light: constant radiance picked up by rays that escape
    # the scene. The reference leaves exactly this hook in its shading
    # kernel — ``if (!hit) continue; // Here we could accumulate
    # path.weight * envContrib`` (smallpt.cpp:168) — but never implements
    # it. (0, 0, 0) keeps the reference's black-void behavior. Applies
    # to Mode.FULL transport only; AOV modes ignore misses like the
    # reference's debug outputs do.
    env_emission: tuple = (0.0, 0.0, 0.0)

    filter: Filter = Filter.BOX
    camera_model: CameraModel = CameraModel.MATRIX

    intersector: Intersector = Intersector.JAX
    scheduler: Scheduler = Scheduler.MEGA

    # Chunking: spheres/triangles are scanned in chunks of this size inside
    # the pure-JAX intersector to bound (lanes x prims) memory.
    prim_chunk: int = 512

    # dtype for path state. The port renders "float32" only; any other
    # value raises NotImplementedError (engine/renderer.py::_route).
    dtype: str = "float32"

    def __post_init__(self):
        if self.split_budget not in (1, 2, 4, 8, 16):
            raise ValueError("split_budget must be a power of two in [1,16]")
        if not isinstance(self.nee_lights, tuple) or not all(
            isinstance(i, numbers.Integral) and not isinstance(i, bool)
            and i >= 0
            for i in self.nee_lights
        ):
            raise ValueError("nee_lights must be a tuple of sphere indices")
        # coerce numpy/other Integral indices (np.int64 from argmax/argsort
        # is the common source of light ids) to plain hashable ints
        if self.nee_lights and not all(
            type(i) is int for i in self.nee_lights
        ):
            object.__setattr__(
                self, "nee_lights", tuple(int(i) for i in self.nee_lights)
            )
        if self.aperture < 0:
            raise ValueError("aperture must be >= 0")
        if (
            not isinstance(self.env_emission, tuple)
            or len(self.env_emission) != 3
            or not all(
                isinstance(c, numbers.Real) and c >= 0
                for c in self.env_emission
            )
        ):
            raise ValueError("env_emission must be a tuple of 3 floats >= 0")
        if self.env_emission != (0.0, 0.0, 0.0) and not all(
            type(c) is float for c in self.env_emission
        ):
            # coerce ints/np floats to plain hashable floats (equal configs
            # must hash equal)
            object.__setattr__(
                self, "env_emission", tuple(float(c) for c in self.env_emission)
            )
        if self.jitter_size < 1:
            raise ValueError("jitter_size must be >= 1")

    @property
    def has_env(self) -> bool:
        """True when escaped rays pick up environment radiance (the
        smallpt.cpp:168 hook)."""
        return self.env_emission != (0.0, 0.0, 0.0)

    @property
    def spp(self) -> int:
        """Samples per pixel per pass (smallpt.cpp:286,704)."""
        return self.jitter_size * self.jitter_size * self.spp_per_cell

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
