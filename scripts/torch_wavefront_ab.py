"""Paired A/B of the PyTorch port's wavefront, binned and DDA paths between
two source trees, on one CUDA card.

    python scripts/torch_wavefront_ab.py PARENT_TREE CHANGE_TREE \
        [--paths NAME,...] [--blocks N] [--strict] [--out wavefront_ab.json]

Each tree is a checkout (or ``git archive`` unpack) holding
``smallpt_tpu_torch/``. The script runs its worker in blocks of four, each
in a fresh process with ``PYTHONPATH`` set to one tree, in the order
parent, change, change, parent, so that a drift of the host over the call
falls on both sides alike (--blocks, 1 by default). A worker builds the
kernels of its own tree and times, with CUDA events (one warm-up, then
three):

- ``regen_cornell_1024x768``: REGEN + K2, Cornell, 4 spp, max_depth 48, a
  ``ProgressiveRenderer`` pass (path 1 of PERF.md section 4);
- ``regen_procedural10000_512x384``: the same on 10,000 spheres, max_depth
  24 (path 2);
- ``flat_mesh500_256x192``: FLAT + K6 on procedural_mesh_scene(500), max_depth
  12 (path 3);
- ``flat_split8_cornell_1024x768``: FLAT + K2 with split_budget 8, as path 1
  (path 4);
  K2 and K6 are each bit-equal to one plain version in every tree, so the
  image's bits after the timed passes (``*_bits``) must be equal across
  the trees on paths 1 to 4. On paths 1, 2 and 4 every K2 launch of one
  more pass is timed alone as K8's are below (the first, middle and last,
  the sum: ``*_k2_pass_ms``; the first launch's first 77 rays alone:
  ``*_k2_rays77_ms``), and the first change worker sums their bounds
  (chip_smoke.py::k2_bound with the path's scene: ``*_k2_pass_bound_ms``,
  and with every row at the whole test,
  ``*_k2_pass_bound_every_pair_full_ms``);
- ``mesh_stream_mesh500_256x192``: a ``WavefrontStreamingRenderer`` round
  (reset, step(n_bounces=24, add_samples=8), flush) on path 3's scene (path
  6), its accumulators' bits likewise. On both mesh paths every K6 launch
  of one more pass or round is timed alone as K8's are below (the first,
  middle and last, the sum: ``*_k6_pass_ms``), and the first change worker
  sums their bounds (chip_smoke.py::k6_bound: ``*_k6_pass_bound_ms``, and
  at the whole test's 49 ops every live pair,
  ``*_k6_pass_bound_every_pair_full_ms``);
- ``flat_culled_mesh500_256x192`` and ``mesh_stream_culled_mesh500_256x192``:
  paths 3 and 6 with the culled route forced (MESH_ACCEL_MIN_TRIS = 1),
  through K7 (paths 5 and 7), timed the same way; K7 is bit-equal to K6 in
  every tree, so their bits must equal paths 3's and 6's where a worker
  runs both, and across the trees. Every K7 launch of one more pass or
  round is timed alone (``*_k7_pass_ms``, first, middle, last, the sum),
  and the first change worker sums their bounds (chip_smoke.py::k7_bound,
  the function's: ``*_k7_pass_bound_ms``; the tile walk's alone:
  ``*_k7_pass_bound_tile_walk_ms``);
- the binned paths through K8 at bench.py --procedural-binned's shape
  (procedural_sphere_scene(10000), 512x384, 4 spp, max_depth 24, four
  lanes a pixel, seeded 1000), each without and with NEE on sphere 8
  (``*_nee``): ``binned_drain_procedural10000_512x384``, a
  ``ProgressiveRenderer`` pass on the "binned" route (path 8), and
  ``binned_stream_procedural10000_512x384``, a ``BinnedStreamingRenderer``
  round (reset, step(4, 8), flush; path 9). Beside the pass times: K8's
  launches a pass, a checksum of the accumulators' bits (``*_bits``: K8 is
  bit-equal to one plain version in every tree, so the trees' images must
  be too), and every K8 launch of one more pass timed alone from its own
  input state (CUDA events, the mean of five after a warm-up, the card
  held busy about 1 ms before each, so that the events time the launch's
  kernels and not the host's enqueueing of them): the first, middle and
  last launch and their sum (``*_k8_pass_ms``); the first change worker
  also sums each launch's bound (chip_smoke.py::k8_bound, from the change
  tree) over that pass (``*_k8_pass_bound_ms``);
- the DDA paths through K3 on procedural_sphere_scene(10000), seeded
  1000: ``dda_procedural10000_512x384`` and ``*_nee`` (NEE on sphere 8), a
  ``StreamingRenderer`` round as chip_smoke.py::k3_main runs it (reset,
  step(spp * max_depth + 16 iterations, 4 samples), flush; bench.py
  --procedural and --procedural-nee), and ``dda_procedural10000_1920x1080``,
  one round as chip_smoke.py::k3_hd runs it (24 spp, launches capped at 16
  bounce iterations; bench.py --procedural-hd). K3 is bit-equal to one
  plain version in every tree, so the accumulators' bits (``*_bits``) and
  the state planes' (``*_state_bits``) must be equal across the trees. At
  512x384, K3 alone on one launch that drains a budget of 4 from a fresh
  state (key fold_in(base_key(0), 1000)), timed as K8's launches are
  (``*_k3_launch_ms``), its planes' bits (``*_k3_launch_bits``); with
  --strict the first parent and the first change worker also hold that
  launch's planes to the plain version's (chip_smoke.py::k3_strict, not
  raising: the lanes that differ a plane, ``*_k3_strict``, and their sum,
  ``*_k3_strict_lanes_differ``).

- the K1 paths on the Cornell box at 1024x768, max_depth 48, seed 0:
  ``mega_cornell_1024x768``, a ``ProgressiveRenderer`` pass on the default
  route (4 spp; K1a), and ``stream_cornell_1024x768`` and ``*_nee`` (NEE on
  sphere 8), a ``StreamingRenderer`` round of 24 spp in one launch that
  drains, as chip_smoke.py::stream_full_width runs it (K1c). K1a and K1c
  are bit-equal to one plain version in every tree, so the image's or the
  accumulators' bits (``*_bits``) must be equal across the trees. K1 alone
  on one launch (key fold_in(base_key(0), 1000)), timed as K8's launches
  are: K1a over the whole frame (``*_k1_launch_ms``), K1c draining a
  budget of 4 from a fresh state; their outputs' bits
  (``*_k1_launch_bits``); with --strict the first parent and the first
  change worker also hold that launch to the plain version
  (chip_smoke.py::k1_strict, not raising: ``*_k1_strict``,
  ``*_k1_strict_lanes_differ``).

- the recorder of the training step (BASELINE config 4: Cornell
  512x512, 4 spp, max_depth 16, key fold_in(base_key(0), 1000)):
  ``record_cornell_512x512``, the record phase as the step runs it
  (``render_record_megakernel``: the tables, K1b's launches, the image and
  the winner plane in FLAT order); beside it the same phase made one K1b
  launch a sample, its winners stacked into FLAT order
  (``*_per_sample``), each the median of N_RECORD runs after a warm-up
  (a run takes 1-2 ms, mostly the host's, and the first runs of a process
  carry the allocator's growth); and the training step (``*_step``,
  ``sgd_train_step`` through the replay, the median of five). The
  bits of the image, winners and rays of both forms (``*_bits``,
  ``*_per_sample_bits``) must be equal across the trees. K1b alone on one
  sample's launch (``mega_record``, 262,144 lanes) and, where the tree has
  it, on the step's launch over the 4 samples (``_record_launch``,
  1,048,576 lanes), timed as K8's launches are (``*_k1b_launch_ms``,
  ``*_k1b_launch4_ms``); with --strict the one-sample launch held to the
  plain version (chip_smoke.py::record_strict, not raising:
  ``*_k1b_strict``, ``*_k1b_strict_lanes_differ``).

--paths keeps only the named ones (all of them by default). Beside each
worker's readings, the card's mean SM clock and power draw over the
worker (nvidia-smi sampled every 100 ms: ``sm_clock_mhz``, ``power_w``).

It prints one JSON line a worker, then the card's name and power limit and
a summary line: each reading's mean a tree (over its workers) and the
change's ratio to the parent. Exits non-zero without a card, or if the
trees' ``*_bits`` differ. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import functools
import json
import os
import subprocess
import sys

import numpy as np

N_TIMED = 3
N_RECORD = 25
BINNED_SEED = 1000
HOLD_CYCLES = 2_000_000  # the card's spin before a timed launch, ~1 ms
DDA = ("dda_procedural10000_512x384", "dda_procedural10000_512x384_nee",
       "dda_procedural10000_1920x1080")
K1 = ("mega_cornell_1024x768", "stream_cornell_1024x768",
      "stream_cornell_1024x768_nee")
RECORD = "record_cornell_512x512"
BINNED = ("binned_drain_procedural10000_512x384",
          "binned_drain_procedural10000_512x384_nee",
          "binned_stream_procedural10000_512x384",
          "binned_stream_procedural10000_512x384_nee")


def _ms(fn) -> float:
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return float(a.elapsed_time(b))


def _times(fn) -> list:
    import torch

    fn()
    torch.cuda.synchronize()
    return [_ms(fn) for _ in range(N_TIMED)]


def _median_ms(fn, n: int) -> float:
    """The median CUDA-event time of n runs of fn() after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    return float(np.median([_ms(fn) for _ in range(n)]))


def _launch_ms(run, state, before) -> float:
    """One K8 launch (run()) from its input state: the mean of five timed
    runs after a warm-up, the state copied back before each, outside the
    events, and the card then held busy."""
    import torch

    times = []
    for k in range(6):
        for x, x0 in zip(state, before):
            x.copy_(x0)
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        if k:
            times.append(float(a.elapsed_time(b)))
    return float(np.mean(times))


def binned(only: set, bounds: bool) -> dict:
    """The binned paths (see the module's docstring)."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.ops import megakernel as mk

    k8_bound = None
    if bounds:
        import chip_smoke

        k8_bound = chip_smoke.k8_bound
    dev = torch.device("cuda")
    cam = smallpt_camera()
    scene = procedural_sphere_scene(10000)
    base = RenderConfig(width=512, height=384, spp_per_cell=1, max_depth=24,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    out = {}
    for name in BINNED:
        if only and name not in only:
            continue
        cfg = base.replace(nee_lights=(8,)) if name.endswith("_nee") \
            else base
        if "_drain_" in name:
            r = ProgressiveRenderer(scene, cam, cfg, seed=BINNED_SEED,
                                    device=dev)
            br = r._binned

            def round_():
                r.step()
        else:
            r = br = BinnedStreamingRenderer(scene, cam, cfg,
                                             seed=BINNED_SEED, device=dev)

            def round_():
                r.reset()
                r.step(add_samples=cfg.spp, n_bounces=8)
                r.flush()
        round_()
        torch.cuda.synchronize()
        n0 = mk.stream_step_binned.launches
        out[name] = [_ms(round_) for _ in range(N_TIMED)]
        out[name + "_launches"] = (mk.stream_step_binned.launches
                                   - n0) / N_TIMED
        rad, w = br.accumulators()
        out[name + "_bits"] = _bits(rad.cpu().numpy(), w.cpu().numpy())

        # every K8 launch of one more pass, each timed alone (and bounded)
        # from its input state before the pass goes on
        real, ms, bound = mk.stream_step_binned, [], []

        def spy(*a, **k):
            before = (a[3].clone(), a[4].clone())
            ms.append(_launch_ms(lambda: real(*a, **k), (a[3], a[4]),
                                 before))
            if k8_bound is not None:
                bound.append(k8_bound(before, a, k)["bound_ms"])
            a[3].copy_(before[0])
            a[4].copy_(before[1])
            return real(*a, **k)

        spy.launches = real.launches
        mk.stream_step_binned = spy
        try:
            round_()
        finally:
            mk.stream_step_binned = real
            real.launches = spy.launches
        torch.cuda.synchronize()
        for k, v in (("first", ms[0]), ("middle", ms[len(ms) // 2]),
                     ("last", ms[-1])):
            out[f"{name}_{k}_launch_ms"] = v
        out[name + "_k8_pass_ms"] = float(np.sum(ms))
        if bound:
            out[name + "_k8_pass_bound_ms"] = float(np.sum(bound))
        del r, br
        torch.cuda.empty_cache()
    return out


def dda(only: set, strict: bool) -> dict:
    """The DDA paths (see the module's docstring)."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    k3_strict = None
    if strict:
        import chip_smoke

        k3_strict = chip_smoke.k3_strict
    dev = torch.device("cuda")
    scene = procedural_sphere_scene(10000)
    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               spp_per_cell=1)
    base = RenderConfig(width=512, height=384, max_depth=24, **leg)
    out = {}
    for name in DDA:
        if only and name not in only:
            continue
        hd = "_1920x1080" in name
        cfg = (RenderConfig(width=1920, height=1080, max_depth=24,
                            **dict(leg, spp_per_cell=6)) if hd
               else base.replace(nee_lights=(8,)) if name.endswith("_nee")
               else base)
        r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=BINNED_SEED,
                              device=dev)
        if hd:
            r.max_launch_iters = 16

        def round_():
            r.reset()
            r.step(n_iters=cfg.spp * cfg.max_depth + 16, add_samples=cfg.spp)
            r.flush()

        out[name] = _times(round_)
        rad, w = r.accumulators()
        out[name + "_bits"] = _bits(rad.cpu().numpy(), w.cpu().numpy())
        out[name + "_state_bits"] = _bits(r.f.cpu().numpy(),
                                          r.i.cpu().numpy())
        if hd:
            del r
            torch.cuda.empty_cache()
            continue
        key = rng.fold_in(rng.base_key(0), 1000)
        f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
        mk.set_sample_budget(i0, 4, cfg)
        f, i = f0.clone(), i0.clone()

        def launch():
            sd.stream_step_dda(r._dda, r._cam, cfg, key, f, i, None,
                               10_000_000)

        out[name + "_k3_launch_ms"] = _launch_ms(launch, (f, i), (f0, i0))
        f.copy_(f0)
        i.copy_(i0)
        launch()
        out[name + "_k3_launch_bits"] = _bits(f.cpu().numpy(),
                                              i.cpu().numpy())
        if k3_strict is not None:
            fp, ip = f0.clone(), i0.clone()
            sd.stream_step_dda_plain(r._dda, r._cam, cfg,
                                     *rng.key_words(key), fp, ip,
                                     10_000_000)
            st = k3_strict(name, cfg, f, i, fp, ip, check=False)
            out[name + "_k3_strict"] = st["planes"]
            out[name + "_k3_strict_lanes_differ"] = st["lanes_differ"]
        del r
        torch.cuda.empty_cache()
    return out


def k1(only: set, strict: bool) -> dict:
    """The K1 paths (see the module's docstring)."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk

    k1_strict = None
    if strict:
        import chip_smoke

        k1_strict = chip_smoke.k1_strict
    dev = torch.device("cuda")
    scene, cam = cornell_box_scene(), smallpt_camera()
    ns = scene.n_spheres
    base = RenderConfig(width=1024, height=768, spp_per_cell=1,
                        max_depth=48, camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT)
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1_ = rng.key_words(key)
    out = {}
    for name in K1:
        if only and name not in only:
            continue
        cfg = base.replace(nee_lights=(8,)) if name.endswith("_nee") \
            else base
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        if name.startswith("mega_"):
            r = ProgressiveRenderer(scene, cam, cfg, seed=0, device=dev)
            n0 = mk.mega_pass.launches
            out[name] = _times(r.step)
            if mk.mega_pass.launches - n0 != 1 + N_TIMED:
                raise AssertionError(f"{name}: not the K1a route")
            out[name + "_bits"] = _bits(r.image)
            got = []

            def launch():
                got[:] = mk.mega_pass(table, camv, cfg, key, n_spheres=ns)

            out[name + "_k1_launch_ms"] = _launch_ms(launch, (), ())
            out[name + "_k1_launch_bits"] = _bits(*(t.cpu().numpy()
                                                    for t in got))
            if k1_strict is not None:
                want = mk.render_pass_plain(table, camv, cfg, k0, k1_,
                                            n_spheres=ns)
                st = k1_strict(name, cfg, *got, *want, check=False)
        else:
            spp = 24
            r = StreamingRenderer(scene, cam, cfg, seed=0, device=dev)

            def round_():
                r.reset()
                r.step(n_iters=10_000_000, add_samples=spp)

            out[name] = _times(round_)
            rad, w = r.accumulators()
            out[name + "_bits"] = _bits(rad.cpu().numpy(), w.cpu().numpy())
            f0, i0 = mk.init_stream_state(cfg, device=dev)
            mk.set_sample_budget(i0, 4, cfg)
            f, i = f0.clone(), i0.clone()

            def launch():
                mk.stream_step(table, camv, cfg, key, f, i, None,
                               10_000_000, n_spheres=ns)

            out[name + "_k1_launch_ms"] = _launch_ms(launch, (f, i),
                                                     (f0, i0))
            f.copy_(f0)
            i.copy_(i0)
            launch()
            out[name + "_k1_launch_bits"] = _bits(f.cpu().numpy(),
                                                  i.cpu().numpy())
            if k1_strict is not None:
                fp, ip = f0.clone(), i0.clone()
                mk.stream_step_plain(table, camv, cfg, k0, k1_, fp, ip,
                                     10_000_000, n_spheres=ns)
                st = k1_strict(name, cfg, f, i, fp, ip, check=False)
        if k1_strict is not None:
            out[name + "_k1_strict"] = st["planes"]
            out[name + "_k1_strict_lanes_differ"] = st["lanes_differ"]
        del r
        torch.cuda.empty_cache()
    return out


def _record_per_sample(mk, scene, cam, cfg, key, dev):
    """The record phase made one K1b launch a sample (mega_record), its
    radiance summed and its winners stacked into FLAT order."""
    import torch

    table = mk.build_scene_table(scene, cfg, dev)
    camv = mk.build_camera_vec(cam, cfg, dev)
    rad = torch.zeros((cfg.n_pixels, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    recs = []
    for s in range(cfg.spp):
        r_s, n_s, w_s = mk.mega_record(table, camv, cfg, key, s,
                                       n_spheres=scene.n_spheres)
        rad = rad + r_s
        rays = rays + n_s.sum(dtype=torch.int64)
        recs.append(w_s)
    winners = torch.stack(recs, dim=2).reshape(cfg.max_depth, -1)
    return rad, winners, rays


def record(only: set, strict: bool) -> dict:
    """The recorder's path (see the module's docstring)."""
    if only and RECORD not in only:
        return {}
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.grad import diff
    from smallpt_tpu_torch.ops import megakernel as mk

    record_strict = None
    if strict:
        import chip_smoke

        record_strict = chip_smoke.record_strict
    dev = torch.device("cuda")
    scene, cam = cornell_box_scene(), smallpt_camera()
    ns = scene.n_spheres
    cfg = RenderConfig(width=512, height=512, spp_per_cell=1, max_depth=16,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1_ = rng.key_words(key)
    got = []
    out = {RECORD: _median_ms(lambda: got.__setitem__(
        slice(None), mk.render_record_megakernel(scene, cam, cfg, key,
                                                 device=dev)), N_RECORD)}
    img, winners, rays = got
    out[RECORD + "_bits"] = _bits(img.cpu().numpy(), winners.cpu().numpy(),
                                  rays.cpu().numpy())
    out[RECORD + "_per_sample"] = _median_ms(lambda: got.__setitem__(
        slice(None), _record_per_sample(mk, scene, cam, cfg, key, dev)),
        N_RECORD)
    out[RECORD + "_per_sample_bits"] = _bits(*(t.cpu().numpy() for t in got))
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99), device=dev)
    out[RECORD + "_step"] = _median_ms(lambda: diff.sgd_train_step(
        scene, cam, cfg, key, target, device=dev), 5)
    table = mk.build_scene_table(scene, cfg, dev)
    camv = mk.build_camera_vec(cam, cfg, dev)
    one = []

    def launch():
        one[:] = mk.mega_record(table, camv, cfg, key, 0, n_spheres=ns)

    out[RECORD + "_k1b_launch_ms"] = _launch_ms(launch, (), ())
    if hasattr(mk, "_record_launch"):
        out[RECORD + "_k1b_launch4_ms"] = _launch_ms(
            lambda: mk._record_launch(table, camv, cfg, k0, k1_, 0, 0,
                                      cfg.height, ns, cfg.spp), (), ())
    if record_strict is not None:
        want = mk.record_pass_plain(table, camv, cfg, k0, k1_, 0,
                                    n_spheres=ns)
        st = record_strict(RECORD, one, want, check=False)
        out[RECORD + "_k1b_strict"] = st["planes"]
        out[RECORD + "_k1b_strict_lanes_differ"] = st["lanes_differ"]
    del table, camv, target
    torch.cuda.empty_cache()
    return out


def _k7_bound(*a, **k) -> dict:
    """chip_smoke.py::k7_bound of one K7 launch on the wrapper's
    arguments, its t from the plain version."""
    import chip_smoke

    from smallpt_tpu_torch.ops import mesh_pallas as mp

    want = mp.closest_tri_culled_plain(*a, **k)
    return chip_smoke.k7_bound(a, want[0], k.get("eps", 0.0))


def _kernel_pass(run, kernel: str, bounds: bool, scene=None) -> dict:
    """Every launch of the closest-hit kernel ``kernel`` ("k2", "k6" or
    "k7") in one more run(), each timed alone (``_launch_ms``: the kernel
    writes only its outputs, so nothing is restored) and, with bounds,
    bounded (chip_smoke.py::k2_bound, with the sphere scene rendered,
    k6_bound or k7_bound, from the change tree; beside each, every pair at
    the whole test's, or K7's tile walk): the first, middle and last
    launch's ms, their sum and the bounds' sums; for K2 also the first
    launch's first 77 rays alone (one ray block, ``rays77_ms``). Each key
    is prefixed with the kernel's name."""
    import torch

    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    mod, name = {"k2": (ip, "closest_hit"), "k6": (mp, "closest_tri"),
                 "k7": (mp, "closest_tri_culled")}[kernel]
    bound_fn, other = None, ("bound_ms_tile_walk" if kernel == "k7"
                             else "bound_ms_every_pair_full")
    if bounds:
        import chip_smoke

        bound_fn = {"k2": functools.partial(chip_smoke.k2_bound,
                                            scene=scene),
                    "k6": chip_smoke.k6_bound, "k7": _k7_bound}[kernel]
    real, ms, bound, full, first = getattr(mod, name), [], [], [], []

    def spy(*a, **k):
        ms.append(_launch_ms(lambda: real(*a, **k), (), ()))
        if not first:
            first.append((a, k))
        if bound_fn is not None:
            b = bound_fn(*a, **k)
            bound.append(b["bound_ms"])
            full.append(b[other])
        return real(*a, **k)

    spy.launches = real.launches
    setattr(mod, name, spy)
    try:
        run()
    finally:
        setattr(mod, name, real)
        real.launches = spy.launches
    torch.cuda.synchronize()
    out = {"first_launch_ms": ms[0], "middle_launch_ms": ms[len(ms) // 2],
           "last_launch_ms": ms[-1], "pass_ms": float(np.sum(ms)),
           "pass_launches": len(ms)}
    if kernel == "k2":
        (o, d, *rest), k = first[0]
        o, d = o[:, :77].contiguous(), d[:, :77].contiguous()
        out["rays77_ms"] = _launch_ms(lambda: real(o, d, *rest, **k), (),
                                      ())
    if bound:
        out["pass_bound_ms"] = float(np.sum(bound))
        out["pass_" + other.replace("bound_ms", "bound") + "_ms"] = float(
            np.sum(full))
    return {f"{kernel}_{k}": v for k, v in out.items()}


def _clock_means(samples: str) -> dict:
    """The mean SM clock (MHz) and power draw (W) of nvidia-smi's
    "clocks.sm, power.draw" lines."""
    rows = []
    for line in samples.splitlines():
        try:
            rows.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return {}
    mhz, watts = np.mean(np.array(rows), axis=0)
    return {"sm_clock_mhz": float(mhz), "power_w": float(watts)}


def _bits(*arrays) -> str:
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(a).tobytes() for a in arrays)).hexdigest()[:16]


def worker(only: set, bounds: bool, strict: bool) -> dict:
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_mesh_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine import renderer
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer

    # the bounds and the strict check come from the chip_smoke.py beside
    # this script; the package from the worker's tree, first on the path
    sys.path.append(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dev = torch.device("cuda")
    cam = smallpt_camera()
    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               intersector=Intersector.PALLAS, spp_per_cell=1)
    cornell, mesh = cornell_box_scene(), procedural_mesh_scene(500)
    c1 = RenderConfig(width=1024, height=768, max_depth=48,
                      scheduler=Scheduler.REGEN, **leg)
    passes = {
        "regen_cornell_1024x768": (cornell, c1),
        "regen_procedural10000_512x384": (
            procedural_sphere_scene(10000),
            RenderConfig(width=512, height=384, max_depth=24,
                         scheduler=Scheduler.REGEN, **leg)),
        "flat_mesh500_256x192": (mesh, RenderConfig(
            width=256, height=192, max_depth=12, scheduler=Scheduler.FLAT,
            **leg)),
        "flat_split8_cornell_1024x768": (
            cornell, c1.replace(scheduler=Scheduler.FLAT, split_budget=8)),
    }
    passes["flat_culled_mesh500_256x192"] = passes["flat_mesh500_256x192"]
    culled = {"flat_culled_mesh500_256x192": "flat_mesh500_256x192",
              "mesh_stream_culled_mesh500_256x192":
              "mesh_stream_mesh500_256x192"}
    out = {"tree": os.environ.get("PYTHONPATH", ""), **k1(only, strict),
           **record(only, strict), **dda(only, strict),
           **binned(only, bounds)}
    default = renderer.MESH_ACCEL_MIN_TRIS
    for name, (scene, cfg) in passes.items():
        if only and name not in only:
            continue
        # the culled route (K7) where the path forces it, else the default
        renderer.MESH_ACCEL_MIN_TRIS = 1 if name in culled else default
        r = ProgressiveRenderer(scene, cam, cfg, seed=0, device=dev)
        out[name] = _times(r.step)
        out[name + "_mean"] = float(r.image.mean())
        out[name + "_bits"] = _bits(r.image)
        kernel = ("k7" if name in culled else "k6" if scene is mesh
                  else "k2")
        out.update({f"{name}_{k}": v for k, v in _kernel_pass(
            r.step, kernel, bounds, scene).items()})
        del r
    cfg = RenderConfig(width=256, height=192, max_depth=12, **leg)
    for name in ("mesh_stream_mesh500_256x192",
                 "mesh_stream_culled_mesh500_256x192"):
        if only and name not in only:
            continue
        renderer.MESH_ACCEL_MIN_TRIS = 1 if name in culled else default
        s = WavefrontStreamingRenderer(mesh, cam, cfg, seed=0, device=dev)

        def round_():
            s.reset()
            s.step(n_bounces=24, add_samples=8)
            s.flush()

        out[name] = _times(round_)
        rad, w = s.accumulators()
        out[name + "_bits"] = _bits(rad.cpu().numpy(), w.cpu().numpy())
        out.update({f"{name}_{k}": v for k, v in _kernel_pass(
            round_, "k7" if name in culled else "k6", bounds).items()})
        del s
    renderer.MESH_ACCEL_MIN_TRIS = default
    for name, k6_path in culled.items():
        if name + "_bits" in out and k6_path + "_bits" in out \
                and out[name + "_bits"] != out[k6_path + "_bits"]:
            raise AssertionError(f"{name}: bits differ from {k6_path}'s")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--paths", default="")
    p.add_argument("--blocks", type=int, default=1)
    p.add_argument("--bounds", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--strict", action="store_true",
                   help="hold K1's, K1b's and K3's launches to the plain "
                   "version in the first worker of each tree")
    p.add_argument("--out", default="wavefront_ab.json")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wavefront_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.worker:
        only = set(filter(None, args.paths.split(",")))
        print(json.dumps(worker(only, args.bounds, args.strict)),
              flush=True)
        return 0
    runs = []
    for n, side in enumerate(("parent", "change", "change", "parent")
                             * args.blocks):
        tree = os.path.abspath(getattr(args, side))
        env = dict(os.environ, PYTHONPATH=tree)
        # the K2, K6, K7 and K8 launches' bounds once, in the first change
        # worker; K1 and K3 against the plain version once a tree
        extra = (["--bounds"] if n == 1 else []) + (
            ["--strict"] if args.strict and n < 2 else [])
        # the card's SM clock and power draw over the worker
        smi_log = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.parent,
                 args.change, "--worker", "--paths", args.paths, *extra],
                env=env, capture_output=True, text=True, timeout=1800,
                cwd=tree)
        finally:
            smi_log.terminate()
            samples, _ = smi_log.communicate(timeout=60)
        if res.returncode:
            print(res.stdout, res.stderr, file=sys.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["side"] = side
        run.update(_clock_means(samples))
        runs.append(run)
        print(json.dumps(run), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    summary, same = {}, True
    for name in {k: 0 for r in runs for k in r}:
        if name in ("tree", "side") or name.endswith(("_mean", "_strict")):
            continue
        if name.endswith("_bits"):
            same &= len({r[name] for r in runs}) == 1
            continue
        by = {side: [t for r in runs if r["side"] == side and name in r
                     for t in np.atleast_1d(r[name])]
              for side in ("parent", "change")}
        by = {k: float(np.mean(v)) if v else None for k, v in by.items()}
        summary[name] = dict(parent=by["parent"], change=by["change"],
                             ratio=by["change"] / by["parent"]
                             if by["parent"] and by["change"] else None)
    summary["images_bit_equal"] = same
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(device=smi, runs=runs, summary=summary), f, indent=1)
    print(smi)
    print(json.dumps(summary))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
