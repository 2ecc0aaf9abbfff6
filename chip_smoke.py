#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (smallpt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's eight kernel libraries from csrc/ with nvcc, all at
once (and beside them a small library of stream_binned.cu's sphere test,
lane.cuh's and K8's plan, for two checks): megakernel.cu (the per-pass mega_pass, the recording mega_record and
the streaming stream_step, with NEE in all three), stream_dda.cu (the DDA streaming kernel,
stream_step_dda), closest_hit.cu (K2, the wavefronts' sphere closest hit),
closest_tri.cu (K6, their triangle closest hit), closest_tri_culled.cu
(K7, the grid-culled triangle sweep), stream_binned.cu (K8, the binned
scheduler's bounce), dda.cu (K4, the per-ray DDA closest hit) and
closest_hit_mxu.cu (K5, the sphere sweep whose small spheres' quadratic
coefficients come from table rows). It holds each kernel
against its plain PyTorch version (at small sizes, and on the main paths'
own rays at full width) and against the stored f64 golden images, drives
the main paths through the kernels and times them:
- per pass: ProgressiveRenderer on the Cornell box at 1024x768, 4 spp a
  pass, max_depth 48;
- streaming (bench.py's headline configuration): StreamingRenderer on the
  same scene and size, max_depth 48, 24 spp in one launch that drains,
  without and with NEE on the light (sphere 8); every K1a and K1c launch
  held to the plain version is also held on every lane, bit for bit
  (k1_strict), with the bound at K1's own sphere test (k1_bound) and the
  lane utilisation of one thread a lane (lane_utilisation), and K1a and
  K1c run constructed launches at the edges of their queue, their cap
  and their sphere test (1 and 127 lanes, caps cutting lanes mid-path,
  lanes with no budget among working ones, origins on a wall);
- big sphere scenes, streaming (bench.py --procedural and --procedural-nee):
  StreamingRenderer auto-routes procedural_sphere_scene(10000) to the DDA
  kernel at 512x384, 4 spp, max_depth 24, seed 1000, without and with NEE,
  and its image is held to the classic route's on the same scene; then the
  config-5 shape (--procedural-hd): 1920x1080, 24 spp, launches capped at
  16 bounce iterations, whose launches are chained through the plain
  version too and held to it; every K3 state held to the plain version's
  is also held plane by plane, bit for bit (k3_strict), and K3 runs
  constructed launches at the edges of its queue, its cap and its tables
  (77 lanes, every lane idle, capped at 1 and 7 iterations, the overflow
  tables, 1280x720 lanes, at least 3x the threads of the queue's first
  wave), each reporting its plan, ptxas's registers and spills and the
  lanes its queue handed out;
- the wavefront schedulers through the closest-hit kernels
  (ProgressiveRenderer): REGEN with K2 on the Cornell box at 1024x768, 4
  spp a pass, max_depth 48, without and with NEE, and on
  procedural_sphere_scene(10000) at 512x384, 4 spp, max_depth 24, each
  pass's image held to the megakernel's on the same key; FLAT with K6 on
  procedural_mesh_scene(500) at 256x192, held to the plain intersector
  route; FLAT with K2 and split_budget 8 on the Cornell box at 1024x768.
  The goldens and the AOV modes run through these routes too. K6 is held
  bit for bit to its plain version on the first and a middle launch of
  FLAT and of the mesh stream, and on constructed launches that reach its
  plan's edges (77 rays cut to one range a chunk, a tie with a copy in a
  later range, rays parallel to a plane of triangles, n_rows below the
  table), each with the plan its launcher made;
- the grid-culled sweep (K7): against its plain version and K6, each
  launch timed beside K6 on the same rays, on the 60-ball mesh (random,
  coherent and surface rays, an overflowing list, a ragged tile, all-miss
  rays), on procedural_mesh_scene(500)'s camera and first-bounce rays at
  256x192, 4 spp, and on constructed launches at the edges of its box
  cull, its normal cones and its group walk (k7_constructed_launches,
  ops/cull_rays.py's kinds: rays grazing
  triangle planes, zero direction components, origins on and inside
  chunk boxes and on surfaces, NaN and inf, one lane missing among near
  hits, 1 ray, a ragged tile, a 49,152-lane stream launch, grazing rays on
  a mesh of randomly rotated instances whose normals are not shared), each
  with its
  bounds (k7_bound: the lesser of the tile walk's and the box-culled
  count) and ptxas's registers, stack and spills; the FLAT mesh path with
  the culled route forced (MESH_ACCEL_MIN_TRIS = 1), its pass bit-equal
  to the K6 pass, its launches held to the plain version and to K6;
- mesh streaming (bench.py --mesh-stream's shape): WavefrontStreamingRenderer
  on procedural_mesh_scene(500) at 256x192, max_depth 12, rounds of
  step(24 bounces, 8 samples) and a flush, through K6 and with the culled
  route forced through K7, the two bit-equal, the K6 stream held to the
  FLAT per-pass image at 8 spp; then the CLI's mesh routes in process
  (the default route through MeshStreamProgressiveRenderer, and
  --streaming with --checkpoint and --resume, byte-equal to one run);
- the binned scheduler (bench.py --procedural-binned's shape):
  procedural_sphere_scene(10000) at 512x384, 4 spp, max_depth 24, four
  lanes a pixel, without and with NEE, as the per-pass drain
  (ProgressiveRenderer's "binned" route) and as BinnedStreamingRenderer
  rounds (step(4, 8), flush); K8 held to its plain version bit for bit on
  every launch of small drains (the AOV modes, the thin lens and the
  environment light, two NEE lights, a one-chunk near prefix that makes
  lanes march, the all-chunks fallback), on the first, a middle and the
  last launch of each main path, where the culled launch is also held to
  the all-chunks sweep, and on two constructed launches (no working lane;
  one dense tile whose items the sweep cuts into ranges); K8's compaction
  and plan on the card held bit for bit to their plain versions
  (ops/megakernel.py::_k8_cut) on those and on two real launches; K8's
  sphere test
  with the miss decided first held bit for bit to lane.cuh's sphere_tt on
  edge inputs (tangent rays, NaN, zero radius, origins inside and
  outside); the binned image with one lane a pixel against the
  classic route's; the drain beside REGEN through K2 (ROADMAP.md H4); the
  CLI's binned routes in process (the default big-scene route, and
  --binned --nee with --checkpoint and --resume, byte-equal to one run);
  a BinnedStreamingRenderer round with the bin sort every bounce and one
  with the three-program bounce, each bit-equal to the fused, unsorted
  round, the three-program round's K8 launches held to the plain version;
- scene gradients (bench.py --diff, BASELINE config 4): sgd_train_step on
  the Cornell box at 512x512, 4 spp, max_depth 16 through the replay
  differentiator, whose record is the recording megakernel K1b (one
  launch a step over the pixels' 4 samples), with diff_remat on and off,
  its parts and peak memory; one step of the scan differentiator through
  K2 beside it, and the record above MEGA_MAX_SPHERES (the flat wavefront
  over K2), each with its first and middle K2 launch held to the plain
  version; every K1b launch held to its plain version on every lane, bit
  for bit (record_strict: Cornell, the thin lens and the environment
  light, 2,048 spheres, the config-4 launch and one sample's, the shard
  replay's last launch, and constructed launches: 1, 127 and 254 lanes,
  786,432 lanes past several first waves, 12,000 spheres swept from
  global memory, NEE with 1 and 3 lights, an on-wall camera), each with
  its queue and plan, the config-4 launch with its bound at K1's own
  sphere test (k1_bound); the record's image to K1a's pass, and the
  gradients on the card at 12x12 to the CPU's, with the
  finite-difference gates of tests/test_torch_grad*.py;
- the per-ray DDA closest hit (scripts/bench_dda_tpu.py's stage 2):
  intersect_spheres_dda on procedural_sphere_scene(10000), 196,608 bounce
  and 196,608 camera rays, grids at occ_target 16, 28 and 48, K4 held bit
  for bit to its plain version there and on tests/test_dda.py's five
  cases (its queue's rays, walk steps and slots tested to the plain
  version's counts), and to K2 on the same rays (t and winner), with K2's
  time beside K4's, and on constructed launches (k4_constructed_launches:
  rays that miss the grid, twins in one cell, an overflowing grid, a
  launch past the persistent grid's first wave);
- the host surfaces on the per-pass configuration (Cornell, 1024x768, 4
  spp a pass, max_depth 48; K1a): the interactive session over an
  in-memory stream (each restarted pass bit-equal to a fresh renderer's,
  the request-to-frame time), load_scene of a 10,000-sphere scene file
  (the binned drain, K8) and back, run with native frames, a per-pass
  checkpoint resumed byte-equal, the CLI's --frames, --scene-file,
  --interactive, --checkpoint and --resume in process, occupancy_profile
  on REGEN through K2, and one pass under trace (also traced right after
  the per-pass main path);
- the MXU-assisted sweep (scripts/bench_mxu_tpu.py's shape):
  intersect_spheres_mxu on procedural_sphere_scene(10000) and 196,608
  rays, K5 held bit for bit to its plain version there and on the Cornell
  box and 2,000 spheres (rays from inside and outside the spheres' box,
  tests/test_intersect_pallas.py's 77-ray case), its refined hits held to
  K2's under test_mxu_matches_pure_jax's gates, K2's time beside K5's,
  and on constructed launches under its own plan and forced cuts of its
  slots (k5_constructed_launches: twins, masked rows, 1 ray, 77 rays);
- multi-device (parallel/), every shard of a 2 x 2 (tile, sample) mesh on
  the one card in this process: render_sharded (MEGA Cornell 1024x768, 4
  spp) against the single pass; ShardedStreamingRenderer, classic on the
  Cornell box at 1024x768 and DDA on 10,000 spheres at 512x384, each
  shard's band state bit-equal to single-device streams keyed fold_in(key,
  s); ShardedBinnedRenderer on 10,000 spheres at 512x384 bit-equal to
  n_streams=2; the config-4 sharded replay step's gradients against the
  single-device step; then two gloo ranks spawned on the card, the MEGA
  image of each against the single pass;
- the main paths at full width against the port's f64 oracle
  (smallpt_tpu_torch/oracle/numpy_oracle.py, oracle_phases), one frame at
  1 spp, max_depth 12, key 21 each, under the JAX suite's oracle gates
  (tests/test_golden.py:111-172) on a stratified pixel subsample: render's
  per-pass megakernel (K1a) and StreamingRenderer (K1c, without and with
  NEE) on the Cornell box at 1024x768; render's binned drain (K8) on
  procedural_sphere_scene(2100, seed=7), StreamingRenderer's DDA route
  (K3) and REGEN (K2) on procedural_sphere_scene(10000), at 512x384; FLAT
  through K6, then K7, on procedural_mesh_scene(500) at 256x192; and the
  oracle's uniforms drawn on the card, bit-equal to the CPU's.
The megakernel's branches that the main paths do not take (thin lens,
environment light, two NEE lights, row bands and sample slices, 2048
spheres, the opted-in shared memory at 4096 spheres and the global-memory
sweep at 16384) are held against the plain version too.
Each phase prints one flushed line with its elapsed seconds. The last three lines are the card's
name and power limit as nvidia-smi gives them, a JSON object with one entry
per kernel, and {"ok": true, "device": {...}}. Any failed check raises, and
the script then exits non-zero without that last line. It needs one CUDA
device and exits non-zero without one. It imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_cornell_48x36.npz")
GOLDEN_NEE = os.path.join(REPO, "tests", "data",
                          "golden_nee_smalllight_32x24.npz")
GOLDEN_DOF = os.path.join(REPO, "tests", "data", "golden_dof_32x24.npz")
GOLDEN_SHALLOW = os.path.join(REPO, "tests", "data",
                              "golden_cornell_shallow_48x36.npz")
GOLDEN_MESH = os.path.join(REPO, "tests", "data", "golden_mesh_32x24.npz")
T0 = time.perf_counter()

# H100 SXM float32 rate outside the tensor cores and HBM3 rate (NVIDIA data
# sheet), for the least time the card could take for a pass. The 67 TFLOP/s
# count an FMA as two flops; a kernel built with --fmad=false, as this one
# is, issues no FMA and retires its adds and multiplies at most at half that
# rate, PEAK_FP32_NOFMA, which bound_nofma_ms uses.
PEAK_FP32_OPS = 67e12
PEAK_FP32_NOFMA = PEAK_FP32_OPS / 2
PEAK_BYTES = 3.35e12
# float ops of one ray in csrc/megakernel.cu, counted from the source: each
# sphere of the sweep (sphere_tt + the compare): 27 add/sub/mul, 3 sqrt,
# 1 div, 1 max, 6 compares; the rest of a bounce (hit point, normal, flip,
# emission, uniforms, roulette, the DIFF branch, state update): ~150. A
# square root or a division (an SFU sequence of several instructions)
# counts as one op.
OPS_PER_SPHERE = 38
OPS_PER_BOUNCE = 150
# float and integer ops of one NEE shadow ray besides its sweep, counted
# from the NEE block of bounce(): the light vector and shell test (10),
# the cone bound (5), PCG4D and two uniforms (~54 integer ops), the cone
# sample and its frame (~45), the direction (25) and the lit contribution
# (22). The sweep adds OPS_PER_SPHERE per sphere, the light's own included.
OPS_PER_CONE = 160
# K1a's and K1c's bound prices each (ray, sphere) test of their sweeps the
# way their own test (csrc/megakernel.cu::k1_tt) takes it, by the class the
# plain version counts (ops/megakernel.py::_count_pairs): a miss decided at
# det 24 ops (the stable form to det 23 and its test, K2's and K3's
# count), the inside path 36 (the whole test without opn's square root and
# the division), any other test the whole test's OPS_PER_SPHERE. The NEE
# cone's own test of the light stays whole (lane.cuh::sphere_tt).
OPS_K1_MISS, OPS_K1_INSIDE = 24, 36
# float ops of the DDA kernel's own work besides its sphere tests, counted
# from csrc/stream_dda.cu: a walk step (the exit t, the axis choice, three
# divisions for the cell widths, the advance and the in-grid test) ~30; a
# walk init's grid clip (three slabs: a division, two subtractions and
# multiplications, min and max each; the entry point, its cell and the next
# crossings) ~60.
OPS_PER_STEP = 30
OPS_PER_INIT = 60
# The image gate of kernel vs plain: at most 2% of values diverge by more
# than 10%, the means within 5% (a razor flip moves a whole sample).
MAX_FRAC = 0.02
# The kernel and its plain version draw the same random bits, so their
# radiance means differ only by the few lanes a razor flip moves: at most
# 1.46e-3 (relative, as gate() measures it) over every kernel-vs-plain check
# of this script on an H100, while a kernel whose NEE term is scaled by 0.97
# reads 1.22e-2 at the first NEE check (PERF.md, "the kernel-vs-plain mean
# limit"). KP_MEAN sits between.
KP_MEAN = 5e-3
# The JAX suite's gate for a dense procedural sphere scene at 512x384, path
# for path on the same sample streams (tests/test_golden.py::
# test_binned_route_oracle_gate_512x384_procedural): at most 5% of values
# diverge by more than 10%, its thousands of sphere rims razoring more paths
# than Cornell's 9 spheres. The REGEN route through K2 sweeps part B's small
# spheres in the direct quadratic, K1a every sphere in the stable form; on
# procedural_sphere_scene(10000) at 512x384 that formula alone moves 3.4%
# of values against a stable-only K2 with everything else equal (PERF.md
# §6, F8), above tests/test_megakernel.py::_compare's 2%.
MAX_FRAC_PROCEDURAL = 0.05
# The JAX suite's gates against its f64 oracle at full width, path for path
# at 1 spp on a stratified pixel subsample (tests/test_golden.py:111-172):
# at most ORACLE_MAX_FRAC of values more than 10% off on the Cornell box and
# the mesh, MAX_FRAC_PROCEDURAL on the dense sphere scenes, and the means
# within ORACLE_MEAN; the key of both tests.
ORACLE_MAX_FRAC = 0.04
ORACLE_MEAN = 0.1
ORACLE_SEED = 21


def phase(name: str, **info) -> None:
    dt = time.perf_counter() - T0
    print(f"[{dt:8.2f} s] {name}: {json.dumps(info)}", flush=True)


def gate(img: np.ndarray, ref: np.ndarray, max_frac: float,
         max_mean: float = 0.05) -> dict:
    """The JAX suite's image gate (tests/test_megakernel.py::_compare and
    tests/test_golden.py): at most max_frac of values with
    |a-b|/(1+|b|) > 0.1, and the means within max_mean (5%; KP_MEAN for a
    kernel against its plain version)."""
    img, ref = np.asarray(img), np.asarray(ref)
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    mean_rel = float(abs(img.mean() - ref.mean()) / (abs(ref.mean()) + 0.1))
    out = {"frac_div": frac, "max_frac": max_frac, "mean_rel": mean_rel,
           "max_mean": max_mean, "max_abs_err": float(np.abs(img - ref).max())}
    if not (np.isfinite(img).all() and frac <= max_frac
            and mean_rel < max_mean):
        raise AssertionError(f"image gate failed: {out}")
    return out


def cuda_ms(fn, reps: int, setup=None, skip_first: bool = False):
    """(mean CUDA-event time of fn() in ms over reps calls, fn's last
    result). setup(), when given, runs before each call, outside its events.
    Nothing synchronizes between the calls, so the host's launch work
    overlaps the previous call; skip_first drops the first call, which
    starts from an idle card."""
    import torch

    events, out = [], None
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in events]
    return float(np.mean(times[1:] if skip_first else times)), out


# cycles the card spins before a launch timed alone (about 1 ms), longer
# than the host takes to enqueue the launch, so that its events time the
# launch and not the host's enqueueing of it
HOLD_CYCLES = 2_000_000


def hold_card() -> None:
    import torch

    torch.cuda._sleep(HOLD_CYCLES)


def rays_close(name: str, nk: int, np_: int) -> None:
    if abs(nk - np_) > max(64, 0.001 * np_):
        raise AssertionError(f"{name}: ray counts differ: {nk} vs {np_}")


def state_gate(name, cfg, fk, ik, fp, ip, drained: bool,
               n_rows=None) -> dict:
    """Streaming state of the kernel (fk, ik) against the plain version's
    (fp, ip), both from the same state and key (classic or DDA planes). The
    budget plane is read only and must be equal. alive, s_idx and, for the
    DDA state, the walk state must be equal on every lane once drained, and
    before that on all but MAX_FRAC of the lanes (a razor flip moves a
    lane's whole path). depth and sup are compared on lanes alive in both:
    an idle lane's depth and sup differ by design (the TPU tile and the
    plain loop keep stepping idle lanes; the kernel's lane stops), and
    regeneration resets both. The radiance under the image gate with
    KP_MEAN; the m1 and m2 planes and stream_variance's mean and variance
    under the image gate; the per-lane ray counts within max(64, 0.1%) in
    sum."""
    from smallpt_tpu_torch.ops import megakernel as mk

    g = (cfg.height if n_rows is None else n_rows) * cfg.width
    (fk_, ik_), (fp_, ip_) = ([t[:, :g].cpu() for t in mk._planes(f, i)]
                              for f, i in ((fk, ik), (fp, ip)))
    if not bool((ik_[4] == ip_[4]).all()):
        raise AssertionError(f"{name}: budget planes differ")
    differ = (ik_[1] != ip_[1]) | (ik_[2] != ip_[2])
    if ik_.shape[0] > mk._NI:  # the DDA walk state
        differ = differ | (ik_[mk._NI + 1] != ip_[mk._NI + 1])
    moved = int(differ.sum())
    if (drained and moved) or moved > MAX_FRAC * g:
        raise AssertionError(f"{name}: alive/s_idx/walk differ on {moved} "
                             "lanes")
    both = (ik_[2] != 0) & (ip_[2] != 0)
    live_diff = int(((ik_[0] != ip_[0]) | (ik_[5] != ip_[5]))[both].sum())
    if live_diff > MAX_FRAC * g:
        raise AssertionError(f"{name}: depth/sup differ on {live_diff} "
                             "live lanes")
    radk = mk.stream_image(fk, ik, cfg, n_rows)[0].cpu().numpy()
    radp = mk.stream_image(fp, ip, cfg, n_rows)[0].cpu().numpy()
    out = gate(radk, radp, MAX_FRAC, KP_MEAN)
    vk = mk.stream_variance(fk, ik, cfg, n_rows)
    vp = mk.stream_variance(fp, ip, cfg, n_rows)
    out["moments"] = {
        "m1": gate(fk_[12], fp_[12], MAX_FRAC),
        "m2": gate(fk_[13], fp_[13], MAX_FRAC),
        "var_mean": gate(vk[0].cpu(), vp[0].cpu(), MAX_FRAC),
        "var_var": gate(vk[1].cpu(), vp[1].cpu(), MAX_FRAC)}
    rays_close(name, int(ik_[3].sum()), int(ip_[3].sum()))
    out.update(lanes_moved=moved, live_depth_sup_diff=live_diff,
               alive=int(ik_[2].sum()), rays_kernel=int(ik_[3].sum()),
               rays_plain=int(ip_[3].sum()))
    return out


def _strict_planes(fnames, inames, fk, ik, fp, ip) -> dict:
    """A streaming state (fk, ik) against another (fp, ip), plane by plane
    (fnames and inames their f32 and i32 planes): every f32 plane compared
    as int32 and every i32 plane, on every lane of the planes, except depth
    and sup on lanes idle (alive 0) in both. Returns the lanes that differ
    a plane that differs anywhere (``planes``), their sum
    (``lanes_differ``) and the depth and sup differences left out on idle
    lanes."""
    import torch

    torch.cuda.synchronize()
    fk_, fp_ = (t.reshape(len(fnames), -1).view(torch.int32) for t in (fk,
                                                                       fp))
    ik_, ip_ = (t.reshape(len(inames), -1) for t in (ik, ip))
    idle = (ik_[inames.index("alive")] == 0) & (
        ip_[inames.index("alive")] == 0)
    planes, idle_diff = {}, {}
    for names, a, b in ((fnames, fk_, fp_), (inames, ik_, ip_)):
        for k, plane in enumerate(names):
            differ = a[k] != b[k]
            if plane in ("depth", "sup"):
                idle_diff[plane] = int((differ & idle).sum())
                differ = differ & ~idle
            if bool(differ.any()):
                planes[plane] = int(differ.sum())
    return dict(planes=planes, lanes_differ=sum(planes.values()),
                idle_depth_sup_diff=idle_diff, lanes=int(ik_.shape[1]))


def k3_strict(name, cfg, fk, ik, fp, ip, check: bool = True) -> dict:
    """K3's state (fk, ik) against the plain version's (fp, ip), both from
    the same state and key, strictly (_strict_planes); raises unless
    lanes_differ is 0 (check)."""
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    fnames = (mk._F_PLANES + sd._F_WALK
              + (sd._F_NEE if cfg.nee_lights else ()))
    out = _strict_planes(fnames, mk._I_PLANES + sd._I_WALK_PLANES, fk, ik,
                         fp, ip)
    if check and out["lanes_differ"]:
        raise AssertionError(f"{name}: K3's planes differ from the plain "
                             f"version's: {out['planes']}")
    return out


# the lanes_differ of every K1a and K1c launch held by k1_strict, and of
# every K1b launch held by record_strict, in this run, by wrapper
K1_STRICT = {"mega_pass": [], "stream_step": [], "mega_record": []}


def k1_strict(name, cfg, fk, ik, fp, ip, check: bool = True) -> dict:
    """K1a's or K1c's output against the plain version's on the same
    inputs, strictly, on every lane. Per pass (ik a (G,) rays plane; cfg
    unused): fk and fp the (G, 3) radiance, compared as int32, and the
    rays. Streaming (ik a state's i32 planes): every plane
    (_strict_planes), depth and sup aside on lanes idle in both, as the
    design comment of csrc/megakernel.cu allows. Returns the lanes that
    differ a plane (``planes``) and their sum (``lanes_differ``); raises
    unless that is 0 (check)."""
    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    if ik.dim() == 1:
        torch.cuda.synchronize()
        rad = (fk.view(torch.int32) != fp.view(torch.int32)).any(dim=1)
        planes = {k: int(v.sum()) for k, v in (("radiance", rad),
                                              ("rays", ik != ip))
                  if bool(v.any())}
        out = dict(planes=planes, lanes_differ=sum(planes.values()),
                   lanes=int(ik.shape[0]))
        K1_STRICT["mega_pass"].append(out["lanes_differ"])
    else:
        out = _strict_planes(mk._F_PLANES, mk._I_PLANES, fk, ik, fp, ip)
        K1_STRICT["stream_step"].append(out["lanes_differ"])
    if check and out["lanes_differ"]:
        raise AssertionError(f"{name}: K1's output differs from the plain "
                             f"version's: {out['planes']}")
    return out


def lane_utilisation(rays) -> float:
    """The share of a warp's lane slots that issue work when one thread
    runs one lane to its end (K1a before its lane queue): the lanes'
    iterations (a per-pass launch's rays plane: one ray an iteration)
    over 32 times the sum over warps (32 consecutive lanes, the last one
    padded with idle lanes) of their longest lane's."""
    import torch

    r = torch.as_tensor(rays).reshape(-1).to(torch.int64).cpu()
    pad = (-r.shape[0]) % 32
    w = torch.cat([r, r.new_zeros(pad)]).reshape(-1, 32)
    issued = 32 * int(w.max(dim=1).values.sum())
    return int(r.sum()) / issued if issued else 1.0


def chain(cfg, launches, init, kernel_step, plain_step, n_rows=None,
          gate_at=None, strict=None) -> dict:
    """Run the same launches ((budget, n_iters) pairs) through a streaming
    kernel (kernel_step(f, i, budget, n_iters) -> rays) and its plain
    version (plain_step(f, i, n_iters) -> rays) from one fresh state
    (init() -> (f, i), the kernel's, updated in place); gate the launch's
    rays after each launch, and the states after each launch in gate_at
    (None: every one) and after the last, which must drain; strict, when
    given (k3_strict), holds each gated state to the plain version's bit
    for bit as well."""
    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    fk, ik = init()
    fp, ip = fk.clone(), ik.clone()
    out = {}
    for n, (budget, n_iters) in enumerate(launches):
        rk = kernel_step(fk, ik, budget, n_iters)
        if budget is not None:
            mk.set_sample_budget(ip, budget, cfg, n_rows)
        rp = plain_step(fp, ip, n_iters)
        torch.cuda.synchronize()
        last = n == len(launches) - 1
        rays_close(f"launch {n}", int(rk), int(rp))
        if not (last or gate_at is None or n in gate_at):
            continue
        st = state_gate(f"launch {n}", cfg, fk, ik, fp, ip, drained=last,
                        n_rows=n_rows)
        st.update(launch_rays_kernel=int(rk), launch_rays_plain=int(rp))
        if strict is not None:
            st["strict"] = strict(f"launch {n}", cfg, fk, ik, fp, ip)
        out[f"launch{n}"] = st
    if mk.stream_pending(ik) != (0, 0):
        raise AssertionError("the last launch did not drain")
    return out


def stream_chain(table, camv, cfg, key, ns, launches, ip_offset=0,
                 row_offset=0, n_rows=None) -> dict:
    """chain() through the classic streaming kernel (stream_step) and
    stream_step_plain, on a band of n_rows rows from row_offset with the
    samples from ip_offset, each gated state also under k1_strict."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    k0, k1 = rng.key_words(key)
    band = dict(ip_offset=ip_offset, row_offset=row_offset, n_rows=n_rows)
    return chain(
        cfg, launches,
        lambda: mk.init_stream_state(cfg, n_rows, device=table.device),
        lambda f, i, b, n: mk.stream_step(table, camv, cfg, key, f, i, b, n,
                                          n_spheres=ns, **band)[2],
        lambda f, i, n: mk.stream_step_plain(table, camv, cfg, k0, k1, f, i,
                                             n, n_spheres=ns, **band)[2],
        n_rows, strict=k1_strict)


def dda_chain(tables, camv, cfg, key, launches, state=None, counts=None,
              gate_at=None) -> dict:
    """chain() through the DDA kernel (stream_step_dda) and
    stream_step_dda_plain, from state (the kernel's (f, i), updated in
    place; None: a fresh one), each gated state also under k3_strict;
    counts gains the plain version's work."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import stream_dda as sd

    k0, k1 = rng.key_words(key)
    return chain(
        cfg, launches,
        (lambda: state) if state is not None else
        (lambda: sd.init_stream_dda_state(cfg, device=tables.device)),
        lambda f, i, b, n: sd.stream_step_dda(tables, camv, cfg, key, f, i,
                                              b, n)[2],
        lambda f, i, n: sd.stream_step_dda_plain(
            tables, camv, cfg, k0, k1, f, i, n, counts=counts)[2],
        gate_at=gate_at, strict=k3_strict)


def compare_pass(name, rad_k, rays_k, rad_p, rays_p) -> dict:
    """A per-pass launch's (radiance, rays) against the plain version's on
    the same inputs: the image gate with KP_MEAN, rays within
    max(64, 0.1%)."""
    import torch

    torch.cuda.synchronize()
    st = gate(rad_k.cpu().numpy(), rad_p.cpu().numpy(), MAX_FRAC, KP_MEAN)
    nk, np_ = int(rays_k.sum()), int(rays_p.sum())
    rays_close(name, nk, np_)
    st.update(rays_kernel=nk, rays_plain=np_)
    return st


def pass_vs_plain(name, table, camv, cfg, key, ns, **band) -> dict:
    """One per-pass launch (mega_pass) against render_pass_plain on the
    same inputs (compare_pass, and k1_strict)."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    got = mk.mega_pass(table, camv, cfg, key, n_spheres=ns, **band)
    want = mk.render_pass_plain(table, camv, cfg, *rng.key_words(key),
                                n_spheres=ns, **band)
    return dict(compare_pass(name, *got, *want),
                strict=k1_strict(name, cfg, *got, *want))


def gate_shallow(img: np.ndarray, ref: np.ndarray) -> dict:
    """tests/test_golden.py::test_golden_cornell_shallow_tight's gate, the
    JAX suite's detector of a systematic shift: at most 2.5% of values
    diverge by more than 10%, at most 0.5% lie in the 1-10% band, the means
    within 2%."""
    img, ref = np.asarray(img), np.asarray(ref)
    rel = np.abs(img - ref) / (1.0 + np.abs(ref))
    frac = float((rel > 0.1).mean())
    band = float(((rel > 0.01) & (rel <= 0.1)).mean())
    mean_gap = float(abs(img.mean() - ref.mean()) / (ref.mean() + 0.1))
    out = {"frac_div": frac, "max_frac": 0.025, "band_1_10": band,
           "max_band": 0.005, "mean_rel": mean_gap, "max_mean": 0.02}
    if not (np.isfinite(img).all() and frac <= 0.025 and band <= 0.005
            and mean_gap < 0.02):
        raise AssertionError(f"shallow golden gate failed: {out}")
    return out


def device_ms_by_name(prof) -> dict:
    """The device's own events (kernels, copies, sets) of a finished
    torch.profiler run, their durations summed by name (60 characters) in
    ms: the profiler's raw Kineto events, read directly. key_averages()'s
    self device times sum to the same, but build Python objects for every
    host event first, tens of seconds for a wavefront pass's 10^5 events
    (scripts/torch_profile_sums.py compares the two)."""
    from torch.autograd import DeviceType

    by_name = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            name = evt.name()[:60]
            by_name[name] = by_name.get(name, 0.0) + evt.duration_ns() / 1e6
    return by_name


# each wrapper's kernels as the profiler names them (demangled), one
# event each a wrapper call: K1a is mega_pass_kernel<kGlobal, kNee>, K1b
# mega_record_kernel<kGlobal, kNee>; K6 launches one kernel (a memset, no
# kernel, zeroes its counters first when it cuts its rows); K8 launches
# four kernels in turn
KERNEL_EVENT = {name: tuple(re.compile(p) for p in pats) for name, pats in (
    ("mega_pass", (r"\bmega_pass_kernel<",)),
    ("mega_record", (r"\bmega_record_kernel<",)),
    ("stream_step", (r"\bstream_step_kernel\b",)),
    ("stream_step_dda", (r"\bstream_dda_kernel\b",)),
    ("closest_hit", (r"\bclosest_hit_kernel\b",)),
    ("closest_hit_mxu", (r"\bclosest_hit_mxu_kernel\b",)),
    ("closest_hit_dda", (r"\bdda_kernel\b",)),
    ("closest_tri", (r"\bclosest_tri_kernel\b",)),
    ("closest_tri_culled", (r"\bclosest_tri_culled_kernel\b",)),
    ("stream_step_binned", (r"\bbinned_compact_kernel\b",
                            r"\bbinned_plan_kernel\b",
                            r"\bbinned_sweep_kernel\b",
                            r"\bstream_binned_kernel\b")))}


# the seconds a profiler session is held open before and after the
# profiled call, tried in turn until every hand-written launch has its
# device event (utils/metrics.py::trace, PERF.md section 7, F11)
HOLDS_S = (0.0, 2.0, 8.0)


def events_off(names, launched: dict) -> tuple:
    """The profiler's device-kernel events (their names) of the
    hand-written kernels, counted by wrapper and kernel, against the
    launches the wrappers counted over the profiled call: each of a
    wrapper's kernels needs one event a call. (the launched wrappers'
    counts, {wrapper: (events of each kernel, launches)} where one
    differs)."""
    seen = {w: [0] * len(pats) for w, pats in KERNEL_EVENT.items()}
    for name in names:
        for w, pats in KERNEL_EVENT.items():
            for k, pat in enumerate(pats):
                if pat.search(name):
                    seen[w][k] += 1
    return ({w: n for w, n in launched.items() if n},
            {w: (seen[w], n) for w, n in launched.items()
             if any(e != n for e in seen[w])})


def profile(fn) -> dict:
    """torch.profiler over one call of fn: the device time by kernel name,
    and the device's busy share of the call's wall time. Every launch of a
    hand-written kernel in the call must have its device event; a session
    that lost one is run again held open longer (HOLDS_S), and the last
    hold that still loses one raises, so that no busy share undercounts.
    Diagnostic only: a profiler that records no device time gives "not
    measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    for hold in HOLDS_S:
        torch.cuda.synchronize()
        before = counts()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            time.sleep(hold)
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
            time.sleep(hold)
        launched = {k: v - before[k] for k, v in counts().items()}
        events, off = events_off(
            (e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA), launched)
        if not off:
            break
    if off:
        raise AssertionError(f"profile: the profiler recorded (events, "
                             f"launches) {off} of the hand-written kernels "
                             f"held open {hold} s")
    by_name = device_ms_by_name(prof)
    busy_ms = sum(by_name.values())
    if not busy_ms:
        return {"device_ms": "not measured", "wall_ms": wall_us / 1e3}
    return {"device_ms_by_kernel": by_name, "device_busy_ms": busy_ms,
            "wall_ms": wall_us / 1e3, "busy_share": busy_ms * 1e3 / wall_us,
            "kernel_events": events, "hold_s": hold}


def stream_full_width(name, scene, cfg, ref_mean, dev, n_rounds=3) -> dict:
    """The streaming main path at full width: StreamingRenderer rounds from
    fresh state, 24 samples in one launch each (the first one warms up),
    timed with CUDA events; then the kernel alone against
    stream_step_plain on one key with a budget of 4, its time, the plain
    version's time, and the bound of that launch."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk

    spp = 24
    mk.mega_pass.launches = 0
    mk.stream_step.launches = 0
    r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=0, device=dev)

    def round_():
        r.reset()
        return r.step(n_iters=10_000_000, add_samples=spp)

    round_()
    torch.cuda.synchronize()
    round_ms, round_rays = zip(*(cuda_ms(round_, 1) for _ in range(n_rounds)))
    launches = mk.stream_step.launches
    if launches != n_rounds + 1 or mk.mega_pass.launches:
        raise AssertionError(f"{name}: {launches} stream_step launches for "
                             f"{n_rounds + 1} rounds")
    _, w = r.accumulators()
    if not bool((w == spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    mean_rel = float(abs(img.mean() - ref_mean) / ref_mean)
    if mean_rel >= 0.02:
        raise AssertionError(f"{name}: mean {img.mean()} vs per-pass "
                             f"{ref_mean}")
    ms = float(np.mean(round_ms))
    table, camv = r._table, r._cam
    ns = scene.n_spheres
    f0, i0 = mk.init_stream_state(cfg, device=dev)
    f, i = f0.clone(), i0.clone()

    def timed_launch(key, budget):
        """(CUDA-event ms, rays) of one launch that drains a fresh state
        with this budget, the mean of 5 after one warm-up; the last
        launch's state stays in (f, i)."""
        mk.set_sample_budget(i0, budget, cfg, accumulate_max=False)
        return cuda_ms(lambda: mk.stream_step(
            table, camv, cfg, key, f, i, None, 10_000_000, n_spheres=ns)[2],
            6, setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)

    # the round's launch alone (the rest of a round is host work: reset,
    # budget plane, the ray count read back)
    kernel_round_ms, _ = timed_launch(r.key, spp)
    main = dict(rounds=n_rounds, spp=spp, launches=launches,
                round_ms=round_ms, ms_per_round=ms, rays=round_rays,
                mrays_per_s=float(np.mean(round_rays)) / ms / 1e3,
                kernel_round_ms=kernel_round_ms,
                host_ms=ms - kernel_round_ms, profile=profile(round_),
                mean=float(img.mean()), per_pass_mean=ref_mean,
                mean_rel=mean_rel)

    # the kernel alone against its plain version, one key, budget 4
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1 = rng.key_words(key)
    k_ms, rk = timed_launch(key, 4)
    fp, ip = f0.clone(), i0.clone()
    counts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, rp = mk.stream_step_plain(table, camv, cfg, k0, k1, fp, ip,
                                    10_000_000, n_spheres=ns, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp = state_gate(name, cfg, f, i, fp, ip, drained=True)
    cmp["strict"] = k1_strict(name, cfg, f, i, fp, ip)
    n_rays = int(rk)
    rays_close(name, n_rays, int(rp))
    lanes = f0.shape[1] * 8
    nbytes = (ns * 16 * 4 + camv.numel() * 4 + lanes * 4 * (14 + 6)
              + lanes * 4 * (14 + 5))
    kernel = dict(kernel_ms=k_ms, plain_iterations=counts.get("iterations"),
                  mrays_per_s=n_rays / k_ms / 1e3, plain_ms=plain_ms,
                  **k1_bound(counts, n_rays, ns, nbytes),
                  plan=mk.mega_plan(lanes, ns, len(cfg.nee_lights),
                                    "stream"),
                  vs_plain=cmp)
    return {"main": main, "kernel": kernel}


def branch_phases(dev) -> dict:
    """The megakernel's branches the main paths do not take, kernel against
    plain version per pass and streaming (two partial launches and a
    drain): the thin lens, the environment light, two NEE lights (the
    small light and a wall), a row band with a sample slice, and 2048
    procedural spheres. The four band x slice pieces of a pass, launched
    apart, sum to the full pass under the image gate."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import (
        default_matrix_camera, smallpt_camera,
    )
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, cornell_box_small_light_scene,
        procedural_sphere_scene, two_sphere_scene,
    )
    from smallpt_tpu_torch.ops import megakernel as mk

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    legacy, matrix = smallpt_camera(), default_matrix_camera()
    cases = {
        "lens_32x24": (cornell_box_scene(), legacy, RenderConfig(
            width=32, height=24, spp_per_cell=2, max_depth=12, aperture=4.0,
            focal_distance=120.0, **leg), 13),
        "env_32x32": (two_sphere_scene(), matrix, RenderConfig(
            width=32, height=32, spp_per_cell=1, max_depth=12,
            env_emission=(0.2, 0.3, 0.4), camera_model=CameraModel.MATRIX,
            filter=Filter.BOX), 3),
        "nee_8_3_32x24": (cornell_box_small_light_scene(), legacy,
                          RenderConfig(width=32, height=24, spp_per_cell=1,
                                       max_depth=16, nee_lights=(8, 3),
                                       **leg), 5),
        "procedural2048_64x48": (procedural_sphere_scene(2048), legacy,
                                 RenderConfig(width=64, height=48,
                                              spp_per_cell=1, max_depth=12,
                                              **leg), 4),
    }
    launches = ((4, 16), (None, 16), (None, 10_000_000))
    out = {}
    for name, (scene, cam, cfg, seed) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        key, ns = rng.base_key(seed), scene.n_spheres
        out[name] = {
            "per_pass": pass_vs_plain(name, table, camv, cfg, key, ns),
            "streaming": stream_chain(table, camv, cfg, key, ns, launches)}

    # row bands x sample slices: each piece against the plain version, their
    # sum against the full pass; a streaming band with a sample offset
    cfg = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       **leg)
    scene = cornell_box_scene()
    table = mk.build_scene_table(scene, cfg, dev)
    camv = mk.build_camera_vec(legacy, cfg, dev)
    key, ns = rng.base_key(9), scene.n_spheres
    full, rays_full = mk.mega_pass(table, camv, cfg, key, n_spheres=ns)
    summed = torch.zeros_like(full).view(cfg.height, cfg.width, 3)
    pieces, rays_sum = {}, 0
    for row_offset in (0, 24):
        for ip_offset in (0, 2):
            band = dict(ip_offset=ip_offset, row_offset=row_offset,
                        n_rows=24, k_samples=2)
            name = f"rows{row_offset}+24_ip{ip_offset}+2"
            pieces[name] = pass_vs_plain(name, table, camv, cfg, key, ns,
                                         **band)
            rad, rays = mk.mega_pass(table, camv, cfg, key, n_spheres=ns,
                                     **band)
            summed[row_offset:row_offset + 24] += rad.view(24, cfg.width, 3)
            rays_sum += int(rays.sum())
    torch.cuda.synchronize()
    sum_gate = gate(summed.cpu().numpy(),
                    full.view(cfg.height, cfg.width, 3).cpu().numpy(),
                    MAX_FRAC, KP_MEAN)
    if rays_sum != int(rays_full.sum()):
        raise AssertionError(f"band/slice rays {rays_sum} vs "
                             f"{int(rays_full.sum())}")
    out["band_slice_64x48"] = {
        "pieces": pieces, "sum_vs_full": sum_gate, "rays": rays_sum,
        "streaming_rows24+24_ip2": stream_chain(
            table, camv, cfg, key, ns, launches, ip_offset=2, row_offset=24,
            n_rows=24)}
    return out


def big_classic_phases(dev) -> dict:
    """The classic route above 2048 spheres (ROADMAP F1), kernel against
    plain version with two NEE lights (8, 3), per pass and streaming (two
    partial launches and a drain): 4096 spheres sweep from shared memory
    that the launcher opts in to (80 KB), 16384 spheres sweep from global
    memory (the columns would need 320 KB)."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import megakernel as mk

    cfg = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       nee_lights=(8, 3), camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
    out = {}
    for n in (4096, 16384):
        scene = procedural_sphere_scene(n)
        table = mk.build_scene_table(scene, cfg, dev)
        key = rng.base_key(n)
        name = f"procedural{n}_64x48_nee_8_3"
        out[name] = {
            "sweep_columns": ("shared memory, opted in" if 20 * n <= 232448
                              else "global memory"),
            "per_pass": pass_vs_plain(name, table, camv, cfg, key,
                                      scene.n_spheres),
            "streaming": stream_chain(table, camv, cfg, key, scene.n_spheres,
                                      ((4, 16), (None, 16),
                                       (None, 10_000_000)))}
    return out


def k1_queue(name, queue, n_lanes: int, worked: int) -> dict:
    """A K1a or K1c launch's queue (mk.QUEUE_FIELDS): the lanes handed
    out, which must be every lane once (n_lanes), and the lanes that had
    work, which must be the launch's (worked)."""
    from smallpt_tpu_torch.ops import megakernel as mk

    q = dict(zip(mk.QUEUE_FIELDS, (int(x) for x in queue.tolist())))
    if q["handed"] != n_lanes or q["worked"] != worked:
        raise AssertionError(f"{name}: K1's queue handed out {q['handed']} "
                             f"of {n_lanes} lanes, {q['worked']} with work "
                             f"of {worked}")
    return q


def k1_working_lanes(i) -> int:
    """The lanes of a streaming state (i its i32 planes) that a K1c launch
    works on: alive, or with a sample of their budget left."""
    from smallpt_tpu_torch.ops import megakernel as mk

    ii = i.reshape(len(mk._I_PLANES), -1)
    alive, s_idx, budget = (ii[mk._I_PLANES.index(k)]
                            for k in ("alive", "s_idx", "budget"))
    return int(((alive != 0) | (s_idx < budget - 1)).sum())


def k1_constructed_launches(dev) -> dict:
    """K1a and K1c against their plain version on launches built to reach
    the edges of their queue, their cap and their sphere test, each held by
    k1_strict (every lane, bit for bit) and its rays exactly, with the
    launch's plan and its queue (every lane handed out once), through the
    uncounted launches mk._pass_launch and mk._stream_launch:
    - one lane (1x1 pixels) and one lane short of a block (127x1), per
      pass (4 samples) and streaming (budget 4; the state's one tile of
      8,192 lanes, the rest idle), with NEE on the light;
    - Cornell at 128x96, budget 4, launches capped at 3 and at 5
      iterations (lanes cut mid-path), then chained to the drain, without
      and with NEE;
    - launches whose lanes are more than three first waves (the main
      path's Cornell at 1024x768), so that threads take lanes from the
      queue: a 4-sample pass, and streaming budget 4 capped at 5 and at 5
      iterations (each thread's count restarting at every lane it takes),
      then drained, without and with NEE;
    - lanes with no budget among working ones (budgets 0-4 drawn from a
      seed, a third of them 0), capped at 6, then drained;
    - a camera whose rays start exactly on the left wall (on_wall_camera),
      per pass and streaming."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.ops import megakernel as mk

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               spp_per_cell=1)
    scene = cornell_box_scene()
    ns = scene.n_spheres
    on_wall = on_wall_camera()
    c128 = RenderConfig(width=128, height=96, max_depth=24, **leg)
    main = RenderConfig(width=1024, height=768, max_depth=48, **leg)
    out = {}

    def refills(name, res, lanes):
        """Record the launch's first wave (a lane a thread); where name
        says the queue must refill, hold it to at least three waves."""
        wave = res["plan"]["threads"]
        res["first_wave"] = wave
        if "refill" in name and lanes < 3 * wave:
            raise AssertionError(f"{name}: {lanes} lanes for a first wave "
                                 f"of {wave}")

    def one_pass(name, cfg, cam, seed):
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        k0, k1 = rng.key_words(rng.base_key(seed))
        rad, rays, queue = mk._pass_launch(table, camv, cfg, k0, k1, 0, 0,
                                           cfg.height, cfg.spp, ns)
        want = mk.render_pass_plain(table, camv, cfg, k0, k1, n_spheres=ns)
        out[name] = dict(
            strict=k1_strict(name, cfg, rad, rays, *want),
            rays=int(rays.sum()), lanes=cfg.n_pixels,
            queue=k1_queue(name, queue, cfg.n_pixels, cfg.n_pixels),
            plan=mk.mega_plan(cfg.n_pixels, ns, len(cfg.nee_lights), "pass"))
        refills(name, out[name], cfg.n_pixels)

    def stream(name, cfg, cam, seed, launches):
        """launches: (budget, n_iters) pairs from a fresh state, each held
        to the plain version's from the same state."""
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        k0, k1 = rng.key_words(rng.base_key(seed))
        f, i = mk.init_stream_state(cfg, device=dev)
        n_cols = f.shape[1]
        lanes = mk._SUB * n_cols
        res = {}
        for n, (budget, n_iters) in enumerate(launches):
            if budget is not None:
                mk.set_sample_budget(i, budget, cfg)
            fp, ip_ = f.clone(), i.clone()
            worked = k1_working_lanes(i)
            rk, queue = mk._stream_launch(table, camv, cfg, k0, k1, f, i,
                                          n_iters, 0, 0, n_cols, ns)
            rp = mk.stream_step_plain(table, camv, cfg, k0, k1, fp, ip_,
                                      n_iters, n_spheres=ns)[2]
            if int(rk) != int(rp):
                raise AssertionError(f"{name} launch {n}: rays {int(rk)} vs "
                                     f"{int(rp)}")
            res[f"launch{n}"] = dict(
                strict=k1_strict(f"{name} launch {n}", cfg, f, i, fp, ip_),
                rays=int(rk), n_iters=n_iters,
                queue=k1_queue(name, queue, lanes, worked),
                pending=mk.stream_pending(i))
        if mk.stream_pending(i) != (0, 0):
            raise AssertionError(f"{name}: the last launch did not drain")
        res["plan"] = mk.mega_plan(lanes, ns, len(cfg.nee_lights), "stream")
        refills(name, res, lanes)
        out[name] = res

    drain = 10_000_000
    for w in (1, 127):
        cfg = c128.replace(width=w, height=1, nee_lights=(8,))
        one_pass(f"pass_lanes{w}_nee", cfg, smallpt_camera(), 1800 + w)
        stream(f"stream_lanes{w}_nee", cfg, smallpt_camera(), 1800 + w,
               ((4, drain),))
    for nee in ((), (8,)):
        tag = "_nee" if nee else ""
        stream(f"capped_3_5{tag}", c128.replace(nee_lights=nee),
               smallpt_camera(), 1810, ((4, 3), (None, 5), (None, drain)))
    one_pass("pass_refill_1024x768", main, smallpt_camera(), 1813)
    for nee in ((), (8,)):
        tag = "_nee" if nee else ""
        stream(f"refill_capped_5_5_1024x768{tag}",
               main.replace(nee_lights=nee), smallpt_camera(), 1813,
               ((4, 5), (None, 5), (None, drain)))
    budgets = np.random.default_rng(1811).integers(0, 5, c128.n_pixels)
    budgets[::3] = 0
    stream("no_budget_among_working", c128, smallpt_camera(), 1811,
           ((budgets, 6), (None, drain)))
    wall = c128.replace(width=64, height=48)
    one_pass("on_wall_pass", wall.replace(spp_per_cell=2), on_wall, 1812)
    stream("on_wall_stream", wall, on_wall, 1812, ((2, 5), (None, drain)))
    # the origins on the wall: their inside guard against r*r
    table = mk.build_scene_table(scene, wall, dev)
    camv = mk.build_camera_vec(on_wall, wall, dev).reshape(-1).cpu()
    out["on_wall_origin"] = [float(x) for x in camv[9:12]]
    out["on_wall_push"] = float(camv[12])
    del table
    torch.cuda.empty_cache()
    return out


def golden_phases(dev) -> dict:
    """The two stored goldens no other phase uses: the thin lens
    (golden_dof_32x24, the 2% gate) and shallow Cornell
    (golden_cornell_shallow_48x36, gate_shallow), per pass on the card."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.renderer import render

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    cornell, legacy = cornell_box_scene(), smallpt_camera()
    dof = RenderConfig(width=32, height=24, spp_per_cell=2, max_depth=12,
                       aperture=4.0, focal_distance=120.0, **leg)
    img = render(cornell, legacy, dof, rng.base_key(13), device=dev)
    out = {"dof_32x24": gate(img.cpu().numpy(),
                             np.load(GOLDEN_DOF)["image"], 0.02)}
    shallow = RenderConfig(width=48, height=36, spp_per_cell=4, max_depth=4,
                           **leg)
    img = render(cornell, legacy, shallow, rng.base_key(17), device=dev)
    out["cornell_shallow_48x36"] = gate_shallow(
        img.cpu().numpy(), np.load(GOLDEN_SHALLOW)["image"])
    return out


def k3_vs_plain_phases(dev) -> dict:
    """The DDA kernel against its plain version, each a chain of two
    partial launches and a drain: procedural_sphere_scene(300) at 64x48
    (grid of occ_target 16, as the JAX suite builds it) and (10000) at
    128x96 (the default grid), each without and with NEE on the light
    (sphere 8), and the overflow tables nb=(2,2,2), k_max=32."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    s300, s10k = procedural_sphere_scene(300), procedural_sphere_scene(10000)
    c64 = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=12,
                       **leg)
    c128 = c64.replace(width=128, height=96, max_depth=24)
    cases = {
        "procedural300_64x48": (s300, c64, dict(occ_target=16.0), 0),
        "procedural300_64x48_nee": (s300, c64.replace(nee_lights=(8,)),
                                    dict(occ_target=16.0), 1),
        "procedural10000_128x96": (s10k, c128, {}, 2),
        "procedural10000_128x96_nee": (s10k, c128.replace(nee_lights=(8,)),
                                       {}, 3),
        "overflow_nb222_k32_64x48": (s300, c64,
                                     dict(nb=(2, 2, 2), k_max=32), 4),
    }
    launches = ((3, 60), (None, 60), (None, 10_000_000))
    out = {}
    for name, (scene, cfg, build, seed) in cases.items():
        tables = sd.build_stream_dda_tables(scene, cfg, device=dev, **build)
        camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
        out[name] = {"grid": {"nb": tables.nb, "k": tables.k,
                              "n_always": tables.n_always,
                              "n_overflow": tables.n_overflow},
                     **dda_chain(tables, camv, cfg, rng.base_key(seed),
                                 launches),
                     "queue_launch": k3_queue_launch(
                         tables, camv, cfg, rng.base_key(seed),
                         *launches[0])[3]}
    return out


def k1_bound(counts: dict, n_rays: int, n_spheres: int, nbytes: int) -> dict:
    """The least time of one K1a or K1c launch for the work the plain
    version counted on the same inputs (counts: the shadow rays and each
    sweep's sphere tests by class; n_rays the launch's rays): its
    operations at the float rate, each test at its class's price
    (OPS_K1_*), each ray's bounce at OPS_PER_BOUNCE and each shadow ray's
    cone sample and light test at OPS_PER_CONE + OPS_PER_SPHERE; nbytes
    at the memory rate. Beside it the count before K1's own test: every
    ray and shadow ray at the whole test on every sphere
    (``bound_ms_every_test_full``, and its no-FMA time)."""
    from smallpt_tpu_torch.ops import megakernel as mk

    shadow = counts.get("shadow_rays", 0)
    price = dict(miss=OPS_K1_MISS, inside=OPS_K1_INSIDE, full=OPS_PER_SPHERE)
    tests = {f"{p}pairs_{c}": counts.get(f"{p}pairs_{c}", 0)
             for p in ("", "shadow_") for c in mk.PAIR_CLASSES}
    ops = (n_rays * OPS_PER_BOUNCE + shadow * (OPS_PER_CONE + OPS_PER_SPHERE)
           + sum(price[k.rsplit("_", 1)[1]] * v for k, v in tests.items()))
    full_ops = (n_rays * (OPS_PER_SPHERE * n_spheres + OPS_PER_BOUNCE)
                + shadow * (OPS_PER_SPHERE * n_spheres + OPS_PER_CONE))
    full = _bound(full_ops, nbytes)
    return _bound(ops, nbytes, rays=n_rays, shadow_rays=shadow, **tests,
                  ops_every_test_full=full_ops,
                  bound_ms_every_test_full=full["bound_ms"],
                  bound_nofma_ms_every_test_full=full["bound_nofma_ms"])


def k3_bound(counts: dict, n_lanes: int, nf: int, tables) -> dict:
    """The least time of one DDA launch for the work that the plain version
    counted on the same inputs (counts: its sphere tests in cells and of
    the always table and those of them past det, walk steps, inits, shadow
    rays; the kernel's lanes do the same work): its operations at the
    float rate, each sphere test priced at what K3's early-miss test
    (csrc/lane.cuh::early_stable_tt) spends up to its decision,
    OPS_K2_STABLE_MISS for a miss at det and OPS_K2_STABLE_HIT for a test
    past det; its bytes (the tables the kernel reads, its slots' geometry
    and counts, the ids, the always and scene tables, and the state read
    once, the state written once) at the memory rate. Beside it the same
    with every test at the whole test's OPS_PER_SPHERE
    (``bound_ms_every_slot_full``, the count the kernel before the early
    miss was held to), and the bytes of the cell slots its walk steps read
    from L1 and L2: 16 B a tested slot (``slot_bytes``), 32 B as the cell
    table holds them (``slot_bytes_cells``)."""
    slot_tests, slot_past, always_tests, always_past, walk_steps, inits, \
        shadow = (counts[k] for k in (
            "slot_tests", "slot_tests_det_ge0", "always_tests",
            "always_tests_det_ge0", "walk_steps", "inits", "shadow_rays"))
    rays = inits - shadow
    tests, past = slot_tests + always_tests, slot_past + always_past
    rest = (walk_steps * OPS_PER_STEP + inits * OPS_PER_INIT
            + rays * OPS_PER_BOUNCE + shadow * OPS_PER_CONE)
    ops = ((tests - past) * OPS_K2_STABLE_MISS + past * OPS_K2_STABLE_HIT
           + rest)
    full_ops = tests * OPS_PER_SPHERE + rest
    n_cells, k = tables.cells.shape[:2]
    nbytes = (tables.slot_geom.numel() * 4 + tables.slot_count.numel() * 4
              + n_cells * k * 4
              + 4 * (tables.always_tbl.numel() + tables.scene_tbl.numel()
                     + 16)
              + n_lanes * 4 * (nf + 9) * 2)
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    full_ms = max(full_ops / PEAK_FP32_OPS * 1e3, bytes_ms)
    return dict(slot_tests=slot_tests, slot_tests_det_ge0=slot_past,
                always_tests=always_tests, always_tests_det_ge0=always_past,
                walk_steps=walk_steps, inits=inits, shadow_rays=shadow,
                ops=ops, ops_every_slot_full=full_ops, bytes=nbytes,
                bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms,
                bound_nofma_ms=ops / PEAK_FP32_NOFMA * 1e3,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                bound_ms_every_slot_full=full_ms,
                slot_bytes=16 * slot_tests,
                slot_bytes_ms=16 * slot_tests / PEAK_BYTES * 1e3,
                slot_bytes_cells=32 * slot_tests)


def k3_launch_info(tables, n_lanes: int, queue=None) -> dict:
    """K3's launch of n_lanes lanes over the tables: its plan
    (stream_dda.dda_plan: the blocks, the threads of its first wave, the
    blocks an SM holds, the shared memory a block), ptxas's registers,
    stack and spills, and, from a launch's queue (stream_dda._launch), the
    lanes handed out, which must be every lane once, and the lanes that
    had work."""
    from smallpt_tpu_torch.ops import stream_dda as sd

    out = dict(plan=sd.dda_plan(n_lanes, tables.n_always,
                                bool(tables.light_rows)),
               ptxas=ptxas_entry(sd.LIBRARY[0]))
    if queue is not None:
        q = dict(zip(sd.QUEUE_FIELDS, (int(x) for x in queue.tolist())))
        if q["handed"] != n_lanes:
            raise AssertionError(f"K3's queue handed out {q['handed']} of "
                                 f"{n_lanes} lanes")
        out["queue"] = q
    return out


def k3_queue_launch(tables, camv, cfg, key, budget: int, n_iters: int):
    """One uncounted K3 launch (stream_dda._launch) from a fresh state of
    the given budget: (f, i, rays, k3_launch_info with its queue)."""
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    f, i = sd.init_stream_dda_state(cfg, device=tables.device)
    mk.set_sample_budget(i, budget, cfg)
    rays, queue = sd._launch(tables, camv, cfg, key, f, i, n_iters)
    return f, i, rays, k3_launch_info(tables, f.shape[1] * mk._SUB, queue)


def k3_main(name, cfg, dev, n_rounds=3) -> dict:
    """The DDA main path (bench.py --procedural, seed 1000):
    StreamingRenderer auto-routes procedural_sphere_scene(10000) to the DDA
    kernel; each round is reset, step(spp * max_depth + 16, spp), flush,
    timed with CUDA events, after a warm-up round. The launch counts are
    zeroed before the rounds and read after. Weights equal the budget at
    every pixel; the image is held to the classic route's on the same scene
    and seed (the image gate, weights equal). Then the kernel alone, one
    key, one launch that drains a budget of 4: its time, and the plain
    version's time, state and counted work (the kernel's bound) on the same
    inputs."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    spp = cfg.spp
    scene = procedural_sphere_scene(10000)
    r = StreamingRenderer(scene, smallpt_camera(), cfg, seed=1000,
                          device=dev)
    if r._dda is None:
        raise AssertionError(f"{name}: not routed to the DDA kernel")

    def round_(renderer):
        renderer.reset()
        renderer.step(n_iters=spp * cfg.max_depth + 16, add_samples=spp)
        renderer.flush()

    round_(r)
    torch.cuda.synchronize()
    mk.mega_pass.launches = mk.stream_step.launches = 0
    sd.stream_step_dda.launches = 0
    rays0 = r.stats.rays
    round_ms = [cuda_ms(lambda: round_(r), 1)[0] for _ in range(n_rounds)]
    launches = sd.stream_step_dda.launches
    if not launches or mk.stream_step.launches or mk.mega_pass.launches:
        raise AssertionError(f"{name}: launches dda {launches}, classic "
                             f"{mk.stream_step.launches}")
    rays = (r.stats.rays - rays0) // n_rounds
    rad, w = r.accumulators()
    if not bool((w == spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    # the classic route on the same scene and seed
    c = StreamingRenderer(scene, smallpt_camera(), cfg, seed=1000, dda=False,
                          device=dev)
    classic_ms = cuda_ms(lambda: round_(c), 1)[0]
    crad, cw = c.accumulators()
    if not bool((cw == w).all()):
        raise AssertionError(f"{name}: classic weights differ")
    vs_classic = gate(rad.cpu().numpy(), crad.cpu().numpy(), MAX_FRAC)
    ms = float(np.mean(round_ms))
    main = dict(width=cfg.width, height=cfg.height, spp=spp,
                max_depth=cfg.max_depth, nee=list(cfg.nee_lights),
                grid={"nb": r._dda.nb, "k": r._dda.k,
                      "n_always": r._dda.n_always,
                      "n_overflow": r._dda.n_overflow},
                rounds=n_rounds, launches=launches, round_ms=round_ms,
                ms_per_round=ms, rays=rays, mrays_per_s=rays / ms / 1e3,
                classic_round_ms=classic_ms,
                classic_rays=c.stats.rays, vs_classic=vs_classic,
                mean=float(img.mean()), profile=profile(lambda: round_(r)))

    # the kernel alone against its plain version, one key, budget 4
    tables, camv = r._dda, r._cam
    key = rng.fold_in(rng.base_key(0), 1000)
    k0, k1 = rng.key_words(key)
    f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
    mk.set_sample_budget(i0, 4, cfg)
    f, i = f0.clone(), i0.clone()
    k_ms, rk = cuda_ms(lambda: sd.stream_step_dda(
        tables, camv, cfg, key, f, i, None, 10_000_000)[2], 6,
        setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)
    fp, ip = f0.clone(), i0.clone()
    counts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, rp = sd.stream_step_dda_plain(tables, camv, cfg, k0, k1, fp, ip,
                                        10_000_000, counts=counts)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp = state_gate(name, cfg, f, i, fp, ip, drained=True)
    cmp["strict"] = k3_strict(name, cfg, f, i, fp, ip)
    n_rays = int(rk)
    rays_close(name, n_rays, int(rp))
    fq, iq, rq, info = k3_queue_launch(tables, camv, cfg, key, 4,
                                       10_000_000)
    if not (torch.equal(fq, f) and torch.equal(iq, i)
            and int(rq) == n_rays):
        raise AssertionError(f"{name}: the queue's launch differs")
    kernel = dict(kernel_ms=k_ms, rays=n_rays,
                  mrays_per_s=n_rays / k_ms / 1e3, plain_ms=plain_ms,
                  plain_counts=counts,
                  **k3_bound(counts, f0.shape[1] * 8, sd._nf_d(cfg),
                             tables),
                  vs_plain=cmp, **info)
    return {"main": main, "kernel": kernel}


def k3_hd(dev) -> dict:
    """The config-5 shape through the DDA main path (bench.py
    --procedural-hd): procedural_sphere_scene(10000) at 1920x1080, 24 spp,
    max_depth 24, seed 1000, launches capped at 16 bounce iterations; one
    round timed with CUDA events. Weights equal 24 at every pixel and the
    image is finite. Then the round's launches, chained from a fresh state
    with the round's key through the kernel and through the plain version
    (dda_chain: the states gated after the first three launches, the
    middle one and the last, which drains; the rays after each), the
    kernel's chain ending in the round's state bit for bit. Then the
    round's work in one uncapped launch that drains it: its time and, from
    the work the plain chain counted, its bound."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    cfg = RenderConfig(width=1920, height=1080, spp_per_cell=6, max_depth=24,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    r = StreamingRenderer(procedural_sphere_scene(10000), smallpt_camera(),
                          cfg, seed=1000, device=dev)
    r.max_launch_iters = 16
    mk.mega_pass.launches = mk.stream_step.launches = 0
    sd.stream_step_dda.launches = 0

    def round_():
        r.step(n_iters=cfg.spp * cfg.max_depth + 16, add_samples=cfg.spp)
        r.flush()

    torch.cuda.synchronize()
    ms = cuda_ms(round_, 1)[0]
    launches = sd.stream_step_dda.launches
    if r._dda is None or not launches or mk.stream_step.launches:
        raise AssertionError("config-5 shape: not run through the DDA "
                             "kernel")
    _, w = r.accumulators()
    if not bool((w == cfg.spp).all()):
        raise AssertionError(f"config-5 shape: weights {float(w.min())}.."
                             f"{float(w.max())}, want {cfg.spp}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"config-5 shape: image {img.shape} not finite")

    # every launch of the round has the capped iterations; the first one
    # raises the budget
    it = r.max_launch_iters * r._DDA_ITER_SCALE
    round_launches = ((cfg.spp, it),) + ((None, it),) * (launches - 1)
    f, i = sd.init_stream_dda_state(cfg, device=dev)
    counts = {}
    t = time.perf_counter()
    vs_plain = dda_chain(r._dda, r._cam, cfg, r.key, round_launches,
                         state=(f, i), counts=counts,
                         gate_at={0, 1, 2, launches // 2})
    chain_s = time.perf_counter() - t
    if not (torch.equal(f, r.f) and torch.equal(i, r.i)):
        raise AssertionError("config-5 shape: the kernel's chain does not "
                             "end in the round's state")
    rays = counts["inits"] - counts["shadow_rays"]
    if rays != r.stats.rays:
        raise AssertionError(f"config-5 shape: the plain chain traced {rays} "
                             f"rays, the round {r.stats.rays}")

    f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
    mk.set_sample_budget(i0, cfg.spp, cfg)
    f.copy_(f0)
    i.copy_(i0)
    k_ms, rk = cuda_ms(lambda: sd.stream_step_dda(
        r._dda, r._cam, cfg, r.key, f, i, None, 10_000_000)[2], 3,
        setup=lambda: (f.copy_(f0), i.copy_(i0)), skip_first=True)
    rk = int(rk)
    if rk != r.stats.rays:
        raise AssertionError(f"config-5 shape: one launch traced {rk} rays, "
                             f"the round {r.stats.rays}")
    fq, iq, rq, info = k3_queue_launch(r._dda, r._cam, cfg, r.key, cfg.spp,
                                       10_000_000)
    if not (torch.equal(fq, f) and torch.equal(iq, i) and int(rq) == rk):
        raise AssertionError("config-5 shape: the queue's launch differs")
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                launch_iters=16,
                launches=launches, round_ms=ms, rays=r.stats.rays,
                mrays_per_s=r.stats.rays / ms / 1e3,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                mean=float(img.mean()),
                vs_plain=dict(chain_seconds=chain_s, plain_counts=counts,
                              **vs_plain),
                kernel=dict(kernel_ms=k_ms, rays=rk,
                            mrays_per_s=rk / k_ms / 1e3,
                            **k3_bound(counts, f0.shape[1] * 8,
                                       sd._nf_d(cfg), r._dda), **info))


def k3_constructed_launches(dev) -> dict:
    """K3 against its plain version on launches built to reach the edges
    of its queue, its cap and its tables, each from a fresh state through
    stream_dda._launch (uncounted), held by k3_strict (every plane bit for
    bit) and its rays exactly, with the launch's plan, queue and time
    (hold_card before each call):
    - 77 lanes (11 x 7 pixels; the state's one 8,192-lane tile), 10,000
      spheres, budget 2, drained;
    - a launch whose every lane is idle (budget 0): no ray, no lane with
      work, the state unchanged;
    - 10,000 spheres at 128x96, budget 4, capped at 1 iteration and at 7
      (the lanes stop mid-walk), and at 7 with NEE on sphere 8;
    - the overflow tables (procedural_sphere_scene(300), nb=(2, 2, 2),
      k_max=32) at 64x48, budget 3, drained;
    - 10,000 spheres at 1280x720, budget 1, capped at 24 iterations: its
      lanes at least 3x the threads of the queue's first wave."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               spp_per_cell=1)
    s10k, s300 = procedural_sphere_scene(10000), procedural_sphere_scene(300)
    c128 = RenderConfig(width=128, height=96, max_depth=24, **leg)
    cases = {
        "lanes77": (s10k, c128.replace(width=11, height=7), {}, 2,
                    10_000_000),
        "all_idle": (s10k, c128, {}, 0, 10_000_000),
        "capped_1": (s10k, c128, {}, 4, 1),
        "capped_7": (s10k, c128, {}, 4, 7),
        "capped_7_nee": (s10k, c128.replace(nee_lights=(8,)), {}, 4, 7),
        "overflow_nb222_k32": (s300, c128.replace(width=64, height=48,
                                                  max_depth=12),
                               dict(nb=(2, 2, 2), k_max=32), 3, 10_000_000),
        "queue_3x_1280x720": (s10k, c128.replace(width=1280, height=720),
                              {}, 1, 24),
    }
    out = {}
    for n, (name, (scene, cfg, build, budget, n_iters)) in enumerate(
            cases.items()):
        tables = sd.build_stream_dda_tables(scene, cfg, device=dev, **build)
        camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
        key = rng.base_key(1700 + n)
        fk, ik, rk, info = k3_queue_launch(tables, camv, cfg, key, budget,
                                           n_iters)
        f0, i0 = sd.init_stream_dda_state(cfg, device=dev)
        mk.set_sample_budget(i0, budget, cfg)
        fp, ip_ = f0.clone(), i0.clone()
        rp = sd.stream_step_dda_plain(tables, camv, cfg, *rng.key_words(key),
                                      fp, ip_, n_iters)[2]
        st = k3_strict(name, cfg, fk, ik, fp, ip_)
        if int(rk) != int(rp):
            raise AssertionError(f"{name}: rays {int(rk)} vs {int(rp)}")
        q, lanes = info["queue"], info["plan"]["threads"]
        if name == "all_idle" and (int(rk) or q["worked"] or not (
                torch.equal(fk, f0) and torch.equal(ik, i0))):
            raise AssertionError(f"{name}: an idle launch did work: {q}")
        if name.startswith("queue_3x") and q["handed"] < 3 * lanes:
            raise AssertionError(f"{name}: {q['handed']} lanes for {lanes} "
                                 "threads")
        f, i = fk.clone(), ik.clone()
        ms, _ = cuda_ms(lambda: sd._launch(tables, camv, cfg, key, f, i,
                                           n_iters), 3,
                        setup=lambda: (f.copy_(f0), i.copy_(i0),
                                       hold_card()))
        out[name] = dict(strict=st, rays=int(rk), budget=budget,
                         n_iters=n_iters, kernel_ms=ms,
                         width=cfg.width, height=cfg.height,
                         lanes_per_thread=q["handed"] / lanes,
                         max_abs_err=0.0, **info)
        del tables
        torch.cuda.empty_cache()
    return out


# float ops of one (ray, row) test of the closest-hit kernels, counted from
# csrc/lane.cuh and csrc/tri.cuh (a square root or a division counts as
# one op): the whole stable form (sphere_tt) 37 and the fold's compare 1;
# the whole direct quadratic (sphere_tt_fast) 25 and the compare; the whole
# triangle test (iq's formulation, the bounds and the fold, tri_candidate)
# 49, as K7 and K6 run it on every pair they sweep; a skipped row (radius
# 0, or a padding triangle) its one compare. K4 and K5 are priced at these,
# K2 at the OPS_K2_* counts of its early-miss tests below.
OPS_K2_STABLE = 38
OPS_K2_FAST = 26
OPS_K6_ROW = 49
OPS_ROW_SKIP = 1
# K2's bound prices each pair at what its early-miss tests
# (csrc/lane.cuh: early_stable_tt, early_direct_tt, on the live rows it
# stages) spend up to their decision (K3's bound prices its slot and always
# tests at the stable form's two counts: it calls the same early_stable_tt):
# the stable form to det (23) and det >= 0 (24) for a miss, which skips
# the fold; the rest of the test (2 for s, 3 for |op|, 3 for cc, denom,
# its sign, the division, the two root tests) and the fold's compare for a
# det >= 0 pair (38); the direct quadratic to
# det with r * r staged once a row (16) and the compare (17) for a miss;
# s, the two roots, their tests and the fold (24) for a det >= 0 pair. A
# row left out as the table is staged (r not > 0) costs no op a pair.
OPS_K2_STABLE_MISS, OPS_K2_STABLE_HIT = 24, 38
OPS_K2_DIRECT_MISS, OPS_K2_DIRECT_HIT = 17, 24
# K6's bound prices each pair at the ops a test that decides it on dn and
# t first needs (tests/test_torch_tri_split.py emulates one): rov0 (3), dn
# (5) and dn == 0 (1): 9 where dn is 0; then 1 / dn, t (7) and eps < t <
# bt (2): 19 where t drops it; then q (9), u (7), v (6) and the bounds
# with u + v (5): 46 for the whole test. csrc/closest_tri.cu runs the
# whole test on every pair it sweeps (such a test lost on bounce rays,
# PERF.md); a row it leaves out as it stages the table (padding, n = 0)
# costs no op a pair.
OPS_K6_DN, OPS_K6_T, OPS_K6_FULL = 9, 19, 46
# One box test of K7 (csrc/closest_tri_culled.cu::box_keep; its plain form
# ops/mesh_pallas.py::box_test): c - o (3), the sum of their absolute
# values (2; an absolute value is an operand's modifier), times kBoxRel
# plus w0 (2), h + w (3) and its copysign (3), the slab ends (6
# subtractions or additions, 6 products), their max and min (4) and the
# three compares that drop a chunk (3). K7's cone test (sweep_cones;
# ops/mesh_pallas.py::cone_test): d . a (3 products, 2 sums), s times |d|
# (1) and the compare (1); |d| once a ray (3 products, 2 sums, the root).
OPS_K7_BOX = 32
OPS_K7_CONE = 7
OPS_K7_LEN = 6


def k2_pairs(org, dirs, table, n_a: int, n_b: int) -> dict:
    """The (ray, row) pairs of one K2 launch by where its early-miss tests
    decide them, counted by a plain sweep of the launch's own rays ((3, N)
    planes) over the live rows (r > 0) of [0, n_a + n_b), each in its form
    and op for op as far as det: "stable_miss", "stable_hit" (det >= 0 in
    the stable form), "direct_miss", "direct_hit"; "warp_rows" and
    "warp_rows_tail", the (32 consecutive rays, row) pairs and those where
    some ray goes on past det (a kernel warp's rays of one slot of its
    threads); "live_a", "live_b" and "left_out", the rows the kernel
    stages in each part and leaves out."""
    import torch

    rows = table[:n_a + n_b]
    live = torch.nonzero(rows[:, 3] > 0.0)[:, 0]
    n = org.shape[1]
    lane = [x[:, None] for x in (*org, *dirs)]
    ox, oy, oz, dx, dy, dz = lane
    pad = (-n) % 32
    out = dict(stable_miss=0, stable_hit=0, direct_miss=0, direct_hit=0,
               warp_rows=0, warp_rows_tail=0,
               live_a=int((live < n_a).sum()), live_b=int((live >= n_a).sum()),
               left_out=n_a + n_b - live.numel())
    per = max(1, (1 << 24) // max(n, 1))
    for form, ids in (("stable", live[live < n_a]),
                      ("direct", live[live >= n_a])):
        for lo in range(0, ids.numel(), per):
            c = rows.index_select(0, ids[lo:lo + per])
            cx, cy, cz, r = (c[:, k][None, :] for k in range(4))
            opx = cx - ox
            opy = cy - oy
            opz = cz - oz
            b = opx * dx + opy * dy + opz * dz
            if form == "stable":
                fx = opx - b * dx
                fy = opy - b * dy
                fz = opz - b * dz
                sp = torch.sqrt(fx * fx + fy * fy + fz * fz)
                det = (r - sp) * (r + sp)
            else:
                det = b * b - (opx * opx + opy * opy + opz * opz) + r * r
            go = det >= 0.0
            hits = int(go.sum())
            out[f"{form}_hit"] += hits
            out[f"{form}_miss"] += go.numel() - hits
            if pad:
                go = torch.cat([go, go.new_zeros((pad, go.shape[1]))])
            warp = go.view(-1, 32, go.shape[1]).any(dim=1)
            out["warp_rows"] += warp.numel()
            out["warp_rows_tail"] += int(warp.sum())
    return out


def k2_plan(org, dirs, table, n_a: int, n_b: int, forced: int = 0) -> dict:
    """The plan K2's launcher makes of a launch on these arguments
    (csrc/closest_hit.cu::smallpt_closest_hit_plan, on the card; forced >
    0: with its rows forced into that many ranges), with its scratch in
    MB."""
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    n, rows = org.shape[1], n_a + n_b
    plan = (ip.read_plan(ip._kernel_lib()[1], table.device, n, rows, forced)
            if forced else ip.closest_hit_plan(n, rows, table.device))
    return dict(plan, scratch_mb=plan["scratch_words"] * 4 / 1e6)


# K4's grids of a scene, built once a (scene, occ_target) for k2_walk
_WALK_GRIDS: dict = {}


def k2_walk(org, dirs, scene) -> dict | None:
    """The ops a grid walk spends on the same rays ((3, N) planes) over the
    same spheres: K4's walk (ops/dda.py), whose plain version counts its
    work, on the scene's grid at each of DDA_OCC (k_max 128), the least of
    them. Each sphere test is priced at its early miss's ops, the least a
    test costs (OPS_K2_STABLE_MISS a part-A row, OPS_K2_DIRECT_MISS a
    tested slot or overflow row), each cell at OPS_PER_STEP and each ray's
    clip at OPS_PER_INIT. None where the scene takes no grid (no small
    sphere)."""
    from smallpt_tpu_torch.ops import dda

    best = None
    for occ in DDA_OCC:
        key = (id(scene), occ, str(org.device))
        if key not in _WALK_GRIDS:
            try:
                grid = dda.build_dda_grid(scene, occ_target=occ, k_max=128,
                                          device=org.device)
            except ValueError:
                return None
            _WALK_GRIDS[key] = (scene, grid)
        cnt = {}
        dda.closest_hit_dda_plain(org, dirs, _WALK_GRIDS[key][1], counts=cnt)
        ops = (cnt["part_a_tests"] * OPS_K2_STABLE_MISS
               + (cnt["overflow_tests"] + cnt["slot_tests"])
               * OPS_K2_DIRECT_MISS
               + cnt["walk_steps"] * OPS_PER_STEP
               + org.shape[1] * OPS_PER_INIT)
        if best is None or ops < best["ops"]:
            best = dict(ops=ops, occ=occ, counts=cnt)
    return best


def k2_bound(org, dirs, table, n_a: int, n_b: int, scene=None) -> dict:
    """The least time of one K2 launch on closest_hit's arguments: 24 B of
    ray in and 8 B out a ray and the table's 32-B rows once, at the memory
    rate, or the float work the function needs, whichever is longer. That
    work is the lesser of two algorithms' counts:
    - this kernel's staged sweep (``bound_ms_staged_sweep``): each (ray,
      live row) pair at the ops the early-miss tests spend up to their
      decision (k2_pairs: OPS_K2_STABLE_MISS / _HIT, OPS_K2_DIRECT_MISS /
      _HIT; none for a row left out);
    - a grid walk over the scene's spheres (k2_walk: ``bound_ms_grid_walk``),
      counted where the sweep's ops outlast the bytes and scene (the
      scene the table was built from) is given: on a few spheres the
      sweep is no more work than a walk, and the bytes bound it anyway.
    ``bound_algorithm`` names the one taken. Beside them, the bound of the
    whole test on every row, as K2 was held to before its early miss
    (``bound_ms_every_pair_full``): OPS_K2_STABLE a live part-A row,
    OPS_K2_FAST a live part-B row, a compare a dead row, for every ray."""
    n_rays = org.shape[1]
    pairs = k2_pairs(org, dirs, table, n_a, n_b)
    ops = (OPS_K2_STABLE_MISS * pairs["stable_miss"]
           + OPS_K2_STABLE_HIT * pairs["stable_hit"]
           + OPS_K2_DIRECT_MISS * pairs["direct_miss"]
           + OPS_K2_DIRECT_HIT * pairs["direct_hit"])
    nbytes = n_rays * (24 + 8) + (n_a + n_b) * 32
    full = _bound(n_rays * (OPS_K2_STABLE * pairs["live_a"]
                            + OPS_K2_FAST * pairs["live_b"]
                            + OPS_ROW_SKIP * pairs["left_out"]), nbytes)
    sweep = _bound(ops, nbytes)
    info = dict(pairs=pairs, bound_ms_staged_sweep=sweep["bound_ms"],
                bound_ms_every_pair_full=full["bound_ms"],
                bound_by_every_pair_full=full["bound_by"])
    algorithm = "staged sweep"
    if scene is not None and sweep["bound_ops_ms"] > sweep["bound_bytes_ms"]:
        walk = k2_walk(org, dirs, scene)
        if walk is not None:
            info.update(walk=walk, bound_ms_grid_walk=_bound(
                walk["ops"], nbytes)["bound_ms"])
            if walk["ops"] < ops:
                ops, algorithm = walk["ops"], "grid walk"
    return _bound(ops, nbytes, bound_algorithm=algorithm, **info)


def k6_pairs(org, dirs, table, n_rows=None, eps: float = 0.0) -> dict:
    """The (ray, row) pairs of one K6 launch by where a test that decides
    dn and t first decides them, counted by a plain fold of the launch's
    own rays over the rows in row order with the running best kept row by
    row (the sweep uncut): "dn" (dn == 0), "t" (t outside (eps, bt)),
    "full" (the whole test), over the live rows ("live": valid, n not 0);
    "left_out", the rows the kernel leaves out as it stages them."""
    import torch

    from smallpt_tpu_torch.ops import mesh_pallas as mp

    rows = table[:table.shape[0] if n_rows is None else n_rows]
    live = (rows[:, 12] > 0.5) & (rows[:, 9:12] != 0.0).any(dim=1)
    r = rows[live]
    lane = [x[:, None] for x in (*org, *dirs)]
    dx, dy, dz = lane[3:]
    bt = torch.full((org.shape[1], 1), 3.0e38, device=org.device)
    out = dict(dn=0, t=0, full=0, live=int(live.sum()),
               left_out=int((~live).sum()))
    for lo in range(0, r.shape[0], 128):
        cols = [r[lo:lo + 128, k][None, :] for k in range(13)]
        hit, t, _, _ = mp._tri_test(lane, cols, eps)
        dn = dx * cols[9] + dy * cols[10] + dz * cols[11]
        cand = torch.where(hit, t, 3.0e38)
        run = torch.cummin(cand, dim=1).values
        best = torch.minimum(bt, torch.cat([bt, run[:, :-1]], dim=1))
        at_dn = dn == 0.0
        at_t = ~at_dn & ~((eps < t) & (t < best))
        out["dn"] += int(at_dn.sum())
        out["t"] += int(at_t.sum())
        out["full"] += int((~at_dn & ~at_t).sum())
        bt = torch.minimum(bt, run[:, -1:])
    return out


def k6_plan(org, dirs, table, n_rows=None, eps: float = 0.0) -> dict:
    """The plan K6's launcher makes of a launch on these arguments
    (csrc/closest_tri.cu::smallpt_closest_tri_plan, on the card), with its
    scratch in MB."""
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    plan = mp.closest_tri_plan(
        org.shape[1], table.shape[0] if n_rows is None else n_rows,
        table.device)
    return dict(plan, scratch_mb=plan["scratch_words"] * 4 / 1e6)


def k6_bound(org, dirs, table, n_rows=None, eps: float = 0.0) -> dict:
    """The least time of one K6 launch on its arguments: each (ray, row)
    pair at the ops a test that decides dn and t first spends up to its
    decision (k6_pairs: OPS_K6_DN, OPS_K6_T, OPS_K6_FULL; none for a row
    left out), at the float rate; 24 B in and 16 B out a ray and the table's 64-B rows once
    at the memory rate. Beside it, the bound as the one-stage test was held
    to (bound_ms_every_pair_full): OPS_K6_ROW per (ray, live row), a
    compare per padding row."""
    n_rays = org.shape[1]
    pairs = k6_pairs(org, dirs, table, n_rows, eps)
    rows = table.shape[0] if n_rows is None else n_rows
    valid = int((table[:rows, 12] > 0.5).sum())
    ops = (OPS_K6_DN * pairs["dn"] + OPS_K6_T * pairs["t"]
           + OPS_K6_FULL * pairs["full"])
    nbytes = n_rays * (24 + 16) + rows * 64
    full = _bound(n_rays * (OPS_K6_ROW * valid
                            + OPS_ROW_SKIP * (rows - valid)), nbytes)
    return _bound(ops, nbytes, pairs=pairs, valid_rows=valid,
                  bound_ms_every_pair_full=full["bound_ms"],
                  bound_by_every_pair_full=full["bound_by"])


def _k7_staged(lane, t_final, rays, rows, mask, eps: float) -> list:
    """[dn, t, full]: the (ray, row) pairs of rays (P,) (indices into the
    lane planes (ox, oy, oz, dx, dy, dz) and t_final) and rows (P, R, 16)
    where mask (P, R), by where a test that decides dn and t first decides
    them at the ray's final t (k6_pairs' stages; a pair whose t is at or
    below the final t takes the whole test): the least over any order of
    the sweep."""
    import torch

    from smallpt_tpu_torch.ops import mesh_pallas as mp

    out = [0, 0, 0]
    step = max(1, (1 << 22) // max(rows.shape[1], 1))
    for lo in range(0, rays.shape[0], step):
        ray, row, m = (x[lo:lo + step] for x in (rays, rows, mask))
        ln = [x[ray][:, None] for x in lane]
        cols = [row[..., k] for k in range(13)]
        _, t, _, _ = mp._tri_test(ln, cols, eps)
        dn = ln[3] * cols[9] + ln[4] * cols[10] + ln[5] * cols[11]
        at_dn = dn == 0.0
        at_t = ~at_dn & ~((eps < t) & (t <= t_final[ray][:, None]))
        out[0] += int((at_dn & m).sum())
        out[1] += int((at_t & m).sum())
        out[2] += int((~at_dn & ~at_t & m).sum())
    return out


def k7_walk(args, t_final, eps: float = 0.0, batch: int = 1 << 23) -> dict:
    """The work of one K7 launch on the wrapper's arguments (org, dirs,
    n_rays, table, boxes, slivers, cones, cone_rows, lists, dlo, stops,
    n_glob, n_chunks) at each ray's final t (t_final: the launch's
    (n_rays,) t, 3e38 on a miss), counted over the valid rays in batches
    of tiles (about ``batch`` (ray, slot) pairs a batch):
    - "tile", the tile-wide walk of the kernel before the box cull: each
      tile sweeps the global chunks, its listed slots until every valid
      lane's t is below the next slot's bound, and every local chunk on
      an overflow whose tail a lane reaches: "pairs" (valid lane, valid
      row) and "dead" (valid lane, padding row) of the chunks swept;
    - "ray", a ray alone: its cone tests ("cone_tests", every cone), the
      box tests over the slots it walks (until its own t is below the next
      bound; every local chunk after an overflow whose tail it reaches),
      and the (ray, row) pairs it tests, by stage ("ray_dn", "ray_t",
      "ray_full", _k7_staged): the live rows of the global chunks, the
      slivers, the cones it grazes ("cone_rows") and the chunks whose box
      it enters before its t (mesh_pallas.box_test with best = its t);
    - "group", as the kernel walks (GROUP rays): every slot of its tile's
      list (and every local chunk after an overflow whose tail a valid
      lane reaches), a box test each a valid lane, and the pairs by stage:
      the live rows of the globals, the slivers, each lane's cones and
      the union of its valid lanes' entered chunks, each for every valid
      lane.
    A chunk with no live row takes no box test (the kernel skips it)."""
    import torch

    from smallpt_tpu_torch.ops import mesh_pallas as mp

    (org, dirs, n_rays, table, boxes, slivers, cones, cone_rows, lists, dlo,
     stops, n_glob, n_chunks) = args[:13]
    dev = org.device
    n_pad, g = org.shape[1], mp.GROUP
    n_tiles, l_max = lists.shape
    t = torch.full((n_pad,), 3e38, device=dev)
    t[:n_rays] = t_final[:n_rays]
    valid = torch.arange(n_pad, device=dev) < n_rays
    lane = mp.box_lane(org, dirs)
    rays = [*org, *dirs]
    live = boxes[:, 7].contiguous().view(torch.int32)
    bits = torch.tensor([1 << k for k in range(16)], dtype=torch.int32,
                        device=dev)
    live_bits = (live[:, None] & bits) != 0
    n_live = live_bits.sum(dim=1)
    has_live = live != 0
    chunk_rows = table.reshape(-1, 16, 16)
    n_valid = (table[:, 12] > 0.5).reshape(-1, 16).sum(dim=1)
    stop = stops.long()
    walk = stop.abs()
    out = {k: 0 for k in ("tile_pairs", "tile_dead", "tile_chunks",
                          "cone_tests", "cone_rows", "ray_tests", "ray_dn",
                          "ray_t", "ray_full", "ray_rows", "ray_entered",
                          "group_tests", "group_dn", "group_t", "group_full",
                          "group_rows", "group_union")}
    entered_max, union_max = 0, 0

    def add(keys, st):
        for key in keys:
            for k, v in zip(("dn", "t", "full"), st):
                out[f"{key}_{k}"] += v

    # every valid ray: the global chunks' live rows, the slivers and the
    # rows of the cones it grazes
    glob = torch.cat([torch.nonzero(live_bits[:n_glob].reshape(-1))[:, 0]
                      .to(torch.int32), slivers])
    every = torch.nonzero(valid)[:, 0]
    n_cones = cones.shape[0]
    off = cone_rows[:n_cones + 1].long()
    size = off[1:] - off[:-1]
    out["cone_tests"] = n_rays * n_cones
    grow = table[glob.long()]
    for lo in range(0, every.numel(), 1024):
        r = every[lo:lo + 1024]
        if glob.numel():
            add(("ray", "group"), _k7_staged(
                rays, t, r, grow[None].expand(r.numel(), -1, -1),
                torch.ones((r.numel(), grow.shape[0]), dtype=torch.bool,
                           device=dev), eps))
        if n_cones:
            hit = mp.cone_test([x[r][:, None] for x in rays[3:]],
                               [c[None, :] for c in cones.unbind(dim=1)])
            ray, cone = torch.nonzero(hit, as_tuple=True)
            n_at = size[cone]
            first = (off[cone] - torch.cumsum(n_at, 0) + n_at
                     ).repeat_interleave(n_at)
            at = torch.arange(int(n_at.sum()), device=dev) + first
            row = table[cone_rows[n_cones + 1 + at].long()]
            out["cone_rows"] += row.shape[0]
            add(("ray", "group"), _k7_staged(
                rays, t, r[ray].repeat_interleave(n_at), row[:, None],
                torch.ones((row.shape[0], 1), dtype=torch.bool,
                           device=dev), eps))
    out["ray_rows"] += n_rays * glob.numel() + out["cone_rows"]
    out["group_rows"] += n_rays * glob.numel() + out["cone_rows"]
    glob_valid = int(n_valid[:n_glob].sum())

    def walked(c):
        """Slots walked where c[..., j] says the walk goes on past j."""
        before = torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]],
                           dim=-1)
        return torch.cumprod(before.to(torch.int32), dim=-1).bool()

    def count(t0, cid, w_ray, w_grp, tt, vv, lanes):
        """Count the ray's and the group's work over the slots cid (b, S)
        of tiles t0.. where the ray walks w_ray (b, 1024, S) and the group
        w_grp (b, 1024 // g, S); returns each ray's entered chunks (b,
        1024) and each group's union (b, 1024 // g)."""
        b, s_ = cid.shape
        box = [x.reshape(b, 1, s_) for x in boxes[cid].unbind(dim=2)]
        keep = mp.box_test(lanes, box, tt[:, :, None], eps) & vv[:, :, None]
        tested = has_live[cid][:, None, :]
        ent = keep & w_ray
        out["ray_tests"] += int((w_ray & tested).sum())
        kg = keep.reshape(b, 1024 // g, g, s_).any(dim=2) & w_grp
        out["group_tests"] += int(((w_grp & tested[:, 0][:, None, :]).sum(
            dim=2) * vv.reshape(b, 1024 // g, g).sum(dim=2)).sum())
        swept = kg.repeat_interleave(g, dim=1) & vv[:, :, None]
        # the rows of the entered chunks (ray) and of the union (group)
        for key, sel in (("ray", ent), ("group", swept)):
            tl, ray, slot = torch.nonzero(sel, as_tuple=True)
            c = cid[tl, slot]
            out[key + "_rows"] += int(n_live[c].sum())
            add((key,), _k7_staged(rays, t, t0 * 1024 + tl * 1024 + ray,
                                   chunk_rows[c], live_bits[c], eps))
        return ent.sum(dim=2), kg.sum(dim=2)

    per = max(1, batch // (1024 * max(l_max, n_chunks)))
    for t0 in range(0, n_tiles, per):
        t1 = min(n_tiles, t0 + per)
        b = t1 - t0
        tt = t[t0 * 1024:t1 * 1024].reshape(b, 1024)
        vv = valid[t0 * 1024:t1 * 1024].reshape(b, 1024)
        nv = vv.sum(dim=1)
        lanes = [x[t0 * 1024:t1 * 1024].reshape(b, 1024, 1) for x in lane]
        w = walk[t0:t1]
        bound = dlo[t0:t1]
        nxt = torch.cat([bound[:, 1:], torch.full((b, 1), float("inf"),
                                                  device=dev)], dim=1)
        inwalk = torch.arange(l_max, device=dev)[None, :] < w[:, None]
        cont = (tt[:, :, None] >= nxt[:, None, :]) & vv[:, :, None]
        w_ray = walked(cont) & inwalk[:, None, :] & vv[:, :, None]
        w_grp = inwalk[:, None, :] & vv.reshape(b, 1024 // g, g).any(
            dim=2)[:, :, None]
        w_tile = walked(cont.any(dim=1)) & inwalk
        cid = n_glob + lists[t0:t1].long()
        out["tile_chunks"] += int(w_tile.sum()) + b * n_glob
        tile_valid = (w_tile * n_valid[cid]).sum(dim=1) + glob_valid
        out["tile_pairs"] += int((nv * tile_valid).sum())
        out["tile_dead"] += int((nv * (16 * (w_tile.sum(dim=1) + n_glob)
                                       - tile_valid)).sum())
        per_ray, union = count(t0, cid, w_ray, w_grp, tt, vv, lanes)
        # the overflow fallback: every local chunk, for the rays, groups
        # and tiles whose t reaches the last slot's bound
        tail = stop[t0:t1] < 0
        if bool(tail.any()):
            last = bound.gather(1, (w - 1).clamp(min=0)[:, None])
            reach = (tt >= last) & vv & tail[:, None]
            greach = reach.reshape(b, 1024 // g, g).any(dim=2)
            treach = reach.any(dim=1)
            every_c = (n_glob + torch.arange(n_chunks, device=dev))[
                None].expand(b, -1)
            fb_ray, fb_union = count(
                t0, every_c, reach[:, :, None].expand(-1, -1, n_chunks),
                greach[:, :, None].expand(-1, -1, n_chunks), tt, vv, lanes)
            per_ray, union = per_ray + fb_ray, union + fb_union
            out["tile_chunks"] += int(treach.sum()) * n_chunks
            fb_valid = int(n_valid[n_glob:].sum())
            out["tile_pairs"] += int((nv * treach).sum()) * fb_valid
            out["tile_dead"] += int((nv * treach).sum()) * (
                16 * n_chunks - fb_valid)
        out["ray_entered"] += int(per_ray.sum())
        entered_max = max(entered_max, int(per_ray.max()))
        out["group_union"] += int(union.sum())
        union_max = max(union_max, int(union.max()))
    n_groups = n_pad // g
    out.update(ray_entered_mean=out["ray_entered"] / max(n_rays, 1),
               ray_entered_max=entered_max,
               cone_rows_mean=out["cone_rows"] / max(n_rays, 1),
               group_union_mean=out["group_union"] / max(n_groups, 1),
               group_union_max=union_max,
               tile_chunks_mean=out["tile_chunks"] / max(n_tiles, 1))
    return out


def k7_bound(args, t_final, eps: float = 0.0) -> dict:
    """The least time of one K7 launch on the wrapper's arguments (org,
    dirs, n_rays, table, boxes, slivers, lists, dlo, stops, ...) and its t
    (t_final), the function's: the lesser of
    - the tile-wide walk's count (bound_ms_tile_walk: OPS_K6_ROW per
      (valid ray, valid row) and a compare per padding row of the chunks
      each tile sweeps, k7_walk's "tile"; PRs 8-15 bound K7 by this walk at
      the running best, the same walk), and
    - the box-culled count (bound_ms_box_culled: for each ray its |d|
      and cone tests at OPS_K7_LEN and OPS_K7_CONE, its box tests over
      the slots it walks at OPS_K7_BOX, and the pairs it tests (the live
      rows of the global chunks, the slivers, the cones it grazes and the
      chunks it enters before its t) at K6's staged counts, OPS_K6_DN,
      OPS_K6_T or OPS_K6_FULL as dn, t at the ray's final t or the whole
      test decides each, k7_walk's "ray"),
    at the float rate, against the ray planes, the table, the boxes, the
    cones and the lists read once and 16 B a ray written, at the memory
    rate. Beside it the design's least (bound_ms_group_union: the same
    but a group's box tests and the union of its lanes' chunks for each
    lane, "group")."""
    org, _, n_rays, table = args[:4]
    c = k7_walk(args, t_final, eps)
    nbytes = (2 * org.numel() * 4 + n_rays * 16
              + sum(x.numel() * 4 for x in args[3:11]))
    tile = _bound(OPS_K6_ROW * c["tile_pairs"] + OPS_ROW_SKIP * c["tile_dead"],
                  nbytes)

    def culled(key):
        tests = (OPS_K7_BOX * c[key + "_tests"] + OPS_K7_LEN * n_rays
                 + OPS_K7_CONE * c["cone_tests"])
        rows = (OPS_K6_DN * c[key + "_dn"] + OPS_K6_T * c[key + "_t"]
                + OPS_K6_FULL * c[key + "_full"])
        return _bound(tests + rows, nbytes,
                      bound_ops_ms_tests=tests / PEAK_FP32_OPS * 1e3,
                      bound_ops_ms_rows=rows / PEAK_FP32_OPS * 1e3)

    ray, grp = culled("ray"), culled("group")
    best = ray if ray["bound_ms"] <= tile["bound_ms"] else tile
    return dict(best, bound_algorithm=("box-culled"
                                       if best is ray else "tile walk"),
                bound_ms_tile_walk=tile["bound_ms"],
                bound_ms_box_culled=ray["bound_ms"],
                bound_ms_group_union=grp["bound_ms"],
                bound_ops_ms_tests=ray["bound_ops_ms_tests"],
                bound_ops_ms_rows=ray["bound_ops_ms_rows"],
                group_bound_ops_ms_tests=grp["bound_ops_ms_tests"],
                group_bound_ops_ms_rows=grp["bound_ops_ms_rows"], counts=c)


def _bound(ops, nbytes, **info) -> dict:
    ops_ms, bytes_ms = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(info, ops=ops, bytes=nbytes, bound_ops_ms=ops_ms,
                bound_bytes_ms=bytes_ms,
                bound_nofma_ms=ops / PEAK_FP32_NOFMA * 1e3,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _wrappers() -> tuple:
    """Every kernel wrapper, each counting its launches."""
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.ops import stream_dda as sd

    return (mk.mega_pass, mk.stream_step, sd.stream_step_dda, ip.closest_hit,
            mp.closest_tri, mp.closest_tri_culled, mk.stream_step_binned,
            mk.mega_record, dda.closest_hit_dda, ip.closest_hit_mxu)


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers():
        fn.launches = 0


def counts() -> dict:
    return {fn.__name__: fn.launches for fn in _wrappers()}


def camera_and_bounce_rays(scene, cfg, camera, key, intersect_fn, dev):
    """The camera ray of each pixel's first sample, and the ray each lane
    continues with after one bounce through intersect_fn (its own ray where
    the path ends): ((org, dirs), (org, dirs)), (N, 3) each on dev."""
    import torch

    from smallpt_tpu_torch.core import camera as cam
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import wavefront as wf

    pixel = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(pixel)
    org, dirs = cam.generate_rays(
        camera, rng.camera_uniforms(key, pixel * cfg.spp), cfg,
        pixel % cfg.width, pixel // cfg.width, zero, zero)
    nxt = wf.bounce_step(wf.initial_state(org, dirs, 1), intersect_fn,
                         scene.material, cfg, key, pixel)
    return (org, dirs), (nxt.org, nxt.dir)


def exact(name, got, want) -> dict:
    """Kernel outputs against the plain version's: every tensor equal."""
    import torch

    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            diff = int((a != b).sum())
            raise AssertionError(f"{name}: output {k} differs on {diff} of "
                                 f"{a.numel()} rays")
    t = got[0]
    hit = t < 3e38
    return dict(rays=t.numel(), hit_share=float(hit.float().mean()),
                equal=True, max_abs_err=0.0)


def k2_vs_plain(name, scene, org, dirs, dev) -> dict:
    """K2 against closest_hit_plain on the same rays ((N, 3) each): t and
    slot bit-equal; with the plan the launcher made (and its scratch)."""
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    table, _, nbc, nsc = ip.build_sphere_table(scene, device=dev)
    o, d = org.T.contiguous(), dirs.T.contiguous()
    args = (o, d, table, 64 * nbc, 64 * nsc)
    return dict(exact(name, ip.closest_hit(*args),
                      ip.closest_hit_plain(*args)), plan=k2_plan(*args))


def k6_vs_plain(name, scene, org, dirs, dev) -> dict:
    """K6 against closest_tri_plain on the same rays: t, id, u, v
    bit-equal."""
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    table = mp.build_tri_table(scene, device=dev)
    o, d = org.T.contiguous(), dirs.T.contiguous()
    return exact(name, mp.closest_tri(o, d, table),
                 mp.closest_tri_plain(o, d, table))


def closest_hit_phases(dev) -> dict:
    """K2 against its plain version: the Cornell box on the 786,432 camera
    rays of 1024x768 and their first-bounce rays, procedural_sphere_scene
    (10000) on 16,384 camera and first-bounce rays (128x128), the
    300-sphere scene (part A truncates) likewise, 77 rays, and 77 rays that
    miss every sphere."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene, scene_to,
    )
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    key = rng.fold_in(rng.base_key(0), 1000)
    out = {}
    for name, scene, (w, h) in (
            ("cornell_1024x768", cornell_box_scene(), (1024, 768)),
            ("procedural10000_128x128", procedural_sphere_scene(10000),
             (128, 128)),
            ("procedural300_128x128", procedural_sphere_scene(300),
             (128, 128))):
        cfg = RenderConfig(width=w, height=h, max_depth=48, **leg)
        ds = scene_to(scene, dev)
        cam_rays, bounce_rays = camera_and_bounce_rays(
            ds, cfg, smallpt_camera(), key, make_intersect_fn(ds, cfg), dev)
        out[f"{name}_camera"] = k2_vs_plain(name, scene, *cam_rays, dev)
        out[f"{name}_bounce"] = k2_vs_plain(name, scene, *bounce_rays, dev)
    org, dirs = cam_rays[0][:77], cam_rays[1][:77]
    out["cornell_77"] = k2_vs_plain("77 rays", cornell_box_scene(), org,
                                    dirs, dev)
    far = torch.tensor([[50.0, 40.0, 1e6]], device=dev).expand(77, 3)
    away = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(77, 3)
    miss = k2_vs_plain("all miss", cornell_box_scene(), far, away, dev)
    if miss["hit_share"] != 0.0:
        raise AssertionError("all-miss rays hit")
    out["cornell_all_miss_77"] = miss
    out["ptxas"] = ptxas_entry(ip.LIBRARY[0])
    return out


def k2_edge_launch(table, n_a: int, n_b: int):
    """A launch of edge cases (tests/test_torch_hit_split.py's, on the
    card) over a copy of a sphere table of n_a part-A and n_b part-B rows.
    Rows n_a + 1 to n_a + 4 (part B) become a unit sphere at P = (-512,
    -512, -512), away from the scene, a radius-5 sphere through P, a
    sphere of NaN eps and one of infinite radius; rows 2 and 3 (part A) a
    1e5 sphere whose top is 1 below P and one of infinite radius; 60 other
    live rows get a NaN or a zero radius. Rays (P, a power of two, keeps
    them exact): two along x tangent to the unit sphere (det exactly 0),
    the one at y = -1 also to the 1e5 sphere, at the same t; rays from
    inside the unit sphere and the 1e5 sphere; the test's origins (on and
    inside the spheres, NaN and inf) in its directions (NaN among them);
    inf directions. Returns (org, dirs, table): (3, N) planes and the
    table."""
    import torch

    p = np.float32([-512.0, -512.0, -512.0])
    tab = table.clone()
    rng_ = np.random.default_rng(16)
    rows = [(n_a + 1, (0, 0, 0), 1.0, 1e-4), (n_a + 2, (3, 4, 0), 5.0, 1e-4),
            (n_a + 3, (0, 0, 10), 2.0, float("nan")),
            (n_a + 4, (0, 0, 0), float("inf"), 1e-4),
            (2, (0, -1e5 - 1, 0), 1e5, 0.05), (3, (0, 0, 0), float("inf"),
                                                1e-4)]
    for k, c, r, eps in rows:
        tab[k, :3] = torch.from_numpy(p + np.float32(c))
        tab[k, 3], tab[k, 4] = r, eps
    live = torch.nonzero(tab[:n_a + n_b, 3] > 0)[:, 0].cpu().numpy()
    dead = rng_.choice(live[~np.isin(live, [k for k, *_ in rows])], 60,
                       replace=False)
    tab[torch.from_numpy(dead[:30]).to(tab.device), 3] = float("nan")
    tab[torch.from_numpy(dead[30:]).to(tab.device), 3] = 0.0
    o = [(-5, 1, 0), (-5, 0, 0), (0, 0, 0), (1, 0, 0), (0.5, 0, 0),
         (np.nan, 0, 0), (np.inf, 0, 0), (-5, 1e-20, 0), (0, 0, -1e5)]
    d = [(1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 1), (np.nan, 0, 0),
         (0.6, 0.8, 0)]
    org = [p + np.float32(a) for a in o for _ in d]
    dirs = [np.float32(b) for _ in o for b in d]
    # tangent to the unit sphere (op = (5, -y, 0), b = 5, det = 25 - 26 +
    # 1); at y = -1 also to the 1e5 sphere's top, at the same t = 5
    for y in (1, -1):
        org.append(p + np.float32([-5, y, 0]))
        dirs.append(np.float32([1, 0, 0]))
    inside = rng_.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    below = rng_.uniform((-50, -60, -50), (50, -2, 50), (64, 3))
    unit = rng_.normal(size=(192, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    org += list(p + inside) + list(p + below.astype(np.float32))
    org += [p + np.float32([-5, 0, 0])] * 64
    dirs += list(unit.astype(np.float32))
    dirs[-64::8] = [np.float32([np.inf, 0, 0])] * 8
    dirs[-63::8] = [np.float32([0, -np.inf, 0])] * 8
    with np.errstate(all="ignore"):
        o_t = torch.from_numpy(np.stack(org).T.copy()).to(tab.device)
        d_t = torch.from_numpy(np.stack(dirs).T.copy()).to(tab.device)
    return o_t.contiguous(), d_t.contiguous(), tab


def k2_constructed_launches(dev) -> dict:
    """K2 against its plain version (t and slot bit-equal) on launches built
    to reach the edges of its plan and of its tests, each under the plan
    its launcher makes and under forced cuts of its rows (1 range, 3, 7 and
    one a 256-row chunk; ``intersect_pallas._launch``, uncounted), with the
    plan, its scratch, the time (``hold_card`` before each call) and, on
    the scene's own table, the bounds:
    - 77 camera rays of procedural_sphere_scene(10000) over its 10,176
      rows: one ray block, which the plan cuts the deepest;
    - 3,072 rays from outside the scene pointing away: every pair a miss,
      every range's partial (3e38, 0);
    - the 16,384 first-bounce rays of the scene at 128x128;
    - the scene's part B twice over (the copy after the original, as more
      part-B rows) on the 16,384 camera rays: every part-B hit ties with
      its copy in a later range, and the original must win;
    - k2_edge_launch over the scene's table: tangent rays (det 0), origins
      inside spheres, NaN and inf rays, NaN and zero radii among the live
      rows, an infinite radius and a NaN eps."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        procedural_sphere_scene, scene_to,
    )
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    scene = procedural_sphere_scene(10000)
    cfg = RenderConfig(width=128, height=128, camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    ds = scene_to(scene, dev)
    (co, cd), (bo, bd) = camera_and_bounce_rays(
        ds, cfg, smallpt_camera(), rng.fold_in(rng.base_key(0), 1003),
        make_intersect_fn(ds, cfg), dev)
    table, _, nbc, nsc = ip.build_sphere_table(scene, device=dev)
    n_a, n_b = 64 * nbc, 64 * nsc
    dup = torch.cat([table[:n_a + n_b], table[n_a:n_a + n_b]])
    g = torch.Generator().manual_seed(16)
    away = torch.nn.functional.normalize(torch.randn((3072, 3), generator=g),
                                         dim=1)
    away[:, 2] = away[:, 2].abs() + 1.0
    away = torch.nn.functional.normalize(away, dim=1)
    far = torch.tensor([[50.0, 40.0, 1e6]]).expand(3072, 3)
    eo, ed, etab = k2_edge_launch(table, n_a, n_b)
    chunks = -(-(n_a + n_b) // 256)
    out = {}
    for name, o, d, tab, nb in (
            ("rays77_all_rows", co[:77].T, cd[:77].T, table, n_b),
            ("all_miss_3072", far.to(dev).T, away.to(dev).T, table, n_b),
            ("bounce_16384", bo.T, bd.T, table, n_b),
            ("duplicate_part_b_camera", co.T, cd.T, dup, 2 * n_b),
            ("edges", eo, ed, etab, n_b)):
        args = (o.contiguous(), d.contiguous(), tab, n_a, nb)
        want = ip.closest_hit_plain(*args)
        hit = want[0] < 3e38
        if name.startswith("all_miss") and bool(hit.any()):
            raise AssertionError(f"{name}: {int(hit.sum())} rays hit")
        if name.startswith("duplicate") and (
                not bool(hit.any())
                or bool((want[1][hit] >= n_a + n_b).any())):
            raise AssertionError(f"{name}: a copy won a tie")
        if name == "edges" and not bool(
                torch.isin(want[1][hit], torch.tensor(
                    [2, n_a + 1, n_a + 2], device=dev,
                    dtype=torch.int32)).any()):
            raise AssertionError(f"{name}: no edge sphere won")
        cuts = {}
        for forced in (0, 1, 3, 7, chunks):
            def launch():
                return (ip.closest_hit(*args) if forced == 0
                        else ip._launch(*args, forced))
            st = exact(f"{name} forced={forced}", launch(), want)
            ms, _ = cuda_ms(launch, 3, setup=hold_card)
            cuts["own_plan" if forced == 0 else f"forced_{forced}"] = dict(
                st, kernel_ms=ms, plan=k2_plan(*args, forced=forced))
        if len({c["plan"]["ranges"] for c in cuts.values()}) < 4:
            raise AssertionError(f"{name}: cuts {cuts}")
        out[name] = dict(cuts, **(k2_bound(*args, scene=ds) if tab is table
                                  else {}))
    if out["rays77_all_rows"]["own_plan"]["plan"]["ranges"] < 2:
        raise AssertionError(f"77 rays: plan {out['rays77_all_rows']}")
    out["ptxas"] = ptxas_entry(ip.LIBRARY[0])
    return out


def closest_tri_phases(dev) -> dict:
    """K6 against its plain version: the debug triangle on the matrix
    camera's rays (64x48), procedural_mesh_scene(500) (32,014 triangles) on
    16,384 camera and first-bounce rays (128x128), and the 60-ball scene
    (3,854 triangles) on 32x24 camera and first-bounce rays."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import (
        default_matrix_camera, smallpt_camera,
    )
    from smallpt_tpu_torch.core.scene import (
        procedural_mesh_scene, scene_to, single_triangle_scene,
    )
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn

    key = rng.fold_in(rng.base_key(0), 1001)
    out = {}
    for name, scene, cam, cfg in (
            ("triangle_64x48", single_triangle_scene(),
             default_matrix_camera(), RenderConfig(width=64, height=48)),
            ("mesh500_128x128", procedural_mesh_scene(500), smallpt_camera(),
             RenderConfig(width=128, height=128, camera_model=CameraModel
                          .LEGACY, filter=Filter.TENT)),
            ("mesh60_32x24", procedural_mesh_scene(60, seed=3),
             smallpt_camera(), RenderConfig(width=32, height=24,
                                            camera_model=CameraModel.LEGACY,
                                            filter=Filter.TENT))):
        ds = scene_to(scene, dev)
        cam_rays, bounce_rays = camera_and_bounce_rays(
            ds, cfg, cam, key, make_intersect_fn(ds, cfg), dev)
        out[f"{name}_camera"] = k6_vs_plain(name, scene, *cam_rays, dev)
        out[f"{name}_bounce"] = k6_vs_plain(name, scene, *bounce_rays, dev)
    if not 0 < out["triangle_64x48_camera"]["hit_share"] < 1:
        raise AssertionError("the debug triangle is not in view")
    return out


def k6_constructed_launches(dev) -> dict:
    """K6 against its plain version (t, tri, u, v bit-equal) on launches
    built to reach the edges of its plan, each with the plan its launcher
    made, its scratch, its time and its bounds:
    - 77 camera rays of procedural_mesh_scene(500) over all 32,014 rows:
      one ray block, cut to one range a chunk (the deepest cut);
    - the mesh's valid rows twice over, the copy after the originals (and
      a padding row), on 3,072 camera and first-bounce rays (64x48): every
      hit ties with its copy in a later range, and the original must win;
    - 4,000 triangles (2,000 unit quads) in the plane z = 5 and 3,072 rays,
      two in three with dz = 0 exactly (dn == 0 on every pair: all miss),
      the rest crossing the plane from above a quad;
    - the first 20,000 rows of the mesh's table (n_rows below its 32,032
      rows, off a chunk boundary) on the 3,072 bounce rays."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene, scene_to
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    mesh = procedural_mesh_scene(500)
    cfg = RenderConfig(width=64, height=48, camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    ds = scene_to(mesh, dev)
    (co, cd), (bo, bd) = camera_and_bounce_rays(
        ds, cfg, smallpt_camera(), rng.fold_in(rng.base_key(0), 1002),
        make_intersect_fn(ds, cfg), dev)
    table = mp.build_tri_table(mesh, device=dev)
    valid = table[table[:, 12] > 0.5]
    dup = torch.cat([valid, torch.zeros((1, 16), device=dev), valid])
    dup = torch.cat([dup, torch.zeros(((-dup.shape[0]) % 32, 16),
                                      device=dev)])
    g = torch.Generator().manual_seed(15)
    xy = torch.rand((2000, 2), generator=g) * 200.0
    quads = torch.zeros((4000, 16))
    for k, (e1, e2) in enumerate((((1, 0, 0), (1, 1, 0)),
                                  ((1, 1, 0), (0, 1, 0)))):
        q = quads[k::2]
        q[:, 0:2], q[:, 2] = xy, 5.0
        q[:, 3:6], q[:, 6:9] = torch.tensor(e1), torch.tensor(e2)
        q[:, 9:12] = torch.linalg.cross(q[:, 3:6], q[:, 6:9])
        q[:, 12] = 1.0
    quads = quads.to(dev)
    n = 3072
    po = torch.rand((n, 3), generator=g) * torch.tensor([200.0, 200.0, 10.0])
    pd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                       dim=1)
    flat = torch.arange(n) % 3 != 2
    pd[flat, 2] = 0.0
    cross = ~flat
    po[cross, :2] = xy[torch.arange(int(cross.sum())) % 2000] + 0.25
    po[cross, 2] = 9.0
    pd[cross] = torch.tensor([0.01, 0.02, -1.0])
    out = {}
    for name, o, d, tab, n_rows in (
            ("rays77_all_rows", co[:77], cd[:77], table, None),
            ("duplicate_tie_camera", co, cd, dup, None),
            ("duplicate_tie_bounce", bo, bd, dup, None),
            ("parallel_to_plane", po.to(dev), pd.to(dev), quads, None),
            ("n_rows_20000", bo, bd, table, 20000)):
        ot, dt = o.T.contiguous(), d.T.contiguous()
        kw = {} if n_rows is None else {"n_rows": n_rows}
        got = mp.closest_tri(ot, dt, tab, **kw)
        st = exact(name, got, mp.closest_tri_plain(ot, dt, tab, **kw))
        hit = got[0] < 3e38
        if name.startswith("duplicate") and (
                not bool(hit.any())
                or bool((got[1][hit] >= valid.shape[0]).any())):
            raise AssertionError(f"{name}: a copy won a tie")
        if name == "parallel_to_plane" and (
                bool(hit[flat.to(dev)].any())
                or not bool(hit[cross.to(dev)].any())):
            raise AssertionError(f"{name}: hits {int(hit.sum())}")
        if n_rows is not None and bool((got[1][hit] >= n_rows).any()):
            raise AssertionError(f"{name}: a row past n_rows won")
        ms, _ = cuda_ms(lambda: mp.closest_tri(ot, dt, tab, **kw), 3)
        out[name] = dict(st, plan=k6_plan(ot, dt, tab, **kw), kernel_ms=ms,
                         **k6_bound(ot, dt, tab, **kw))
    if out["rays77_all_rows"]["plan"]["ranges"] != -(-table.shape[0] // 256):
        raise AssertionError(f"77 rays: plan {out['rays77_all_rows']}")
    return out


def wavefront_golden_phases(dev) -> dict:
    """The goldens through the wavefront routes and the closest-hit
    kernels (tests/test_torch_wavefront.py's cases): Cornell 48x36 through
    REGEN and K2 (5% gate), the NEE small light 32x24 through FLAT and K2,
    the thin lens 32x24 through REGEN and K2, and the 60-ball mesh 32x24
    through FLAT and K6 (2% gates)."""
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, cornell_box_small_light_scene,
        procedural_mesh_scene,
    )
    from smallpt_tpu_torch.engine.renderer import render

    base = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                intersector=Intersector.PALLAS)
    regen, flat = Scheduler.REGEN, Scheduler.FLAT
    cases = {
        "cornell48_regen": (GOLDEN, cornell_box_scene(), dict(
            width=48, height=36, spp_per_cell=4, max_depth=24,
            scheduler=regen), 7, 0.05, "closest_hit"),
        "nee32_flat": (GOLDEN_NEE, cornell_box_small_light_scene(), dict(
            width=32, height=24, spp_per_cell=2, max_depth=16,
            nee_lights=(8,), scheduler=flat), 11, 0.02, "closest_hit"),
        "dof32_regen": (GOLDEN_DOF, cornell_box_scene(), dict(
            width=32, height=24, spp_per_cell=2, max_depth=12, aperture=4.0,
            focal_distance=120.0, scheduler=regen), 13, 0.02, "closest_hit"),
        "mesh32_flat": (GOLDEN_MESH, procedural_mesh_scene(60, seed=3), dict(
            width=32, height=24, spp_per_cell=2, max_depth=10,
            scheduler=flat), 19, 0.02, "closest_tri"),
    }
    out = {}
    for name, (path, scene, kw, seed, frac, kernel) in cases.items():
        zero_counts()
        img = render(scene, smallpt_camera(), RenderConfig(**base, **kw),
                     rng.base_key(seed), device=dev)
        if not counts()[kernel]:
            raise AssertionError(f"{name}: {kernel} never launched")
        out[name] = gate(img.cpu().numpy(), np.load(path)["image"], frac)
    return out


def aov_phases(dev) -> dict:
    """The AOV modes at 256x192, REGEN, through K2 against the plain
    intersector route on the same key: NORMAL, EMISSION and UV under the
    image gate (2%); INST_ID per sample value within two ulp of the colour
    hash (2^-7) on 98% of values (a razor flip changes the id)."""
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, Mode, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.renderer import render

    out = {}
    for mode in (Mode.NORMAL, Mode.EMISSION, Mode.UV, Mode.INST_ID):
        cfg = RenderConfig(width=256, height=192, spp_per_cell=1,
                           max_depth=4, mode=mode, scheduler=Scheduler.REGEN,
                           camera_model=CameraModel.LEGACY,
                           filter=Filter.TENT)
        key = rng.base_key(21)
        zero_counts()
        img = render(cornell_box_scene(), smallpt_camera(),
                     cfg.replace(intersector=Intersector.PALLAS), key,
                     device=dev).cpu().numpy()
        if not counts()["closest_hit"]:
            raise AssertionError(f"{mode.value}: K2 never launched")
        ref = render(cornell_box_scene(), smallpt_camera(), cfg, key,
                     device=dev).cpu().numpy()
        if mode == Mode.INST_ID:
            close = float((np.abs(img - ref) <= 2.0 ** -7 * cfg.spp).mean())
            if close < 0.98 or not np.isfinite(img).all():
                raise AssertionError(f"inst_id: {close} of values close")
            out[mode.value] = {"close_share": close}
        else:
            out[mode.value] = gate(img, ref, 0.02)
    return out


def capture_calls(mod, name: str, fn, which, state=()) -> list:
    """Run fn() with mod.name wrapped so that its calls numbered in
    ``which`` (from 0) are kept; returns one dict a kept call: "a" and "k",
    its positional and keyword arguments; "args", all of them by the
    wrapper's parameter names; "before", copies of the arguments named in
    ``state`` taken before the call (a streaming wrapper updates its state
    in place); "out", copies of its outputs. The kept calls are fn's own
    launches and count as such."""
    import inspect

    import torch

    real, kept, n = getattr(mod, name), [], [0]
    sig = inspect.signature(real)

    def spy(*a, **k):
        keep = n[0] in which
        n[0] += 1
        if not keep:
            return real(*a, **k)
        bound = sig.bind(*a, **k)
        bound.apply_defaults()
        before = {s_: bound.arguments[s_].clone() for s_ in state}
        out = real(*a, **k)
        kept.append(dict(a=a, k=k, args=dict(bound.arguments),
                         before=before, out=tuple(
                             x.clone() if isinstance(x, torch.Tensor) else x
                             for x in out)))
        return out

    # the wrapper counts its launches on the name it is bound to in its
    # own module: the spy carries the count while it stands there
    home = (sys.modules[real.__module__] is mod
            and hasattr(real, "launches"))
    if home:
        spy.launches = real.launches
    setattr(mod, name, spy)
    try:
        fn()
    finally:
        setattr(mod, name, real)
        if home:
            real.launches = spy.launches
    return kept


def compare_images(name, img, rays, ref, ref_rays,
                   max_frac: float = MAX_FRAC) -> dict:
    """tests/test_megakernel.py::_compare's gate: max_frac (2%) of values
    off by 10%, means within 5%, rays within max(64, 0.1%)."""
    st = gate(img, ref, max_frac)
    rays_close(name, int(rays), int(ref_rays))
    st.update(rays=int(rays), ref_rays=int(ref_rays))
    return st


def launches_vs_plain(name, kernel: str, fn, per_run: float,
                      scene=None) -> dict:
    """The inputs of the first launch of the closest-hit kernel ``kernel``
    in a run of fn() and of one in its middle (per_run: the launches a run
    makes), captured from a further run: on each, the kernel against its
    plain version (bit-equal), its CUDA-event time (the card held busy
    before each call: ``hold_card``), the plain version's host time and the
    launch's bound ("first", "middle"; K2's with the sphere scene the run
    renders, ``k2_bound``); K7's also against K6 on the same rays, with K6's
    time beside it, where the mesh scene the run renders is given."""
    import torch

    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    mod = ip if kernel == "closest_hit" else mp
    kept = capture_calls(mod, kernel, fn, {0, int(per_run) // 2})
    launches = {}
    for k, call in zip(("first", "middle"), kept):
        args, kw = call["a"], call["k"]
        n = args[2] if kernel == "closest_tri_culled" else args[0].shape[1]
        k_ms, got = cuda_ms(lambda: getattr(mod, kernel)(*args, **kw), 5,
                            setup=hold_card)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kernel == "closest_tri_culled":
            want = mp.closest_tri_culled_plain(*args, **kw)
        elif kernel == "closest_tri":
            want = mp.closest_tri_plain(*args, **kw)
        else:
            want = ip.closest_hit_plain(*args, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        bound = (k2_bound(*args, **kw, scene=scene)
                 if kernel == "closest_hit" else k6_bound(*args, **kw)
                 if kernel == "closest_tri" else k7_bound(
                     args, got[0], kw.get("eps", 0.0)))
        if kernel in ("closest_hit", "closest_tri"):
            # the cut the launcher made of this launch, and its scratch
            bound["plan"] = (k2_plan if kernel == "closest_hit"
                             else k6_plan)(*args, **kw)
        launches[k] = dict(rays=n, kernel_ms=k_ms, plain_ms=plain_ms,
                           vs_plain=exact(name, got, want), **bound)
        if kernel == "closest_tri_culled" and scene is not None:
            # K6 on the same rays: the same outputs, and its time
            table = mp.build_tri_table(scene, device=args[0].device)
            launches[k]["vs_k6"] = k7_vs_k6(name, table, args, got)
            launches[k]["k6_ms"], _ = cuda_ms(
                lambda: mp.closest_tri(args[0], args[1], table), 5,
                setup=hold_card)
    return launches


def wavefront_path(name, scene, camera, cfg, dev, kernel: str,
                   n_passes: int = 3) -> dict:
    """A wavefront main path at full width: ProgressiveRenderer passes (one
    warm-up, then n_passes timed with CUDA events), the launch counts zeroed
    just before the timed passes and read just after; the image finite.
    Then the first launch of a pass and one in its middle against the plain
    version (``launches_vs_plain``); the device's busy share over one pass
    (torch.profiler); the host part of a pass (pass time less its launches
    at the kernel's time)."""
    import torch

    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer

    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    r = ProgressiveRenderer(scene, camera, cfg, seed=0, device=dev)
    r.step()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_build
    rays0 = r.stats.rays
    zero_counts()
    pass_ms = [cuda_ms(r.step, 1)[0] for _ in range(n_passes)]
    launched = counts()
    rays = (r.stats.rays - rays0) / n_passes
    others = {"closest_tri": "closest_tri_culled",
              "closest_tri_culled": "closest_tri"}.get(kernel, "mega_pass")
    if not launched[kernel] or launched["mega_pass"] or launched[others]:
        raise AssertionError(f"{name}: launches {launched}")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    per_pass = launched[kernel] / n_passes
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the path's own
    launches = launches_vs_plain(name, kernel, r.step, per_pass, scene)
    ms = float(np.mean(pass_ms))
    kernel_ms = float(np.mean([v["kernel_ms"] for v in launches.values()]))
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                max_depth=cfg.max_depth, scheduler=cfg.scheduler.value,
                split_budget=cfg.split_budget, nee=list(cfg.nee_lights),
                first_pass_s=warm_s, passes=n_passes, launches=launched,
                launches_per_pass=per_pass, pass_ms=pass_ms,
                ms_per_pass=ms, rays=rays, mrays_per_s=rays / ms / 1e3,
                kernel=launches, kernel_ms_per_launch=kernel_ms,
                host_ms=ms - per_pass * kernel_ms,
                peak_mem_gb=peak_gb,
                mean=float(img.mean()), profile=profile(r.step))


def part_b_effect(scene, camera, cfg, key, dev) -> dict:
    """What part B's direct quadratic alone does to a REGEN pass (reported,
    not gated): the pass through K2 against the same pass through K2 on a
    table that holds every sphere in its stable part, and that pass against
    K1a's on the same key (the image gate's numbers and rays)."""
    import torch

    from smallpt_tpu_torch.core.scene import scene_to
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn, \
        render_pixels
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import megakernel as mk

    ds = scene_to(scene, dev)
    n = scene.n_spheres
    n_pad = -(-n // 64) * 64
    rows = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    rows[:n, 0:3], rows[:n, 3] = ds.center, ds.radius
    rows[:n, 4] = torch.clamp(float(np.float32(cfg.intersect_eps_rel))
                              * ds.radius, min=cfg.intersect_eps)
    perm = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    perm[:n] = torch.arange(n, device=dev)
    stable = (rows, perm, n_pad // 64, 0)
    pixel = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)

    def regen(fn):
        rad, rays = render_pixels(ds, camera, cfg, key, pixel,
                                  pixel % cfg.width, pixel // cfg.width, 0,
                                  cfg.spp, intersect_fn=fn)
        return rad.view(cfg.height, cfg.width, 3).cpu().numpy(), int(rays)

    def report(a, b):
        rel = np.abs(a[0] - b[0]) / (1.0 + np.abs(b[0]))
        return dict(frac_div=float((rel > 0.1).mean()),
                    mean_rel=float(abs(a[0].mean() - b[0].mean())
                                   / (abs(b[0].mean()) + 0.1)),
                    rays=a[1], ref_rays=b[1])

    k2 = regen(make_intersect_fn(ds, cfg))
    k2_stable = regen(lambda o, d: ip.intersect_spheres_pallas(
        o, d, ds, want_uv=False, tables=stable))
    rad, rays = mk.mega_pass(mk.build_scene_table(scene, cfg, dev),
                             mk.build_camera_vec(camera, cfg, dev), cfg,
                             key, n_spheres=n)
    mega = (rad.view(cfg.height, cfg.width, 3).cpu().numpy(),
            int(rays.sum(dtype=torch.int64)))
    return {"k2_vs_k2_stable_only": report(k2, k2_stable),
            "k2_stable_only_vs_mega_pass": report(k2_stable, mega),
            "k2_vs_mega_pass": report(k2, mega)}


def wavefront_main_paths(dev) -> dict:
    """The four wavefront main paths at full width:
    1. REGEN + K2 on the Cornell box at 1024x768, 4 spp a pass, max_depth
       48, without and with NEE on sphere 8; a pass's image held to the
       megakernel's (mega_pass, K1a) on the same key;
    2. REGEN + K2 on procedural_sphere_scene(10000) at 512x384, 4 spp,
       max_depth 24 (bench.py --procedural-brute with the scheduler named);
       held to mega_pass on the same key under the JAX suite's gate for
       this scene class (MAX_FRAC_PROCEDURAL);
    3. FLAT + K6 on procedural_mesh_scene(500) at 256x192, 4 spp, max_depth
       12 (bench.py --mesh's brute shape); held to the plain intersector
       route of the same config on the card;
    4. FLAT + K2 with split_budget 8 on the Cornell box at 1024x768, the
       rest as path 1: finite, its mean within 2% of path 1's."""
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_mesh_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine.renderer import render_with_stats
    from smallpt_tpu_torch.ops import megakernel as mk

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               intersector=Intersector.PALLAS)
    cam = smallpt_camera()
    key = rng.fold_in(rng.base_key(0), 0)
    out = {}

    def vs_mega(name, scene, cfg, max_frac=MAX_FRAC):
        img, rays = render_with_stats(scene, cam, cfg, key, device=dev)
        ref, ref_rays = mk.mega_pass(mk.build_scene_table(scene, cfg, dev),
                                     mk.build_camera_vec(cam, cfg, dev),
                                     cfg, key, n_spheres=scene.n_spheres)
        torch.cuda.synchronize()
        return compare_images(name, img.cpu().numpy(),
                              rays, ref.view(img.shape).cpu().numpy(),
                              ref_rays.sum(dtype=torch.int64), max_frac)

    cornell = cornell_box_scene()
    c1 = RenderConfig(width=1024, height=768, spp_per_cell=1, max_depth=48,
                      scheduler=Scheduler.REGEN, **leg)
    for name, cfg in (("regen_main_cornell_1024x768", c1),
                      ("regen_main_cornell_1024x768_nee",
                       c1.replace(nee_lights=(8,)))):
        out[name] = wavefront_path(name, cornell, cam, cfg, dev,
                                   "closest_hit")
        out[name]["vs_mega_pass"] = vs_mega(name, cornell, cfg)
        phase(name, **out[name])

    big = procedural_sphere_scene(10000)
    c2 = RenderConfig(width=512, height=384, spp_per_cell=1, max_depth=24,
                      scheduler=Scheduler.REGEN, **leg)
    name = "regen_main_procedural10000_512x384"
    out[name] = wavefront_path(name, big, cam, c2, dev, "closest_hit")
    out[name]["vs_mega_pass"] = vs_mega(name, big, c2, MAX_FRAC_PROCEDURAL)
    out[name]["part_b_formula"] = part_b_effect(big, cam, c2, key, dev)
    phase(name, **out[name])

    mesh = procedural_mesh_scene(500)
    c3 = RenderConfig(width=256, height=192, spp_per_cell=1, max_depth=12,
                      scheduler=Scheduler.FLAT, **leg)
    name = "flat_main_mesh500_256x192"
    out[name] = wavefront_path(name, mesh, cam, c3, dev, "closest_tri")
    img, rays = render_with_stats(mesh, cam, c3, key, device=dev)
    t = time.perf_counter()
    ref, ref_rays = render_with_stats(
        mesh, cam, c3.replace(intersector=Intersector.JAX), key, device=dev)
    torch.cuda.synchronize()
    out[name]["vs_plain_route"] = dict(
        seconds=time.perf_counter() - t,
        **compare_images(name, img.cpu().numpy(), rays, ref.cpu().numpy(),
                         ref_rays))
    phase(name, **out[name])

    name = "flat_split8_cornell_1024x768"
    c4 = c1.replace(scheduler=Scheduler.FLAT, split_budget=8)
    out[name] = wavefront_path(name, cornell, cam, c4, dev, "closest_hit")
    ref_mean = out["regen_main_cornell_1024x768"]["mean"]
    mean_rel = abs(out[name]["mean"] - ref_mean) / ref_mean
    if mean_rel >= 0.02:
        raise AssertionError(f"{name}: mean {out[name]['mean']} vs REGEN "
                             f"{ref_mean}")
    out[name]["mean_rel_vs_regen"] = mean_rel
    phase(name, **out[name])
    return out


def k7_vs_plain(name, org, dirs, accel, full: bool = False) -> dict:
    """K7 against closest_tri_culled_plain on (N, 3) rays and a
    MeshGridAccel on the card, on the tile lists of these rays (full:
    every local chunk listed with bound 0, a valid input for any rays and
    the one for NaN and inf rays, whose bin keys the list builder cannot
    take): t, id, u, v bit-equal. Returns the check with the bound of the
    launch (k7_bound) and the wrapper's arguments and outputs (keys "args"
    and "got", for the caller's timings)."""
    import torch

    from smallpt_tpu_torch.ops import mesh_accel as ma
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    n = org.shape[0]
    n_pad = -(-max(n, 1) // ma.RAY_TILE) * ma.RAY_TILE
    ot, dt = mp._ray_planes(org, dirs, n_pad)
    if full:
        t_ = n_pad // ma.RAY_TILE
        c = accel.n_chunks
        lists = torch.arange(c, dtype=torch.int32, device=org.device
                             ).expand(t_, c).contiguous()
        dlo = torch.zeros((t_, c), device=org.device)
        stops = torch.full((t_,), c, dtype=torch.int32, device=org.device)
    else:
        valid = torch.arange(n_pad, device=org.device) < n
        lists, dlo, stops = ma.mesh_tile_lists(ot, dt, valid, accel)
    args = (ot, dt, n, accel.table, accel.boxes, accel.slivers, accel.cones,
            accel.cone_rows, lists, dlo, stops, accel.n_glob_chunks,
            accel.n_chunks)
    got = mp.closest_tri_culled(*args)
    want = mp.closest_tri_culled_plain(*args)
    out = exact(name, got, want)
    out.update(tiles=int(stops.numel()),
               overflow_tiles=int((stops < 0).sum()),
               listed_mean=float(stops.abs().float().mean()),
               **k7_bound(args, got[0]))
    return dict(out, args=args, got=got)


def k7_vs_k6(name, table, args, got) -> dict:
    """K7's outputs (got) against K6 on the same rays and K6's table of
    the mesh: t on every lane, the triangle, u and v on hit lanes, equal."""
    import torch

    from smallpt_tpu_torch.ops import mesh_pallas as mp

    org, dirs, n = args[0], args[1], args[2]
    want = [x[:n] for x in mp.closest_tri(org, dirs, table)]
    torch.cuda.synchronize()
    hit = want[0] < 3e38
    same = [bool(torch.equal(got[0], want[0]))] + [
        bool(torch.equal(g[hit], w[hit])) for g, w in zip(got[1:], want[1:])]
    if not all(same):
        raise AssertionError(f"{name}: K7 vs K6 (t, tri, u, v) {same}")
    return {"equal": True, "hit_share": float(hit.float().mean())}


def k7_held(name, o, d, accel, table, full: bool = False) -> dict:
    """One K7 launch on (N, 3) rays held to its plain version (k7_vs_plain)
    and to K6 on the same rays and K6's table (k7_vs_k6), with K7's and
    K6's CUDA-event times (the card held busy before each)."""
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    st = k7_vs_plain(name, o, d, accel, full)
    args, got = st.pop("args"), st.pop("got")
    st["vs_k6"] = k7_vs_k6(name, table, args, got)
    st["kernel_ms"], _ = cuda_ms(lambda: mp.closest_tri_culled(*args), 3,
                                 setup=hold_card)
    st["k6_ms"], _ = cuda_ms(lambda: mp.closest_tri(args[0], args[1],
                                                    table), 3,
                             setup=hold_card)
    return st


def k7_constructed_launches(dev) -> dict:
    """K7 held bit for bit to its plain version and to K6 (k7_held, each
    with its time, K6's and its bound) on launches built to reach the
    edges of its box cull and its group walk, on the 60-ball
    mesh (3,854 triangles), each kind built by ops/cull_rays.py::edge_rays
    (tests/test_torch_tri_cull.py holds the plain cull and sweep to the
    same kinds on the CPU):
    - rays grazing triangle planes: through a point of a triangle along
      its plane, tilted off it by |cos| 0, 1e-7, ..., 1e-2;
    - directions with one or two zero components (+0 and -0), some from
      chunk box centres;
    - origins on chunk box faces, directions along the face (0), grazing
      it (1e-6) or random; origins inside chunk boxes;
    - origins on the surfaces a camera-like bundle hits (t near eps);
    - NaN and inf in origins and directions among finite rays (every
      local chunk listed);
    - a tile whose lanes hit a near ball but for one, which misses
      everything from outside the room;
    - 1 ray; 3 x 1,024 + 17 rays (a ragged tile and a ragged group);
    - 2,048 grazing rays on ops/cull_rays.py::rotated_ball_mesh (768
      triangles of 12 balls, each turned by its own random rotation, so
      that no two share a normal; its cone count printed beside);
    - a 49,152-lane launch of the mesh stream on procedural_mesh_scene(500)
      with the culled route forced (the fifth of a round's launches; dead
      and flushed lanes with their stale rays included)."""
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene, scene_to
    from smallpt_tpu_torch.engine import renderer
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )
    from smallpt_tpu_torch.ops import cull_rays as cr
    from smallpt_tpu_torch.ops import mesh_accel as ma
    from smallpt_tpu_torch.ops import mesh_pallas as mp

    m60 = scene_to(procedural_mesh_scene(60, seed=3), dev)
    acc = ma.build_mesh_grid_accel(m60, device=dev)
    table = mp.build_tri_table(m60, device=dev)
    cases = {}
    for k, (name, kind, n) in enumerate((
            ("grazing_planes", "grazing", 2048),
            ("axis_parallel", "axis_parallel", 2048),
            ("box_faces", "box_faces", 2048),
            ("inside_boxes", "inside_box", 2048),
            ("on_surfaces", "on_surface", 2048),
            ("nan_inf", "nan_inf", 2048),
            ("one_lane_misses", "one_lane_misses", 1024),
            ("ragged_3089", "random", 3 * 1024 + 17),
            ("one_ray", "random", 1))):
        cases[name] = [torch.tensor(x, device=dev) for x in
                       cr.edge_rays(kind, acc, table, n, 20 + k)]

    out = {}
    for name, (o, d) in cases.items():
        out[name] = k7_held(name, o.contiguous(), d.contiguous(), acc, table,
                            full=name == "nan_inf")
    miss = out["one_lane_misses"]
    if not 0.99 < miss["vs_k6"]["hit_share"] < 1.0:
        raise AssertionError(f"one_lane_misses: {miss['vs_k6']}")

    # a mesh whose triangles share no normals: 12 randomly rotated balls
    rot = scene_to(cr.rotated_ball_mesh(), dev)
    racc = ma.build_mesh_grid_accel(rot, device=dev)
    rtab = mp.build_tri_table(rot, device=dev)
    o, d = (torch.tensor(x, device=dev) for x in cr.edge_rays(
        "grazing", racc, rtab, 2048, 30))
    out["rotated_instances_grazing"] = dict(
        k7_held("rotated_instances_grazing", o, d, racc, rtab),
        cones=int(racc.cones.shape[0]), rows=int(rot.indices.shape[0]),
        slivers=int(racc.slivers.numel()))

    # the mesh stream's fifth launch, 49,152 lanes, culled route forced
    mesh = procedural_mesh_scene(500)
    cfg = RenderConfig(width=256, height=192, spp_per_cell=1, max_depth=12,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    old = renderer.MESH_ACCEL_MIN_TRIS
    renderer.MESH_ACCEL_MIN_TRIS = 1
    try:
        s = WavefrontStreamingRenderer(mesh, smallpt_camera(), cfg, seed=0,
                                       device=dev)
        s.reset()
        kept = capture_calls(mp, "closest_tri_culled",
                             lambda: s.step(n_bounces=8, add_samples=8),
                             {4})
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old
    if not kept:
        raise AssertionError("the culled stream made fewer than 5 launches")
    args, kw, got = kept[0]["a"], kept[0]["k"], kept[0]["out"]
    tab6 = mp.build_tri_table(s.scene, device=dev)
    want = mp.closest_tri_culled_plain(*args, **kw)
    st = exact("stream_launch", got, want)
    st["vs_k6"] = k7_vs_k6("stream_launch", tab6, args, got)
    st["kernel_ms"], _ = cuda_ms(lambda: mp.closest_tri_culled(*args, **kw),
                                 5, setup=hold_card)
    st["k6_ms"], _ = cuda_ms(lambda: mp.closest_tri(args[0], args[1],
                                                    tab6), 5,
                             setup=hold_card)
    st.update(k7_bound(args, got[0], kw.get("eps", 0.0)))
    out["stream_launch_49152"] = st
    return out


def closest_tri_culled_phases(dev):
    """K7 against its plain version and K6 on the card, bit-equal in every
    output, each launch timed beside K6 on the same rays (k7_held): the
    60-ball mesh (3,854 triangles) on 2,048 random, coherent and
    surface-respawned rays (tests/test_mesh_accel.py's cases), an overflow
    accel (l_max 16), a ragged last tile (3 x 1,024 + 17 rays) and 77 rays
    that miss everything; then procedural_mesh_scene(500) (32,014
    triangles) on the 196,608 camera rays of 256x192 at 4 spp and their
    first-bounce rays, every tile, with the tile-list prep's time
    (mesh_tile_lists, torch) and its peak memory, and K7's bounds with
    their counts. Returns (vs plain, vs K6)."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import camera as cam
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene, scene_to
    from smallpt_tpu_torch.engine.renderer import make_intersect_fn
    from smallpt_tpu_torch.ops import mesh_accel as ma
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.ops import wavefront as wf

    def rays(kind, n, seed, scene=None):
        r = np.random.default_rng(seed)
        if kind == "random":
            o = r.uniform((5, 5, 25), (95, 75, 145), (n, 3))
            d = r.normal(size=(n, 3))
        else:
            o = np.asarray([50.0, 52.0, 155.0]) + r.uniform(-0.5, 0.5,
                                                            (n, 3))
            d = np.asarray([0.0, -0.04, -1.0]) + r.uniform(-0.08, 0.08,
                                                           (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o = torch.tensor(o, dtype=torch.float32, device=dev)
        d = torch.tensor(d, dtype=torch.float32, device=dev)
        if kind == "surface":
            h = mp.intersect_mesh_pallas(o, d, scene)
            o = o + d * torch.where(torch.isfinite(h.t), h.t, 1.0)[:, None] \
                * 0.999
            d = torch.tensor(r.normal(size=(n, 3)), dtype=torch.float32,
                             device=dev)
            d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        return o, d

    m60 = scene_to(procedural_mesh_scene(60, seed=3), dev)
    acc60 = ma.build_mesh_grid_accel(m60, device=dev)
    tab60 = mp.build_tri_table(m60, device=dev)
    vs_plain = {}
    for kind in ("random", "coherent", "surface"):
        vs_plain[f"mesh60_{kind}_2048"] = k7_held(
            kind, *rays(kind, 2048, 11, m60), acc60, tab60)
    vs_plain["mesh60_overflow_lmax16"] = k7_held(
        "overflow", *rays("random", 2048, 41),
        ma.build_mesh_grid_accel(m60, l_max=16, device=dev), tab60)
    if vs_plain["mesh60_overflow_lmax16"]["overflow_tiles"] != 2:
        raise AssertionError("the l_max 16 accel did not overflow")
    vs_plain["mesh60_ragged_3089"] = k7_held(
        "ragged", *rays("random", 3 * 1024 + 17, 51), acc60, tab60)
    far = torch.tensor([[50.0, 40.0, 1e4]], device=dev).expand(77, 3)
    away = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(77, 3)
    miss = k7_held("all miss", far.contiguous(), away.contiguous(), acc60,
                   tab60)
    if miss["hit_share"] != 0.0:
        raise AssertionError("all-miss rays hit")
    vs_plain["mesh60_all_miss_77"] = miss

    mesh = scene_to(procedural_mesh_scene(500), dev)
    cfg = RenderConfig(width=256, height=192, spp_per_cell=1,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    key = rng.fold_in(rng.base_key(0), 1002)
    sid, _, col, row, cx, cy = cam.sample_indices(cfg, cfg.n_pixels,
                                                  device=dev)
    org, dirs = cam.generate_rays(smallpt_camera(),
                                  rng.camera_uniforms(key, sid), cfg, col,
                                  row, cx, cy)
    nxt = wf.bounce_step(wf.initial_state(org, dirs, 1),
                         make_intersect_fn(mesh, cfg), mesh.material, cfg,
                         key, sid)
    t = time.perf_counter()
    acc = ma.build_mesh_grid_accel(mesh, device=dev)
    build_s = time.perf_counter() - t
    table = mp.build_tri_table(mesh, device=dev)
    vs_k6 = {"accel": dict(build_s=build_s, nb=list(acc.nb),
                           n_chunks=acc.n_chunks,
                           n_glob_chunks=acc.n_glob_chunks,
                           l_max=acc.l_max, n_bins=acc.n_bins,
                           masks_mb=acc.masks.numel() * 4 / 1e6)}
    for name, (o, d) in (("mesh500_256x192_camera", (org, dirs)),
                         ("mesh500_256x192_bounce", (nxt.org, nxt.dir))):
        st = k7_vs_plain(name, o, d, acc)
        args, got = st.pop("args"), st.pop("got")
        vs_plain[name] = st
        cmp = k7_vs_k6(name, table, args, got)
        ot, dt, n = args[0], args[1], args[2]
        valid = torch.arange(ot.shape[1], device=dev) < n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        lists_ms, _ = cuda_ms(lambda: ma.mesh_tile_lists(ot, dt, valid, acc),
                              5, skip_first=True)
        lists_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        k7_ms, _ = cuda_ms(lambda: mp.closest_tri_culled(*args), 5,
                           setup=hold_card)
        k6_ms, _ = cuda_ms(lambda: mp.closest_tri(ot, dt, table), 5,
                           setup=hold_card)
        k6b = k6_bound(ot, dt, table)
        vs_k6[name] = dict(cmp, rays=n, k7_ms=k7_ms, k6_ms=k6_ms,
                           lists_ms=lists_ms,
                           lists_peak_gb_above_inputs=lists_peak,
                           k7_plus_lists_ms=k7_ms + lists_ms,
                           k7_bound_ms=st["bound_ms"],
                           k7_bound_ms_tile_walk=st["bound_ms_tile_walk"],
                           k7_bound_ms_group_union=st[
                               "bound_ms_group_union"],
                           k6_bound_ms=k6b["bound_ms"],
                           k6_bound_ms_every_pair_full=k6b[
                               "bound_ms_every_pair_full"],
                           k6_plan=k6_plan(ot, dt, table),
                           counts=st["counts"],
                           pairs_k6=ot.shape[1] * k6b["valid_rows"],
                           pairs_k6_staged=k6b["pairs"])
    return vs_plain, vs_k6


def flat_culled_path(dev) -> dict:
    """bench.py --mesh's culled variant (bench.py:234-283): path 3's
    configuration (procedural_mesh_scene(500), 256x192, 4 spp, max_depth
    12, FLAT + PALLAS) with MESH_ACCEL_MIN_TRIS = 1, through K7: a pass on
    path 3's key bit-equal to the K6 pass (image and rays), then the
    wavefront main-path measurements (wavefront_path)."""
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene
    from smallpt_tpu_torch.engine import renderer

    mesh, cam = procedural_mesh_scene(500), smallpt_camera()
    cfg = RenderConfig(width=256, height=192, spp_per_cell=1, max_depth=12,
                       scheduler=Scheduler.FLAT, camera_model=CameraModel
                       .LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    key = rng.fold_in(rng.base_key(0), 0)
    name = "flat_culled_mesh500_256x192"
    zero_counts()
    img6, rays6 = renderer.render_with_stats(mesh, cam, cfg, key, device=dev)
    old = renderer.MESH_ACCEL_MIN_TRIS
    renderer.MESH_ACCEL_MIN_TRIS = 1
    try:
        img7, rays7 = renderer.render_with_stats(mesh, cam, cfg, key,
                                                 device=dev)
        launched = counts()
        out = wavefront_path(name, mesh, cam, cfg, dev, "closest_tri_culled")
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old
    torch.cuda.synchronize()
    if not (torch.equal(img6, img7) and int(rays6) == int(rays7)
            and launched["closest_tri"] and launched["closest_tri_culled"]):
        raise AssertionError(f"{name}: the K7 pass differs from the K6 pass "
                             f"({int(rays7)} vs {int(rays6)} rays, "
                             f"launches {launched})")
    out["vs_k6_pass"] = dict(equal=True, rays=int(rays7))
    return out


def mesh_stream_path(name, dev, kernel: str, n_rounds=3) -> dict:
    """bench.py --mesh-stream's shape (bench.py:286-333):
    WavefrontStreamingRenderer on procedural_mesh_scene(500), 256x192,
    max_depth 12, PALLAS; a round is reset(), step(n_bounces=24,
    add_samples=8) and flush(); one warm-up round, then n_rounds timed with
    CUDA events, the launch counts zeroed just before and read just after.
    Gates: the closest-hit kernel ``kernel`` launched and the other mesh
    kernel not, every weight exactly 8 after the flush, a finite image;
    then the first launch of a round and one in its middle (49,152 lanes,
    dead and flushed lanes with their stale rays included) against the
    plain version, bit-equal, with their times and bounds
    (``launches_vs_plain``). Returns the measurements and the last timed
    round's sums (key "sums")."""
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene
    from smallpt_tpu_torch.engine.mesh_stream import (
        WavefrontStreamingRenderer,
    )

    cfg = RenderConfig(width=256, height=192, spp_per_cell=1, max_depth=12,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    r = WavefrontStreamingRenderer(procedural_mesh_scene(500),
                                   smallpt_camera(), cfg, seed=0, device=dev)
    build_s = time.perf_counter() - t

    def round_():
        r.reset()
        r.step(n_bounces=24, add_samples=8)
        r.flush()
        return r.stats.rays

    t = time.perf_counter()
    round_()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    zero_counts()
    round_ms, round_rays = zip(*(cuda_ms(round_, 1) for _ in range(n_rounds)))
    launched = counts()
    other = ("closest_tri" if kernel == "closest_tri_culled"
             else "closest_tri_culled")
    if not launched[kernel] or launched[other]:
        raise AssertionError(f"{name}: launches {launched}")
    rad, w = r.accumulators()
    if not bool((w == 8).all()):
        raise AssertionError(f"{name}: weights {int(w.min())}..{int(w.max())}"
                             ", want 8")
    img = r.image
    if not np.isfinite(img).all() or img.shape != (192, 256, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    sums = (rad.cpu().numpy(), w.cpu().numpy(), img)
    ms = float(np.mean(round_ms))
    rays = float(np.mean(round_rays))
    per_round = launched[kernel] / n_rounds
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the path's own
    launches = launches_vs_plain(name, kernel, round_, per_round,
                                 r.scene)
    kernel_ms = float(np.mean([v["kernel_ms"] for v in launches.values()]))
    return dict(width=256, height=192, spp=8, max_depth=12, n_bounces=24,
                build_s=build_s, first_round_s=warm_s, rounds=n_rounds,
                round_ms=round_ms, ms_per_round=ms, rays=round_rays,
                mrays_per_s=rays / ms / 1e3, launches=launched,
                launches_per_round=per_round, kernel=launches,
                kernel_ms_per_launch=kernel_ms,
                host_ms=ms - per_round * kernel_ms,
                peak_mem_gb=peak_gb,
                mean=float(img.mean()), profile=profile(round_), sums=sums)


def mesh_stream_phases(dev) -> dict:
    """The mesh stream through K6 (the default route) and with
    MESH_ACCEL_MIN_TRIS = 1 through K7, bit-equal to each other (image and
    weights); the K6 stream against the FLAT per-pass image at 8 spp on
    the card under tests/test_mesh_stream.py's gate (isclose(rtol=0.2,
    atol=3*12/spp) on more than 90% of values, means within 8%)."""
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_mesh_scene
    from smallpt_tpu_torch.engine import renderer

    out = {}
    name = "mesh_stream_main_mesh500_256x192"
    out[name] = main = mesh_stream_path(name, dev, "closest_tri")
    rad6, w6, img_s = main.pop("sums")
    spp = 8
    cfg = RenderConfig(width=256, height=192, spp_per_cell=spp // 4,
                       max_depth=12, scheduler=Scheduler.FLAT,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT,
                       intersector=Intersector.PALLAS)
    img_p, _ = renderer.render_with_stats(procedural_mesh_scene(500),
                                          smallpt_camera(), cfg,
                                          rng.base_key(1), device=dev)
    img_p = img_p.cpu().numpy() / spp
    close = float(np.isclose(img_s, img_p, rtol=0.2,
                             atol=3 * 12 / spp).mean())
    mean_rel = float(abs(img_s.mean() - img_p.mean()) / (img_p.mean() + 0.05))
    main["vs_flat_8spp"] = dict(close_share=close, min_close=0.9,
                                mean_rel=mean_rel, max_mean=0.08)
    if not (close > 0.9 and mean_rel < 0.08):
        raise AssertionError(f"{name}: vs FLAT {main['vs_flat_8spp']}")
    phase(name, **main)

    name = "mesh_stream_culled_mesh500_256x192"
    old = renderer.MESH_ACCEL_MIN_TRIS
    renderer.MESH_ACCEL_MIN_TRIS = 1
    try:
        out[name] = culled = mesh_stream_path(name, dev,
                                              "closest_tri_culled")
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old
    rad7, w7, _ = culled.pop("sums")
    if not (np.array_equal(rad6, rad7) and np.array_equal(w6, w7)):
        raise AssertionError(f"{name}: the K7 stream differs from the K6 "
                             "stream")
    culled["vs_k6_stream"] = {"equal": True}
    phase(name, **culled)
    return out


def cli_mesh_phases(dev) -> dict:
    """The CLI's mesh routes on the card, in process: the default route
    (python -m smallpt_tpu_torch 8 --scene mesh --width 256 --height 192
    --max-depth 12 --stats) through MeshStreamProgressiveRenderer and K6;
    --streaming --scene mesh with --checkpoint, then --resume, byte-equal to
    one uninterrupted run of twice the samples."""
    import contextlib
    import io

    from smallpt_tpu_torch import cli

    d = tempfile.mkdtemp(prefix="smallpt_torch_cli_")
    size = ["--width", "256", "--height", "192", "--max-depth", "12"]
    made = []
    real = cli.MeshStreamProgressiveRenderer

    def counted(*a, **k):
        made.append(1)
        return real(*a, **k)

    err = io.StringIO()
    zero_counts()
    cli.MeshStreamProgressiveRenderer = counted
    t = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(["8", "--scene", "mesh", *size, "--stats",
                           "--out", os.path.join(d, "mesh.png")])
    finally:
        cli.MeshStreamProgressiveRenderer = real
    default_s = time.perf_counter() - t
    launched = counts()
    stats = [json.loads(ln) for ln in err.getvalue().splitlines()
             if ln.startswith("{")]
    if (rc != 0 or made != [1] or not launched["closest_tri"]
            or not stats):
        raise AssertionError(f"cli default mesh route: rc {rc}, made {made}, "
                             f"launches {launched}")
    out = {"default_route": dict(seconds=default_s, launches=launched,
                                 last_stats=stats[-1])}
    base = ["8", "--scene", "mesh", "--streaming", *size, "--quiet"]
    ck, a, b, whole = (os.path.join(d, n) for n in (
        "ck.npz", "a.ppm", "b.ppm", "whole.ppm"))
    t = time.perf_counter()
    for argv in ([*base, "--out", a, "--checkpoint", ck],
                 [*base, "--out", b, "--resume", ck],
                 [*base, "--passes", "2", "--out", whole]):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli {argv}")
    with open(b, "rb") as fb, open(whole, "rb") as fw:
        same = fb.read() == fw.read()
    if not same:
        raise AssertionError("cli --streaming --scene mesh: the resumed "
                             "image differs from the uninterrupted one")
    out["streaming_checkpoint_resume"] = dict(
        byte_equal=True, seconds=time.perf_counter() - t)
    return out


# ---------------------------------------------------------------------------
# The binned scheduler (K8, csrc/stream_binned.cu)
# ---------------------------------------------------------------------------

# float ops of a lane's bounce in csrc/stream_binned.cu besides its sweep:
# the frontier escape (three slabs: a division, two subtractions and
# multiplications, min and max each; the entry/exit folds and the finality
# test) ~30, then the hit point, normal, emission, uniforms and shade as the
# megakernel's OPS_PER_BOUNCE. A pending shadow slot's resolve (t_light, the
# cone bound and the direct term) ~60. The sweep, for an alive lane's ray
# and for each pending shadow against each row its tile sweeps: a pair that
# misses (det < 0 or NaN, or a radius that is not positive) OPS_K8_MISS up
# to that decision (the offset 3, b 5, the perpendicular 6, its square 5, a
# square root, det 3, the two compares 2), any other OPS_PER_SPHERE.
OPS_K8_LANE = 30 + OPS_PER_BOUNCE
OPS_K8_RESOLVE = 60
OPS_K8_MISS = 25
# the binned main path: bench.py --procedural-binned's shape
# (bench.py:144-188): procedural_sphere_scene(10000), 512x384, 4 spp,
# max_depth 24, the renderer seeded 1000
BINNED_SEED = 1000


def k8_items(before, args, kw):
    """The items one K8 launch sweeps, from its input state: each alive
    lane's ray and each pending shadow (a slot whose pending bit a lane
    holds: no other slot's fold is read), as (tile (N,) int64, origin and
    direction, six (N,) f32), alive lanes first, then each slot's."""
    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    f, i = before
    t = args[5].shape[0]
    fv = f.view(-1, 8, t, mk._LANE_B)
    iv = i.view(-1, 8, t, mk._LANE_B)
    tile = torch.arange(t, device=f.device)[None, :, None].expand(
        8, t, mk._LANE_B)
    sel = [(iv[mk._I_ALIVE] != 0, 3)]
    sel += [(((iv[mk._I_NEEP] >> s) & 1) == 1, mk._F_LD0 + 3 * s)
            for s in range(len(kw.get("nee_rows", ())))]
    parts = [[tile[m]] + [fv[k][m] for k in (0, 1, 2, p, p + 1, p + 2)]
             for m, p in sel]
    return [torch.cat(x) for x in zip(*parts)]


def k8_pairs(before, args, kw) -> tuple:
    """The (item, row) pairs of one K8 launch (k8_items against every row
    of its tile's chunk sequence on this launch's stops) and those among
    them that do not miss (det >= 0 and a positive radius), counted by the
    plain fold of its inputs: the sphere test's ops up to det, in the
    kernel's order, one sequence position at a time. Returns (pairs, hit
    pairs, rows a tile (T,) numpy)."""
    import torch

    table, lists, stops = args[0], args[5], args[6]
    n_glob, n_chunks = kw["n_glob_chunks"], kw["n_chunks"]
    tile, ox, oy, oz, dx, dy, dz = k8_items(before, args, kw)
    n_seq = n_glob + torch.where(stops < 0, n_chunks, stops).long()
    seq = n_seq[tile]
    order = torch.argsort(seq, descending=True)
    tile, seq = tile[order], seq[order]
    ox, oy, oz, dx, dy, dz = (x[order, None] for x in (ox, oy, oz, dx, dy,
                                                       dz))
    chunks = table.view(-1, 8, 16)
    full = stops.long()[tile] < 0
    lists_l = lists.long()
    l_max = lists.shape[1]
    hits = 0
    for j in range(int(seq[0]) if seq.numel() else 0):
        n = int((seq > j).sum())
        local = j - n_glob
        if local < 0:
            cid = torch.full((n,), j, device=tile.device)
        else:
            cid = n_glob + torch.where(
                full[:n], local, lists_l[tile[:n], min(local, l_max - 1)])
        c = chunks[cid]
        opx = c[:, :, 0] - ox[:n]
        opy = c[:, :, 1] - oy[:n]
        opz = c[:, :, 2] - oz[:n]
        b = opx * dx[:n] + opy * dy[:n] + opz * dz[:n]
        fx = opx - b * dx[:n]
        fy = opy - b * dy[:n]
        fz = opz - b * dz[:n]
        sp = torch.sqrt(fx * fx + fy * fy + fz * fz)
        sr = c[:, :, 3]
        hits += int(((sr - sp) * (sr + sp) >= 0.0).logical_and(
            sr > 0.0).sum())
    rows = 8 * n_seq.cpu().numpy()
    return int(8 * seq.sum()), hits, rows


def k8_bound(before, args, kw) -> dict:
    """The least time of one K8 launch on its inputs (the state before it
    and the wrapper's arguments): per (item, row) pair of k8_pairs,
    OPS_PER_SPHERE where the test does not miss and OPS_K8_MISS where it
    does, OPS_K8_LANE per alive lane and OPS_K8_RESOLVE per pending
    shadow, at the float rate; at the memory rate, a working lane's state
    (alive, or a shadow pending) read once and written once, a lane
    without work its work planes read (alive, and the pending bits with
    NEE) and the four planes it changes written (the candidate, its row,
    the frontier and the pending bit: the rest is its input), the table,
    lists, stops and dcut read once. Beside it, the bound as the
    one-kernel design was held to (bound_ms_every_pair_full): every pair
    at OPS_PER_SPHERE, every lane's whole state in and out."""
    from smallpt_tpu_torch.ops import megakernel as mk

    f, i = before
    table, lists, stops = args[0], args[5], args[6]
    n_slots = len(kw.get("nee_rows", ()))
    pairs, hit_pairs, rows = k8_pairs(before, args, kw)
    alive = i[8 * mk._I_ALIVE:8 * mk._I_ALIVE + 8] != 0
    work = alive | (i[8 * mk._I_NEEP:8 * mk._I_NEEP + 8] != 0) \
        if n_slots else alive
    n_alive, n_work = int(alive.sum()), int(work.sum())
    n_items = k8_items(before, args, kw)[0].numel()
    pend_shadows = n_items - n_alive
    lane_ops = OPS_K8_LANE * n_alive + OPS_K8_RESOLVE * pend_shadows
    ops = (OPS_PER_SPHERE * hit_pairs + OPS_K8_MISS * (pairs - hit_pairs)
           + lane_ops)
    inputs = (table.numel() + lists.numel() + stops.numel()
              + args[7].numel()) * 4
    lane_bytes = (f.shape[0] + i.shape[0]) // 8 * 4
    nbytes = (2 * n_work * lane_bytes
              + (work.numel() - n_work) * 4 * ((2 if n_slots else 1) + 4)
              + inputs)
    pr12 = _bound(OPS_PER_SPHERE * pairs + lane_ops,
                  2 * (f.numel() + i.numel()) * 4 + inputs)
    return _bound(ops, nbytes, pairs=pairs, hit_pairs=hit_pairs,
                  alive=n_alive, pending_shadows=pend_shadows,
                  working_lanes=n_work,
                  rows_per_tile={"mean": float(rows.mean()),
                                 "min": int(rows.min()),
                                 "max": int(rows.max())},
                  bound_ms_every_pair_full=pr12["bound_ms"],
                  bound_by_every_pair_full=pr12["bound_by"])


def capture_binned(fn, which, last: bool = False) -> list:
    """Run fn() with ops/megakernel.py's stream_step_binned wrapped so that
    each of its calls numbered in ``which`` (from 0; None: every call)
    keeps a copy of the state before and after, the rays and the
    arguments: [(before, (f, i, rays), args, kwargs)], in call order; with
    last, the last call too, at the end of the list if ``which`` did not
    hold it. The binned engine updates its state in place, so the copies
    are taken at the call."""
    from smallpt_tpu_torch.ops import megakernel as mk

    real, kept, n, final = mk.stream_step_binned, [], [0], [None]

    def spy(*a, **k):
        keep = which is None or n[0] in which
        n[0] += 1
        before = (a[3].clone(), a[4].clone()) if keep or last else None
        out = real(*a, **k)
        cap = (before, (a[3].clone(), a[4].clone(), out[2]), a, k) \
            if keep or last else None
        if keep:
            kept.append(cap)
        final[0] = None if keep else cap
        return out

    spy.launches = real.launches
    mk.stream_step_binned = spy
    try:
        fn()
    finally:
        mk.stream_step_binned = real
        real.launches = spy.launches
    if last and final[0] is not None:
        kept.append(final[0])
    return kept


def _bits_differ(a, b) -> int:
    """Values whose bits differ (float planes compared as int32, so -0 and
    NaN count)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _max_abs(a, b) -> float:
    import torch

    ok = torch.isfinite(a) & torch.isfinite(b)
    return float((a - b).abs()[ok].max()) if bool(ok.any()) else 0.0


def k8_vs_plain(name, cap, time_it: bool = False) -> dict:
    """One captured K8 launch against the plain version run on a copy of
    its input state: every plane of f and i bit-equal, and the rays equal.
    With time_it also the kernel's CUDA-event time (mean of 5 runs from
    the same input, after one warm-up), the plain version's host time and
    the launch's bound."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    (f0, i0), (fk, ik, rk), args, kw = cap
    table, config, key, _, _, lists, stops, dcut = args[:8]
    fp, ip = f0.clone(), i0.clone()
    k0, k1 = rng.key_words(key)
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, _, rp = mk.stream_step_binned_plain(table, config, k0, k1, fp, ip,
                                           lists, stops, dcut, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    nf, ni = f0.shape[0] // 8, i0.shape[0] // 8
    f_diff = {k: _bits_differ(fk[8 * k:8 * k + 8], fp[8 * k:8 * k + 8])
              for k in range(nf)}
    i_diff = {k: _bits_differ(ik[8 * k:8 * k + 8], ip[8 * k:8 * k + 8])
              for k in range(ni)}
    out = dict(lanes=f0.shape[1] * 8, rays=int(rk), plain_rays=int(rp),
               f_planes_differ={k: v for k, v in f_diff.items() if v},
               i_planes_differ={k: v for k, v in i_diff.items() if v},
               max_abs_err=_max_abs(fk, fp), plain_ms=plain_ms,
               pending_after=int((ik[8 * mk._I_PEND:8 * mk._I_PEND + 8]
                                  != 0).sum()),
               full_sweep_tiles=int((stops < 0).sum()),
               finite_dcut_tiles=int(torch.isfinite(dcut).sum()))
    if out["f_planes_differ"] or out["i_planes_differ"] or int(rk) != int(rp):
        raise AssertionError(f"{name}: K8 differs from its plain version: "
                             f"{out}")
    if time_it:
        f, i = f0.clone(), i0.clone()
        a = list(args)
        a[3], a[4] = f, i
        # the card is held busy (hold_card) before each timed launch: a
        # drain's last launches take less time on the card than the
        # wrapper on the host
        k_ms, _ = cuda_ms(lambda: mk.stream_step_binned(*a, **kw)[2], 6,
                          setup=lambda: (f.copy_(f0), i.copy_(i0),
                                         hold_card()),
                          skip_first=True)
        out.update(kernel_ms=k_ms, **k8_bound((f0, i0), args, kw))
    return out


def k8_full_sweep(name, cap) -> dict:
    """The captured launch again with every tile forced to the all-chunks
    sweep (stops -1, dcut +inf): every lane the culled launch did not
    leave pending has the same bits in every plane (a culled sweep never
    drops a hit, and the winner does not depend on the order)."""
    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    (f0, i0), (fk, ik, _), args, kw = cap
    a = list(args)
    a[3], a[4] = f0.clone(), i0.clone()
    a[6] = torch.full_like(args[6], -1)
    a[7] = torch.full_like(args[7], float("inf"))
    mk.stream_step_binned(*a, **kw)
    torch.cuda.synchronize()
    keep = ik[8 * mk._I_PEND:8 * mk._I_PEND + 8] == 0
    n_f, n_i = f0.shape[0] // 8, i0.shape[0] // 8
    bad = 0
    for buf_k, buf_s, n in ((fk, a[3], n_f), (ik, a[4], n_i)):
        for k in range(n):
            x, y = buf_k[8 * k:8 * k + 8], buf_s[8 * k:8 * k + 8]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            bad += int(((x != y) & keep).sum())
    out = dict(lanes_compared=int(keep.sum()),
               lanes_pending_in_culled=int((~keep).sum()), values_differ=bad)
    if bad:
        raise AssertionError(f"{name}: culled launch != full sweep: {out}")
    return out


def k8_small_case(name, scene, cfg, dev, spp: int, **kw) -> dict:
    """A drain (step(spp, 4), flush) of a BinnedStreamingRenderer on the
    card with every K8 launch captured: each against its plain version
    (bit-equal), the first against the all-chunks sweep; the weights
    exactly spp. Returns the counts and the accumulators."""
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer

    r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg, seed=0,
                                device=dev, **kw)

    def drain():
        r.step(add_samples=spp, n_bounces=4)
        r.flush()

    caps = capture_binned(drain, None)
    rad, w = r.accumulators()
    if not bool((w == spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {spp}")
    checks = [k8_vs_plain(f"{name}/launch {n}", c)
              for n, c in enumerate(caps)]
    out = dict(launches=len(caps), rays=sum(c["rays"] for c in checks),
               max_abs_err=max(c["max_abs_err"] for c in checks),
               pending_lanes=sum(c["pending_after"] for c in checks),
               full_sweep_tiles=sum(c["full_sweep_tiles"] for c in checks),
               finite_dcut_tiles=sum(c["finite_dcut_tiles"] for c in checks),
               first_vs_full_sweep=k8_full_sweep(name, caps[0]))
    return out, rad.cpu(), w.cpu()


def k8_small_phases(dev) -> dict:
    """K8 against its plain version on every launch of small drains
    (tests/test_binned.py's scene and config): pinhole, the AOV modes,
    the thin lens with the environment light, NEE on two and three lights
    (the kernel's two NEE instances), a list
    capacity of 2 (every tile on the all-chunks fallback: the image
    bit-equal to the culled one, as tests/test_binned.py:69 pins), and a
    near prefix of one chunk with four lanes a pixel on 600 spheres (lanes
    pend and march)."""
    import dataclasses

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Mode, RenderConfig,
    )
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene
    from smallpt_tpu_torch.engine.binned import build_accel_for_camera

    scene = procedural_sphere_scene(80, seed=3)
    cfg = RenderConfig(width=24, height=16, spp_per_cell=1, max_depth=10,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    cases = {
        "proc80_24x16": (scene, cfg, 2, {}),
        "proc80_uv": (scene, cfg.replace(mode=Mode.UV), 2, {}),
        "proc80_inst_id": (scene, cfg.replace(mode=Mode.INST_ID), 2, {}),
        "proc80_normal": (scene, cfg.replace(mode=Mode.NORMAL), 2, {}),
        "proc80_emission": (scene, cfg.replace(mode=Mode.EMISSION), 2, {}),
        "proc80_lens_env": (scene, cfg.replace(
            aperture=3.0, focal_distance=112.0,
            env_emission=(0.2, 0.3, 0.4)), 3, {}),
        "proc80_nee_8_3": (scene, cfg.replace(nee_lights=(8, 3)), 3, {}),
        # three lights: the kernel's instance with the slots in local
        # memory (the one above holds two in registers)
        "proc80_nee_8_3_6": (scene, cfg.replace(nee_lights=(8, 3, 6)), 2,
                             {}),
        "proc600_48x32_knear1_inflight4": (
            procedural_sphere_scene(600, seed=7),
            cfg.replace(width=48, height=32, nee_lights=(8,)), 4,
            {"k_near": 1, "inflight": 4}),
    }
    out, imgs = {}, {}
    for name, (sc, c, spp, kw) in cases.items():
        out[name], imgs[name], _ = k8_small_case(
            name, sc, c, dev, spp, **{"inflight": 1, **kw})
    # the all-chunks fallback: a 2-chunk list overflows on every tile
    for name in ("proc80_24x16", "proc80_nee_8_3", "proc80_uv"):
        sc, c, spp, _ = cases[name]
        # the renderer's own grid and chunks, a list capacity of 2
        accel = dataclasses.replace(
            build_accel_for_camera(sc, smallpt_camera(), c, device=dev),
            l_max=2)
        st, img, _ = k8_small_case(name + "_lmax2", sc, c, dev, spp,
                                   accel=accel, inflight=1)
        if not bool((img == imgs[name]).all()):
            raise AssertionError(f"{name}: the all-chunks sweep's image "
                                 "differs from the culled one")
        st["image_equals_culled"] = True
        out[name + "_lmax2"] = st
    return out


def k8_plan_check(name, lib_path, before, args, kw) -> dict:
    """K8's compaction and plan (csrc/stream_binned.cu
    binned_compact_kernel, binned_plan_kernel) run on the card through the
    library start_k8_check built, on one launch's input state and stops,
    held bit for bit to their plain versions on the same inputs: each
    tile's items (k8_items), the cut and each tile's ranges
    (ops/megakernel.py::_k8_cut at the fill the device reports) and the
    tiles' first units; the library's kGroup and kMinRange against
    _k8_cut's. Returns the device's plan: the fill, the items, groups,
    units, the range length (None: no cut) and the most ranges a group."""
    import ctypes

    import torch

    from smallpt_tpu_torch.ops import megakernel as mk

    lib = ctypes.CDLL(str(lib_path))
    lib.k8_plan.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.k8_plan.restype = ctypes.c_int
    lib.smallpt_stream_binned_scratch_words.argtypes = [ctypes.c_int] * 2
    lib.smallpt_stream_binned_scratch_words.restype = ctypes.c_longlong
    consts = (ctypes.c_int * 2)()
    lib.k8_constants(consts)
    if tuple(consts) != (mk._K8_GROUP, mk._K8_MIN_RANGE):
        raise AssertionError(f"{name}: kGroup, kMinRange {tuple(consts)} "
                             f"!= _k8_cut's {mk._K8_GROUP}, "
                             f"{mk._K8_MIN_RANGE}")
    i0, stops = before[1], args[6]
    n_cols, n_tiles = i0.shape[1], stops.shape[0]
    n_l = len(kw.get("nee_rows", ()))
    n_words = lib.smallpt_stream_binned_scratch_words(n_cols, n_l)
    scratch = torch.empty(n_words, dtype=torch.int32, device=i0.device)
    got = torch.empty(3 * n_tiles + 2, dtype=torch.int32, device=i0.device)
    fill = ctypes.c_int(0)
    err = lib.k8_plan(i0.data_ptr(), stops.data_ptr(), scratch.data_ptr(),
                      got.data_ptr(), n_cols, n_l, kw["n_glob_chunks"],
                      kw["n_chunks"], ctypes.byref(fill),
                      torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"{name}: k8_plan: CUDA error {err}")
    got = got.cpu().numpy().astype(np.int64)
    d_cut, d_items = int(got[0]), got[1:1 + n_tiles]
    d_nr, d_base = got[1 + n_tiles:1 + 2 * n_tiles], got[1 + 2 * n_tiles:]
    n_items = torch.bincount(k8_items(before, args, kw)[0],
                             minlength=n_tiles).cpu().numpy()
    st = stops.cpu().numpy().astype(np.int64)
    n_seq = kw["n_glob_chunks"] + np.where(st < 0, kw["n_chunks"], st)
    cut, nr = mk._k8_cut(n_items, n_seq, fill.value)
    groups = -(-n_items // mk._K8_GROUP)
    base = np.concatenate([[0], np.cumsum(groups * nr)])
    no_cut = 0x7fffffff  # the plan's L when no sequence is cut
    same = dict(items=bool((d_items == n_items).all()),
                cut=d_cut == (no_cut if cut is None else cut),
                ranges=bool((d_nr == nr).all()),
                unit_base=bool((d_base == base).all()))
    if not all(same.values()):
        raise AssertionError(f"{name}: K8's plan on the card differs from "
                             f"_k8_cut: {same}; device L {d_cut}, plain "
                             f"{cut}")
    return dict(fill=fill.value, items=int(d_items.sum()),
                groups=int(groups.sum()), units=int(d_base[-1]),
                cut_chunks=None if d_cut == no_cut else d_cut,
                ranges_max=int(d_nr.max()), plan_bit_equal=True)


def k8_constructed(scene, cfg, dev, lib_path) -> dict:
    """Two K8 launches built for the design's edges, each against its
    plain version bit for bit and timed: one with no working lane (a real
    launch's input with every alive and pending bit cleared), and one
    whose dense tile's items the plan must cut into ranges (one tile of
    8,192 lanes, 64x32 at four lanes a pixel, all alive with pending NEE
    shadows, on the 10,000-sphere scene with every chunk swept: stops -1,
    dcut +inf). Each one's plan is the device's (k8_plan_check, held to
    _k8_cut on the same inputs), and so is the plan of the real launch
    the first is built from (every lane working) and of that drain's last
    launch (a few lanes left)."""
    import torch

    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk

    def run(name, cap, f0, i0, stops=None, dcut=None):
        a = list(cap[2])
        if stops is not None:
            a[6], a[7] = stops, dcut
        kw = cap[3]
        plan = k8_plan_check(name, lib_path, (f0, i0), a, kw)
        f, i = f0.clone(), i0.clone()
        a[3], a[4] = f, i
        rays = mk.stream_step_binned(*a, **kw)[2]
        torch.cuda.synchronize()
        out = k8_vs_plain(name, ((f0, i0), (f, i, rays), tuple(a), kw),
                          time_it=True)
        out.update(plan)
        return out

    nee = cfg.replace(nee_lights=(8,))
    r = BinnedStreamingRenderer(scene, smallpt_camera(), nee, seed=0,
                                device=dev)

    def drain():
        r.step(add_samples=1, n_bounces=2)
        r.flush()

    cap, last = capture_binned(drain, {1}, last=True)
    out = {k: k8_plan_check(f"k8 {k} plan", lib_path, c[0], c[2], c[3])
           for k, c in (("real_launch", cap), ("drain_last_launch", last))}
    f0, i0 = (x.clone() for x in cap[0])
    for k in (mk._I_ALIVE, mk._I_NEEP):
        i0[8 * k:8 * k + 8] = 0
    out["no_working_lane"] = run("k8 no working lane", cap, f0, i0)
    if out["no_working_lane"]["items"] != 0:
        raise AssertionError(f"no working lane: {out['no_working_lane']}")

    small = nee.replace(width=64, height=32)
    r = BinnedStreamingRenderer(scene, smallpt_camera(), small, seed=0,
                                inflight=4, device=dev)
    cap = capture_binned(lambda: r.step(add_samples=4, n_bounces=2),
                         {1})[0]
    f0, i0 = cap[0]
    stops = torch.full_like(cap[2][6], -1)
    dcut = torch.full_like(cap[2][7], float("inf"))
    dense = run("k8 dense tile cut", cap, f0, i0, stops, dcut)
    if f0.shape[1] != mk._LANE_B or dense["cut_chunks"] is None \
            or dense["ranges_max"] < 2 or dense["pending_shadows"] == 0:
        raise AssertionError(f"dense tile: no cut into ranges: {dense}")
    out["dense_tile_cut"] = dense
    return out


# K8's early-miss sphere test beside lane.cuh's sphere_tt, and K8's
# compaction and plan alone, built from the checkout's stream_binned.cu
# into one small library for these checks
K8_CHECK_CU = r"""
#include "stream_binned.cu"

__global__ void k8_sphere_pairs_kernel(const float* ray, const float* sph,
                                       float* out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const float* a = ray + 6 * k;
  const float* s = sph + 5 * k;
  out[2 * k] = sphere_tt_miss_first(a[0], a[1], a[2], a[3], a[4], a[5],
                                    s[0], s[1], s[2], s[3], s[4]);
  out[2 * k + 1] = smallpt::sphere_tt(a[0], a[1], a[2], a[3], a[4], a[5],
                                      s[0], s[1], s[2], s[3], s[4]);
}

extern "C" int k8_sphere_pairs(const void* ray, const void* sph, void* out,
                               int n, void* stream) {
  k8_sphere_pairs_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ray, (const float*)sph, (float*)out, n);
  return (int)cudaGetLastError();
}

// {kGroup, kMinRange}
extern "C" void k8_constants(int* out) {
  out[0] = kGroup;
  out[1] = kMinRange;
}

// K8's compaction and plan on one launch's int planes i and stops, into
// scratch (smallpt_stream_binned_scratch_words words on this device); out
// (3 T + 2 int32 on the device) gets {L, n_items[T], nr[T],
// unit_base[T + 1]}, *fill the plan's fill on this device.
extern "C" int k8_plan(const void* i, const void* stops, void* scratch,
                       void* out, int n_cols, int n_l, int n_glob,
                       int n_chunks, int* fill, void* stream) {
  Fit fit;
  cudaError_t err = device_fit(&fit);
  if (err != cudaSuccess) return (int)err;
  *fill = fit.fill;
  const cudaStream_t s = (cudaStream_t)stream;
  const int t = n_cols / kLaneB;
  const Scratch sc = carve((int*)scratch, n_cols, n_l, fit.fill);
  if ((err = plan((const int*)i, (const int*)stops, n_cols, n_l, n_glob,
                  n_chunks, fit.fill, sc, s)) != cudaSuccess)
    return (int)err;
  int* o = (int*)out;
  const cudaMemcpyKind d2d = cudaMemcpyDeviceToDevice;
  if ((err = cudaMemcpyAsync(o, sc.cut, sizeof(int), d2d, s)) ||
      (err = cudaMemcpyAsync(o + 1, sc.n_items, t * sizeof(int), d2d, s)) ||
      (err = cudaMemcpyAsync(o + 1 + t, sc.nr, t * sizeof(int), d2d, s)))
    return (int)err;
  return (int)cudaMemcpyAsync(o + 1 + 2 * t, sc.unit_base,
                              (t + 1) * sizeof(int), d2d, s);
}
"""


def start_k8_check():
    """Start nvcc on K8_CHECK_CU (its library beside the port's, in
    _build/): (the library's path, the nvcc process), to be waited for."""
    from smallpt_tpu_torch.utils import nvcc

    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = nvcc.BUILD_DIR / "k8_check.cu"
    src.write_text(K8_CHECK_CU)
    lib_path = nvcc.BUILD_DIR / f"libk8_check_{os.getpid()}.so"
    return lib_path, subprocess.Popen(
        [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-I", str(nvcc.CSRC_DIR), "-o",
         str(lib_path), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def k8_sphere_edges(dev, lib_path) -> dict:
    """K8's sphere test with the miss decided first
    (stream_binned.cu::sphere_tt_miss_first) against lane.cuh::sphere_tt,
    which every other sphere kernel calls, bit for bit on the card, through
    the library start_k8_check built: rays tangent to the sphere
    (and 1-3 ulp off), NaN in each input, radius 0, -0 and negative,
    origins inside and outside pointing toward and away, the Cornell box's
    1e5 walls, and 200,000 random pairs at the 10,000-sphere scene's
    scale."""
    import ctypes

    import torch

    fn = ctypes.CDLL(str(lib_path)).k8_sphere_pairs
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    f32 = np.float32
    rays, sph, kinds = [], [], []

    def add(kind, o, d, c, r, eps=1e-4):
        rays.append([*o, *d])
        sph.append([*c, r, eps])
        kinds.append(kind)

    nan = float("nan")
    for c, r in (((0.0, 0.0, 0.0), 1.0), ((50.0, 40.0, 80.0), 16.5),
                 ((27.0, 16.5, 47.0), 16.5)):
        cx, cy, cz = c
        for k in range(-3, 4):
            y = f32(cy + r)
            for _ in range(abs(k)):
                y = np.nextafter(y, f32(np.inf if k > 0 else -np.inf))
            add("tangent", (cx - 100.0, float(y), cz), (1.0, 0.0, 0.0), c, r)
            add("tangent", (cx, cy - 3 * r, float(f32(cz - r))),
                (0.0, 1.0, 0.0), c, r)
        add("inside", (cx + 0.3 * r, cy + 0.2 * r, cz - 0.1 * r),
            (0.6, 0.0, 0.8), c, r)
        add("inside", (cx, cy, cz), (0.0, 0.0, -1.0), c, r)
        add("outside_toward", (cx - 3 * r, cy + 0.5 * r, cz),
            (1.0, 0.0, 0.0), c, r)
        add("outside_away", (cx - 3 * r, cy + 0.5 * r, cz),
            (-1.0, 0.0, 0.0), c, r)
        add("outside_miss", (cx - 3 * r, cy + 2 * r, cz), (1.0, 0.0, 0.0),
            c, r)
        for rr in (0.0, -0.0, -r):
            add("radius", (cx - 3 * r, cy, cz), (1.0, 0.0, 0.0), c, rr)
        for slot in range(11):
            v = [cx - 3 * r, cy, cz, 1.0, 0.0, 0.0, cx, cy, cz, r, 1e-4]
            v[slot] = nan
            add("nan", v[:3], v[3:6], v[6:9], v[9], v[10])
    # the Cornell box's walls: 1e5 spheres seen from inside the box
    for c in ((1e5 + 1, 40.8, 81.6), (-1e5 + 99, 40.8, 81.6),
              (50, 40.8, 1e5), (50, 1e5, 81.6), (50, -1e5 + 81.6, 81.6)):
        for d in ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.6, -0.8),
                  (0.0, -0.6, 0.8), (0.48, 0.6, 0.64)):
            add("wall", (50.0, 52.0, 95.6), d, c, 1e5, 1e5 * 1e-4)
    rng = np.random.default_rng(14)
    n_rand = 200_000
    o = rng.uniform(-20, 120, (n_rand, 3))
    d = rng.normal(size=(n_rand, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = rng.uniform(-20, 120, (n_rand, 3))
    r = rng.uniform(0.2, 6.0, (n_rand, 1))
    edge = np.asarray(rays, f32), np.asarray(sph, f32)
    ray_a = np.concatenate([edge[0], np.hstack([o, d]).astype(f32)])
    sph_a = np.concatenate([edge[1], np.hstack(
        [c, r, 1e-4 * np.ones_like(r)]).astype(f32)])
    n = len(ray_a)
    ray_t = torch.tensor(ray_a, device=dev)
    sph_t = torch.tensor(sph_a, device=dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = fn(ray_t.data_ptr(), sph_t.data_ptr(), out.data_ptr(), n,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"k8_sphere_pairs: CUDA error {err}")
    bits = out.view(torch.int32)
    differ = (bits[:, 0] != bits[:, 1]).cpu().numpy()
    hit = (out[:, 1] < 3e38).cpu().numpy()
    kinds += ["random"] * n_rand
    by_kind = {}
    for k, df, h in zip(kinds, differ, hit):
        e = by_kind.setdefault(k, {"pairs": 0, "hits": 0, "differ": 0})
        e["pairs"] += 1
        e["hits"] += int(h)
        e["differ"] += int(df)
    result = dict(pairs=n, differ=int(differ.sum()), by_kind=by_kind)
    if result["differ"]:
        raise AssertionError(f"K8's early-miss test differs from "
                             f"sphere_tt: {result}")
    return result


def binned_path(name, scene, cfg, dev, drain: bool,
                n_rounds: int = 3) -> dict:
    """A binned main path at full width (procedural_sphere_scene(10000)):
    the per-pass drain (ProgressiveRenderer, route "binned", a pass =
    reset, budget spp, 8 bounces, flush) or the stream round
    (BinnedStreamingRenderer: reset, step(spp, 8), flush, as
    bench.py::bench_binned), one warm-up, then n_rounds timed with CUDA
    events, the launch counts zeroed just before and read just after; the
    weights exactly spp; the first launch of a pass, one in its middle and
    its last (in the flush) against the plain version (bit-equal), timed,
    with their bounds; the
    first against the all-chunks sweep; the device's busy share (profiler);
    the host part; the peak memory and K8's scratch a launch; the tile
    lists alone (time, peak memory above their inputs)."""
    import torch

    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.ops import accel as acc
    from smallpt_tpu_torch.ops import megakernel as mk

    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    if drain:
        r = ProgressiveRenderer(scene, smallpt_camera(), cfg,
                                seed=BINNED_SEED, device=dev)
        if r.route != "binned":
            raise AssertionError(f"{name}: route {r.route}, not binned")
        br = r._binned

        def round_():
            r.step()
    else:
        r = br = BinnedStreamingRenderer(scene, smallpt_camera(), cfg,
                                         seed=BINNED_SEED, device=dev)

        def round_():
            r.reset()
            r.step(add_samples=cfg.spp, n_bounces=8)
            r.flush()
    round_()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_build
    zero_counts()
    rays = []
    round_ms = []
    for _ in range(n_rounds):
        ms_, _ = cuda_ms(round_, 1)
        round_ms.append(ms_)
        rays.append(br.stats.rays)
    launched = counts()
    k8_n = launched["stream_step_binned"]
    if not k8_n or any(v for k, v in launched.items()
                       if k != "stream_step_binned"):
        raise AssertionError(f"{name}: launches {launched}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, w = br.accumulators()
    if not bool((w == cfg.spp).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}, want {cfg.spp}")
    img = (r.image if drain else br.image)
    if not np.isfinite(img).all() or img.shape != (cfg.height, cfg.width, 3):
        raise AssertionError(f"{name}: image not finite {img.shape}")
    per_round = k8_n / n_rounds
    caps = capture_binned(round_, {0, int(per_round) // 2}, last=True)
    kernel = {k: k8_vs_plain(f"{name}/{k}", c, time_it=True)
              for k, c in zip(("first", "middle", "last"), caps)}
    full = k8_full_sweep(name, caps[0])
    # the tile lists of the first launch alone: time and peak memory above
    # their inputs
    (f0, i0), _, args, kw = caps[0]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lists_ms, _ = cuda_ms(lambda: acc.tile_work_lists_bucketed(
        f0, i0, cfg, br.accel, k_near=br.k_near), 3)
    lists_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    # the scratch each K8 call takes from the allocator (items, plan,
    # partials: csrc/stream_binned.cu scratch_words on this card)
    k8_scratch_mb = mk._binned_lib()[1](
        f0.shape[1], len(kw.get("nee_rows", ()))) * 4 / 1e6
    ms = float(np.mean(round_ms))
    kernel_ms = float(np.mean([v["kernel_ms"] for v in kernel.values()]))
    ray_mean = float(np.mean(rays))
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                max_depth=cfg.max_depth, nee=list(cfg.nee_lights),
                inflight=br.inflight, tiles=int(f0.shape[1] // mk._LANE_B),
                chunks=br.accel.n_chunks, grid=list(br.accel.nb),
                first_round_s=warm_s, rounds=n_rounds, launches=launched,
                launches_per_round=per_round, round_ms=round_ms,
                ms_per_round=ms, rays=rays, mrays_per_s=ray_mean / ms / 1e3,
                kernel=kernel, kernel_ms_per_launch=kernel_ms,
                host_ms=ms - per_round * kernel_ms,
                first_vs_full_sweep=full, lists_ms=lists_ms,
                lists_peak_gb=lists_peak_gb, peak_mem_gb=peak_gb,
                k8_scratch_mb=k8_scratch_mb, mean=float(img.mean()),
                profile=profile(round_))


def binned_vs_classic(scene, cfg, dev) -> dict:
    """With one lane a pixel the binned stream and the classic streaming
    route (K1c's global-sweep instance) draw the same samples (streaming
    keying v2, ip = s_idx): on the main path's scene and config (4 spp),
    without and with NEE, the binned image against the classic one under
    the JAX suite's gate for this scene class (MAX_FRAC_PROCEDURAL), with
    weights exactly 4 in both."""
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer

    out = {}
    for name, c in (("procedural10000_512x384", cfg),
                    ("procedural10000_512x384_nee",
                     cfg.replace(nee_lights=(8,)))):
        b = BinnedStreamingRenderer(scene, smallpt_camera(), c,
                                    seed=BINNED_SEED, inflight=1, device=dev)
        b.step(add_samples=4, n_bounces=8)
        b.flush()
        rad_b, w_b = (x.cpu().numpy() for x in b.accumulators())
        k = StreamingRenderer(scene, smallpt_camera(), c, seed=BINNED_SEED,
                              dda=False, device=dev)
        k.step(n_iters=10_000_000, add_samples=4)
        k.flush()
        rad_c, w_c = (x.cpu().numpy() for x in k.accumulators())
        if not ((w_b == 4).all() and (w_c == 4).all()):
            raise AssertionError(f"{name}: weights not exactly 4")
        st = gate(rad_b / 4, rad_c / 4, MAX_FRAC_PROCEDURAL)
        st.update(values_bit_equal=float((rad_b == rad_c).mean()),
                  rays_binned=b.stats.rays, rays_classic=k.stats.rays)
        out[name] = st
    return out


def h4_ab(scene, cfg, dev) -> dict:
    """ROADMAP.md hazard H4: the binned drain (the port's route for a MEGA
    sphere scene above MEGA_MAX_SPHERES, as the JAX package's) beside REGEN
    through K2 on the same scene, config and pass keys: passes in the
    order binned, REGEN, REGEN, binned after one warm-up each (CUDA
    events), rays and Mrays/s, the images' means."""
    import torch

    from smallpt_tpu_torch.config import Intersector, Scheduler
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer

    rs = {"binned": ProgressiveRenderer(scene, smallpt_camera(), cfg,
                                        device=dev),
          "regen_k2": ProgressiveRenderer(
              scene, smallpt_camera(), cfg.replace(
                  scheduler=Scheduler.REGEN,
                  intersector=Intersector.PALLAS), device=dev)}
    if rs["binned"].route != "binned" or rs["regen_k2"].route != "regen":
        raise AssertionError("H4: unexpected routes")
    for r in rs.values():
        r.step()
    torch.cuda.synchronize()
    ms = {k: [] for k in rs}
    rays = {k: [] for k in rs}
    for k in ("binned", "regen_k2", "regen_k2", "binned"):
        r0 = rs[k].stats.rays
        ms[k].append(cuda_ms(rs[k].step, 1)[0])
        rays[k].append(rs[k].stats.rays - r0)
    out = {}
    for k in rs:
        m = float(np.mean(ms[k]))
        out[k] = dict(pass_ms=ms[k], ms_per_pass=m, rays=rays[k],
                      mrays_per_s=float(np.mean(rays[k])) / m / 1e3,
                      mean=float(rs[k].image.mean()))
    out["binned_over_regen_time"] = (out["binned"]["ms_per_pass"]
                                     / out["regen_k2"]["ms_per_pass"])
    out["faster"] = ("binned" if out["binned_over_regen_time"] < 1
                     else "regen_k2")
    return out


def cli_binned_phases(dev) -> dict:
    """The CLI's binned routes in process, through K8: the default route
    of a sphere scene above 2048 spheres (BinnedProgressiveRenderer) at
    bench.py's shape, and --binned with NEE: 4 spp with --checkpoint, then
    4 more with --resume, byte-equal to one run of 8."""
    import torch

    from smallpt_tpu_torch import cli

    tmp = tempfile.mkdtemp(prefix="smallpt_torch_cli_binned_")
    out = {}
    zero_counts()
    t = time.perf_counter()
    png = os.path.join(tmp, "procedural.ppm")
    cli.main(["4", "--scene", "procedural", "--width", "512", "--height",
              "384", "--max-depth", "24", "--out", png, "--quiet"])
    torch.cuda.synchronize()
    launched = counts()
    if not launched["stream_step_binned"] or any(
            v for k, v in launched.items() if k != "stream_step_binned"):
        raise AssertionError(f"CLI default big-scene route: {launched}")
    out["default_route"] = dict(seconds=time.perf_counter() - t,
                                launches=launched,
                                bytes=os.path.getsize(png))
    common = ["4", "--scene", "procedural", "--binned", "--nee", "8",
              "--width", "256", "--height", "192", "--max-depth", "12",
              "--quiet"]
    ck = os.path.join(tmp, "ck.npz")
    one, a, b = (os.path.join(tmp, n) for n in ("one.ppm", "a.ppm",
                                                "b.ppm"))
    zero_counts()
    cli.main(common + ["--out", a, "--checkpoint", ck])
    cli.main(common + ["--out", b, "--resume", ck])
    cli.main(common + ["--out", one, "--passes", "2"])
    launched = counts()
    with open(b, "rb") as fb, open(one, "rb") as fo:
        same = fb.read() == fo.read()
    if not same or not launched["stream_step_binned"]:
        raise AssertionError(f"--binned resume not byte-equal to one run "
                             f"({launched})")
    out["binned_checkpoint_resume"] = dict(byte_equal=True,
                                           launches=launched)
    return out


# ---------------------------------------------------------------------------
# The gradient path (grad/): the recording megakernel K1b, the replay
# differentiator over it, and the scan differentiator over K2
# ---------------------------------------------------------------------------

# BASELINE config 4 (bench.py --diff, :335-399): Cornell, 512x512, 4 spp,
# max_depth 16, the replay differentiator; nothing cut.
GRAD_W = GRAD_H = 512
GRAD_DEPTH = 16


def grad_config(**kw):
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig,
    )

    base = dict(width=GRAD_W, height=GRAD_H, spp_per_cell=1,
                max_depth=GRAD_DEPTH, camera_model=CameraModel.LEGACY,
                filter=Filter.TENT, intersector=Intersector.PALLAS)
    base.update(kw)
    return RenderConfig(**base)


def ptxas_entry(lib: str, symbol: str = "") -> list:
    """ptxas's register lines and its stack and spill lines, from this
    process's build of library lib, of the entries whose mangled name holds
    symbol (the shared-memory instance of K1b, say; every entry by
    default)."""
    from smallpt_tpu_torch.utils import nvcc

    out, inside = [], not symbol
    for ln in nvcc.builds.get(lib, {}).get("ptxas", "").splitlines():
        if "Compiling entry" in ln:
            inside = symbol in ln
        elif inside and ("registers" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def record_strict(name, got, want, check: bool = True) -> dict:
    """One K1b launch's (radiance, rays, winners) against its plain
    version's on the same inputs, strictly, on every lane: the radiance
    compared as int32, the rays, and the lane's winner at every depth.
    Returns the lanes that differ an output (``planes``) and their sum
    (``lanes_differ``), the lanes, rays and hit entries, and the
    radiance's max_abs_err; raises unless lanes_differ is 0 (check)."""
    import torch

    torch.cuda.synchronize()
    rad, rays, rec = got[:3]
    prad, prays, prec = want[:3]
    differ = (("radiance", (rad.view(torch.int32)
                            != prad.view(torch.int32)).any(dim=1)),
              ("rays", rays != prays), ("winners", (rec != prec).any(dim=0)))
    planes = {k: int(v.sum()) for k, v in differ if bool(v.any())}
    out = dict(planes=planes, lanes_differ=sum(planes.values()),
               lanes=int(rays.shape[0]), rays=int(rays.sum()),
               hit_entries=int((rec >= 0).sum()),
               max_abs_err=float((rad - prad).abs().max()))
    K1_STRICT["mega_record"].append(out["lanes_differ"])
    if check and out["lanes_differ"]:
        raise AssertionError(f"{name}: K1b's output differs from the plain "
                             f"version's: {planes}")
    return out


def record_launch_vs_plain(name, table, camv, cfg, key, ns,
                           k_samples: int = 1, ip_offset: int = 0) -> dict:
    """One K1b launch over the frame's k_samples in-pixel samples from
    ip_offset (mk._record_launch, uncounted) against the plain version
    (record_strict), with its queue (k1_queue: every lane handed out once,
    each with work) and its plan."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk

    k0, k1 = rng.key_words(key)
    rad, rays, rec, queue = mk._record_launch(table, camv, cfg, k0, k1,
                                              ip_offset, 0, cfg.height, ns,
                                              k_samples)
    want = mk.record_pass_plain(table, camv, cfg, k0, k1, ip_offset,
                                n_spheres=ns, k_samples=k_samples)
    n = int(rays.shape[0])
    return dict(strict=record_strict(name, (rad, rays, rec), want),
                queue=k1_queue(name, queue, n, n),
                plan=mk.mega_plan(n, ns, len(cfg.nee_lights), "record"))


def record_vs_plain_small(dev) -> dict:
    """K1b against its plain version, in-pixel samples 0 and 1 of Cornell
    32x24 at depth 6, Cornell with the thin lens and the environment light,
    and procedural_sphere_scene(2048) (K1b's largest route)."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.ops import megakernel as mk

    leg = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT,
               spp_per_cell=1, width=32, height=24)
    cases = {
        "cornell_32x24_depth6": (cornell_box_scene(),
                                 RenderConfig(max_depth=6, **leg)),
        "cornell_lens_env_32x24": (cornell_box_scene(), RenderConfig(
            max_depth=8, aperture=4.0, focal_distance=120.0,
            env_emission=(0.2, 0.3, 0.4), **leg)),
        "procedural2048_32x24": (procedural_sphere_scene(2048),
                                 RenderConfig(max_depth=6, **leg)),
    }
    out = {}
    for name, (scene, cfg) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(smallpt_camera(), cfg, dev)
        key = rng.base_key(3)
        for s in range(2):
            got = mk.mega_record(table, camv, cfg, key, s,
                                 n_spheres=scene.n_spheres)
            want = mk.record_pass_plain(table, camv, cfg,
                                        *rng.key_words(key), s,
                                        n_spheres=scene.n_spheres)
            out[f"{name}/s{s}"] = record_strict(f"{name}/s{s}", got, want)
    return out


def record_vs_mega(dev) -> dict:
    """At config 4: the record's image (render_record_megakernel, one K1b
    launch over the 4 in-pixel samples) against K1a's pass on the same key
    under tests/test_megakernel.py::_compare's gate (rays within max(64,
    0.1%)), its winners against the same launch made alone. Then K1b alone
    on the main path's launch (1,048,576 lanes, each pixel's 4 samples) and
    on one sample's (262,144 lanes, mega_record's: the launch the record
    made a sample before), each against its plain version
    (record_launch_vs_plain: every lane, its queue and plan), its CUDA-event
    time (the mean of five, the card held busy before each), the plain
    version's host time, and its bound (k1_bound: at K1's own sphere test
    from the plain version's counts of the tests by class, and with every
    test whole; the sphere table and camera read once, 16 B a lane and the
    D x G winner plane written once); on the one-sample launch, the lane
    utilisation one thread a lane to its end gives (lane_utilisation, the
    design before the queue)."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.ops import megakernel as mk

    scene, cam, cfg = cornell_box_scene(), smallpt_camera(), grad_config()
    key = rng.base_key(5)
    img_r, winners, rays_r = mk.render_record_megakernel(scene, cam, cfg, key,
                                                         device=dev)
    img_m, rays_m = mk.render_pass_megakernel(scene, cam, cfg, key,
                                              device=dev)
    rays_close("record_vs_mega", int(rays_r), int(rays_m))
    st = gate(img_r.cpu().numpy() / cfg.spp, img_m.cpu().numpy() / cfg.spp,
              MAX_FRAC)
    if tuple(winners.shape) != (cfg.max_depth, cfg.n_pixels * cfg.spp):
        raise AssertionError(f"winners {tuple(winners.shape)}")
    table = mk.build_scene_table(scene, cfg, dev)
    camv = mk.build_camera_vec(cam, cfg, dev)
    ns = scene.n_spheres
    k0, k1 = rng.key_words(key)
    out = dict(image_vs_k1a=st, rays_record=int(rays_r),
               rays_k1a=int(rays_m),
               hit_share=float((winners >= 0).float().mean()))
    for name, k in (("launch", cfg.spp), ("one_sample", 1)):
        k_ms, got = cuda_ms(lambda: mk._record_launch(
            table, camv, cfg, k0, k1, 0, 0, cfg.height, ns, k), 6,
            setup=hold_card, skip_first=True)
        if k == cfg.spp and not torch.equal(got[2], winners):
            raise AssertionError("record_vs_mega: the record's winners "
                                 "differ from its launch's")
        torch.cuda.synchronize()
        t = time.perf_counter()
        mk.record_pass_plain(table, camv, cfg, k0, k1, n_spheres=ns,
                             k_samples=k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        res = record_launch_vs_plain(f"record_{name}_512x512", table, camv,
                                     cfg, key, ns, k)
        counts = {}
        mk.record_pass_plain(table, camv, cfg, k0, k1, n_spheres=ns,
                             k_samples=k, counts=counts)
        n, n_rays = res["strict"]["lanes"], res["strict"]["rays"]
        nbytes = (ns * 16 * 4 + camv.numel() * 4 + n * 16
                  + cfg.max_depth * n * 4)
        res.update(kernel_ms=k_ms, plain_ms=plain_ms,
                   **k1_bound(counts, n_rays, ns, nbytes),
                   rays_per_lane_mean=n_rays / n,
                   rays_per_lane_max=int(got[1].max()),
                   lane_utilisation_one_lane_a_thread=lane_utilisation(
                       got[1]))
        res.update(share=res["bound_ms"] / k_ms,
                   share_every_test_full=res["bound_ms_every_test_full"]
                   / k_ms)
        out[name] = res
    return out


def on_wall_camera():
    """A camera whose rays start exactly on the Cornell box's left wall
    (origin (1, 40.8, 81.6), the wall's centre 1e5 away on x, push 0), so
    that K1's inside guard meets q within an ulp of r*r."""
    import torch

    from smallpt_tpu_torch.core.camera import LegacyCamera

    d = np.array([1.0, 0.0, -1.0], np.float32)
    return LegacyCamera(
        origin=torch.tensor([1.0, 40.8, 81.6]),
        direction=torch.tensor(d / np.linalg.norm(d)),
        fov_scale=torch.tensor(0.5135), push_forward=torch.tensor(0.0))


def k1b_constructed_launches(dev) -> dict:
    """K1b against its plain version on launches built to reach the edges
    of its queue, its instances and its sphere test, each through the
    uncounted mk._record_launch and held by record_launch_vs_plain (every
    lane: the radiance as int32, the rays, the winners; the queue handing
    out every lane once; the launch's plan):
    - one lane (1x1 pixels), one lane short of a block (127x1), and 127
      pixels' two samples (254 lanes);
    - lanes past several first waves: Cornell at 1024x768, depth 16, one
      sample a lane (786,432 lanes, held to at least three first waves);
    - procedural_sphere_scene(12000) at 64x48, depth 8, whose sweep
      columns (240 KB) do not fit the card's shared memory: the instance
      that sweeps from global memory;
    - the NEE instance with one light (8) and with three (8, 3, 6), Cornell
      128x96, two samples a lane;
    - the thin lens and the environment light, Cornell 128x96, 4 samples;
    - the camera on the left wall (on_wall_camera), 64x48, 2 samples."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.ops import megakernel as mk

    c128 = grad_config(width=128, height=96)
    cases = {
        "lanes1": (cornell_box_scene(), c128.replace(width=1, height=1), 1),
        "lanes127": (cornell_box_scene(), c128.replace(width=127, height=1),
                     1),
        "lanes254_two_samples": (cornell_box_scene(), c128.replace(
            width=127, height=1), 2),
        "refill_1024x768": (cornell_box_scene(), grad_config(
            width=1024, height=768), 1),
        "procedural12000_global_sweep": (procedural_sphere_scene(12000),
                                         grad_config(width=64, height=48,
                                                     max_depth=8), 1),
        "nee_1_light": (cornell_box_scene(), c128.replace(nee_lights=(8,)),
                        2),
        "nee_3_lights": (cornell_box_scene(), c128.replace(
            nee_lights=(8, 3, 6)), 2),
        "lens_env": (cornell_box_scene(), c128.replace(
            aperture=4.0, focal_distance=120.0,
            env_emission=(0.2, 0.3, 0.4)), 4),
        "on_wall": (cornell_box_scene(), grad_config(width=64, height=48),
                    2),
    }
    out = {}
    for n, (name, (scene, cfg, k)) in enumerate(cases.items()):
        cam = on_wall_camera() if name == "on_wall" else smallpt_camera()
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        res = record_launch_vs_plain(name, table, camv, cfg,
                                     rng.base_key(1900 + n), scene.n_spheres,
                                     k, ip_offset=n % 3)
        res["first_wave"] = wave = res["plan"]["threads"]
        lanes = res["strict"]["lanes"]
        if "refill" in name and lanes < 3 * wave:
            raise AssertionError(f"{name}: {lanes} lanes for a first wave "
                                 f"of {wave}")
        if ("global" in name) != bool(res["plan"]["global"]) or bool(
                res["plan"]["nee"]) != bool(cfg.nee_lights):
            raise AssertionError(f"{name}: the plan's instance "
                                 f"{res['plan']}")
        out[name] = res
        del table
    torch.cuda.empty_cache()
    return out


def _cos(a, b) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm() + 1e-300))


def _grads_close(name, got, want, rtol: float) -> dict:
    """Gradients (SceneParams) against reference ones: allclose at rtol and
    atol rtol * max|g| per leaf, and finite."""
    import torch

    out = {}
    for field, a, b in zip(want._fields, want, got):
        a, b = a.cpu(), b.cpu()
        ok = (bool(torch.isfinite(b).all())
              and torch.allclose(b, a, rtol=rtol,
                                 atol=rtol * float(a.abs().max())))
        out[field] = dict(max_abs_diff=float((a - b).abs().max()),
                          max_abs=float(a.abs().max()))
        if not ok:
            raise AssertionError(f"{name}/{field}: {out[field]}")
    return out


def grad_small(dev) -> dict:
    """At tests/test_grad_replay.py's shape (Cornell 12x12, 4 spp,
    max_depth 4), on the card: the replay, the scan through K2 and NEE
    (the flat path) against the port's CPU gradients on the same inputs
    (rtol 1e-4, atol 1e-4 max|g|: index_add adds in no fixed order on the
    card); then tests/test_torch_grad*.py's finite-difference gates
    (albedo, emission, the glass center), diff_remat on and off, the
    recorder above MEGA_MAX_SPHERES (patched to 4) against the scan, mesh
    materials through K6, and SGD and Adam lowering the loss."""
    import torch

    from smallpt_tpu_torch.config import Intersector, Scheduler
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_mesh_scene,
    )
    from smallpt_tpu_torch.engine import renderer
    from smallpt_tpu_torch.grad import diff, replay
    from smallpt_tpu_torch.ops import megakernel as mk

    scene, cam = cornell_box_scene(), smallpt_camera()
    cfg = grad_config(width=12, height=12, max_depth=4)
    key = rng.base_key(0)
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99),
                              device="cpu")
    out = {}
    for name, c in (("replay", cfg), ("scan_k2", cfg.replace(
            diff_replay=False)), ("nee", cfg.replace(nee_lights=(8,)))):
        lk, ik, gk = diff.image_loss_and_grads(scene, cam, c, key, target,
                                               device=dev)
        lc, ic, gc = diff.image_loss_and_grads(scene, cam, c, key, target,
                                               device="cpu")
        if abs(float(lk) - float(lc)) > 1e-4 * float(lc):
            raise AssertionError(f"grad_small/{name}: loss {float(lk)} vs "
                                 f"{float(lc)}")
        out[name] = dict(loss=float(lk), loss_cpu=float(lc),
                         image_max_abs_diff=float((ik.cpu() - ic).abs().max()),
                         grads=_grads_close(name, gk, gc, 1e-4))

    def fd(fn, field, idx, h):
        params, refl = diff.split_scene(scene)

        def at(delta):
            leaf = getattr(params, field).clone()
            leaf[idx] += delta
            return fn(diff.merge_scene(params._replace(**{field: leaf}),
                                       refl))
        return (at(h) - at(-h)) / (2 * h)

    tgt = target.to(dev)

    def record_loss(s):
        img, _, _ = replay.record_forward(s, cam, cfg, key, device=dev)
        return float(torch.mean((img - tgt) ** 2))

    _, _, g = diff.image_loss_and_grads(scene, cam, cfg, key, target,
                                        device=dev)
    fds = {}
    for field, idx, tol in (("albedo", (0, 0), 1e-4),
                            ("albedo", (2, 1), 1e-4),
                            ("emission", (8, 0), 1e-5)):
        f_ = fd(record_loss, field, idx, 1e-3)
        an = float(getattr(g, field)[idx])
        fds[f"{field}{list(idx)}"] = dict(analytic=an, fd=f_)
        if not abs(an - f_) < 5e-3 * max(1.0, abs(f_)) + tol:
            raise AssertionError(f"grad_small FD {field}{idx}: {an} vs {f_}")
    # the glass ball's center (tests/test_grad.py's specular gate)
    gcfg = grad_config(width=24, height=24, max_depth=6,
                       intersector=Intersector.JAX)
    gtarget = diff.render_mean(scene, cam, gcfg, key, device=dev)
    params, refl = diff.split_scene(scene)
    center = params.center.clone()
    center[7] += torch.tensor([1.5, 1.0, -1.5])
    moved = diff.merge_scene(params._replace(center=center), refl)
    _, _, gg = diff.image_loss_and_grads(moved, cam, gcfg, key, gtarget,
                                         device=dev)

    def glass_loss(s, delta):
        c = s.center.clone()
        c[7, 0] += delta
        img = diff.render_mean(s._replace(center=c), cam, gcfg, key,
                               device=dev)
        return float(torch.mean((img - gtarget) ** 2))

    f_ = (glass_loss(moved, 1e-2) - glass_loss(moved, -1e-2)) / 2e-2
    an = float(gg.center[7, 0])
    fds["glass_center_x"] = dict(analytic=an, fd=f_)
    if an == 0.0 or not abs(an - f_) < 0.05 * max(1e-4, abs(f_)):
        raise AssertionError(f"grad_small glass FD: {an} vs {f_}")
    out["fd"] = fds
    # diff_remat off: the same gradients
    _, _, gn = diff.image_loss_and_grads(scene, cam, cfg.replace(
        diff_remat=False), key, target, device=dev)
    out["no_remat"] = _grads_close("no_remat", gn, g, 1e-4)
    # the recorder above MEGA_MAX_SPHERES: the flat wavefront over K2
    real = mk.MEGA_MAX_SPHERES
    mk.MEGA_MAX_SPHERES = 4
    try:
        fcfg = cfg.replace(width=14, height=10)
        ftarget = diff.render_mean(scene, cam, fcfg, rng.base_key(99),
                                   device=dev)
        lr_, ir, gr = diff.image_loss_and_grads(scene, cam, fcfg, key,
                                                ftarget, device=dev)
    finally:
        mk.MEGA_MAX_SPHERES = real
    ls, is_, gs = diff.image_loss_and_grads(scene, cam, fcfg.replace(
        diff_replay=False), key, ftarget, device=dev)
    if not (abs(float(lr_) - float(ls)) <= 1e-3 * float(ls)
            and torch.allclose(ir, is_, rtol=5e-3, atol=5e-3)):
        raise AssertionError(f"fallback recorder: loss {float(lr_)} vs "
                             f"{float(ls)}")
    for field, a, b in zip(gs._fields, gs, gr):
        if not torch.allclose(b, a, rtol=0.05,
                              atol=1e-5 + 0.02 * float(a.abs().max())):
            raise AssertionError(f"fallback recorder: {field}")
    out["fallback_recorder"] = dict(loss=float(lr_), loss_scan=float(ls))
    # mesh materials through the flat wavefront and K6
    mcfg = grad_config(width=10, height=8, max_depth=5,
                       scheduler=Scheduler.FLAT)
    mesh = procedural_mesh_scene(n_balls=2, subdiv_longitude=3, seed=1)

    def mesh_loss(albedo):
        s = mesh._replace(material=mesh.material._replace(albedo=albedo))
        img = renderer.render(s, cam, mcfg, key, differentiable=True,
                              device=dev)
        return torch.mean(img ** 2)

    a0 = mesh.material.albedo.to(dev).requires_grad_(True)
    (ga,) = torch.autograd.grad(mesh_loss(a0), (a0,))
    bump = torch.zeros_like(a0)
    bump[4, 0] = 1e-3
    with torch.no_grad():
        f_ = float((mesh_loss(a0 + bump) - mesh_loss(a0 - bump)) / 2e-3)
    an = float(ga[4, 0])
    out["mesh_albedo_fd"] = dict(analytic=an, fd=f_)
    if not abs(an - f_) < 5e-3 * max(abs(f_), 1e-4):
        raise AssertionError(f"mesh FD: {an} vs {f_}")
    # SGD and Adam recover a perturbed albedo (8x8)
    tcfg = cfg.replace(width=8, height=8)
    ttarget = diff.render_mean(scene, cam, tcfg, key, device=dev)
    albedo = params.albedo.clone()
    albedo[0] = torch.tensor([0.3, 0.6, 0.6])
    start = diff.merge_scene(params._replace(albedo=albedo), refl)
    s, sgd = start, []
    for _ in range(8):
        s, loss, _ = diff.sgd_train_step(s, cam, tcfg, key, ttarget, lr=1.0,
                                         device=dev)
        sgd.append(float(loss))
    step, state = diff.adam_optimizer(start, lr=0.01, device=dev)
    s, adam = start, []
    for _ in range(8):
        s, state, loss, _ = step(s, cam, tcfg, key, ttarget, state)
        adam.append(float(loss))
    out["sgd_losses"], out["adam_losses"] = sgd, adam
    if not (min(sgd) < 0.5 * sgd[0] and adam[-1] < 0.6 * adam[0]):
        raise AssertionError(f"training: sgd {sgd}, adam {adam}")
    return out


def _top(prof: dict, n: int = 8) -> dict:
    by = prof.get("device_ms_by_kernel")
    if isinstance(by, dict):
        prof = dict(prof, device_ms_by_kernel=dict(
            sorted(by.items(), key=lambda kv: -kv[1])[:n]))
    return prof


def grad_main(dev, n_steps: int = 3) -> dict:
    """The gradient main path at config 4 (bench.py --diff): sgd_train_step
    through the replay differentiator, one warm-up step, then n_steps timed
    with CUDA events (step s keyed fold_in(base_key(0), s)), the launch
    counts zeroed just before the timed steps and read just after (K1b
    only). Then its parts (the record, the replay's forward and backward),
    forward rays and Mrays/s as bench.py counts them, the device's busy
    share and the peak memory with diff_remat on and off; one step of the
    scan differentiator through K2 for comparison, with its counts, and
    the record above MEGA_MAX_SPHERES (the flat wavefront over K2) with
    its counts, each with its first and middle K2 launch on the step's own
    rays against the plain version (``launches_vs_plain``); the
    gradients' cosines per leaf, each at least 0.99: the replay recorded
    by K1b against the scan, and the replay recorded by the flat wavefront
    over K2 (the recorder above MEGA_MAX_SPHERES) against the scan; every
    gradient finite."""
    import torch

    from smallpt_tpu_torch.core import camera as cam_mod
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene, scene_to
    from smallpt_tpu_torch.engine import renderer
    from smallpt_tpu_torch.grad import diff, replay
    from smallpt_tpu_torch.ops import megakernel as mk

    scene, cam, cfg = cornell_box_scene(), smallpt_camera(), grad_config()
    base = rng.base_key(0)
    target = diff.render_mean(scene, cam, cfg, rng.base_key(99), device=dev)
    # forward rays as bench.py counts them: the differentiable flat pass's
    sid, _, col, row, cx, cy = cam_mod.sample_indices(cfg, cfg.n_pixels,
                                                      device=dev)
    with torch.no_grad():
        _, rays_fwd = renderer.render_samples(
            scene_to(scene, dev), cam, cfg, base, sid, col, row, cx, cy,
            differentiable=True, return_stats=True)
    rays_fwd = int(rays_fwd)
    out = dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
               max_depth=cfg.max_depth, forward_rays=rays_fwd)
    for remat in (True, False):
        c = cfg.replace(diff_remat=remat)
        s = scene
        s, _, _ = diff.sgd_train_step(s, cam, c, base, target, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if remat:
            zero_counts()
        step_ms, losses = [], []
        for k in range(n_steps):
            key = rng.fold_in(base, k)
            ms_, (s, loss, img) = cuda_ms(
                lambda: diff.sgd_train_step(s, cam, c, key, target,
                                            device=dev), 1)
            step_ms.append(ms_)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 1e9
        tag = "remat" if remat else "no_remat"
        if remat:
            launched = counts()
            # one K1b launch a step, over the pixels' spp samples
            if (launched["mega_record"] != n_steps
                    or any(v for k_, v in launched.items()
                           if k_ != "mega_record")):
                raise AssertionError(f"grad main path: launches {launched}")
            out["launches"] = launched
        if not (np.isfinite(losses).all() and bool(torch.isfinite(
                img).all()) and all(bool(torch.isfinite(x).all())
                                    for x in diff.split_scene(s)[0])):
            raise AssertionError(f"grad main path ({tag}): not finite")
        ms = float(np.mean(step_ms))
        out[tag] = dict(step_ms=step_ms, ms_per_step=ms, losses=losses,
                        peak_mem_gb=peak,
                        fwd_mrays_per_s=rays_fwd / ms / 1e3)
    # the parts of a step (remat on), on the host's clock with the card
    # synchronized at each boundary (the path is host-bound): the record,
    # the replay's forward with its loss, its backward; and a whole step,
    # in the same loop; 3 runs
    key = base
    params, refl = diff.split_scene(scene)
    parts = []
    for _ in range(3):
        t = [0.0] * 5
        torch.cuda.synchronize()
        t[0] = time.perf_counter()
        img, winners, rays = replay.record_forward(scene, cam, cfg, key,
                                                   device=dev)
        torch.cuda.synchronize()
        t[1] = time.perf_counter()
        leaves = [p.to(dev).requires_grad_(True) for p in params]
        dscene = diff.merge_scene(diff.SceneParams(*leaves), refl.to(dev))
        loss = torch.mean((replay.replay_mean(dscene, cam, cfg, key, winners,
                                              device=dev) - target) ** 2)
        torch.cuda.synchronize()
        t[2] = time.perf_counter()
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t[3] = time.perf_counter()
        del loss, leaves, dscene
        diff.sgd_train_step(scene, cam, cfg, key, target, device=dev)
        torch.cuda.synchronize()
        t[4] = time.perf_counter()
        parts.append([(t[k + 1] - t[k]) * 1e3 for k in range(4)])
    rec_ms, fwd_ms, bwd_ms, step = (float(x) for x in np.mean(parts, axis=0))
    out["parts"] = dict(
        host_clock_step_ms=step, record_ms=rec_ms, record_rays=int(rays),
        k1b_launches_per_step=1, replay_forward_ms=fwd_ms,
        replay_backward_ms=bwd_ms,
        rest_ms=step - rec_ms - fwd_ms - bwd_ms)
    out["profile"] = _top(profile(lambda: diff.sgd_train_step(
        scene, cam, cfg, key, target, device=dev)))
    # the scan differentiator through K2, one step
    scfg = cfg.replace(diff_replay=False)
    diff.image_loss_and_grads(scene, cam, scfg, key, target, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    scan_ms, (ls, _, gs) = cuda_ms(lambda: diff.image_loss_and_grads(
        scene, cam, scfg, key, target, device=dev), 1)
    launched = counts()
    if not launched["closest_hit"] or any(
            v for k_, v in launched.items() if k_ != "closest_hit"):
        raise AssertionError(f"grad scan path: launches {launched}")
    out["scan"] = dict(ms=scan_ms, launches=launched, loss=float(ls),
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    # its first K2 launch (forward, bounce 0) and its middle one (the
    # recompute of the last bounce), each on the step's own 1,048,576
    # detached rays, dead lanes included, against the plain version
    out["scan"]["kernel"] = launches_vs_plain(
        "grad_scan_cornell_512x512", "closest_hit",
        lambda: diff.image_loss_and_grads(scene, cam, scfg, key, target,
                                          device=dev),
        launched["closest_hit"])
    lr_, _, gr = diff.image_loss_and_grads(scene, cam, cfg, key, target,
                                           device=dev)
    real = mk.MEGA_MAX_SPHERES
    mk.MEGA_MAX_SPHERES = 0
    try:
        # the recorder above MEGA_MAX_SPHERES: the flat wavefront over K2,
        # its launches counted alone, its first and middle launch against
        # the plain version
        zero_counts()
        replay.record_forward(scene, cam, cfg, key, device=dev)
        launched = counts()
        if not launched["closest_hit"] or any(
                v for k_, v in launched.items() if k_ != "closest_hit"):
            raise AssertionError(f"grad flat recorder: launches {launched}")
        out["record_flat"] = dict(launches=launched, kernel=launches_vs_plain(
            "grad_record_flat_cornell_512x512", "closest_hit",
            lambda: replay.record_forward(scene, cam, cfg, key, device=dev),
            launched["closest_hit"]))
        lf, _, gf = diff.image_loss_and_grads(scene, cam, cfg, key, target,
                                              device=dev)
    finally:
        mk.MEGA_MAX_SPHERES = real
    cos_k1b = {f: _cos(a, b) for f, a, b in zip(gs._fields, gr, gs)}
    cos_flat = {f: _cos(a, b) for f, a, b in zip(gs._fields, gf, gs)}
    out["cosine_replay_k1b_vs_scan"] = cos_k1b
    out["cosine_replay_flat_recorder_vs_scan"] = cos_flat
    out["loss_replay_k1b"], out["loss_replay_flat"] = float(lr_), float(lf)
    if not all(bool(torch.isfinite(x).all()) for x in (*gr, *gs, *gf)):
        raise AssertionError("grad main path: gradients not finite")
    if min(cos_k1b.values()) < 0.99 or min(cos_flat.values()) < 0.99:
        raise AssertionError(f"grad cosines: {cos_k1b} {cos_flat}")
    return out


def binned_options(scene, cfg, dev) -> dict:
    """ROADMAP.md item 11b on the binned main path's shape: one
    BinnedStreamingRenderer round (reset, step(spp, 8), flush) fused and
    unsorted, with the bin sort every bounce (sort_every=1) and with the
    three-program bounce (fused=False), each after a warm-up round, timed
    (CUDA events), its launch counts zeroed just before and read just after
    (K8 only); the accumulators of the sorted and the three-program round
    bit-equal to the fused, unsorted round's; the three-program round's
    first and middle K8 launch against the plain version (bit-equal,
    timed, bounded)."""
    import torch

    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer

    out, ref = {}, None
    for name, kw in (("fused", {}), ("sort_every_1", dict(sort_every=1)),
                     ("three_program", dict(fused=False))):
        r = BinnedStreamingRenderer(scene, smallpt_camera(), cfg,
                                    seed=BINNED_SEED, device=dev, **kw)

        def round_():
            r.reset()
            r.step(add_samples=cfg.spp, n_bounces=8)
            r.flush()

        round_()
        torch.cuda.synchronize()
        zero_counts()
        ms, _ = cuda_ms(round_, 1)
        launched = counts()
        if not launched["stream_step_binned"] or any(
                v for k, v in launched.items() if k != "stream_step_binned"):
            raise AssertionError(f"binned {name}: launches {launched}")
        rad, w = r.accumulators()
        if ref is None:
            ref = (rad.clone(), w.clone(), r.stats.rays)
        elif not (torch.equal(rad, ref[0]) and torch.equal(w, ref[1])):
            raise AssertionError(
                f"binned {name}: accumulators differ from the fused, "
                f"unsorted round on {int((rad != ref[0]).sum())} values")
        out[name] = dict(round_ms=ms, launches=launched,
                         bit_equal_to_fused=True,
                         weights_exact=bool((w == cfg.spp).all()))
        if name == "three_program":
            per_round = launched["stream_step_binned"]
            caps = capture_binned(round_, {0, per_round // 2})
            out[name]["kernel"] = {
                k: k8_vs_plain(f"binned {name}/{k}", c, time_it=True)
                for k, c in zip(("first", "middle"), caps)}
    return out


# K4 (csrc/dda.cu): tests/test_dda.py's five cases, and bench_dda_tpu.py's
# stage 2 (procedural_sphere_scene(10000), 196,608 bounce and camera rays,
# grids at occ_target 16, 28 and 48 with k_max 128)
DDA_RAYS = 192 * 1024
DDA_OCC = (16.0, 28.0, 48.0)


def dda_rays(n, seed, inside=True, coherent=False):
    """scripts/bench_dda_tpu.py::_rays (tests/test_dda.py::_rays without
    coherent): origins in the Cornell volume or around the camera,
    isotropic or camera-like unit directions; (N, 3) f32 numpy each."""
    rng_ = np.random.default_rng(seed)
    if inside:
        org = rng_.uniform([5, 5, 20], [95, 75, 150], (n, 3))
    elif coherent:
        org = np.tile(np.asarray([[50.0, 52.0, 295.6]]), (n, 1))
        org += rng_.normal(scale=0.5, size=(n, 3))
    else:
        org = rng_.uniform([-40, -40, 170], [140, 120, 320], (n, 3))
    if coherent:
        d = np.asarray([0.0, -0.04, -1.0]) + rng_.normal(scale=0.2,
                                                          size=(n, 3))
    else:
        d = rng_.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def k4_bound(counts: dict, n_rays: int, grid) -> dict:
    """The least time of one K4 launch for the work the plain version
    counted on the same rays (its walk visits the cells the kernel's
    does), each pair priced at what K4's early-miss tests spend up to
    their decision: a live part-A row OPS_K2_STABLE_MISS, or
    OPS_K2_STABLE_HIT past det; an overflow row or a tested slot
    OPS_K2_DIRECT_MISS, or the whole direct test OPS_K2_FAST past det;
    OPS_PER_STEP a walk step and OPS_PER_INIT a ray's grid clip, at the
    float rate; the ray planes in, t and code out, part A, the overflow
    rows and the cell table once, at the memory rate. Beside it
    (``bound_ms_every_test_full``) every pair at its whole test, as K4 was
    held to before its early miss. slot_bytes: the 16 B of each tested
    slot the warp sweep reads (from L1 or L2)."""
    a_all, a_hit = counts["part_a_tests"], counts["part_a_past_det"]
    d_all = counts["overflow_tests"] + counts["slot_tests"]
    d_hit = counts["overflow_past_det"] + counts["slot_past_det"]
    walk = counts["walk_steps"] * OPS_PER_STEP + n_rays * OPS_PER_INIT
    ops = (OPS_K2_STABLE_MISS * (a_all - a_hit) + OPS_K2_STABLE_HIT * a_hit
           + OPS_K2_DIRECT_MISS * (d_all - d_hit) + OPS_K2_FAST * d_hit
           + walk)
    nbytes = n_rays * (24 + 8) + 4 * (grid.part_a.numel()
                                      + grid.overflow.numel()
                                      + grid.cells.numel())
    whole = _bound(a_all * OPS_K2_STABLE + d_all * OPS_K2_FAST + walk,
                   nbytes)
    return _bound(ops, nbytes, bound_ms_every_test_full=whole["bound_ms"],
                  slot_bytes=16 * counts["slot_tests"],
                  cells_per_ray_mean=counts["walk_steps"] / n_rays,
                  cells_per_ray_max=counts["max_steps"])


def k4_vs_plain(name, org, dirs, grid) -> dict:
    """K4 against closest_hit_dda_plain on the same (N, 3) rays: the
    counted wrapper's t and code bit-equal; then a second launch
    (dda._launch, uncounted, which returns the scratch) whose (t, code)
    equal the first's and whose queue counters hold against the plain
    version's counts: every ray finished, the walk steps and the slots
    tested. Returns exact()'s reading plus the plain version's counts and
    host-clock ms, the queue, K4's launch (dda.dda_plan), and the planes
    and K4's outputs for reuse."""
    import torch

    from smallpt_tpu_torch.ops import dda

    o, d = org.T.contiguous(), dirs.T.contiguous()
    t4, code = dda.closest_hit_dda(o, d, grid)
    cnt = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = dda.closest_hit_dda_plain(o, d, grid, counts=cnt)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    st = exact(name, (t4, code), want)
    t_q, code_q, queue = dda._launch(o, d, grid)
    if not (torch.equal(t_q.view(torch.int32), t4.view(torch.int32))
            and torch.equal(code_q, code)):
        raise AssertionError(f"{name}: K4's second launch differs from "
                             "its first")
    q = dict(zip(dda.QUEUE_FIELDS, queue.tolist()))
    n = o.shape[1]
    for key, val in (("rays", n), ("walk_steps", cnt["walk_steps"]),
                     ("slot_tests", cnt["slot_tests"])):
        if q[key] != val:
            raise AssertionError(f"{name}: K4's queue counted {q[key]} "
                                 f"{key}, the plain version {val}")
    plan = dda.dda_plan(n, o.device)
    if q["next"] < n - plan["threads"]:
        raise AssertionError(f"{name}: the queue handed out {q['next']} "
                             f"rays past a first wave of {plan['threads']}")
    return dict(st, plain_ms=plain_ms, counts=cnt, queue=q, plan=plan,
                planes=(o, d), got=(t4, code))


def k4_vs_k2(name, t4, code, grid, t2, id2) -> dict:
    """K4's (t, code) against K2's t and winners (sphere ids, perm[slot])
    on the same rays: t bit-equal everywhere, the winner's id equal where
    K2 hits (a part-A code through grid.perm_a)."""
    import torch

    c = code.long()
    ids4 = torch.where(c < 0, grid.perm_a.index_select(
        0, (-c - 1).clamp(min=0)), c)
    hit = t2 < 3e38
    if not torch.equal(t4, t2):
        raise AssertionError(f"{name}: K4 t differs from K2's on "
                             f"{int((t4 != t2).sum())} rays")
    if not torch.equal(ids4[hit], id2[hit]):
        raise AssertionError(f"{name}: K4 winner differs from K2's on "
                             f"{int((ids4[hit] != id2[hit]).sum())} rays")
    return dict(t_equal=True, ids_equal=True, hits=int(hit.sum()))


def dda_vs_plain_small(dev) -> dict:
    """K4 against its plain version on the card, bit for bit (t and code;
    its queue counters against the plain version's counts), on
    tests/test_dda.py's five cases: procedural_sphere_scene(800) at occ
    16 from inside and from outside (2,048 rays each), the Cornell box at
    occ 4, procedural_sphere_scene(600) on a 2x2x2 grid with k_max 48 (its
    spheres overflow) and procedural_sphere_scene(400) at occ 16 with
    origins on the grid's corner and x face and axis-aligned directions
    (1,024 rays each)."""
    import torch

    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.ops import dda

    def t(a):
        return torch.from_numpy(a).to(dev)

    out = {}
    p800 = procedural_sphere_scene(800)
    g800 = dda.build_dda_grid(p800, occ_target=16.0, device=dev)
    for name, inside in (("procedural800_inside", True),
                         ("procedural800_outside", False)):
        o, d = dda_rays(2048, 1, inside=inside)
        out[name] = k4_vs_plain(name, t(o), t(d), g800)
    o, d = dda_rays(1024, 2)
    out["cornell_occ4"] = k4_vs_plain("cornell", t(o), t(d), dda.build_dda_grid(
        cornell_box_scene(), occ_target=4.0, device=dev))
    g = dda.build_dda_grid(procedural_sphere_scene(600), nb=(2, 2, 2),
                           k_max=48, device=dev)
    if g.n_overflow == 0:
        raise AssertionError("the k_max 48 grid did not overflow")
    o, d = dda_rays(1024, 3)
    out["overflow_nb222_k48"] = k4_vs_plain("overflow", t(o), t(d), g)
    out["overflow_nb222_k48"]["n_overflow"] = g.n_overflow
    g = dda.build_dda_grid(procedural_sphere_scene(400), occ_target=16.0,
                           device=dev)
    r = np.random.default_rng(4)
    o = r.uniform([5, 5, 20], [95, 75, 150], (1024, 3))
    o[:64] = np.asarray(g.lo)
    o[64:128, 0] = g.lo[0]
    d = np.eye(3)[r.integers(0, 3, 1024)] * r.choice([-1.0, 1.0], (1024, 1))
    out["axis_aligned_boundary"] = k4_vs_plain(
        "axis-aligned", t(o.astype(np.float32)), t(d.astype(np.float32)), g)
    for v in out.values():
        for k in ("planes", "got"):
            v.pop(k)
    return out


def dda_main(dev) -> dict:
    """bench_dda_tpu.py's stage 2 through the entry point a caller uses,
    intersect_spheres_dda: procedural_sphere_scene(10000), 196,608 bounce
    rays (origins in the volume, isotropic) and 196,608 camera rays (around
    the camera, coherent), grids at occ_target 16, 28 and 48 (k_max 128).
    The main path runs once (counts zeroed before it, read after: one K4
    launch a grid and ray set). Then, per grid and ray set: K4 against its
    plain version (bit-equal; its queue counters against the plain
    version's counts, k4_vs_plain), against K2 (closest_hit) on the same
    rays (hit/miss, winner id and t bit-equal), K4's and K2's ms (the card
    held busy before each call) and the plain version's, the cells a ray
    visited (the plain walk's counts), the bounds and their shares, K4's
    launch and the registers."""
    import torch

    from smallpt_tpu_torch.core.scene import procedural_sphere_scene, scene_to
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    scene = procedural_sphere_scene(10_000)
    dscene = scene_to(scene, dev)
    rays = {}
    for name, inside, coh in (("bounce", True, False),
                              ("camera", False, True)):
        o, d = dda_rays(DDA_RAYS, 11, inside=inside, coherent=coh)
        rays[name] = (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    grids, build_s = {}, {}
    for occ in DDA_OCC:
        t = time.perf_counter()
        grids[occ] = dda.build_dda_grid(scene, occ_target=occ, k_max=128,
                                        device=dev)
        build_s[occ] = time.perf_counter() - t

    # ---- the main path: intersect_spheres_dda on every grid and ray set
    zero_counts()
    t = time.perf_counter()
    hits = {(occ, n): dda.intersect_spheres_dda(o, d, dscene, g,
                                                want_uv=False)
            for occ, g in grids.items() for n, (o, d) in rays.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = counts()
    if launches["closest_hit_dda"] != len(hits):
        raise AssertionError(f"K4 main path: launches {launches}")
    for h in hits.values():
        if not (torch.isfinite(h.t) | torch.isinf(h.t)).all():
            raise AssertionError("K4 main path: NaN t")

    table, perm, nbc, nsc = ip.build_sphere_table(scene, device=dev)
    k2 = {}
    for n, (o, d) in rays.items():
        ot, dt = o.T.contiguous(), d.T.contiguous()
        ms, (t2, slot) = cuda_ms(
            lambda: ip.closest_hit(ot, dt, table, 64 * nbc, 64 * nsc), 6,
            setup=hold_card, skip_first=True)
        k2[n] = dict(ms=ms, t=t2, id=perm.index_select(0, slot.long()),
                     bound_ms=k2_bound(ot, dt, table, 64 * nbc, 64 * nsc,
                                       scene=dscene)["bound_ms"])
    out = dict(rays=DDA_RAYS, launches=launches, main_path_s=main_s,
               grids={int(occ): dict(nb=list(g.nb), cells=g.n_cells, k=g.k,
                                     n_local=g.n_local,
                                     n_overflow=g.n_overflow,
                                     table_mb=g.cells.numel() * 4 / 1e6,
                                     build_s=build_s[occ])
                      for occ, g in grids.items()},
               k2_ms={n: v["ms"] for n, v in k2.items()},
               k2_bound_ms={n: v["bound_ms"] for n, v in k2.items()})
    for occ, g in grids.items():
        for n, (o, d) in rays.items():
            name = f"occ{int(occ)}_{n}"
            st = k4_vs_plain(name, o, d, g)
            (ot, dt), (t4, code) = st.pop("planes"), st.pop("got")
            # the entry point's answer equals the wrapper's
            h = hits[(occ, n)]
            if not torch.equal(torch.where(t4 >= 3e38, float("inf"), t4),
                               h.t):
                raise AssertionError(f"{name}: intersect_spheres_dda t "
                                     "differs from closest_hit_dda's")
            vs_k2 = k4_vs_k2(name, t4, code, g, k2[n]["t"], k2[n]["id"])
            ms, _ = cuda_ms(lambda: dda.closest_hit_dda(ot, dt, g), 6,
                            setup=hold_card, skip_first=True)
            st.update(k4_bound(st["counts"], DDA_RAYS, g))
            st.update(kernel_ms=ms, k2_ms_same_rays=k2[n]["ms"],
                      share=st["bound_ms"] / ms,
                      share_every_test_full=st["bound_ms_every_test_full"]
                      / ms, vs_k2=vs_k2, mrays_per_s=DDA_RAYS / ms / 1e3)
            out[name] = st
    out["ptxas"] = ptxas_entry("smallpt_dda")
    return out


def k4_constructed_launches(dev) -> dict:
    """K4 held bit for bit to its plain version (t and code; its queue's
    rays, walk steps and slots tested to the plain version's counts,
    k4_vs_plain) on launches built to reach the edges of its walk, its
    fold and its queue, each with its time (the card held busy before each
    call):
    - 4,096 rays whose lines miss the grid's box
      (procedural_sphere_scene(800) at occ 16; origins far beyond the
      scene, pointing away): part A and no walk step;
    - the same scene with its sphere 500 twice (the copy appended, id
      800): both in every cell the sphere touches, so every hit on it
      ties, and the fold must keep the lesser id (2,048 rays aimed at it);
    - procedural_sphere_scene(600) on a 2x2x2 grid with k_max 16: most of
      its spheres overflow into the rows every ray sweeps;
    - the persistent grid's first wave (its plan's threads) and 4,097 rays
      more, procedural_sphere_scene(800) at occ 16: the queue hands out
      rays past the first wave."""
    import torch

    from smallpt_tpu_torch.core.scene import (
        procedural_sphere_scene, sphere_scene_from_arrays,
    )
    from smallpt_tpu_torch.ops import dda

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    out = {}
    p800 = procedural_sphere_scene(800)
    g800 = dda.build_dda_grid(p800, occ_target=16.0, device=dev)
    r = np.random.default_rng(41)
    away = r.normal(size=(4096, 3))
    away[:, 2] = np.abs(away[:, 2]) + 1.0
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    far = np.tile([[50.0, 40.0, 1e6]], (4096, 1))
    cases = {"all_outside_the_grid": (far, away, g800)}
    m = p800.material
    pick = [*range(800), 500]
    twin = sphere_scene_from_arrays(
        p800.center[pick], p800.radius[pick], m.emission[pick],
        m.albedo[pick], m.refl[pick])
    o = np.tile(p800.center[500].numpy()[None], (2048, 1)) + r.uniform(
        -60, 60, (2048, 3))
    d = (p800.center[500].numpy()[None] + r.uniform(-1, 1, (2048, 3))
         * float(p800.radius[500]) - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cases["twins_in_one_cell"] = (o, d, dda.build_dda_grid(
        twin, occ_target=16.0, device=dev))
    g600 = dda.build_dda_grid(procedural_sphere_scene(600), nb=(2, 2, 2),
                              k_max=16, device=dev)
    o, d = dda_rays(2048, 42)
    cases["overflowing_grid_k16"] = (o, d, g600)
    n = dda.dda_plan(1, dev)["n_sm"] * dda.dda_plan(1, dev)["per_sm"] * 128
    o, d = dda_rays(n + 4097, 43)
    cases["past_the_first_wave"] = (o, d, g800)
    for name, (o, d, g) in cases.items():
        st = k4_vs_plain(name, t(o), t(d), g)
        (ot, dt), (t4, code) = st.pop("planes"), st.pop("got")
        st["kernel_ms"], _ = cuda_ms(lambda: dda.closest_hit_dda(ot, dt, g),
                                     3, setup=hold_card)
        out[name] = st
    if out["all_outside_the_grid"]["queue"]["walk_steps"] != 0:
        raise AssertionError(f"all outside: {out['all_outside_the_grid']}")
    won = dda.closest_hit_dda_plain(*(t(x).T.contiguous() for x in (
        cases["twins_in_one_cell"][:2])), cases["twins_in_one_cell"][2])[1]
    if not bool((won == 500).any()) or bool((won == 800).any()):
        raise AssertionError("twins: the copy won a tie, or none hit")
    if g600.n_overflow < 300:
        raise AssertionError(f"k_max 16: {g600.n_overflow} overflow")
    out["overflowing_grid_k16"]["n_overflow"] = g600.n_overflow
    past = out["past_the_first_wave"]
    if past["queue"]["next"] < 4097:
        raise AssertionError(f"past the first wave: {past['queue']}")
    return out


# K5's pairs, counted from csrc/closest_hit_mxu.cu's coef_tt: a live small
# sphere's b (3 products, 2 sums, less od: 6), e (3 products, 2 sums, plus
# -q, less oo: 7), det (2) and its compare, 16 ops to a miss; the square
# root, the two roots, their two compares and the fold's, 22 past det.
# K5's part-A rows take K2's stable counts (OPS_K2_STABLE_MISS / _HIT), a
# masked row none. Before its early miss K5 was held to OPS_K5_PAIR, the
# whole test over the non-zero terms (its dots also summed the zero
# terms, 39 ops a pair).
OPS_K5_MISS, OPS_K5_HIT = 16, 22
OPS_K5_PAIR = 21
MXU_RAYS = 512 * 384


def k5_pairs(org_c, dirs, stable, mxu, n_a: int, n_b: int) -> dict:
    """The (ray, slot) pairs of one K5 launch ((3, N) planes in the tables'
    frame) by where its tests decide them, counted op for op as far as
    det: "stable_miss", "stable_hit" over part A's live rows (k2_pairs),
    "coef_miss", "coef_hit" (det >= 0) over the live small spheres
    (intersect_pallas.mxu_live_rows); "live_a", "live_b" and "left_out",
    the slots the kernel stages and leaves out."""
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    a = k2_pairs(org_c, dirs, stable, n_a, 0)
    live, coef = ip.mxu_live_rows(mxu, n_b)
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*org_c, *dirs))
    od = (ox * dx + oy * dy) + oz * dz
    oo = (ox * ox + oy * oy) + oz * oz
    n = org_c.shape[1]
    hits = 0
    per = max(1, (1 << 24) // max(n, 1))
    for lo in range(0, live.numel(), per):
        cx, cy, cz, tx, ty, tz, nq = (coef[lo:lo + per, k][None, :]
                                      for k in range(7))
        b = cx * dx + cy * dy + cz * dz - od
        e = tx * ox + ty * oy + tz * oz + nq - oo
        hits += int((b * b + e >= 0.0).sum())
    return dict(stable_miss=a["stable_miss"], stable_hit=a["stable_hit"],
                coef_miss=n * live.numel() - hits, coef_hit=hits,
                live_a=a["live_a"], live_b=live.numel(),
                left_out=n_a + n_b - a["live_a"] - live.numel())


def k5_bound(org_c, dirs, stable, mxu, n_a: int, n_b: int, scene=None,
             org=None) -> dict:
    """The least time of one K5 launch on closest_hit_mxu's arguments: 24 B
    of ray in and 8 B out a ray and both tables once, at the memory rate,
    or the float work the function needs, whichever is longer. K5 computes
    K2's function (the closest sphere of each ray), so that work is, as in
    k2_bound, the lesser of two algorithms' counts:
    - this kernel's staged sweep (``bound_ms_staged_sweep``): each pair at
      the ops K5's tests spend up to their decision (k5_pairs:
      OPS_K2_STABLE_MISS / _HIT a part-A pair, OPS_K5_MISS / _HIT a small
      one, none a slot left out);
    - a grid walk over the scene's spheres (k2_walk: ``bound_ms_grid_walk``)
      on the same rays, given in the world's frame (org, (3, N)) with the
      scene the tables were built from.
    ``bound_algorithm`` names the one taken. Beside them
    (``bound_ms_every_pair_full``) the count K5 was held to before its
    early miss: OPS_K2_STABLE a live part-A row, OPS_K5_PAIR a live small
    sphere, a compare a dead slot, for every ray."""
    n_rays = org_c.shape[1]
    p = k5_pairs(org_c, dirs, stable, mxu, n_a, n_b)
    ops = (OPS_K2_STABLE_MISS * p["stable_miss"]
           + OPS_K2_STABLE_HIT * p["stable_hit"]
           + OPS_K5_MISS * p["coef_miss"] + OPS_K5_HIT * p["coef_hit"])
    nbytes = n_rays * (24 + 8) + (stable.numel() + mxu.numel()) * 4
    full = _bound(n_rays * (OPS_K2_STABLE * p["live_a"]
                            + OPS_K5_PAIR * p["live_b"]
                            + OPS_ROW_SKIP * p["left_out"]), nbytes)
    info = dict(pairs=p, bound_ms_staged_sweep=_bound(ops, nbytes)[
        "bound_ms"], bound_ms_every_pair_full=full["bound_ms"])
    algorithm = "staged sweep"
    walk = k2_walk(org, dirs, scene) if scene is not None else None
    if walk is not None:
        info.update(walk=walk, bound_ms_grid_walk=_bound(
            walk["ops"], nbytes)["bound_ms"])
        if walk["ops"] < ops:
            ops, algorithm = walk["ops"], "grid walk"
    return _bound(ops, nbytes, bound_algorithm=algorithm, **info)


def k5_plan(args, forced: int = 0) -> dict:
    """The plan K5's launcher makes of a launch on closest_hit_mxu's
    arguments (forced > 0: its slots forced into that many ranges), with
    its scratch in MB."""
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    n, slots, dev = args[0].shape[1], args[4] + args[5], args[2].device
    plan = (ip.read_plan(ip._mxu_lib()[1], dev, n, slots, forced)
            if forced else ip.closest_hit_mxu_plan(n, slots, dev))
    return dict(plan, scratch_mb=plan["scratch_words"] * 4 / 1e6)


def k5_vs_plain(name, scene, org, dirs, dev, tables=None) -> dict:
    """K5 against closest_hit_mxu_plain on the same (N, 3) rays, shifted
    into the tables' frame: t and slot bit-equal. Returns exact()'s
    reading plus the plain version's host-clock ms, the plan the launcher
    made, the arguments and K5's outputs for reuse."""
    import torch

    from smallpt_tpu_torch.ops import intersect_pallas as ip

    if tables is None:
        tables = ip.build_sphere_table_mxu(scene, device=dev)
    stable, mxu, _, nbc, nsc, eps, shift = tables
    o = (org - shift[None, :]).T.contiguous()
    d = dirs.T.contiguous()
    args = (o, d, stable, mxu, 64 * nbc, 64 * nsc, eps)
    got = ip.closest_hit_mxu(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = ip.closest_hit_mxu_plain(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    return dict(exact(name, got, want), plain_ms=plain_ms,
                plan=k5_plan(args), args=args, got=got)


def mxu_vs_plain_small(dev) -> dict:
    """K5 against its plain version on the card, bit for bit (t and slot):
    the Cornell box and procedural_sphere_scene(2000) on 4,096 rays from
    inside the spheres' box and 4,096 from outside it, and
    tests/test_intersect_pallas.py::test_mxu_padding_and_misses's 77 rays
    (from the camera's origin along +z; the same ray 77 times, padded to
    no tile)."""
    import torch

    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )

    def t(a):
        return torch.from_numpy(a).to(dev)

    out = {}
    for sname, scene in (("cornell", cornell_box_scene()),
                         ("procedural2000", procedural_sphere_scene(2000))):
        for rname, inside in (("inside", True), ("outside", False)):
            o, d = dda_rays(4096, 21, inside=inside)
            st = k5_vs_plain(f"{sname}_{rname}", scene, t(o), t(d), dev)
            out[f"{sname}_{rname}_4096"] = st
    o = np.tile(np.float32([[50.0, 52.0, 295.6]]), (77, 1))
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (77, 1))
    out["cornell_padding_77"] = k5_vs_plain("77 rays", cornell_box_scene(),
                                            t(o), t(d), dev)
    for v in out.values():
        for k in ("args", "got"):
            v.pop(k)
    return out


def mxu_gates(name, h_ref, h) -> dict:
    """tests/test_intersect_pallas.py::test_mxu_matches_pure_jax's gates of
    K5's refined hits h against h_ref on the same rays: hit/miss agreement
    above 0.998, winner flips below 3e-3, the 0.999 quantile of |dt| /
    max(t, 1) below 2e-2 and its median below 1e-6 where the winners
    agree, normals within 1e-2."""
    tr, tm = h_ref.t.cpu().numpy(), h.t.cpu().numpy()
    hit_r, hit_m = np.isfinite(tr), np.isfinite(tm)
    agree = float((hit_r == hit_m).mean())
    both = hit_r & hit_m
    ir, im = h_ref.inst.cpu().numpy()[both], h.inst.cpu().numpy()[both]
    flips = float((ir != im).mean())
    same = ir == im
    rel = np.abs(tr[both] - tm[both])[same] / np.maximum(tr[both][same], 1.0)
    nr = h_ref.n.cpu().numpy()[both][same]
    nm = h.n.cpu().numpy()[both][same]
    out = dict(hit_agree=agree, flips=flips, hits=int(both.sum()),
               rel_q999=float(np.quantile(rel, 0.999)),
               rel_median=float(np.median(rel)),
               normal_err=float(np.abs((nr * nm).sum(-1) - 1.0).max()))
    if not (agree > 0.998 and flips < 3e-3 and out["rel_q999"] < 2e-2
            and out["rel_median"] < 1e-6 and out["normal_err"] < 1e-2):
        raise AssertionError(f"{name}: K5 against K2 failed the gates: {out}")
    return out


def mxu_main(dev) -> dict:
    """scripts/bench_mxu_tpu.py's shape through the entry point a caller
    uses, intersect_spheres_mxu: procedural_sphere_scene(10000) and 196,608
    rays (seed 0, origins uniform in [5, 5, 20]-[95, 75, 150], isotropic
    unit directions), the tables built once. The main path runs once
    (counts zeroed before it, read after: one K5 launch). Then K5 against
    its plain version (bit-equal), the refined hits against K2's route
    (intersect_spheres_pallas) on the same rays under
    test_mxu_matches_pure_jax's gates, K5's and K2's ms (the card held busy
    before each call) and the plain version's, the plan and its scratch,
    the bound (k5_bound's: the lesser of its staged sweep's count and a
    grid walk's on the same rays), K2's (k2_bound's), the shares, and the
    registers."""
    import torch

    from smallpt_tpu_torch.core.scene import procedural_sphere_scene, scene_to
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    scene = procedural_sphere_scene(10_000)
    dscene = scene_to(scene, dev)
    rng_ = np.random.default_rng(0)
    o = rng_.uniform([5, 5, 20], [95, 75, 150], (MXU_RAYS, 3))
    d = rng_.normal(size=(MXU_RAYS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    org = torch.from_numpy(o.astype(np.float32)).to(dev)
    dirs = torch.from_numpy(d.astype(np.float32)).to(dev)
    t = time.perf_counter()
    tables = ip.build_sphere_table_mxu(scene, device=dev)
    build_s = time.perf_counter() - t

    zero_counts()
    t = time.perf_counter()
    h = ip.intersect_spheres_mxu(org, dirs, dscene, tables=tables)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = counts()
    if launches["closest_hit_mxu"] != 1:
        raise AssertionError(f"K5 main path: launches {launches}")
    if not (torch.isfinite(h.t) | torch.isinf(h.t)).all():
        raise AssertionError("K5 main path: NaN t")

    st = k5_vs_plain("procedural10000", scene, org, dirs, dev, tables)
    args, got = st.pop("args"), st.pop("got")
    ms, _ = cuda_ms(lambda: ip.closest_hit_mxu(*args), 6, setup=hold_card,
                    skip_first=True)
    k2_tables = ip.build_sphere_table(scene, device=dev)
    table, _, nbc, nsc = k2_tables
    ot, dt = org.T.contiguous(), dirs.T.contiguous()
    k2_ms, _ = cuda_ms(
        lambda: ip.closest_hit(ot, dt, table, 64 * nbc, 64 * nsc), 6,
        setup=hold_card, skip_first=True)
    h_k2 = ip.intersect_spheres_pallas(org, dirs, dscene, want_uv=False,
                                       tables=k2_tables)
    st.update(k5_bound(*args[:6], scene=dscene, org=ot))
    k2b = k2_bound(ot, dt, table, 64 * nbc, 64 * nsc, scene=dscene)
    st.update(kernel_ms=ms, k2_ms_same_rays=k2_ms,
              share=st["bound_ms"] / ms,
              share_staged_sweep=st["bound_ms_staged_sweep"] / ms,
              share_every_pair_full=st["bound_ms_every_pair_full"] / ms,
              k2_bound_ms=k2b["bound_ms"],
              vs_k2=mxu_gates("procedural10000", h_k2, h),
              mrays_per_s=MXU_RAYS / ms / 1e3)
    return dict(st, rays=MXU_RAYS, launches=launches, main_path_s=main_s,
                tables_build_s=build_s,
                mxu_table_kb=args[3].numel() * 4 / 1e3,
                ptxas=ptxas_entry(ip.LIBRARY_MXU[0]))


def k5_constructed_launches(dev) -> dict:
    """K5 held bit for bit to its plain version (t and slot) on launches
    built to reach the edges of its plan, its staging and its tests, each
    under the plan its launcher makes and under forced cuts of its slots
    (1 range, 2, 3 and one a 256-slot chunk; intersect_pallas._mxu_launch,
    uncounted), with the plan and the time (the card held busy before each
    call), on procedural_sphere_scene(2000):
    - 4,096 rays from inside the spheres' box;
    - the scene with its sphere 1500 twice (the copy appended: slot n_a +
      2000, two chunks after the original's): 2,048 rays aimed at it
      hit both at the same t, and the first slot must win under every
      cut;
    - its table with 300 live small spheres masked as the big spheres and
      the padding are (q = 1e30, a 0 in column 7): no ray takes one;
    - 1 ray; 77 rays (one ray block, which the plan cuts the deepest)."""
    import torch

    from smallpt_tpu_torch.core.scene import (
        procedural_sphere_scene, sphere_scene_from_arrays,
    )
    from smallpt_tpu_torch.ops import intersect_pallas as ip

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    scene = procedural_sphere_scene(2000)
    tables = ip.build_sphere_table_mxu(scene, device=dev)
    stable, mxu, _, nbc, nsc, eps, shift = tables
    n_a, n_b = 64 * nbc, 64 * nsc
    o, d = dda_rays(4096, 51)
    r = np.random.default_rng(52)
    m = scene.material
    pick = [*range(2000), 1500]
    twin = sphere_scene_from_arrays(
        scene.center[pick], scene.radius[pick], m.emission[pick],
        m.albedo[pick], m.refl[pick])
    tw = ip.build_sphere_table_mxu(twin, device=dev)
    c = scene.center[1500].numpy()
    to = c[None] + r.uniform(-40, 40, (2048, 3))
    td = c[None] + r.uniform(-1, 1, (2048, 3)) * float(scene.radius[1500]) \
        - to
    td /= np.linalg.norm(td, axis=1, keepdims=True)
    masked = mxu.clone()
    live, _ = ip.mxu_live_rows(mxu, n_b)
    drop = live[torch.from_numpy(r.choice(live.numel(), 300,
                                          replace=False)).to(dev)]
    rows2 = (drop // 64) * 128 + 64 + drop % 64
    masked[rows2, 6] = -1e30
    masked[rows2, 7] = 0.0
    cases = {
        "inside_4096": (o, d, tables),
        "twin_spheres": (to, td, tw),
        "masked_300": (o, d, (stable, masked, *tables[2:])),
        "one_ray": (o[:1], d[:1], tables),
        "rays77": (o[:77], d[:77], tables),
    }
    out = {}
    for name, (o_, d_, tab) in cases.items():
        args = ((t(o_) - tab[6][None, :]).T.contiguous(),
                t(d_).T.contiguous(), tab[0], tab[1], 64 * tab[3],
                64 * tab[4], tab[5])
        want = ip.closest_hit_mxu_plain(*args)
        hit = want[0] < 3e38
        if name == "twin_spheres" and (
                not bool((want[1] == args[4] + 1500).any())
                or bool((want[1] == args[4] + 2000).any())):
            raise AssertionError(f"{name}: the copy won a tie, or none hit")
        if name == "masked_300" and bool(torch.isin(
                want[1][hit], (drop + n_a).to(torch.int32)).any()):
            raise AssertionError(f"{name}: a masked sphere won")
        chunks = -(-(args[4] + args[5]) // 256)
        cuts = {}
        for forced in (0, 1, 2, 3, chunks):
            def launch():
                return (ip.closest_hit_mxu(*args) if forced == 0
                        else ip._mxu_launch(*args, forced=forced))
            cmp = exact(f"{name} forced={forced}", launch(), want)
            ms, _ = cuda_ms(launch, 3, setup=hold_card)
            cuts["own_plan" if forced == 0 else f"forced_{forced}"] = dict(
                cmp, kernel_ms=ms, plan=k5_plan(args, forced))
        if len({c_["plan"]["ranges"] for c_ in cuts.values()}) < 4:
            raise AssertionError(f"{name}: cuts {cuts}")
        out[name] = cuts
    return out


def shard_mesh(dev):
    """The 2 x 2 (tile, sample) mesh whose four shards all run on dev, in
    this one process (the machine has one card)."""
    from smallpt_tpu_torch.parallel import make_mesh

    return make_mesh(2, 2, devices=[dev] * 4)


def allclose_gate(name, got, want, rtol: float) -> dict:
    """got within rtol of want (atol rtol * max|want|): the sharded result
    against the single device's where only the order of the sums
    differs."""
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all())
            and torch.allclose(got, want, rtol=rtol, atol=rtol * scale)):
        raise AssertionError(f"{name}: max |diff| {err} (scale {scale})")
    return dict(max_abs_err=err, scale=scale, equal=bool(err == 0.0))


def mega_config():
    """The per-pass main path's configuration (bench.py's --perpass):
    Cornell at 1024x768, 4 spp, max_depth 48."""
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig

    return RenderConfig(width=1024, height=768, spp_per_cell=1,
                        max_depth=48, camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT)


def shard_mega(dev) -> dict:
    """render_sharded on the 2 x 2 mesh, MEGA Cornell at 1024x768, 4 spp,
    max_depth 48 (each shard one K1a launch over its band and sample
    slice), against the single-device pass on the same key; the last
    shard's launch (rows 384-767, samples 2-3) against the plain version
    on its own inputs (compare_pass, k1_strict)."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.renderer import render_with_stats
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.parallel import render_sharded

    cfg = mega_config()
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(5)
    mesh = shard_mesh(dev)
    got = []
    zero_counts()
    # the last shard's launch (tile 1, sample 1) kept for its plain version
    call = capture_calls(mk, "mega_pass", lambda: got.append(render_sharded(
        scene, cam, cfg, key, mesh)), {3})[0]
    torch.cuda.synchronize()
    launches = counts()
    img = got[0]
    a = call["args"]
    band = {k: a[k] for k in ("ip_offset", "row_offset", "n_rows",
                              "k_samples")}
    want = mk.render_pass_plain(
        a["table"], a["cam"], a["config"], *rng.key_words(a["key"]),
        n_spheres=a["n_spheres"], **band)
    vs_plain = dict(compare_pass(
        "shard_mega shard (1, 1)", *call["out"], *want), **band,
        strict=k1_strict("shard_mega shard (1, 1)", a["config"],
                         *call["out"], *want))
    ref, rays = render_with_stats(scene, cam, cfg, key, device=dev)
    ms, _ = cuda_ms(lambda: render_sharded(scene, cam, cfg, key, mesh), 3,
                    skip_first=True)
    ref_ms, _ = cuda_ms(lambda: render_with_stats(scene, cam, cfg, key,
                                                  device=dev), 3,
                        skip_first=True)
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                launches=launches, shard_vs_plain=vs_plain,
                vs_single=allclose_gate("shard_mega", img, ref, 1e-5),
                image_gate=gate(img.cpu().numpy(), ref.cpu().numpy(),
                                MAX_FRAC),
                ms=ms, single_pass_ms=ref_ms, rays_single=int(rays))


def _streams_equal(name, sharded, singles, rows: int) -> dict:
    """Each shard (t, s)'s band state against rows [t rows, (t + 1) rows)
    of the single-device stream s, plane for plane, bit for bit."""
    from smallpt_tpu_torch.ops import megakernel as mk

    for (t, s), (f, i) in sharded.states.items():
        fs, is_ = mk._planes(singles[s].f, singles[s].i)
        fb, ib = mk._planes(f, i)
        g = rows * sharded.config.width
        for a, b, what in ((fb, fs, "f"), (ib, is_, "i")):
            if not bool((a[:, :g] == b[:, t * g:(t + 1) * g]).all()):
                raise AssertionError(f"{name}: shard ({t}, {s}) {what} "
                                     "planes differ from the single stream")
    return dict(states_equal=True)


def shard_stream_vs_plain(name, call, dda: bool) -> dict:
    """A captured sharded streaming launch (capture_calls with the state
    copied before it) against stream_step_plain or stream_step_dda_plain
    from that state on the same band, key and budget (state_gate, drained
    when the kernel's launch drained; also under k3_strict or
    k1_strict)."""
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd

    a = call["args"]
    cfg, n_rows = a["config"], a["n_rows"]
    band = {k: a[k] for k in ("ip_offset", "row_offset", "n_rows")}
    fk, ik, rk = call["out"]
    fp, ip_ = call["before"]["f"], call["before"]["i"]
    if a["sample_budget"] is not None:
        mk.set_sample_budget(ip_, a["sample_budget"], cfg, n_rows)
    k0, k1 = rng.key_words(a["key"])
    if dda:
        rp = sd.stream_step_dda_plain(a["tables"], a["cam"], cfg, k0, k1,
                                      fp, ip_, a["n_iters"], **band)[2]
    else:
        rp = mk.stream_step_plain(a["table"], a["cam"], cfg, k0, k1, fp, ip_,
                                  a["n_iters"], n_spheres=a["n_spheres"],
                                  **band)[2]
    rays_close(name, int(rk), int(rp))
    st = state_gate(name, cfg, fk, ik, fp, ip_,
                    drained=mk.stream_pending(ik) == (0, 0), n_rows=n_rows)
    st["strict"] = (k3_strict if dda else k1_strict)(name, cfg, fk, ik, fp,
                                                     ip_)
    return dict(st, launch_rays_kernel=int(rk), launch_rays_plain=int(rp),
                n_iters=a["n_iters"], budget=a["sample_budget"], **band)


def shard_stream(name, scene, cfg, dev, budget: int, dda: bool) -> dict:
    """ShardedStreamingRenderer on the 2 x 2 mesh (one step of budget
    samples a shard, then the flush) against two single-device
    StreamingRenderers keyed fold_in(key, s): every shard's band state bit
    for bit, the accumulators and the image exactly; the last shard's
    first launch (K1c or K3 on rows H/2..H-1, key fold_in(key, 1)) against
    the plain version on its own input state (shard_stream_vs_plain)."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import stream_dda as sd
    from smallpt_tpu_torch.parallel import ShardedStreamingRenderer

    cam = smallpt_camera()
    n_iters = cfg.max_depth * budget + 64
    mod, wrapper = (sd, "stream_step_dda") if dda else (mk, "stream_step")
    got = []

    def run():
        r = ShardedStreamingRenderer(scene, cam, cfg, shard_mesh(dev),
                                     seed=2)
        got.append((r, r.step(n_iters=n_iters, add_samples=budget)))
        r.flush()

    zero_counts()
    t0 = time.perf_counter()
    # the last shard's first launch (tile 1, sample 1) kept for its plain
    # version
    call = capture_calls(mod, wrapper, run, {3}, state=("f", "i"))[0]
    (r, rays), = got
    rad, w = r.accumulators()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    if r.dda != dda:
        raise AssertionError(f"{name}: dda {r.dda}, expected {dda}")
    vs_plain = shard_stream_vs_plain(f"{name} shard (1, 1)", call, dda)
    singles = []
    for s in range(2):
        one = StreamingRenderer(scene, cam, cfg, seed=2, device=dev)
        one.key = rng.fold_in(rng.base_key(2), s)
        one.step(n_iters=n_iters, add_samples=budget)
        one.flush()
        singles.append(one)
    rad1 = singles[0].accumulators()[0] + singles[1].accumulators()[0]
    w1 = singles[0].accumulators()[1] + singles[1].accumulators()[1]
    out = _streams_equal(name, r, singles, cfg.height // 2)
    if not (torch.equal(rad, rad1) and torch.equal(w, w1)):
        raise AssertionError(f"{name}: accumulators differ from the single "
                             "streams")
    if not bool((w == 2 * budget).all()):
        raise AssertionError(f"{name}: weights {float(w.min())}.."
                             f"{float(w.max())}")
    return dict(out, width=cfg.width, height=cfg.height, spp=2 * budget,
                launches=launches, shard_vs_plain=vs_plain, rays=rays,
                wall_ms=wall_ms,
                image_mean=float(r.image.mean()), accumulators_equal=True)


def shard_binned(dev, scene) -> dict:
    """ShardedBinnedRenderer on the 2 x 2 mesh, scene
    (procedural_sphere_scene(10000)) at 512x384, 2 samples a shard (4
    spp), max_depth 24, against the single-device BinnedStreamingRenderer
    with n_streams=2 (one lane a pixel): bit for bit (the JAX package's
    contract). Two launches of the last shard (its band's lane ids offset
    by pixel_lo), the first and one in the flush, against K8's plain
    version on their own input states (k8_vs_plain: bit-equal)."""
    import torch

    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.engine.binned import BinnedStreamingRenderer
    from smallpt_tpu_torch.parallel import ShardedBinnedRenderer

    cfg = RenderConfig(width=512, height=384, spp_per_cell=1, max_depth=24,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    cam = smallpt_camera()
    got = []

    def run():
        got.append(ShardedBinnedRenderer(scene, cam, cfg, shard_mesh(dev),
                                         seed=0))
        got[0].step(add_samples=2, n_bounces=8)
        got[0].flush()

    zero_counts()
    t0 = time.perf_counter()
    # the last shard's (tile 1, sample 1) first launch and its 41st, in the
    # flush: the shards take each bounce in turn
    caps = capture_binned(run, {3, 4 * 40 + 3})
    r = got[0]
    rad, w = r.accumulators()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    if len(caps) != 2:
        raise AssertionError(f"shard_binned: {launches} launches")
    vs_plain = {k: k8_vs_plain(f"shard_binned shard (1, 1) {k}", cap)
                for k, cap in zip(("first", "flush"), caps)}
    one = BinnedStreamingRenderer(scene, cam, cfg, seed=0, n_streams=2,
                                  inflight=1, device=dev)
    one.step(add_samples=4, n_bounces=8)
    one.flush()
    rad1, w1 = one.accumulators()
    if not (torch.equal(rad, rad1) and torch.equal(w, w1)):
        raise AssertionError("shard_binned: accumulators differ from "
                             f"n_streams=2: {float((rad - rad1).abs().max())}")
    if r.stats.rays != one.stats.rays:
        raise AssertionError(f"shard_binned: rays {r.stats.rays} vs "
                             f"{one.stats.rays}")
    return dict(width=cfg.width, height=cfg.height, spp=4,
                launches=launches, shard_vs_plain=vs_plain,
                rays=r.stats.rays, wall_ms=wall_ms, equal=True,
                max_abs_err=0.0)


def shard_replay(dev) -> dict:
    """image_loss_and_grads_sharded at config 4 (Cornell 512x512, 4 spp,
    max_depth 16, Intersector.PALLAS) on the 2 x 2 mesh: four K1b records,
    four replays, against the single-device image_loss_and_grads (the
    replay too): the loss and image to 1e-5, the gradients within 1e-4
    (index_add adds in no fixed order on the card). The last K1b launch
    (rows 256-511, in-pixel samples 2 and 3) against its plain version on
    its own inputs (record_strict: every lane, bit for bit)."""
    import torch

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.grad import diff, replay
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.parallel.replay_shard import (
        image_loss_and_grads_sharded,
    )

    cfg = grad_config()
    scene, cam, key = cornell_box_scene(), smallpt_camera(), rng.base_key(0)
    target = replay.record_forward(scene, cam, cfg, rng.base_key(99),
                                   device=dev)[0]
    got = []
    zero_counts()
    t0 = time.perf_counter()
    # the last record launch (tile 1, sample 1: one launch a shard) kept
    # for its plain version
    call = capture_calls(mk, "_record_launch", lambda: got.append(
        image_loss_and_grads_sharded(scene, cam, cfg, key, target,
                                     shard_mesh(dev))), {3})[0]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = counts()
    (loss, img, grads), = got
    a = call["args"]
    band = {k: a[k] for k in ("ip_offset", "row_offset", "n_rows",
                              "k_samples")}
    vs_plain = dict(record_strict(
        "shard_replay shard (1, 1)", call["out"], mk.record_pass_plain(
            a["table"], a["cam"], a["config"], a["k0"], a["k1"],
            n_spheres=a["n_spheres"], **band)), **band)
    loss1, img1, grads1 = diff.image_loss_and_grads(scene, cam, cfg, key,
                                                    target, device=dev)
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp,
                max_depth=cfg.max_depth, launches=launches,
                shard_vs_plain=vs_plain, step_ms=step_ms,
                loss=float(loss), loss_single=float(loss1),
                loss_gate=allclose_gate("shard_replay loss", loss, loss1,
                                        1e-5),
                image=allclose_gate("shard_replay image", img, img1, 1e-5),
                grads=_grads_close("shard_replay", grads, grads1, 1e-4))


def _rank_worker(rank: int, world: int, port: int, out: str,
                 device: str) -> None:
    """One of the two processes of distributed_two_ranks: gloo on the one
    card (device), a 2 x 1 mesh over the ranks' devices, the MEGA pass;
    each rank saves the image it ends with (the all_reduced whole)."""
    import torch

    sys.path.insert(0, REPO)
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.parallel import distributed, render_sharded

    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        mesh = distributed.global_mesh(devices=[device])
        img = render_sharded(cornell_box_scene(), smallpt_camera(),
                             mega_config(), rng.base_key(5), mesh)
        np.save(os.path.join(out, f"rank{rank}.npy"), img.cpu().numpy())
    finally:
        torch.distributed.destroy_process_group()


def distributed_two_ranks(dev) -> dict:
    """Two gloo ranks spawned on the one card (NCCL refuses two ranks on
    one device), each rendering its band of MEGA Cornell at 1024x768, 4
    spp; the all_reduced image of each rank against the single-device
    pass (rtol 2e-5, the JAX package's test_distributed bar)."""
    import socket

    import torch
    import torch.multiprocessing as tmp

    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import cornell_box_scene
    from smallpt_tpu_torch.engine.renderer import render_with_stats

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tempfile.mkdtemp(prefix="smallpt_ranks_")
    t0 = time.perf_counter()
    tmp.spawn(_rank_worker, args=(2, port, out, str(dev)), nprocs=2,
              join=True)
    wall_s = time.perf_counter() - t0
    ref = render_with_stats(cornell_box_scene(), smallpt_camera(),
                            mega_config(), rng.base_key(5), device=dev)[0]
    res = {}
    for r in range(2):
        img = torch.from_numpy(np.load(os.path.join(out, f"rank{r}.npy")))
        res[f"rank{r}"] = allclose_gate(f"rank {r}", img, ref, 2e-5)
    return dict(res, backend="gloo", world=2, wall_s=wall_s)


# the host surfaces' configuration: bench.py's per pass (Cornell, 1024x768,
# 4 spp a pass, max_depth 48) and the 10,000-sphere scene load_scene swaps in
SURF_W, SURF_H, SURF_SPHERES = 1024, 768, 10_000


def _session_lines(lines, r, records):
    """The session's in-memory stream: a line is read once the previous
    request has been taken by a pass and a pass has ended since, so each
    request restarts the accumulation in a pass of its own."""
    for ln in lines:
        n, deadline = len(records), time.perf_counter() + 120
        while r.pending_requests or len(records) <= n:
            if time.perf_counter() > deadline:
                raise AssertionError("session stream: no pass for 120 s")
            time.sleep(1e-3)
        yield ln


def host_surfaces(dev) -> dict:
    """The host surfaces on bench.py's per-pass configuration (Cornell,
    1024x768, 4 spp a pass, max_depth 48; K1a): an InteractiveSession over
    an in-memory stream (update_camera, u, d, reset, snapshot, quit) driving
    a ProgressiveRenderer, each pass that restarts the accumulation
    bit-equal to a fresh renderer's first pass at its camera, and the time
    from a camera request to the end of the pass showing it; load_scene of
    a 10,000-sphere scene file (its next pass through the binned drain, K8,
    bit-equal to a fresh renderer's) and back to the Cornell box; run with
    frames through the native writer, each file byte-equal to the numpy
    writer's on the same image, and a frame's write time; a checkpoint at
    pass 2 resumed to pass 4, byte-equal to four passes; the CLI in
    process (--frames, --scene-file, --interactive on a replaced stdin,
    --checkpoint and --resume); occupancy_profile on REGEN through K2,
    whose sum is render_with_stats' rays; one pass under trace."""
    import io

    import torch

    from smallpt_tpu_torch import cli
    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.core.scene_io import (
        load_scene, save_scene, scene_to_dict,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.engine.renderer import render_with_stats
    from smallpt_tpu_torch.interactive import InteractiveSession
    from smallpt_tpu_torch.utils import image as img_io
    from smallpt_tpu_torch.utils import metrics, native

    cfg = RenderConfig(width=SURF_W, height=SURF_H, spp_per_cell=1,
                       max_depth=48, camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    cornell, legacy = cornell_box_scene(), smallpt_camera()
    tmp = tempfile.mkdtemp(prefix="smallpt_torch_surfaces_")
    out = {}

    def fresh(scene, camera, seed=0):
        f = ProgressiveRenderer(scene, camera, cfg, seed=seed, device=dev)
        f.step()
        return f.accum

    # ---- the session: each request lands between two passes
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=0, device=dev)
    records, enq = [], []
    real_step, real_enqueue = r.step, r.enqueue

    def step(n_passes=1):
        real_step(n_passes)
        r.image  # the frame on the host: the copy synchronizes
        records.append(dict(
            count=r.sample_count, camera=r.camera,
            accum=r.accum.clone() if r.sample_count == 1 else None,
            t=time.perf_counter()))

    def enqueue(req):
        enq.append(time.perf_counter())
        real_enqueue(req)

    r.step, r.enqueue = step, enqueue
    snap = os.path.join(tmp, "snap.png")
    lines = [json.dumps({"action": "update_camera",
                         "org": [50.0, 53.0, 295.6]}), "u", "d",
             json.dumps({"action": "reset"}),
             json.dumps({"action": "snapshot", "path": snap}),
             json.dumps({"action": "quit"})]
    session = InteractiveSession(r, stream=_session_lines(lines, r,
                                                          records))
    zero_counts()
    t0 = time.perf_counter()
    passes = session.run(max_passes=200)
    session.reader.join(timeout=60)
    torch.cuda.synchronize()
    launched = counts()
    if session.reader.is_alive():
        raise AssertionError("session reader thread did not end")
    restarts = [rec for rec in records if rec["count"] == 1]
    # the first pass, and one for each of update_camera, u, d and reset
    if len(restarts) != 5 or not os.path.exists(snap):
        raise AssertionError(f"session: {len(restarts)} restarts, snapshot "
                             f"{os.path.exists(snap)}")
    for rec in restarts:
        if not torch.equal(rec["accum"], fresh(cornell, rec["camera"])):
            raise AssertionError("session: a restarted pass differs from a "
                                 "fresh renderer's first pass")
    ys = [float(rec["camera"].origin[1]) for rec in restarts]
    # each request's pass: the restarts after the first
    latency = [(rec["t"] - e) * 1e3 for e, rec in zip(enq, restarts[1:])]
    if not launched["mega_pass"] or any(
            v for k, v in launched.items() if k != "mega_pass"):
        raise AssertionError(f"session: launches {launched}")
    out["session"] = dict(passes=passes, seconds=time.perf_counter() - t0,
                          launches=launched, restarts_bit_equal=len(restarts),
                          camera_y=ys, request_to_frame_ms=latency)

    # ---- load_scene: 10,000 spheres from a file (the binned drain), back
    path = os.path.join(tmp, "procedural.json")
    save_scene(procedural_sphere_scene(SURF_SPHERES), path)
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=0, device=dev)
    r.step()
    r.enqueue({"action": "load_scene", "path": path})
    zero_counts()
    t = time.perf_counter()
    r.step()
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t) * 1e3
    launched = counts()
    if (r.route != "binned" or not launched["stream_step_binned"]
            or not torch.equal(r.accum, fresh(load_scene(path), legacy))):
        raise AssertionError(f"load_scene of 10,000 spheres: route "
                             f"{r.route}, launches {launched}, or the pass "
                             "differs from a fresh renderer's")
    r.enqueue({"action": "load_scene", "scene": scene_to_dict(cornell)})
    r.step()
    if r.route != "mega" or not torch.equal(r.accum, fresh(cornell, legacy)):
        raise AssertionError("load_scene back to the Cornell box differs")
    out["load_scene"] = dict(route="binned", launches=launched,
                             request_to_frame_ms=load_ms,
                             back_to_cornell_route="mega")

    # ---- run with frames through the native writer
    frames = os.path.join(tmp, "frames", "f_%02d.ppm")
    shown = []
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=1, device=dev)
    t = time.perf_counter()
    r.run(4, on_frame=lambda p: shown.append(p.image), frame_pattern=frames)
    run_ms = (time.perf_counter() - t) * 1e3
    # each frame byte-equal to the synchronous writer of the same image:
    # the native one (the two tone maps round apart, ROADMAP.md H10), or
    # without the library, the numpy one the sink falls back to
    binary = native.available()
    for i, img in enumerate(shown, 1):
        ref = os.path.join(tmp, "ref.ppm")
        if binary:
            native.write_ppm(ref, img[::-1], binary=True)
        else:
            img_io.write_ppm(ref, img)
        with open(frames % i, "rb") as fa, open(ref, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"frame {i} differs from the "
                                     "synchronous writer's file")
    img = shown[-1]
    tonemap_apart = (int((native.tonemap(img) != img_io.to_int(img)).sum())
                     if binary else None)
    native_ms = numpy_ms = None
    if binary:
        t = time.perf_counter()
        native.write_ppm(os.path.join(tmp, "n.ppm"), img[::-1], binary=True)
        native_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    img_io.write_ppm_binary(os.path.join(tmp, "p.ppm"), img)
    numpy_ms = (time.perf_counter() - t) * 1e3
    out["run_frames"] = dict(native=binary, frames=len(shown),
                             byte_equal=True, run_ms=run_ms,
                             tonemap_values_apart=tonemap_apart,
                             frame_write_ms_native=native_ms,
                             frame_write_ms_numpy=numpy_ms)

    # ---- a per-pass checkpoint at pass 2, resumed to pass 4
    ck = os.path.join(tmp, "ck.npz")
    a = ProgressiveRenderer(cornell, legacy, cfg, seed=2, device=dev)
    a.step(2)
    t = time.perf_counter()
    a.save_checkpoint(ck)
    save_ms = (time.perf_counter() - t) * 1e3
    b = ProgressiveRenderer(cornell, legacy, cfg, seed=2, device=dev)
    t = time.perf_counter()
    b.load_checkpoint(ck)
    load_ck_ms = (time.perf_counter() - t) * 1e3
    b.step(2)
    c = ProgressiveRenderer(cornell, legacy, cfg, seed=2, device=dev)
    c.step(4)
    if not (torch.equal(b.accum, c.accum) and b.sample_count == 4
            and np.array_equal(b.image, c.image)):
        raise AssertionError("resumed passes differ from four passes")
    out["checkpoint"] = dict(byte_equal=True, save_ms=save_ms,
                             load_ms=load_ck_ms,
                             bytes=os.path.getsize(ck))

    # ---- the CLI in process
    cpath = os.path.join(tmp, "cornell.json")
    save_scene(cornell, cpath)
    common = ["4", "--width", str(SURF_W), "--height", str(SURF_H),
              "--max-depth", "48", "--device", dev.type, "--quiet"]
    f = {n: os.path.join(tmp, n + ".ppm") for n in (
        "one", "file", "frames", "inter", "a", "b", "four")}
    zero_counts()
    t = time.perf_counter()
    stdin = sys.stdin
    try:
        rc = [cli.main(common + ["--passes", "2", "--out", f["one"]]),
              cli.main(common + ["--passes", "2", "--scene-file", cpath,
                                 "--out", f["file"]]),
              cli.main(common + ["--passes", "3", "--out", f["frames"],
                                 "--frames", os.path.join(
                                     tmp, "cli_frames", "f_%02d.ppm")])]
        sys.stdin = io.StringIO(lines[0] + "\nu\n" + lines[-1] + "\n")
        rc.append(cli.main(common + ["--interactive", "--out", f["inter"]]))
    finally:
        sys.stdin = stdin
    rc += [cli.main(common + ["--passes", "2", "--out", f["a"],
                              "--checkpoint", ck]),
           cli.main(common + ["--passes", "2", "--out", f["b"],
                              "--resume", ck]),
           cli.main(common + ["--passes", "4", "--out", f["four"]])]
    torch.cuda.synchronize()
    launched = counts()

    def same(x, y):
        with open(f[x], "rb") as fx, open(f[y], "rb") as fy:
            return fx.read() == fy.read()

    n_frames = len(os.listdir(os.path.join(tmp, "cli_frames")))
    if (rc != [0] * 7 or not same("one", "file") or not same("b", "four")
            or n_frames != 3 or not launched["mega_pass"]):
        raise AssertionError(f"CLI: rc {rc}, frames {n_frames}, launches "
                             f"{launched}")
    out["cli"] = dict(seconds=time.perf_counter() - t, launches=launched,
                      scene_file_byte_equal=True, frames=n_frames,
                      resume_byte_equal=True, interactive_rc=0)

    # ---- occupancy on REGEN through K2, and one pass under trace
    rcfg = cfg.replace(scheduler=Scheduler.REGEN,
                       intersector=Intersector.PALLAS)
    key = rng.fold_in(rng.base_key(0), 3)
    zero_counts()
    t = time.perf_counter()
    occ = metrics.occupancy_profile(cornell, legacy, rcfg, key, device=dev)
    occ_s = time.perf_counter() - t
    launched = counts()
    _, rays = render_with_stats(cornell, legacy, rcfg, key, device=dev)
    if (int(occ.sum()) != int(rays) or occ[0] != rcfg.n_pixels
            or not launched["closest_hit"]):
        raise AssertionError(f"occupancy: sum {int(occ.sum())} vs rays "
                             f"{int(rays)}, launches {launched}")
    out["occupancy_regen_k2"] = dict(
        iterations=len(occ), sum=int(occ.sum()), rays=int(rays),
        seconds=occ_s, launches=launched,
        utilization_first_last=[float(occ[0] / rcfg.n_pixels),
                                float(occ[-1] / rcfg.n_pixels)],
        utilization_mean=float(occ.mean() / rcfg.n_pixels))
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=0, device=dev)
    r.step()
    tdir = os.path.join(tmp, "trace")
    out["trace"] = trace_pass(r.step, tdir)
    return out


def oracle_gate(rad: np.ndarray, scene, camera, cfg, key, step: int,
                stream: bool, max_frac: float, device) -> dict:
    """A route's one-frame summed radiance rad (H, W, 3) against the port's
    f64 oracle (smallpt_tpu_torch/oracle/numpy_oracle.py) on every step-th
    pixel, the oracle replaying the route's keying: StreamUniformProvider
    for the streaming and binned routes, else PrecomputedUniformProvider,
    its uniforms drawn on ``device``. The gate of tests/test_golden.py
    (gate(): at most max_frac of values with |a-b|/(1+|b|) > 0.1, the
    means within ORACLE_MEAN). Raises on a failed gate."""
    from smallpt_tpu_torch.oracle.numpy_oracle import (
        Oracle, PrecomputedUniformProvider, StreamUniformProvider,
    )

    pixels = np.arange(0, cfg.n_pixels, step, dtype=np.int64)
    sids = (pixels[:, None] * cfg.spp + np.arange(cfg.spp)).reshape(-1)
    t = time.perf_counter()
    provider = (StreamUniformProvider(key, cfg, sids, device=device)
                if stream else
                PrecomputedUniformProvider(key, sids=sids, device=device))
    ovals = Oracle(scene, camera, cfg, provider).render_pixels(pixels)
    oracle_s = time.perf_counter() - t
    rvals = np.asarray(rad).reshape(-1, 3)[pixels]
    return dict(gate(rvals, ovals, max_frac, ORACLE_MEAN),
                pixels=len(pixels), mean=float(rvals.mean()),
                oracle_mean=float(ovals.mean()), oracle_s=oracle_s,
                keying="stream" if stream else "classic")


def provider_draws(provider, sids, hists, depths, slots) -> np.ndarray:
    """Every uniform a provider gives the samples sids: camera, lens, and
    at each (hist, depth) the shade and NEE draws of each light slot, in
    one float64 vector."""
    rows = []
    for s in sids:
        rows += [provider.camera(s), provider.lens(s)]
        for h in hists:
            for d in depths:
                rows.append(provider.shade(s, h, d))
                rows += [provider.nee(s, h, d, k) for k in slots]
    return np.concatenate(rows)


def uniforms_card_vs_cpu(key, cfg, sids, dev) -> dict:
    """The oracle's providers draw on the card what they draw on the CPU,
    bit for bit: every uniform of sids through PrecomputedUniformProvider
    (split histories 0-2) and StreamUniformProvider (history 0), and the
    per-sample UniformProvider on the first 8 sids, at every depth below
    cfg.max_depth and NEE slots 0 and 1."""
    from smallpt_tpu_torch.oracle.numpy_oracle import (
        PrecomputedUniformProvider, StreamUniformProvider, UniformProvider,
    )

    depths = range(cfg.max_depth)
    out = {}
    for name, make, n, hists in (
            ("precomputed", lambda d: PrecomputedUniformProvider(
                key, sids=sids, device=d), len(sids), (0, 1, 2)),
            ("stream", lambda d: StreamUniformProvider(
                key, cfg, sids, device=d), len(sids), (0,)),
            ("per_sample", lambda d: UniformProvider(key, device=d), 8,
             (0, 1, 2))):
        card, cpu = (provider_draws(make(d), sids[:n], hists, depths, (0, 1))
                     for d in (dev, "cpu"))
        if not np.array_equal(card.view(np.uint64), cpu.view(np.uint64)):
            raise AssertionError(f"uniforms {name}: the card's draws differ "
                                 f"from the CPU's in "
                                 f"{int((card != cpu).sum())} values")
        out[name] = dict(sids=n, values=int(card.size), equal=True)
    return out


def oracle_phases(dev) -> dict:
    """The main paths at full width against the port's f64 oracle, each
    one frame at 1 spp, jitter 1, max_depth 12 (the JAX suite's oracle
    settings) through its entry point on the card, seed or key 21, the
    launch counts zeroed before the frame and its kernel's count read
    after (oracle_gate's subsample, keying and gate per phase):
    - K1a: engine/renderer.py::render of the Cornell box at 1024x768 (the
      per-pass megakernel route), every 4,243rd pixel, classic keying;
    - K1c: StreamingRenderer (one stream) on the same, budget 1, drained,
      without and with NEE on sphere 8, streaming keying;
    - K8: render of procedural_sphere_scene(2100, seed=7) at 512x384 (the
      binned drain above MEGA_MAX_SPHERES), every 1,051st pixel, streaming
      keying, MAX_FRAC_PROCEDURAL;
    - K3: StreamingRenderer on procedural_sphere_scene(10000) at 512x384
      (dda_auto), budget 1, drained, streaming keying, MAX_FRAC_PROCEDURAL;
    - K2: render with REGEN and Intersector.PALLAS on the same scene,
      classic keying, MAX_FRAC_PROCEDURAL (the K1a-vs-K2 gate of path 2,
      F8);
    - K6, then K7: render with FLAT and Intersector.PALLAS of
      procedural_mesh_scene(500) at 256x192, every 263rd pixel, classic
      keying, then the same frame with MESH_ACCEL_MIN_TRIS = 1 (as
      flat_culled_path sets it), bit-equal to K6's.
    Then the providers' draws on the card against the CPU's for the first
    phase's samples (uniforms_card_vs_cpu). Each phase prints its line."""
    import torch

    from smallpt_tpu_torch.config import (
        CameraModel, Filter, Intersector, RenderConfig, Scheduler,
    )
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import smallpt_camera
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, procedural_mesh_scene, procedural_sphere_scene,
    )
    from smallpt_tpu_torch.engine import renderer
    from smallpt_tpu_torch.engine.streaming import StreamingRenderer

    cam, key = smallpt_camera(), rng.base_key(ORACLE_SEED)
    base = RenderConfig(width=1024, height=768, jitter_size=1,
                        spp_per_cell=1, max_depth=12,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    out = {}

    def frame(name, kernel, fn):
        """fn()'s (H, W, 3) radiance on the host, the host seconds of the
        frame and the launches of ``kernel`` in it (raises at none)."""
        torch.cuda.synchronize()
        zero_counts()
        t = time.perf_counter()
        rad = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counts()
        if not launched[kernel]:
            raise AssertionError(f"{name}: {kernel} did not launch "
                                 f"({launched})")
        return rad.cpu().numpy(), dict(frame_s=seconds,
                                       launches={kernel: launched[kernel]})

    def streamed(scene, cfg, dda: bool):
        def fn():
            r = StreamingRenderer(scene, cam, cfg, seed=ORACLE_SEED,
                                  device=dev)
            if (r._dda is not None) != dda:
                raise AssertionError("StreamingRenderer took the other "
                                     "route")
            r.step(n_iters=cfg.max_depth + 16, add_samples=1)
            r.flush()
            rad, w = r.accumulators()
            if not bool((w == 1).all()):
                raise AssertionError(f"weights {float(w.min())}.."
                                     f"{float(w.max())}, want 1")
            return rad
        return fn

    def run(name, kernel, fn, scene, cfg, step, stream, max_frac):
        rad, info = frame(name, kernel, fn)
        out[name] = dict(info, **oracle_gate(
            rad, scene, cam, cfg, key, step, stream, max_frac, dev))
        phase(name, **out[name])
        return rad

    cornell = cornell_box_scene()
    run("oracle_mega_cornell_1024x768", "mega_pass",
        lambda: renderer.render(cornell, cam, base, key, device=dev),
        cornell, base, 4243, False, ORACLE_MAX_FRAC)
    for name, cfg in (("oracle_stream_cornell_1024x768", base),
                      ("oracle_stream_cornell_1024x768_nee",
                       base.replace(nee_lights=(8,)))):
        run(name, "stream_step", streamed(cornell, cfg, False), cornell, cfg,
            4243, True, ORACLE_MAX_FRAC)

    pcfg = base.replace(width=512, height=384)
    small = procedural_sphere_scene(2100, seed=7)
    run("oracle_binned_procedural2100_512x384", "stream_step_binned",
        lambda: renderer.render(small, cam, pcfg, key, device=dev),
        small, pcfg, 1051, True, MAX_FRAC_PROCEDURAL)
    big = procedural_sphere_scene(10000)
    run("oracle_dda_procedural10000_512x384", "stream_step_dda",
        streamed(big, pcfg, True), big, pcfg, 1051, True,
        MAX_FRAC_PROCEDURAL)
    rcfg = pcfg.replace(scheduler=Scheduler.REGEN,
                        intersector=Intersector.PALLAS)
    run("oracle_regen_procedural10000_512x384", "closest_hit",
        lambda: renderer.render(big, cam, rcfg, key, device=dev),
        big, rcfg, 1051, False, MAX_FRAC_PROCEDURAL)

    mesh = procedural_mesh_scene(500)
    mcfg = base.replace(width=256, height=192, scheduler=Scheduler.FLAT,
                        intersector=Intersector.PALLAS)
    name = "oracle_mesh500_256x192"
    rad6 = run(name, "closest_tri",
               lambda: renderer.render(mesh, cam, mcfg, key, device=dev),
               mesh, mcfg, 263, False, ORACLE_MAX_FRAC)
    old = renderer.MESH_ACCEL_MIN_TRIS
    renderer.MESH_ACCEL_MIN_TRIS = 1
    try:
        rad7, info = frame(
            name, "closest_tri_culled",
            lambda: renderer.render(mesh, cam, mcfg, key, device=dev))
    finally:
        renderer.MESH_ACCEL_MIN_TRIS = old
    if not np.array_equal(rad6, rad7):
        raise AssertionError(f"{name}: the K7 frame differs from the K6 "
                             "frame")
    out[name]["culled"] = dict(info, bit_equal_to_k6=True)
    phase(f"{name}_culled", **out[name]["culled"])

    pixels = np.arange(0, base.n_pixels, 4243, dtype=np.int64)
    out["uniforms"] = uniforms_card_vs_cpu(key, base, pixels, dev)
    phase("oracle_uniforms_card_vs_cpu", **out["uniforms"])
    out["oracle_s"] = sum(v["oracle_s"] for v in out.values()
                          if "oracle_s" in v)
    return out


def trace_pass(step, tdir) -> dict:
    """utils/metrics.py::trace over one call of step (a K1a pass): the
    file it wrote, its events, its device-kernel events and their device
    ms. Every launch of a hand-written kernel in the call must be in the
    file; a trace that lost one is taken again held open longer (HOLDS_S;
    PERF.md section 7, F11) and the last hold raises. K1a's traced time
    must be within 10% of its CUDA-event time on the same inputs (the
    launch captured from a further call of step, a ProgressiveRenderer's,
    timed apart)."""
    import torch

    from smallpt_tpu_torch.engine import progressive
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.utils import metrics

    for hold in HOLDS_S:
        sub = os.path.join(tdir, f"hold_{hold:g}")
        torch.cuda.synchronize()
        before = counts()
        with metrics.trace(sub, hold_s=hold) as prof:
            step()
            torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts().items()}
        files = os.listdir(sub)
        if len(files) != 1 or os.path.getsize(
                os.path.join(sub, files[0])) == 0:
            raise AssertionError(f"trace wrote {files}")
        with open(os.path.join(sub, files[0])) as f:
            events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        seen, off = events_off((e.get("name", "") for e in kern), launched)
        if not off:
            break
    if off or launched["mega_pass"] != 1:
        raise AssertionError(f"trace: (events, launches) {off} of the "
                             f"hand-written kernels held open {hold} s, "
                             f"launches {launched}")
    k1a_ms = sum(float(e.get("dur", 0.0)) for e in kern if KERNEL_EVENT[
        "mega_pass"][0].search(e.get("name", ""))) / 1e3
    call = capture_calls(progressive, "mega_pass", step, {0})[0]
    cuda_k1a_ms, _ = cuda_ms(lambda: mk.mega_pass(*call["a"], **call["k"]),
                             3)
    rel = abs(k1a_ms - cuda_k1a_ms) / cuda_k1a_ms
    if rel > 0.10:
        raise AssertionError(f"trace: K1a {k1a_ms} ms traced against "
                             f"{cuda_k1a_ms} ms in CUDA events")
    return dict(file=files[0], bytes=os.path.getsize(
                    os.path.join(sub, files[0])),
                hold_s=hold, events=len(events), kernel_events=len(kern),
                hand_written_events=seen, k1a_ms=k1a_ms,
                k1a_cuda_event_ms=cuda_k1a_ms, k1a_rel=rel,
                process_s=time.perf_counter() - T0,
                device_ms=sum(device_ms_by_name(prof).values()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
    from smallpt_tpu_torch.core import rng
    from smallpt_tpu_torch.core.camera import (
        default_matrix_camera, smallpt_camera,
    )
    from smallpt_tpu_torch.core.scene import (
        cornell_box_scene, cornell_box_small_light_scene, two_sphere_scene,
    )
    from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
    from smallpt_tpu_torch.engine.renderer import render
    from smallpt_tpu_torch.ops import dda
    from smallpt_tpu_torch.ops import intersect_pallas as ip
    from smallpt_tpu_torch.ops import megakernel as mk
    from smallpt_tpu_torch.ops import mesh_pallas as mp
    from smallpt_tpu_torch.ops import stream_dda as sd
    from smallpt_tpu_torch.utils import image as img_io
    from smallpt_tpu_torch.utils import nvcc

    # ---- 1. device -------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase("device", kind=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 2. build: the eight libraries at once --------------------------
    libraries = (mk.LIBRARY, sd.LIBRARY, ip.LIBRARY, mp.LIBRARY,
                 mp.LIBRARY_CULLED, mk.LIBRARY_BINNED, dda.LIBRARY,
                 ip.LIBRARY_MXU)
    t_build = time.perf_counter()
    # K8's check library (its sphere test, its plan) builds beside them
    check_lib, check_nvcc = start_k8_check()
    try:
        nvcc.build(dict(libraries))
    finally:
        _, check_err = check_nvcc.communicate(timeout=600)
    if check_nvcc.returncode:
        raise RuntimeError(f"nvcc failed on the K8 check library: "
                           f"{check_err}")
    t_build = time.perf_counter() - t_build
    mk._kernel_lib()
    mk._stream_lib()
    sd._dda_lib()
    ip._kernel_lib()
    mp._kernel_lib()
    mp._culled_lib()
    mk._binned_lib()
    dda._kernel_lib()
    ip._mxu_lib()
    builds = {}
    for lib, _ in libraries:
        info = nvcc.builds.get(lib, {"cmd": None, "seconds": 0.0,
                                     "ptxas": ""})
        builds[lib] = dict(
            cmd=" ".join(info["cmd"] or ["(already built)"]),
            seconds=round(info["seconds"], 3),
            ptxas=[ln for ln in info["ptxas"].splitlines()
                   if "Compiling" in ln or "registers" in ln])
    phase("build", wall_seconds=round(t_build, 3), **builds)

    dev = torch.device("cuda")
    cornell, legacy = cornell_box_scene(), smallpt_camera()

    # ---- 3. kernel vs plain, same device, same key, small ------------------
    cases = {
        "cornell_64x48": (cornell, legacy, RenderConfig(
            width=64, height=48, spp_per_cell=1, max_depth=24,
            camera_model=CameraModel.LEGACY, filter=Filter.TENT), 1),
        "two_sphere_matrix_box_32x32": (
            two_sphere_scene(), default_matrix_camera(), RenderConfig(
                width=32, height=32, spp_per_cell=1, max_depth=12,
                camera_model=CameraModel.MATRIX, filter=Filter.BOX), 2),
    }

    cmp_stats = {}
    for name, (scene, cam, cfg, seed) in cases.items():
        table = mk.build_scene_table(scene, cfg, dev)
        camv = mk.build_camera_vec(cam, cfg, dev)
        cmp_stats[name] = pass_vs_plain(name, table, camv, cfg,
                                        rng.base_key(seed), scene.n_spheres)
    phase("kernel_vs_plain", **cmp_stats)

    # ---- 4. golden on the card --------------------------------------------
    gcfg = RenderConfig(width=48, height=36, spp_per_cell=4, max_depth=24,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    golden = np.load(GOLDEN)["image"]
    gimg = render(cornell, legacy, gcfg, rng.base_key(7), device=dev)
    phase("golden_48x36", **gate(gimg.cpu().numpy(), golden, 0.05))

    # ---- 5. main path at full width -----------------------------------------
    cfg = RenderConfig(width=1024, height=768, spp_per_cell=1, max_depth=48,
                       camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    n_passes = 4
    mk.mega_pass.launches = 0
    r = ProgressiveRenderer(cornell, legacy, cfg, seed=0, device=dev)
    r.step()
    torch.cuda.synchronize()
    pass_ms = [cuda_ms(r.step, 1)[0] for _ in range(n_passes - 1)]
    launches = mk.mega_pass.launches
    img = r.image
    rays_total = r.stats.rays
    if launches != n_passes:
        raise AssertionError(f"{launches} kernel launches for {n_passes} "
                             "passes")
    if not np.isfinite(img).all() or img.shape != (768, 1024, 3):
        raise AssertionError("main-path image is not finite (768, 1024, 3)")
    # the same config at 256x192, 2 passes through the plain version
    small = cfg.replace(width=256, height=192)
    table = mk.build_scene_table(cornell, small, dev)
    camv = mk.build_camera_vec(legacy, small, dev)
    base = rng.base_key(0)
    ref = sum(mk.render_pass_plain(table, camv, small,
                                   *rng.key_words(rng.fold_in(base, p)),
                                   n_spheres=cornell.n_spheres)[0]
              for p in range(2)).cpu().numpy() / (2 * small.spp)
    mean_rel = float(abs(img.mean() - ref.mean()) / ref.mean())
    if mean_rel >= 0.05:
        raise AssertionError(f"main-path mean {img.mean()} vs plain "
                             f"{ref.mean()}")
    out_dir = tempfile.mkdtemp(prefix="smallpt_torch_")
    png = os.path.join(out_dir, "cornell_1024x768.png")
    img_io.write_png(png, img)
    ms = float(np.mean(pass_ms))
    rays_per_pass = rays_total / n_passes
    phase("main_path", width=cfg.width, height=cfg.height, spp=cfg.spp,
          max_depth=cfg.max_depth, passes=n_passes, launches=launches,
          rays=rays_total, pass_ms=pass_ms, ms_per_pass=ms,
          mrays_per_s=rays_per_pass / ms / 1e3, mean=float(img.mean()),
          plain_256x192_mean=float(ref.mean()), mean_rel=mean_rel, png=png)
    phase("trace_early_cornell_1024x768", **trace_pass(
        r.step, tempfile.mkdtemp(prefix="smallpt_trace_")))

    # ---- 6. the kernel alone at the main path's shapes: against its plain
    # version on one key, its time, and its bound ---------------------------
    table = mk.build_scene_table(cornell, cfg, dev)
    camv = mk.build_camera_vec(legacy, cfg, dev)
    ns = cornell.n_spheres
    key = rng.fold_in(base, 1000)
    k_ms, (rad_k, rays_k) = cuda_ms(
        lambda: mk.mega_pass(table, camv, cfg, key, n_spheres=ns), 5)
    n_rays = int(rays_k.sum())
    torch.cuda.synchronize()
    t = time.perf_counter()
    rad_p, rays_p = mk.render_pass_plain(table, camv, cfg,
                                         *rng.key_words(key), n_spheres=ns)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    cmp_stats["cornell_1024x768_main"] = dict(
        compare_pass("cornell_1024x768_main", rad_k, rays_k, rad_p, rays_p),
        strict=k1_strict("cornell_1024x768_main", cfg, rad_k, rays_k, rad_p,
                         rays_p))
    # the plain version again, counting its sphere tests for the bound
    k1_counts = {}
    mk.render_pass_plain(table, camv, cfg, *rng.key_words(key),
                         n_spheres=ns, counts=k1_counts)
    nbytes = (ns * 16 * 4 + camv.numel() * 4 + cfg.n_pixels * 16)
    k1a = dict(kernel_ms=k_ms, mrays_per_s=n_rays / k_ms / 1e3,
               plain_ms=plain_ms, **k1_bound(k1_counts, n_rays, ns, nbytes),
               lane_utilisation_one_lane_a_thread=lane_utilisation(rays_k),
               rays_per_lane_mean=n_rays / cfg.n_pixels,
               rays_per_lane_max=int(rays_k.max()),
               plan=mk.mega_plan(cfg.n_pixels, ns, 0, "pass"),
               vs_plain=cmp_stats["cornell_1024x768_main"])
    phase("kernel_timing", **k1a)

    # ---- 7. streaming kernel vs plain, small: two partial launches and a
    # drain --------------------------------------------------------------------
    scfg = cases["cornell_64x48"][2]
    table = mk.build_scene_table(cornell, scfg, dev)
    camv = mk.build_camera_vec(legacy, scfg, dev)
    partial_drain = ((4, 16), (None, 16), (None, 10_000_000))
    stream_stats = {"cornell_64x48": stream_chain(
        table, camv, scfg, rng.base_key(1), cornell.n_spheres,
        partial_drain)}
    phase("stream_vs_plain", **stream_stats)

    # ---- 8. NEE, small: per pass and streaming against the plain version,
    # and the per-pass NEE render against its golden -------------------------
    small_light = cornell_box_small_light_scene()
    ncfg = RenderConfig(width=32, height=24, spp_per_cell=1, max_depth=24,
                        nee_lights=(8,), camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT)
    table = mk.build_scene_table(small_light, ncfg, dev)
    camv = mk.build_camera_vec(legacy, ncfg, dev)
    ns, key = small_light.n_spheres, rng.base_key(2)
    cmp_stats["nee_small_light_32x24"] = pass_vs_plain(
        "nee_small_light_32x24", table, camv, ncfg, key, ns)
    stream_stats["nee_small_light_32x24"] = stream_chain(
        table, camv, ncfg, key, ns, partial_drain)
    gcfg = ncfg.replace(spp_per_cell=2, max_depth=16)
    golden = np.load(GOLDEN_NEE)["image"]
    gimg = render(small_light, legacy, gcfg, rng.base_key(11), device=dev)
    phase("nee_small", per_pass=cmp_stats["nee_small_light_32x24"],
          streaming=stream_stats["nee_small_light_32x24"],
          golden_32x24=gate(gimg.cpu().numpy(), golden, 0.02))

    # ---- 9-10. the streaming main path at full width, without and with NEE
    # (bench.py's headline configuration) ---------------------------------------
    full = {}
    for name, ncfg_ in (("cornell_1024x768", cfg),
                        ("cornell_1024x768_nee", cfg.replace(
                            nee_lights=(8,)))):
        full[name] = stream_full_width(name, cornell, ncfg_,
                                       float(img.mean()), dev)
        phase(f"stream_main_{name}", **full[name])
    stream_kernel = full["cornell_1024x768"]["kernel"]
    nee_kernel = full["cornell_1024x768_nee"]["kernel"]

    # ---- 11-13. the megakernel's other branches, the classic route above
    # 2048 spheres, and the two goldens no phase above uses --------------------
    phase("branches_vs_plain", **branch_phases(dev))
    phase("big_classic_vs_plain", **big_classic_phases(dev))
    k1_built = k1_constructed_launches(dev)
    phase("k1_constructed_launches", **k1_built)
    phase("goldens", **golden_phases(dev))

    # ---- 14. the DDA kernel against its plain version, small ---------------
    k3_stats = k3_vs_plain_phases(dev)
    phase("dda_vs_plain", **k3_stats)

    # ---- 15-17. the DDA main path: bench.py --procedural without and with
    # NEE at 512x384, then the config-5 shape ----------------------------------
    pcfg = RenderConfig(width=512, height=384, spp_per_cell=1, max_depth=24,
                        camera_model=CameraModel.LEGACY, filter=Filter.TENT)
    k3 = {}
    for name, cfg_ in (("procedural10000_512x384", pcfg),
                       ("procedural10000_512x384_nee",
                        pcfg.replace(nee_lights=(8,)))):
        k3[name] = k3_main(name, cfg_, dev)
        phase(f"dda_main_{name}", **k3[name])
    hd = k3_hd(dev)
    phase("dda_main_procedural10000_1920x1080", **hd)
    k3_built = k3_constructed_launches(dev)
    phase("k3_constructed_launches", **k3_built)
    k3_kernel = k3["procedural10000_512x384"]["kernel"]
    k3_nee_kernel = k3["procedural10000_512x384_nee"]["kernel"]
    k3_errs = [st["max_abs_err"] for case in k3_stats.values()
               for key_, st in case.items() if key_.startswith("launch")]
    k3_errs += [k3[n]["kernel"]["vs_plain"]["max_abs_err"] for n in k3]
    k3_errs += [st["max_abs_err"] for key_, st in hd["vs_plain"].items()
                if key_.startswith("launch")]
    k3_errs += [c["max_abs_err"] for c in k3_built.values()]
    ptxas = ptxas_entry(sd.LIBRARY[0])

    # ---- 18-21. the closest-hit kernels against their plain versions, the
    # goldens and the AOV modes through the wavefront routes -----------------
    k2_stats = closest_hit_phases(dev)
    phase("closest_hit_vs_plain", **k2_stats)
    k2_built = k2_constructed_launches(dev)
    phase("k2_constructed_launches", **k2_built)
    k6_stats = closest_tri_phases(dev)
    phase("closest_tri_vs_plain", **k6_stats)
    k6_built = k6_constructed_launches(dev)
    phase("k6_constructed_launches", **k6_built)
    phase("wavefront_goldens", **wavefront_golden_phases(dev))
    phase("aov_modes_256x192", **aov_phases(dev))

    # ---- 22-26. the four wavefront main paths -------------------------------
    wf = wavefront_main_paths(dev)

    # ---- 27-28. K7 against its plain version, and against K6 on the same
    # rays ------------------------------------------------------------------
    k7_stats, k7_vs_k6_stats = closest_tri_culled_phases(dev)
    phase("closest_tri_culled_vs_plain", **k7_stats)
    phase("closest_tri_culled_vs_k6", **k7_vs_k6_stats)
    k7_built = k7_constructed_launches(dev)
    phase("k7_constructed_launches", **k7_built,
          ptxas=ptxas_entry(mp.LIBRARY_CULLED[0]))

    # ---- 29-31. the culled route of FLAT, and the mesh stream through K6 and
    # through K7 --------------------------------------------------------------
    name = "flat_culled_mesh500_256x192"
    wf[name] = flat_culled_path(dev)
    phase(name, **wf[name])
    ms_paths = mesh_stream_phases(dev)

    # ---- 32. the CLI's mesh routes -----------------------------------------
    phase("cli_mesh_routes", **cli_mesh_phases(dev))

    # ---- 33-43. the binned scheduler: K8 against its plain version on small
    # drains, its four main paths at bench.py's --procedural-binned shape, two
    # constructed launches (no working lane; a dense tile cut into ranges),
    # its early-miss sphere test against sphere_tt, the image against the
    # classic route, the H4 A/B and the CLI's routes -------------------------
    k8_small = k8_small_phases(dev)
    phase("binned_vs_plain_small", **k8_small)
    from smallpt_tpu_torch.core.scene import procedural_sphere_scene

    big = procedural_sphere_scene(10_000)
    binned = {}
    for name, cfg_, drain in (
            ("binned_drain_procedural10000_512x384", pcfg, True),
            ("binned_drain_procedural10000_512x384_nee",
             pcfg.replace(nee_lights=(8,)), True),
            ("binned_stream_procedural10000_512x384", pcfg, False),
            ("binned_stream_procedural10000_512x384_nee",
             pcfg.replace(nee_lights=(8,)), False)):
        binned[name] = binned_path(name, big, cfg_, dev, drain)
        phase(name, **binned[name])
    k8_built = k8_constructed(big, pcfg, dev, check_lib)
    phase("k8_constructed_launches", **k8_built)
    phase("k8_sphere_test_edges", **k8_sphere_edges(dev, check_lib))
    phase("binned_vs_classic", **binned_vs_classic(big, pcfg, dev))
    phase("h4_binned_vs_regen_k2", **h4_ab(big, pcfg, dev))
    phase("cli_binned_routes", **cli_binned_phases(dev))
    opts = binned_options(big, pcfg, dev)
    phase("binned_sort_and_three_program_procedural10000_512x384", **opts)

    # ---- 42-45. the gradient path: K1b against its plain version, the
    # record against K1a, the gradients on the card at 12x12 against the
    # CPU's and the FD gates, then config 4 (bench.py --diff) -----------------
    rec_small = record_vs_plain_small(dev)
    phase("record_vs_plain_small", **rec_small)
    rec_mega = record_vs_mega(dev)
    phase("record_vs_mega", **rec_mega,
          ptxas=ptxas_entry(mk.LIBRARY[0], "mega_record_kernel"))
    k1b_built = k1b_constructed_launches(dev)
    phase("k1b_constructed_launches", **k1b_built)
    phase("grad_small", **grad_small(dev))
    gmain = grad_main(dev)
    phase("grad_main_cornell_512x512", **gmain)

    # ---- 46-48. the per-ray DDA kernel K4: against its plain version on
    # tests/test_dda.py's cases, then bench_dda_tpu.py's stage 2 through
    # intersect_spheres_dda, against the plain version and K2, then on
    # constructed launches; the host surfaces on the per-pass Cornell
    # configuration -----------------------------------------------------------
    k4_small = dda_vs_plain_small(dev)
    phase("dda_vs_plain_small", **k4_small)
    k4 = dda_main(dev)
    phase("dda_main_procedural10000", **k4)
    k4_built = k4_constructed_launches(dev)
    phase("k4_constructed_launches", **k4_built)
    phase("host_surfaces_cornell_1024x768", **host_surfaces(dev))

    # ---- 49-50. K5, the MXU-assisted sweep: against its plain version on
    # tests/test_intersect_pallas.py's cases, then bench_mxu_tpu.py's shape
    # through intersect_spheres_mxu, against the plain version and K2, then
    # on constructed launches under forced cuts ------------------------------
    k5_small = mxu_vs_plain_small(dev)
    phase("mxu_vs_plain_small", **k5_small)
    k5 = mxu_main(dev)
    phase("mxu_main_procedural10000", **k5)
    k5_built = k5_constructed_launches(dev)
    phase("k5_constructed_launches", **k5_built)

    # ---- 51-56. multi-device: each parallel/ module on a 2 x 2 mesh of
    # shards on the one card, against the single-device result; then two
    # gloo ranks --------------------------------------------------------------
    shards = {"mega": shard_mega(dev), "stream": shard_stream(
        "shard_stream", cornell, RenderConfig(
            width=1024, height=768, spp_per_cell=1, max_depth=48,
            camera_model=CameraModel.LEGACY, filter=Filter.TENT), dev,
        budget=2, dda=False)}
    phase("shard_mega_cornell_1024x768", **shards["mega"])
    phase("shard_stream_cornell_1024x768", **shards["stream"])
    shards["dda"] = shard_stream(
        "shard_stream_dda", big, RenderConfig(
            width=512, height=384, spp_per_cell=1, max_depth=24,
            camera_model=CameraModel.LEGACY, filter=Filter.TENT), dev,
        budget=2, dda=True)
    phase("shard_stream_dda_procedural10000_512x384", **shards["dda"])
    shards["binned"] = shard_binned(dev, big)
    phase("shard_binned_procedural10000_512x384", **shards["binned"])
    shards["replay"] = shard_replay(dev)
    phase("shard_replay_cornell_512x512", **shards["replay"])
    phase("distributed_two_ranks", **distributed_two_ranks(dev))

    # ---- 57-66. the main paths at full width against the port's f64
    # oracle, each through its kernel; the providers' draws, card vs CPU -----
    t_oracle = time.perf_counter()
    oracle = oracle_phases(dev)
    phase("oracle_main_paths", seconds=time.perf_counter() - t_oracle,
          oracle_s=oracle["oracle_s"])

    def wf_kernel(name, path, entry, replaces, cmp_stats):
        launch = path["kernel"]["middle"]
        errs = [st["max_abs_err"] for st in cmp_stats.values()
                if isinstance(st, dict)]
        errs += [v["vs_plain"]["max_abs_err"] for v in path["kernel"].values()]
        return {
            "name": name, "route": "cuda", "source": entry,
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": max(errs), "ms": launch["kernel_ms"],
            "plain_ms": launch["plain_ms"], "bound_ms": launch["bound_ms"],
            "bound_by": launch["bound_by"], "rays": launch["rays"],
            "ptxas": ptxas_entry({"closest_hit": ip.LIBRARY[0],
                               "closest_tri": mp.LIBRARY[0]}.get(
                                   name, mp.LIBRARY_CULLED[0])),
            "library_ms": None,
        }

    wf_kernels = [
        wf_kernel("closest_hit", wf["regen_main_cornell_1024x768"],
                  "smallpt_tpu_torch/csrc/closest_hit.cu",
                  "smallpt_tpu/ops/intersect_pallas.py:64", k2_stats),
        wf_kernel("closest_tri", wf["flat_main_mesh500_256x192"],
                  "smallpt_tpu_torch/csrc/closest_tri.cu",
                  "smallpt_tpu/ops/mesh_pallas.py:43", k6_stats),
    ]
    k7 = wf_kernel("closest_tri_culled", wf["flat_culled_mesh500_256x192"],
                   "smallpt_tpu_torch/csrc/closest_tri_culled.cu",
                   "smallpt_tpu/ops/mesh_pallas.py:162", k7_stats)
    k7["launches_by_path"] = {
        "flat_culled_mesh500_256x192": k7["launches"],
        "mesh_stream_culled_mesh500_256x192": ms_paths[
            "mesh_stream_culled_mesh500_256x192"]["launches"][
            "closest_tri_culled"]}
    for k, n in ((wf_kernels[1], "mesh_stream_main_mesh500_256x192"),
                 (k7, "mesh_stream_culled_mesh500_256x192")):
        # the stream's middle launch: its 49,152 lanes against the plain
        # version, its time and its bound
        launch = ms_paths[n]["kernel"]["middle"]
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            v["vs_plain"]["max_abs_err"]
            for v in ms_paths[n]["kernel"].values()])
        k["stream_launch"] = {
            "path": n, "rays": launch["rays"], "ms": launch["kernel_ms"],
            "plain_ms": launch["plain_ms"], "bound_ms": launch["bound_ms"],
            "bound_by": launch["bound_by"], **{
                x: launch[x] for x in ("k6_ms", "bound_ms_tile_walk",
                                       "bound_ms_box_culled",
                                       "bound_ms_group_union")
                if x in launch}}
    k7["same_rays_vs_k6"] = {
        n: {k: v[k] for k in ("k7_ms", "k6_ms", "lists_ms", "k7_bound_ms",
                              "k7_bound_ms_tile_walk",
                              "k7_bound_ms_group_union", "k6_bound_ms")}
        for n, v in k7_vs_k6_stats.items() if n != "accel"}
    # K7's bounds on its path-5 middle launch: the function's (the lesser
    # of the tile walk's and the box-culled count), each, the design's
    # least (a group's union); the counts
    k7_mid = wf["flat_culled_mesh500_256x192"]["kernel"]["middle"]
    for key in ("bound_ms_tile_walk", "bound_ms_box_culled",
                "bound_ms_group_union", "bound_algorithm", "counts"):
        k7[key] = k7_mid[key]
    k7_keys = ("rays", "kernel_ms", "k6_ms", "bound_ms", "bound_by",
               "bound_ms_tile_walk", "bound_ms_box_culled",
               "bound_ms_group_union", "cones", "rows")
    k7["constructed"] = {n: {x: v[x] for x in k7_keys if x in v}
                         for n, v in k7_built.items()}
    k7["max_abs_err"] = max([k7["max_abs_err"]] + [
        v["max_abs_err"] for v in k7_built.values()])
    k7["round_ms_k7_stream"] = ms_paths[
        "mesh_stream_culled_mesh500_256x192"]["ms_per_round"]
    k7["round_ms_k6_stream"] = ms_paths[
        "mesh_stream_main_mesh500_256x192"]["ms_per_round"]
    wf_kernels.append(k7)
    wf_kernels[0]["launches_by_path"] = {
        n: wf[n]["launches"]["closest_hit"] for n in wf
        if "mesh500" not in n}
    wf_kernels[1]["launches_by_path"] = {
        "flat_main_mesh500_256x192": wf_kernels[1]["launches"],
        "mesh_stream_main_mesh500_256x192": ms_paths[
            "mesh_stream_main_mesh500_256x192"]["launches"]["closest_tri"]}
    # K6 on every launch it was held on: the plan its launcher made (with
    # its scratch), the time and both bounds; the paths' peak memory
    k6_paths = {"flat_main_mesh500_256x192": wf["flat_main_mesh500_256x192"],
                "mesh_stream_main_mesh500_256x192": ms_paths[
                    "mesh_stream_main_mesh500_256x192"]}
    k6_keys = ("rays", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
               "bound_ms_every_pair_full", "pairs", "plan")
    wf_kernels[1]["launch_by_path"] = {
        n: {k: {x: v[x] for x in k6_keys if x in v}
            for k, v in p["kernel"].items()} for n, p in k6_paths.items()}
    wf_kernels[1]["peak_gb_by_path"] = {n: p["peak_mem_gb"]
                                        for n, p in k6_paths.items()}
    wf_kernels[1]["constructed"] = {
        n: {x: v[x] for x in k6_keys if x in v} for n, v in k6_built.items()}
    wf_kernels[1]["max_abs_err"] = max(
        [wf_kernels[1]["max_abs_err"]]
        + [v["max_abs_err"] for v in k6_built.values()])
    wf_kernels[1]["bound_ms_every_pair_full"] = wf[
        "flat_main_mesh500_256x192"]["kernel"]["middle"][
        "bound_ms_every_pair_full"]
    b_main = binned["binned_drain_procedural10000_512x384"]
    b_mid = b_main["kernel"]["middle"]
    k8_errs = [v["max_abs_err"] for v in k8_small.values()]
    k8_errs += [v["max_abs_err"] for b in binned.values()
                for v in b["kernel"].values()]
    k8 = {
        "name": "stream_step_binned", "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/stream_binned.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:1414",
        "launches": b_main["launches"]["stream_step_binned"],
        "launches_by_path": {n: b["launches"]["stream_step_binned"]
                             for n, b in binned.items()},
        "max_abs_err": max(k8_errs), "ms": b_mid["kernel_ms"],
        "plain_ms": b_mid["plain_ms"], "bound_ms": b_mid["bound_ms"],
        "bound_by": b_mid["bound_by"], "lanes": b_mid["lanes"],
        "launch_ms_by_path": {
            n: {k: v["kernel_ms"] for k, v in b["kernel"].items()}
            for n, b in binned.items()},
        "bound_ms_by_path": {
            n: {k: v["bound_ms"] for k, v in b["kernel"].items()}
            for n, b in binned.items()},
        "bound_ms_every_pair_full_by_path": {
            n: {k: v["bound_ms_every_pair_full"]
                for k, v in b["kernel"].items()}
            for n, b in binned.items()},
        "constructed": {
            n: {k: v[k] for k in ("kernel_ms", "bound_ms", "items", "units",
                                  "cut_chunks", "ranges_max", "fill")
                if k in v}
            for n, v in k8_built.items()},
        "round_ms_by_path": {n: b["ms_per_round"]
                             for n, b in binned.items()},
        "ptxas": ptxas_entry(mk.LIBRARY_BINNED[0]),
        "library_ms": None,
    }
    k8["launches_by_path"]["binned_three_program"] = opts["three_program"][
        "launches"]["stream_step_binned"]
    k8["launch_ms_three_program"] = {
        k: v["kernel_ms"] for k, v in opts["three_program"]["kernel"].items()}
    k8["max_abs_err"] = max([k8["max_abs_err"]] + [
        v["max_abs_err"] for v in opts["three_program"]["kernel"].values()]
        + [v["max_abs_err"]
           for v in shards["binned"]["shard_vs_plain"].values()]
        + [v["max_abs_err"] for v in k8_built.values()
           if "max_abs_err" in v])
    wf_kernels.append(k8)
    launch, one = rec_mega["launch"], rec_mega["one_sample"]
    k1b_keys = ("bound_ms_every_test_full", "bound_nofma_ms",
                "bound_nofma_ms_every_test_full", "share",
                "share_every_test_full", "rays", "lanes", "queue", "plan")
    wf_kernels.append({
        "name": "mega_record", "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:151",
        "launches": gmain["launches"]["mega_record"],
        "max_abs_err": max(
            [v["max_abs_err"] for v in rec_small.values()]
            + [r["strict"]["max_abs_err"]
               for r in (launch, one, *k1b_built.values())]
            + [shards["replay"]["shard_vs_plain"]["max_abs_err"]]),
        "ms": launch["kernel_ms"], "plain_ms": launch["plain_ms"],
        "bound_ms": launch["bound_ms"], "bound_by": launch["bound_by"],
        **{k: (launch[k] if k in launch else launch["strict"][k])
           for k in k1b_keys},
        "one_sample": {k: one[k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_ms_every_test_full",
            "share", "share_every_test_full", "queue", "plan",
            "lane_utilisation_one_lane_a_thread", "rays_per_lane_mean")},
        "strict_launches": len(K1_STRICT["mega_record"]),
        "strict_lanes_differ": max(K1_STRICT["mega_record"]),
        "constructed": {n: dict(lanes=v["strict"]["lanes"],
                                rays=v["strict"]["rays"], plan=v["plan"])
                        for n, v in k1b_built.items()},
        "ptxas": ptxas_entry(mk.LIBRARY[0], "mega_record_kernel"),
        "library_ms": None,
    })
    k4_main = [v for n, v in k4.items() if n.startswith("occ")]
    k4_mid = k4["occ28_bounce"]
    wf_kernels.append({
        "name": "closest_hit_dda", "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/dda.cu",
        "replaces": "smallpt_tpu/ops/dda.py:258",
        "launches": k4["launches"]["closest_hit_dda"],
        "max_abs_err": max(v["max_abs_err"] for v in (
            *k4_small.values(), *k4_main, *k4_built.values())),
        "ms": k4_mid["kernel_ms"], "plain_ms": k4_mid["plain_ms"],
        "bound_ms": k4_mid["bound_ms"], "bound_by": k4_mid["bound_by"],
        "rays": DDA_RAYS, "k2_ms_same_rays": k4_mid["k2_ms_same_rays"],
        "by_grid_and_rays": {
            n: {f: v[f] for f in (
                "kernel_ms", "k2_ms_same_rays", "plain_ms", "bound_ms",
                "bound_by", "bound_ms_every_test_full", "share",
                "share_every_test_full", "cells_per_ray_mean",
                "cells_per_ray_max", "queue")}
            for n, v in k4.items() if n.startswith("occ")},
        "plan": k4_mid["plan"],
        "constructed": {n: {f: v[f] for f in ("rays", "kernel_ms", "queue")}
                        for n, v in k4_built.items()},
        "ptxas": k4["ptxas"],
        "library_ms": None,
    })
    wf_kernels.append({
        "name": "closest_hit_mxu", "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/closest_hit_mxu.cu",
        "replaces": "smallpt_tpu/ops/intersect_pallas.py:173",
        "launches": k5["launches"]["closest_hit_mxu"],
        "max_abs_err": max(v["max_abs_err"] for v in (
            *k5_small.values(), k5,
            *(c for v in k5_built.values() for c in v.values()))),
        "ms": k5["kernel_ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "bound_algorithm": k5["bound_algorithm"],
        "bound_ms_staged_sweep": k5["bound_ms_staged_sweep"],
        "bound_ms_grid_walk": k5.get("bound_ms_grid_walk"),
        "bound_ms_every_pair_full": k5["bound_ms_every_pair_full"],
        "share": k5["share"],
        "share_staged_sweep": k5["share_staged_sweep"],
        "share_every_pair_full": k5["share_every_pair_full"],
        "rays": MXU_RAYS, "k2_ms_same_rays": k5["k2_ms_same_rays"],
        "k2_bound_ms": k5["k2_bound_ms"], "vs_k2": k5["vs_k2"],
        "plan": k5["plan"],
        "constructed": {n: {c: {f: x[f] for f in ("rays", "kernel_ms")}
                            for c, x in v.items()}
                        for n, v in k5_built.items()},
        "ptxas": k5["ptxas"],
        "library_ms": None,
    })
    # K2 on the gradient path: the scan differentiator and the recorder
    # above MEGA_MAX_SPHERES at config 4, first and middle launch each
    k2 = wf_kernels[0]
    k2["grad_launches"] = {}
    for n, g in (("grad_scan_cornell_512x512", gmain["scan"]),
                 ("grad_record_flat_cornell_512x512", gmain["record_flat"])):
        k2["launches_by_path"][n] = g["launches"]["closest_hit"]
        k2["grad_launches"][n] = {
            k: {f: v[f] for f in ("rays", "kernel_ms", "plain_ms",
                                  "bound_ms", "bound_by")}
            for k, v in g["kernel"].items()}
        k2["max_abs_err"] = max([k2["max_abs_err"]] + [
            v["vs_plain"]["max_abs_err"] for v in g["kernel"].values()])
    # K2 on every launch it was held on: the plan its launcher made (with
    # its scratch), the time and both bounds
    k2_keys = ("rays", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
               "bound_algorithm", "bound_ms_staged_sweep",
               "bound_ms_grid_walk", "bound_ms_every_pair_full", "pairs",
               "plan")
    k2["launch_by_path"] = {
        n: {k: {x: v[x] for x in k2_keys if x in v}
            for k, v in wf[n]["kernel"].items()}
        for n in wf if "mesh500" not in n}
    k2["constructed"] = {
        n: {c: {x: v[c][x] for x in ("kernel_ms", "plan")}
            for c in v if c.startswith(("own", "forced"))}
        for n, v in k2_built.items() if n != "ptxas"}
    k2["max_abs_err"] = max([k2["max_abs_err"]] + [
        c["max_abs_err"] for n, v in k2_built.items() if n != "ptxas"
        for k_, c in v.items() if k_.startswith(("own", "forced"))])
    mid = wf["regen_main_procedural10000_512x384"]["kernel"]["middle"]
    k2["ms_procedural10000"] = mid["kernel_ms"]
    k2["bound_ms_procedural10000"] = mid["bound_ms"]
    k2["bound_ms_staged_sweep_procedural10000"] = mid["bound_ms_staged_sweep"]
    k2["bound_ms_every_pair_full"] = wf["regen_main_cornell_1024x768"][
        "kernel"]["middle"]["bound_ms_every_pair_full"]

    stream_cmp = {f"{case}/{launch}": st["frac_div"]
                  for case, chain_ in stream_stats.items()
                  for launch, st in chain_.items()}
    stream_cmp.update({f"{n}/budget4": full[n]["kernel"]["vs_plain"]
                       ["frac_div"] for n in full})
    stream_errs = [st["max_abs_err"] for chain_ in stream_stats.values()
                   for st in chain_.values()]
    stream_errs += [full[n]["kernel"]["vs_plain"]["max_abs_err"]
                    for n in full]
    stream_errs.append(shards["stream"]["shard_vs_plain"]["max_abs_err"])
    stream_cmp["shard_stream/shard_1_1"] = shards["stream"][
        "shard_vs_plain"]["frac_div"]
    k3_errs.append(shards["dda"]["shard_vs_plain"]["max_abs_err"])
    mega_cmp = dict(cmp_stats, shard_mega_1_1=shards["mega"][
        "shard_vs_plain"])

    k1_keys = ("bound_ms_every_test_full", "bound_nofma_ms",
               "bound_nofma_ms_every_test_full", "plan")
    k1_ptxas = ptxas_entry(mk.LIBRARY[0])
    kernels = [{
        "name": "mega_pass",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:151",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in mega_cmp.values()),
        "frac_div": {k: s["frac_div"] for k, s in mega_cmp.items()},
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1a["bound_ms"],
        "bound_by": k1a["bound_by"],
        **{k: k1a[k] for k in k1_keys},
        "lane_utilisation_one_lane_a_thread": k1a[
            "lane_utilisation_one_lane_a_thread"],
        "strict_launches": len(K1_STRICT["mega_pass"]),
        "strict_lanes_differ": max(K1_STRICT["mega_pass"]),
        "constructed": {n: v for n, v in k1_built.items()
                        if n.startswith(("pass", "on_wall_pass"))},
        "ptxas": k1_ptxas,
        "library_ms": None,
    }, {
        "name": "stream_step",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "smallpt_tpu/ops/megakernel.py:151",
        "launches": full["cornell_1024x768"]["main"]["launches"],
        "launches_nee": full["cornell_1024x768_nee"]["main"]["launches"],
        "max_abs_err": max(stream_errs),
        "frac_div": stream_cmp,
        "ms": stream_kernel["kernel_ms"],
        "plain_ms": stream_kernel["plain_ms"],
        "bound_ms": stream_kernel["bound_ms"],
        "bound_by": stream_kernel["bound_by"],
        **{k: stream_kernel[k] for k in k1_keys},
        "ms_nee": nee_kernel["kernel_ms"],
        "plain_ms_nee": nee_kernel["plain_ms"],
        "bound_ms_nee": nee_kernel["bound_ms"],
        **{f"{k}_nee": nee_kernel[k] for k in k1_keys},
        "round_ms": full["cornell_1024x768"]["main"]["ms_per_round"],
        "round_ms_nee": full["cornell_1024x768_nee"]["main"]["ms_per_round"],
        "kernel_round_ms": full["cornell_1024x768"]["main"][
            "kernel_round_ms"],
        "kernel_round_ms_nee": full["cornell_1024x768_nee"]["main"][
            "kernel_round_ms"],
        "strict_launches": len(K1_STRICT["stream_step"]),
        "strict_lanes_differ": max(K1_STRICT["stream_step"]),
        "constructed": {n: v for n, v in k1_built.items()
                        if not n.startswith(("pass", "on_wall_pass",
                                             "on_wall_o"))},
        "library_ms": None,
    }, {
        "name": "stream_step_dda",
        "route": "cuda",
        "source": "smallpt_tpu_torch/csrc/stream_dda.cu",
        "replaces": "smallpt_tpu/ops/stream_dda.py:273",
        "launches": k3["procedural10000_512x384"]["main"]["launches"],
        "launches_nee": k3["procedural10000_512x384_nee"]["main"]["launches"],
        "max_abs_err": max(k3_errs),
        "ms": k3_kernel["kernel_ms"],
        "plain_ms": k3_kernel["plain_ms"],
        "bound_ms": k3_kernel["bound_ms"],
        "bound_by": k3_kernel["bound_by"],
        "ms_nee": k3_nee_kernel["kernel_ms"],
        "plain_ms_nee": k3_nee_kernel["plain_ms"],
        "bound_ms_nee": k3_nee_kernel["bound_ms"],
        "round_ms": k3["procedural10000_512x384"]["main"]["ms_per_round"],
        "round_ms_nee": k3["procedural10000_512x384_nee"]["main"][
            "ms_per_round"],
        "bound_ms_every_slot_full": k3_kernel["bound_ms_every_slot_full"],
        "ms_hd": hd["kernel"]["kernel_ms"],
        "bound_ms_hd": hd["kernel"]["bound_ms"],
        "round_ms_hd": hd["round_ms"],
        "plan": k3_kernel["plan"],
        "queue": k3_kernel["queue"],
        "constructed_ms": {n: c["kernel_ms"] for n, c in k3_built.items()},
        "strict_lanes_differ": max(
            [k3_kernel["vs_plain"]["strict"]["lanes_differ"],
             k3_nee_kernel["vs_plain"]["strict"]["lanes_differ"]]
            + [c["strict"]["lanes_differ"] for c in k3_built.values()]),
        "ptxas": ptxas,
        "library_ms": None,
    }, *wf_kernels]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
