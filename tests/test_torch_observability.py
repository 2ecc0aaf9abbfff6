"""Observability (utils/metrics.py) against the JAX package's:
occupancy_profile's per-iteration live-lane counts of one regenerative
pass, their sum against the pass's traced rays, the progressive
renderer's stats, and trace's file."""

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from smallpt_tpu.config import (
    CameraModel as JCameraModel, Filter as JFilter, RenderConfig as JConfig,
    Scheduler as JScheduler,
)
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core.camera import smallpt_camera as jcamera
from smallpt_tpu.core.scene import cornell_box_scene as jcornell
from smallpt_tpu.utils import metrics as jmetrics
from smallpt_tpu_torch.config import (
    CameraModel, Filter, RenderConfig, Scheduler,
)
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import cornell_box_scene
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.renderer import render_with_stats
from smallpt_tpu_torch.utils import metrics

_CFG = dict(width=16, height=12, spp_per_cell=1, max_depth=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return RenderConfig(**_CFG, camera_model=CameraModel.LEGACY,
                        filter=Filter.TENT, scheduler=Scheduler.REGEN)


@pytest.mark.parametrize("seed", [0, 5])
def test_occupancy_profile_matches_jax(seed):
    """The same length, and the same count at every iteration but for a
    lane that F3 moves (ROADMAP.md): XLA:CPU's rounding of a multiply-add
    or a reciprocal square root that torch rounds apart can end one path a
    bounce sooner or later. The JAX reference runs with jit disabled,
    which leaves the fewest such lanes (seeds 0-5 at 16x12: 3, 3, 2, 0, 0,
    0 lane-iterations apart compiled; 1, 0, 1, 0, 0, 0 eager; seed 0 eager
    reads 134 against 135 at iteration 30). Gate: at most 2 lane-iterations
    apart in all, none by more than one lane."""
    jcfg = JConfig(**_CFG, camera_model=JCameraModel.LEGACY,
                   filter=JFilter.TENT, scheduler=JScheduler.REGEN)
    with jax.disable_jit():
        want = np.asarray(jmetrics.occupancy_profile(
            jcornell(), jcamera(), jcfg, jrng.base_key(seed)))
    got = metrics.occupancy_profile(cornell_box_scene(), smallpt_camera(),
                                    _cfg(), rng.base_key(seed),
                                    device="cpu")
    assert got.dtype == np.int64 and got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and diff.sum() <= 2


def test_occupancy_profile_sums_to_the_pass_rays():
    cfg = _cfg()
    key = rng.base_key(0)
    occ = metrics.occupancy_profile(cornell_box_scene(), smallpt_camera(),
                                    cfg, key, device="cpu")
    assert 1 <= len(occ) <= cfg.spp * cfg.max_depth
    assert occ[0] == cfg.n_pixels  # every lane starts a sample
    assert occ[-1] >= 1  # the loop ends only when drained
    _, rays = render_with_stats(cornell_box_scene(), smallpt_camera(), cfg,
                                key, device="cpu")
    assert int(occ.sum()) == int(rays)


def test_progressive_tracks_stats(capsys):
    r = ProgressiveRenderer(cornell_box_scene(), smallpt_camera(),
                            _cfg().replace(scheduler=Scheduler.MEGA),
                            seed=0, device="cpu")
    r.log_stats = True
    r.step(2)
    assert r.stats.passes == 2
    assert r.stats.rays > r.config.n_pixels * r.config.spp
    assert r.stats.wall_s > 0 and r.stats.rays_per_s > 0
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()]
    assert [ln["pass"] for ln in lines if ln["event"] == "render_pass"] == [
        1, 2]


def test_trace_writes_a_chrome_trace(tmp_path):
    r = ProgressiveRenderer(cornell_box_scene(), smallpt_camera(),
                            _cfg().replace(scheduler=Scheduler.MEGA),
                            seed=0, device="cpu")
    log_dir = str(tmp_path / "trace")
    with metrics.trace(log_dir) as prof:
        r.step()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(prof.key_averages()) > 0


def test_trace_holds_the_session_open(tmp_path):
    """hold_s keeps the profiler open that long before and after the
    block (the repair of F11's lost device events), and the file is still
    written once."""
    log_dir = str(tmp_path / "held")
    t = time.perf_counter()
    with metrics.trace(log_dir, hold_s=0.05) as prof:
        inner = time.perf_counter()
        torch.ones(4).sum()
        inner = time.perf_counter() - inner
    assert time.perf_counter() - t - inner >= 0.1
    assert len(os.listdir(log_dir)) == 1
    assert len(prof.key_averages()) > 0
