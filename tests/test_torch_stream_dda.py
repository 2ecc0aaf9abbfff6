"""The port's DDA streaming route (ops/stream_dda.py, the DDA branch of
engine/streaming.py) on the CPU, where the wrapper runs its plain PyTorch
version, against the JAX package's stream_dda in the Pallas interpreter.

procedural_sphere_scene(300) at 32x24 (one 8192-lane tile), the grid of
occ_target 16 as tests/test_stream_dda.py builds it, the same key.

Gates.
- Tables: grid, K, bounds, overflow and light rows equal; the always table
  bit-equal; the port's cell slots equal JAX's bf16x3 terms summed, exactly.
- One iteration from JAX's state (test_one_iteration_from_jax_state): the
  depth, s_idx, alive, ray, budget, sup, walk-cell and walk-state planes
  bit-equal on every lane after every iteration of a drain. The winner's
  cell (wcell) and id may differ, on at most 1% of the live lane-steps
  each, and only where XLA:CPU's rounding explains it: XLA:CPU contracts
  a*b + c into one FMA where torch rounds twice (every one of 100,000
  random triples rounds as an FMA, 77% as two ops would), so the same
  sphere's t can come out a few ulps apart in two cells of its walk and the
  running fold's strict < keeps the other cell, or a near-tie of two
  spheres flips; and a 1e5-radius wall's t is known only to about an ulp
  of 1e5 (0.008), so a wall and a sphere near it can trade places. Every such
  lane-step must have the two winners' t within MAX_ULPS = 16 ulps, or a
  wall among them. Measured, seeds 0-3 with and without NEE: wcell differs
  on 23-34 lane-steps (at most 0.13%), every one the same sphere within 8
  ulps; the id on 1-6 (0.02%) without NEE and 133-173 (0.46%) with it,
  every one with a wall among the winners (with NEE most are shadow rays
  leaving a wall, which one side meets again at t ~ 0.05). A sphere radius
  x1.001 in the plain cell test breaks the bit-equal planes and leaves 91
  lane-steps unexplained. Directions within 1e-4 on all but 0.1% of the
  live lane-steps.
- A chain (two partial launches and a drain) against JAX's: budget
  bit-equal; alive and s_idx equal on all but 2% of the lanes before the
  drain; rays within max(64, 0.1%); radiance and m1 under
  tests/test_megakernel.py::_compare's gate, m2 under its fraction part
  (at most 2% of values off by 10%): one flipped sample that sees the
  light adds 12^2 = 144 to one lane's m2, 7% of the plane's mean at 768
  lanes with NEE (measured). The walk: at a cutoff a lane can be a few
  iterations ahead of or behind JAX's on the same path, since a grid
  crossing t an ulp apart makes a walk take one step more or less to the
  same hit (the classic route, one bounce an iteration, moves no lane in
  the same runs). So the test also runs the port one iteration a launch
  (the chain's states must equal it at every cutoff, bit for bit), and a
  lane whose progress (depth, s_idx, alive, rays, walk state, the cell of
  a walk in flight) differs from JAX's must match JAX's progress in that
  trace within MAX_SHIFT = 12 iterations of the cutoff, on all but 2% of
  the lanes. After the drain alive, s_idx, the walk state and the progress
  are equal on every lane. Measured, seeds 0-5 with and without NEE,
  before the drain: the walk state differs on up to 41 of 768 lanes
  (5.3%), alive or s_idx on up to 8 (1.0%), the progress on up to 54; at
  most 5 lanes (0.65%) are not found within the window, the others at most
  10 iterations off (most by 1). Planted in the plain version: a sphere
  radius x1.01 leaves 22 lanes unexplained and moves 30; a walk without
  its early exit moves 129 lanes and its ray counts differ.
- The port's DDA route against its classic route, as the JAX suite holds
  its own (tests/test_stream_dda.py): weights equal, radiance within
  rtol 2e-4 / atol 2e-3, rays equal; with NEE at most 0.3% of the pixels
  flipped (a shadow ray grazing an occluder's rim), the rest as tight.
JAX is compiled once per NEE mode for the iteration and chain tests, in a
module fixture: an XLA:CPU process of the suite crashes once it holds
enough compiled programs (tests/conftest.py clears the caches per module).
"""

import os

import numpy as np
import pytest
import torch

from smallpt_tpu import config as jcfg
from smallpt_tpu.core import camera as jcam
from smallpt_tpu.core import rng as jrng
from smallpt_tpu.core import scene as jscene
from smallpt_tpu.engine import streaming as jstreaming
from smallpt_tpu.ops import megakernel as jmk
from smallpt_tpu.ops import stream_dda as jsd
from smallpt_tpu_torch import cli
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng as trng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene,
)
from smallpt_tpu_torch.engine.progressive import ProgressiveRenderer
from smallpt_tpu_torch.engine.renderer import render
from smallpt_tpu_torch.engine.streaming import StreamingRenderer, dda_auto
from smallpt_tpu_torch.ops import megakernel as tmk
from smallpt_tpu_torch.ops import stream_dda as tsd

_LEG = dict(camera_model=CameraModel.LEGACY, filter=Filter.TENT)
_JLEG = dict(camera_model=jcfg.CameraModel.LEGACY, filter=jcfg.Filter.TENT)
CFG = RenderConfig(width=32, height=24, spp_per_cell=1, max_depth=6, **_LEG)
JCFG = jcfg.RenderConfig(width=32, height=24, spp_per_cell=1, max_depth=6,
                         **_JLEG)
G = CFG.n_pixels
MAX_FRAC = 0.02
# the winners' t of a changed winner, in ulps (module docstring)
MAX_ULPS = 16
# how many iterations a lane of the port's chain may run ahead of or behind
# JAX's on the same path (module docstring)
MAX_SHIFT = 12
# (sample budget, n_iters) of each launch: two partial launches, a drain
LAUNCHES = ((3, 40), (None, 40), (None, 100_000))
_I_NAMES = ("depth", "s_idx", "alive", "rays", "budget", "sup", "cell",
            "walk", "wcell")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on a few hundred lanes, where torch's intra-op
    threads only spin against the suite's other workers (one process run
    of this file takes 45 s either way; under six workers with eight
    threads each it took 650 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(nee):
    lights = dict(nee_lights=(8,)) if nee else {}
    return CFG.replace(**lights), jcfg.RenderConfig(
        width=32, height=24, spp_per_cell=1, max_depth=6, **_JLEG, **lights)


def _image_gate(got, ref):
    rel = np.abs(got - ref) / (1.0 + np.abs(ref))
    assert np.isfinite(got).all()
    assert (rel > 0.1).mean() <= MAX_FRAC, f"{(rel > 0.1).mean():.4f}"
    assert abs(got.mean() - ref.mean()) < 0.05 * (abs(ref.mean()) + 0.1)


def _planes(f, i, nf):
    return (np.asarray(f).reshape(nf, -1)[:, :G],
            np.asarray(i).reshape(tsd._NI_D, -1)[:, :G])


def _progress(i):
    """A lane's progress (rows): depth, s_idx, alive, rays, the walk state,
    and the cell of a walk in flight (-1 otherwise: a finished walk's cell
    is stale)."""
    walking = np.isin(i[7], (1, 3, 4))
    return np.concatenate([i[[0, 1, 2, 3, 7]],
                           np.where(walking, i[6], -1)[None]])


def _is_wall(bid, radius):
    """Lanes whose winner is one of the box's 1e5-radius walls."""
    known = bid < len(radius)
    out = np.zeros(bid.shape, bool)
    out[known] = radius[bid[known].astype(np.int64)] > 1e4
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "nee"])
def jax_dda(request):
    """JAX stream_step_dda on procedural_sphere_scene(300): the state after
    every iteration of a drain from a budget of 2 (one iteration a launch),
    then the chain of LAUNCHES from a fresh state; all with one compiled
    program."""
    nee = request.param
    cfg, jc = _cfgs(nee)
    js = jscene.procedural_sphere_scene(300)
    jt = jsd.build_stream_dda_tables(js, jc, occ_target=16.0)
    key = jrng.base_key(0)
    f, i = jsd.init_stream_dda_state(jc)
    steps = [(np.asarray(f), np.asarray(i))]
    while len(steps) == 1 or jmk.stream_pending(i) != (0, 0):
        f, i, _ = jsd.stream_step_dda(js, jcam.smallpt_camera(), jc, key, f,
                                      i, 2 if len(steps) == 1 else None, 1,
                                      jt)
        steps.append((np.asarray(f), np.asarray(i)))
    f, i = jsd.init_stream_dda_state(jc)
    chain = []
    for budget, n_iters in LAUNCHES:
        f, i, rays = jsd.stream_step_dda(js, jcam.smallpt_camera(), jc, key,
                                         f, i, budget, n_iters, jt)
        chain.append((np.asarray(f), np.asarray(i), int(rays)))
    return dict(nee=nee, cfg=cfg, jc=jc, jt=jt, steps=steps, chain=chain)


def _port_tables(cfg, **kw):
    return (tsd.build_stream_dda_tables(procedural_sphere_scene(300), cfg,
                                        occ_target=16.0, device="cpu", **kw),
            tmk.build_camera_vec(smallpt_camera(), cfg))


# -- tables --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["occ16", "occ16_nee", "default_2100",
                                  "overflow_nb222_k32"])
def test_tables_equal_jax(case):
    n = 2100 if case == "default_2100" else 300
    kw = dict(nb=(2, 2, 2), k_max=32) if case == "overflow_nb222_k32" else (
        {} if case == "default_2100" else dict(occ_target=16.0))
    cfg, jc = _cfgs(case.endswith("nee"))
    jt = jsd.build_stream_dda_tables(jscene.procedural_sphere_scene(n), jc,
                                     **kw)
    tt = tsd.build_stream_dda_tables(procedural_sphere_scene(n), cfg,
                                     device="cpu", **kw)
    assert (tt.nb, tt.k, tt.lo, tt.cell) == (jt.nb, jt.k, jt.lo, jt.cell)
    assert (tt.n_always, tt.n_local, tt.n_overflow, tt.light_rows,
            tt.eps_local) == (jt.n_always, jt.n_local, jt.n_overflow,
                              jt.light_rows, jt.eps_local)
    if case == "overflow_nb222_k32":
        assert tt.n_overflow > 0
    np.testing.assert_array_equal(tt.always_tbl.numpy(),
                                  np.asarray(jt.always_tbl))
    # JAX: (3, 12*K, C) bf16x3 terms of 12 fields; the port: (C, K, 8) slots
    vals = np.asarray(jt.cells3).sum(0).reshape(12, jt.k, jt.n_cells)
    cells = tt.cells.numpy()
    assert cells.shape == (jt.n_cells, jt.k, 8) and not cells[..., 5:].any()
    np.testing.assert_array_equal(cells[..., :5], vals[:5].transpose(2, 1, 0))
    # the payload fields equal the scene table's rows at the slot's id
    full = cells[..., 4] < tsd._BIGID
    ids = cells[..., 4][full].astype(np.int64)
    payload = vals[5:12].transpose(2, 1, 0)[full]
    np.testing.assert_array_equal(payload, tt.scene_tbl.numpy()[ids, 5:12])
    assert not vals[5:12].transpose(2, 1, 0)[~full].any()


def test_explicit_grid_axis_above_32_raises():
    """Hazard H1: the packed cell holds 5 bits per axis; the JAX package's
    build_stream_dda_tables takes an explicit 33-cell axis and corrupts the
    cells silently."""
    scene = procedural_sphere_scene(300)
    with pytest.raises(ValueError, match="1..32"):
        tsd.build_stream_dda_tables(scene, CFG, nb=(33, 1, 1), device="cpu")
    with pytest.raises(ValueError, match="1..32"):
        tsd.build_stream_dda_tables(scene, CFG, nb=(4, 0, 4), device="cpu")
    t = tsd.build_stream_dda_tables(scene, CFG, nb=(32, 1, 1), device="cpu")
    assert t.n_cells == 32


def test_tables_refuse_scenes_without_local_spheres():
    scene = procedural_sphere_scene(9)  # the Cornell walls and light only
    with pytest.raises(ValueError, match="no local spheres"):
        tsd.build_stream_dda_tables(scene, CFG, stable_radius=10.0,
                                    device="cpu")
    with pytest.raises(ValueError, match="uniform local eps"):
        tsd.build_stream_dda_tables(procedural_sphere_scene(300), CFG,
                                    stable_radius=1e4, device="cpu")


# -- against the JAX kernel ------------------------------------------------------

def test_init_state_equals_jax():
    for nee in (False, True):
        cfg, jc = _cfgs(nee)
        jf, ji = jsd.init_stream_dda_state(jc)
        tf, ti = tsd.init_stream_dda_state(cfg, device="cpu")
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert tf.shape[0] == 8 * (26 if nee else 19) and ti.shape[0] == 72


def test_one_iteration_from_jax_state(jax_dda):
    """From JAX's state after every iteration of a drain, one port iteration
    gives JAX's next state: see the module docstring for the gates."""
    cfg, nee = jax_dda["cfg"], jax_dda["nee"]
    tables, cam = _port_tables(cfg)
    nf = tsd._nf_d(cfg)
    steps = jax_dda["steps"]
    radius = tables.scene_tbl[:, 3].numpy()
    live_steps = off_win = off_bid = off_dir = astray = 0
    for n, ((jf0, ji0), (jf, ji)) in enumerate(zip(steps, steps[1:])):
        tf, ti = tmk.state_from_jax(jf0, ji0, device="cpu")
        tsd.stream_step_dda(tables, cam, cfg, trng.base_key(0), tf, ti,
                            2 if n == 0 else None, 1)
        fj, ij = _planes(jf, ji, nf)
        fp, ip = _planes(tf, ti, nf)
        for k, name in enumerate(_I_NAMES[:8]):
            np.testing.assert_array_equal(ip[k], ij[k], err_msg=name)
        live = ij[2] != 0
        live_steps += int(live.sum())
        win = (ip[8] != ij[8]) & live
        bid = (fp[tsd._F_BID] != fj[tsd._F_BID]) & live
        off_win += int(win.sum())
        off_bid += int(bid.sum())
        # each such lane-step: the winners' t a few ulps apart (the same
        # sphere met in another cell, or a near-tie), or a wall among the
        # two winners
        ulps = np.abs(fp[tsd._F_BT].view(np.int32).astype(np.int64)
                      - fj[tsd._F_BT].view(np.int32).astype(np.int64))
        wall = (_is_wall(fp[tsd._F_BID], radius)
                | _is_wall(fj[tsd._F_BID], radius))
        astray += int(((win | bid) & ~((ulps <= MAX_ULPS) | (bid & wall)))
                      .sum())
        off_dir += int((np.abs(fp[3:6] - fj[3:6]).max(0) > 1e-4)[live].sum())
        _image_gate(fp[9:12].T, fj[9:12].T)
        for plane in (12, 13):
            _image_gate(fp[plane], fj[plane])
    assert len(steps) > 30 and live_steps > 20 * G
    assert astray == 0, f"{astray} winner changes with no near-tie or wall"
    assert off_win <= 0.01 * live_steps, f"{off_win} of {live_steps}"
    assert off_bid <= 0.01 * live_steps, f"{off_bid} of {live_steps}"
    assert off_dir <= 0.001 * live_steps, f"{off_dir} of {live_steps}"


def test_chain_matches_jax(jax_dda):
    cfg = jax_dda["cfg"]
    tables, cam = _port_tables(cfg)
    nf = tsd._nf_d(cfg)
    key = trng.base_key(0)
    # the port one iteration a launch from the same start: its state after
    # every iteration, trace[n] after n
    tf, ti = tsd.init_stream_dda_state(cfg, device="cpu")
    tmk.set_sample_budget(ti, LAUNCHES[0][0], cfg)
    trace = [_planes(tf.clone(), ti.clone(), nf)]
    while tmk.stream_pending(ti) != (0, 0):
        tsd.stream_step_dda(tables, cam, cfg, key, tf, ti, None, 1)
        trace.append(_planes(tf.clone(), ti.clone(), nf))
    tf, ti = tsd.init_stream_dda_state(cfg, device="cpu")
    done = 0
    for (budget, n_iters), (jf, ji, jrays) in zip(LAUNCHES,
                                                  jax_dda["chain"]):
        _, _, rays = tsd.stream_step_dda(tables, cam, cfg, key, tf, ti,
                                         budget, n_iters)
        assert rays.dtype == torch.int64 and rays.dim() == 0
        assert abs(int(rays) - jrays) <= max(64, 0.001 * jrays)
        fj, ij = _planes(jf, ji, nf)
        fp, ip = _planes(tf, ti, nf)
        # a launch's cutoff does not change the result
        done = min(done + n_iters, len(trace) - 1)
        np.testing.assert_array_equal(fp, trace[done][0])
        np.testing.assert_array_equal(ip, trace[done][1])
        np.testing.assert_array_equal(ip[4], ij[4])  # budget
        drained = n_iters == LAUNCHES[-1][1]
        moved = (ip[1] != ij[1]) | (ip[2] != ij[2])
        assert moved.sum() <= (0 if drained else MAX_FRAC * G), moved.sum()
        if drained:
            np.testing.assert_array_equal(ip[7], ij[7])  # walk
        # a lane whose progress differs is on JAX's path a few iterations
        # ahead or behind: the port's trace holds JAX's progress near the
        # cutoff
        want = _progress(ij)
        held = np.zeros(G, bool)
        for _, ip_t in trace[max(0, done - MAX_SHIFT):done + MAX_SHIFT + 1]:
            held |= (_progress(ip_t) == want).all(0)
        astray = (_progress(ip) != want).any(0) & ~held
        assert astray.sum() <= (0 if drained else MAX_FRAC * G), astray.sum()
        assert abs(int(ij[3].sum()) - int(ip[3].sum())) <= max(
            64, 0.001 * int(ij[3].sum()))
        _image_gate(fp[9:12].T, fj[9:12].T)
        _image_gate(fp[12], fj[12])
        rel = np.abs(fp[13] - fj[13]) / (1.0 + np.abs(fj[13]))
        assert (rel > 0.1).mean() <= MAX_FRAC
    assert tmk.stream_pending(ti) == (0, 0)
    jimg, jw = jmk.stream_image(jf, ji, jax_dda["jc"])
    img, w = tmk.stream_image(tf, ti, cfg)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    _image_gate(img.numpy(), np.asarray(jimg))


def test_jax_dda_state_continues_in_the_port(jax_dda):
    """state_from_jax and state_to_numpy carry the DDA planes (19 or 26
    f32, 9 i32) across packages unchanged."""
    jf, ji, _ = jax_dda["chain"][0]
    tf, ti = tmk.state_from_jax(jf, ji, device="cpu")
    f_back, i_back = tmk.state_to_numpy(tf, ti)
    np.testing.assert_array_equal(f_back, jf)
    np.testing.assert_array_equal(i_back, ji)
    with pytest.raises(ValueError, match="not a streaming state"):
        tmk.state_from_jax(jf[:8 * 18], ji, device="cpu")
    with pytest.raises(ValueError, match="not a streaming state"):
        tmk.state_from_jax(jf, ji[:8 * 6], device="cpu")


# -- the port's DDA route against its classic route -------------------------------

@pytest.mark.parametrize("nee", [False, True], ids=["plain", "nee"])
def test_dda_matches_classic_streaming(nee):
    """tests/test_stream_dda.py's parity gates on the port alone, 64x48,
    max_depth 6, a budget of 3, drained."""
    cfg = RenderConfig(width=64, height=48, spp_per_cell=1, max_depth=6,
                       nee_lights=(8,) if nee else (), **_LEG)
    scene = procedural_sphere_scene(300)
    key = trng.base_key(0)
    table = tmk.build_scene_table(scene, cfg)
    cam = tmk.build_camera_vec(smallpt_camera(), cfg)
    fc, ic = tmk.init_stream_state(cfg, device="cpu")
    _, _, rays_c = tmk.stream_step(table, cam, cfg, key, fc, ic, 3, 10_000,
                                   n_spheres=scene.n_spheres)
    tables = tsd.build_stream_dda_tables(scene, cfg, occ_target=16.0,
                                         device="cpu")
    fd, id_ = tsd.init_stream_dda_state(cfg, device="cpu")
    _, _, rays_d = tsd.stream_step_dda(tables, cam, cfg, key, fd, id_, 3,
                                       100_000)
    assert tmk.stream_pending(ic) == tmk.stream_pending(id_) == (0, 0)
    rad_c, w_c = (t.numpy() for t in tmk.stream_image(fc, ic, cfg))
    rad_d, w_d = (t.numpy() for t in tmk.stream_image(fd, id_, cfg))
    np.testing.assert_array_equal(w_c, w_d)
    assert (w_c == 3).all()
    assert int(rays_c) == int(rays_d)
    flipped = np.abs(rad_d - rad_c).max(axis=-1) > 2e-3
    assert flipped.mean() < (3e-3 if nee else 1e-9), flipped.sum()
    np.testing.assert_allclose(rad_d[~flipped], rad_c[~flipped], rtol=2e-4,
                               atol=2e-3)


def test_plain_counts_the_work():
    cfg = CFG.replace(nee_lights=(8,))
    tables, cam = _port_tables(cfg)
    f, i = tsd.init_stream_dda_state(cfg, device="cpu")
    counts = {}
    k0, k1 = trng.key_words(trng.base_key(0))
    tmk.set_sample_budget(i, 2, cfg)
    _, _, rays = tsd.stream_step_dda_plain(tables, cam, cfg, k0, k1, f, i,
                                           100_000, counts=counts)
    assert counts["inits"] == int(rays) + counts["shadow_rays"]
    assert counts["always_tests"] == counts["inits"] * tables.n_always
    assert counts["resolves"] == int(rays)
    assert counts["walk_steps"] > counts["inits"] > 0
    assert counts["cell_bytes"] == 32 * counts["slot_tests"] > 0
    assert counts["iterations"] > 20


# -- the wrapper -------------------------------------------------------------------

def test_wrapper_checks_and_counts_no_cpu_launch():
    tables, cam = _port_tables(CFG)
    f, i = tsd.init_stream_dda_state(CFG, device="cpu")
    before = tsd.stream_step_dda.launches
    _, _, rays = tsd.stream_step_dda(tables, cam, CFG, trng.base_key(0), f,
                                     i, 1, 200)
    assert tsd.stream_step_dda.launches == before and int(rays) >= G
    key = trng.base_key(0)
    for bad, exc in (((f[:8], i), ValueError), ((f.double(), i), TypeError),
                     ((f, i.long()), TypeError),
                     (tmk.init_stream_state(CFG, device="cpu"), ValueError)):
        with pytest.raises(exc):
            tsd.stream_step_dda(tables, cam, CFG, key, *bad, 1, 4)
    two = CFG.replace(nee_lights=(0, 8))
    with pytest.raises(ValueError, match="ONE NEE light"):
        tsd.stream_step_dda(tables, cam, two, key,
                            *tsd.init_stream_dda_state(two, device="cpu"),
                            1, 4)
    one = CFG.replace(nee_lights=(8,))
    with pytest.raises(ValueError, match="without the NEE config"):
        tsd.stream_step_dda(tables, cam, one, key,
                            *tsd.init_stream_dda_state(one, device="cpu"),
                            1, 4)
    with pytest.raises(ValueError, match="split_budget"):
        tsd.stream_step_dda(tables, cam, CFG.replace(split_budget=2), key, f,
                            i, 1, 4)


def test_dda_args_layout():
    """The grid launch arguments csrc/stream_dda.cu reads by position."""
    cfg = CFG.replace(nee_lights=(8,))
    tables, _ = _port_tables(cfg)
    ints, floats = tsd._dda_args(tables, tables.light_rows[0])
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert ints.tolist() == [*tables.nb, tables.k, tables.n_always,
                             tables.light_rows[0]]
    np.testing.assert_array_equal(
        floats, np.float32([*tables.lo, *tables.cell, 1e-4]))
    assert tsd._dda_args(tables, None)[0][-1] == -1


# -- the engine --------------------------------------------------------------------

def test_auto_routing_f1_route_opens():
    """dda_auto, as the JAX package routes: above 2048 spheres with at most
    one NEE light the DDA route; with two lights the classic route, which
    now takes the scene (fault F1) up to 65536 spheres."""
    cam = smallpt_camera()
    big = procedural_sphere_scene(4096)
    assert dda_auto(big, CFG) and dda_auto(big, CFG.replace(nee_lights=(8,)))
    assert not dda_auto(big, CFG.replace(nee_lights=(8, 3)))
    assert not dda_auto(procedural_sphere_scene(2048), CFG)
    small = CFG.replace(width=16, height=12, max_depth=4)
    r = StreamingRenderer(big, cam, small.replace(nee_lights=(8,)),
                          device="cpu")
    assert r._dda is not None
    c = StreamingRenderer(big, cam, small.replace(nee_lights=(8, 3)),
                          device="cpu")
    assert c._dda is None and c.f.shape[0] == 8 * 14
    c.step(n_iters=64, add_samples=1)
    c.flush()
    assert (c.accumulators()[1].numpy() == 1).all()
    assert np.isfinite(c.image).all()
    forced = StreamingRenderer(cornell_box_scene(), cam, small, dda=True,
                               device="cpu")
    assert forced._dda is not None
    with pytest.raises(ValueError, match="tables on"):
        StreamingRenderer(cornell_box_scene(), cam, small,
                          dda=tsd.build_stream_dda_tables(
                              cornell_box_scene(), small, device="cpu"),
                          device="meta")


def test_engine_dda_matches_classic_and_checkpoints(tmp_path):
    """The engine's two routes on one scene: equal weights, radiance as
    test_dda_matches_classic_streaming; a DDA checkpoint resumes bit for bit
    and a classic renderer refuses it."""
    scene = procedural_sphere_scene(2100)
    cfg = CFG.replace(width=16, height=12)
    cam = smallpt_camera()
    a = StreamingRenderer(scene, cam, cfg, seed=3, device="cpu")
    b = StreamingRenderer(scene, cam, cfg, seed=3, dda=False, device="cpu")
    assert a._dda is not None and b._dda is None
    for r in (a, b):
        r.step(n_iters=cfg.max_depth * 3, add_samples=2)
        r.flush()
    rad_a, w_a = (t.numpy() for t in a.accumulators())
    rad_b, w_b = (t.numpy() for t in b.accumulators())
    np.testing.assert_array_equal(w_a, w_b)
    np.testing.assert_allclose(rad_a, rad_b, rtol=2e-4, atol=2e-3)
    ck = str(tmp_path / "dda.npz")
    a.save_checkpoint(ck)
    assert bool(np.load(ck)["dda"])
    r2 = StreamingRenderer(scene, cam, cfg, seed=3, device="cpu")
    r2.load_checkpoint(ck)
    np.testing.assert_array_equal(r2.accumulators()[0].numpy(), rad_a)
    with pytest.raises(ValueError, match="traversal mode"):
        b.load_checkpoint(ck)


@pytest.fixture(scope="module")
def jax_dda_checkpoints(tmp_path_factory):
    """JAX's DDA renderer (the default grid) on procedural_sphere_scene(300)
    at 32x24: a checkpoint after step(7, 2), its own image after resuming
    with step(40, 2) and a flush, and its image resumed from the port's
    checkpoint of the same steps."""
    d = tmp_path_factory.mktemp("ck")
    js, cam = jscene.procedural_sphere_scene(300), jcam.smallpt_camera()
    a = jstreaming.StreamingRenderer(js, cam, JCFG, seed=11, dda=True)
    a.step(n_iters=7, add_samples=2)
    a.save_checkpoint(str(d / "jax.npz"))
    a.step(n_iters=40, add_samples=2)
    a.flush()
    b = StreamingRenderer(procedural_sphere_scene(300), smallpt_camera(),
                          CFG, seed=11, dda=True, device="cpu")
    b.step(n_iters=7, add_samples=2)
    b.save_checkpoint(str(d / "port.npz"))
    j = jstreaming.StreamingRenderer(js, cam, JCFG, seed=11, dda=True)
    j.load_checkpoint(str(d / "port.npz"))
    j.step(n_iters=40, add_samples=2)
    j.flush()
    return d, a, j


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dda_checkpoint_resumes_across_packages(jax_dda_checkpoints,
                                                direction):
    d, jax_own, jax_from_port = jax_dda_checkpoints
    port = StreamingRenderer(procedural_sphere_scene(300), smallpt_camera(),
                             CFG, seed=11, dda=True, device="cpu")
    if direction == "jax_to_port":
        port.load_checkpoint(str(d / "jax.npz"))
        assert port.budget == 2 and port.stats.passes == 1
        ref = jax_own
    else:
        port.step(n_iters=7, add_samples=2)
        ref = jax_from_port
    port.step(n_iters=40, add_samples=2)
    port.flush()
    _, w = port.accumulators()
    assert (w.numpy() == 4).all()
    np.testing.assert_array_equal(w.numpy(), np.asarray(ref.accumulators()[1]))
    _image_gate(port.image, ref.image)


def _dda_renderer(seed, cfg=CFG, **kw):
    return StreamingRenderer(procedural_sphere_scene(300), smallpt_camera(),
                             cfg, seed=seed, dda=True, device="cpu", **kw)


def test_capped_dda_flush_drains(monkeypatch):
    """Hazard H2: a DDA bounce costs its walk steps + 1 iterations, so a
    flush round need not change the pending counts even uncapped; the DDA
    flush tolerates unchanged rounds (the capped limit) and drains. Chunked
    launches give the uncapped result exactly."""
    a = _dda_renderer(7)
    a.step(n_iters=2, add_samples=5)
    a.flush()
    b = _dda_renderer(7)
    b.max_launch_iters = 2  # 10 DDA iterations a launch
    b.step(n_iters=2, add_samples=5)
    b.flush()
    for x, y in zip(a.accumulators(), b.accumulators()):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (b.accumulators()[1].numpy() == 5).all()
    # a flush round that moves nothing (as a long walk can leave the counts)
    c = _dda_renderer(7)
    c.step(n_iters=2, add_samples=5)
    real = tsd.stream_step_dda
    stalled = []

    def stall_once(*args, **kw):
        if not stalled:
            stalled.append(1)
            return args[4], args[5], torch.zeros((), dtype=torch.int64)
        return real(*args, **kw)

    monkeypatch.setattr(tsd, "stream_step_dda", stall_once)
    c.flush()
    assert stalled and tmk.stream_pending(c.i) == (0, 0)
    np.testing.assert_array_equal(c.accumulators()[0].numpy(),
                                  a.accumulators()[0].numpy())


def test_adaptive_sampling_on_dda_state():
    """step_adaptive on the DDA state: the budget and moment planes share
    the classic indices; the drain is exact over the per-pixel budgets."""
    r = _dda_renderer(4)
    r.step(n_iters=32, add_samples=4)
    r.step_adaptive(n_iters=48, add_samples_total=2 * G)
    r.flush()
    w = r.accumulators()[1].numpy()
    budgets = np.asarray(r._budgets).reshape(CFG.height, CFG.width)
    np.testing.assert_array_equal(w, budgets)
    assert int(budgets.sum()) == 6 * G and budgets.max() > budgets.min()
    q = _dda_renderer(5).step_to_quality(rel_err=0.5, max_spp=8, min_spp=4,
                                         n_iters=64)
    assert q["spp_min"] >= 4


def test_update_scene_rebuilds_the_tables():
    r = _dda_renderer(1)
    r.step(n_iters=8, add_samples=1)
    before = r._dda
    r.update_scene(procedural_sphere_scene(400))
    assert r._dda is not before and r._dda.n_local == 393
    assert r._dda.scene_tbl.shape == (400, 16)
    assert tmk.stream_pending(r.i) == (0, 0) and r.budget == 0
    r.step(n_iters=64, add_samples=1)
    r.flush()
    assert (r.accumulators()[1].numpy() == 1).all()


# -- the per-pass route's refusal and the CLI ---------------------------------------

def test_per_pass_big_scenes_cite_the_binned_drain():
    """Fault F4: per pass above 2048 spheres the port once raised, naming
    the binned drain; since item 11 it takes that drain (kernel K8), the
    route the JAX package takes there."""
    big = procedural_sphere_scene(2049)
    cfg = CFG.replace(max_depth=2)
    img = render(big, smallpt_camera(), cfg, trng.base_key(0), device="cpu")
    assert img.shape == (24, 32, 3) and torch.isfinite(img).all()
    assert ProgressiveRenderer(big, smallpt_camera(), cfg,
                               device="cpu").route == "binned"


def test_cli_streaming_procedural(tmp_path, monkeypatch):
    out = str(tmp_path / "p.ppm")
    argv = ["4", "--scene", "procedural", "--width", "16", "--height", "12",
            "--max-depth", "6", "--device", "cpu", "--quiet", "--out", out]
    assert cli.main([*argv, "--streaming"]) == 0 and os.path.exists(out)

    class Routed(Exception):
        pass

    def binned(*a, **k):
        raise Routed

    # per pass the scene takes the binned renderer (tests/test_torch_binned
    # .py runs that route)
    monkeypatch.setattr(cli, "BinnedProgressiveRenderer", binned)
    with pytest.raises(Routed):
        cli.main(argv)
