"""K2's redesigned sweep (csrc/closest_hit.cu: only the live rows staged,
in table order, the part-A rows through the stable form and the rest
through the direct quadratic, each deciding a miss before the square
roots; the rows cut into ranges; the partials merged in range order;
several rays a thread), emulated in plain PyTorch and held bit for bit to
the plain version it must equal, ops/intersect_pallas.py::
closest_hit_plain, on the CPU at toy sizes.

The emulation follows the kernel's design, not its code. The rays are
padded to whole blocks of 128 threads x rays_per_thread with the kernel's
finite dummy ray. Each range of rows keeps its live rows (r > 0; a NaN
radius is not) in table order and folds them one row at a time from
(3e38, slot 0) with the strict <: a slot below n_a through the early-miss
stable form, the others through the early-miss direct quadratic (r * r
taken once a row). An early-miss test decides det >= 0 (and r > 0) first
and runs the rest of its test only where it goes on (NaN fed to the rest
elsewhere, so a result taken past a miss would show); a miss is 3e38,
which the fold never takes (the kernel skips the fold on a miss). The
ranges' partials (t, slot) are folded in range order with the strict <.
The cut is a parameter (the kernel's own plan is not copied here): one
range, one row a range, ragged ranges, ranges split at the A/B boundary,
and whole 256-row chunks as the kernel cuts.

Gates: t and slot of every ray bit for bit (t compared as int32). The
cases: a small sphere that part A and part B both hold, whose tie crosses
a range boundary; two identical spheres; rays that miss everything;
tangent rays (det exactly 0); rays from inside a sphere (t_near <= eps);
1e5 walls; a NaN or zero radius inside a range; procedural_sphere_scene
(300) and the Cornell box on camera and first-bounce rays. A merge that
takes ties (<=) must fail on the duplicates. The early-miss tests
themselves are held to the whole tests (``_sphere_tt``,
``_sphere_tt_fast``) on edge inputs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from smallpt_tpu_torch.config import CameraModel, Filter, RenderConfig
from smallpt_tpu_torch.core import rng
from smallpt_tpu_torch.core.camera import smallpt_camera
from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene, sphere_scene_from_arrays,
)
from smallpt_tpu_torch.engine.renderer import make_intersect_fn
from smallpt_tpu_torch.ops import intersect_pallas as ip
from smallpt_tpu_torch.ops.megakernel import _sphere_tt

BIG = 3.0e38
BLOCK = 128  # the kernel's threads a block
CHUNK = 256  # the kernel's rows a staged chunk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad_rays(org, dirs, rays_per_thread: int):
    """The rays padded to whole blocks with the kernel's dummy ray (origin
    0, direction +x)."""
    n = org.shape[1]
    per_block = BLOCK * rays_per_thread
    n_pad = -(-max(n, 1) // per_block) * per_block
    o = torch.zeros((3, n_pad), dtype=torch.float32)
    d = torch.zeros((3, n_pad), dtype=torch.float32)
    d[0] = 1.0
    o[:, :n], d[:, :n] = org, dirs
    return o, d


def _nan_past(go, x):
    """x where the test goes on past det, NaN where it has returned."""
    return torch.where(go, x, float("nan"))


def stable_tt(lane, cols):
    """lane.cuh::early_stable_tt: the stable form to det, 3e38 unless det >= 0
    and r > 0, the rest of the test only past that; (go, tt)."""
    ox, oy, oz, dx, dy, dz = lane
    cx, cy, cz, r, eps = cols
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    b = opx * dx + opy * dy + opz * dz
    fx = opx - b * dx
    fy = opy - b * dy
    fz = opz - b * dz
    pp = fx * fx + fy * fy + fz * fz
    sp = torch.sqrt(pp)
    det = (r - sp) * (r + sp)
    go = (det >= 0.0) & (r > 0.0)
    det, b, pp = (_nan_past(go, x) for x in (det, b, pp))
    s = torch.sqrt(torch.clamp(det, min=0.0))
    opn = torch.sqrt(b * b + pp)
    cc = (opn - r) * (opn + r)
    denom = b + s
    one = torch.ones_like(denom)
    t_near = torch.where(denom > 0.0,
                         cc / torch.where(denom == 0.0, one, denom), -BIG)
    tt = torch.where(t_near > eps, t_near, torch.where(denom > eps, denom,
                                                       BIG))
    return go, torch.where(go, tt, BIG)


def direct_tt(lane, cols, rr):
    """lane.cuh::early_direct_tt: the direct quadratic to det (rr = r * r, one
    rounding a row), 3e38 unless det >= 0 and r > 0, the roots only past
    that; (go, tt)."""
    ox, oy, oz, dx, dy, dz = lane
    cx, cy, cz, r, eps = cols
    opx = cx - ox
    opy = cy - oy
    opz = cz - oz
    b = opx * dx + opy * dy + opz * dz
    op2 = opx * opx + opy * opy + opz * opz
    det = b * b - op2 + rr
    go = (det >= 0.0) & (r > 0.0)
    det, b = _nan_past(go, det), _nan_past(go, b)
    s = torch.sqrt(torch.clamp(det, min=0.0))
    t0 = b - s
    t1 = b + s
    tt = torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, BIG))
    return go, torch.where(go, tt, BIG)


def _range_sweep(lane, rows, ids, n_a, classes, n_real):
    """One unit's fold over its live rows (rows (R, 8) in table order, ids
    their slots) from (3e38, slot 0) with the strict <: the running best
    before each row is the least t of the rows before it (the sequential
    fold's, by cummin); the winner is the last row taken. classes counts
    the pairs of the first n_real rays by form and by whether the early
    miss returns."""
    n = lane[0].shape[0]
    if not rows.shape[0]:
        return torch.full((n,), BIG), torch.zeros((n,), dtype=torch.int32)
    tts = []
    for form, sel in (("stable", ids < n_a), ("direct", ids >= n_a)):
        if not bool(sel.any()):
            continue
        cols = [rows[sel, k][None, :] for k in range(5)]
        go, tt = (stable_tt(lane, cols) if form == "stable"
                  else direct_tt(lane, cols, cols[3] * cols[3]))
        hits = int(go[:n_real].sum())
        classes[f"{form}_hit"] += hits
        classes[f"{form}_miss"] += go[:n_real].numel() - hits
        tts.append(tt)
    tt = torch.cat(tts, dim=1)  # the stable rows are the slots first
    run = torch.cummin(tt, dim=1).values
    before = torch.cat([torch.full((n, 1), BIG), run[:, :-1]], dim=1)
    take = tt < before
    last = (take * torch.arange(1, rows.shape[0] + 1)).amax(dim=1) - 1
    hit = last >= 0
    at = last.clamp(min=0)
    return (torch.where(hit, tt.gather(1, at[:, None])[:, 0], BIG),
            torch.where(hit, ids.to(torch.int32)[at], 0))


def split_sweep(org, dirs, table, n_a, n_b, bounds, rays_per_thread=2,
                strict=True, classes=None):
    """The emulated K2 launch: (t, slot) for (3, N) ray planes over rows [0,
    n_a + n_b), the rows cut at ``bounds`` (0 = b0 < b1 < ... = n_a + n_b),
    the ranges' partials merged in range order with the strict < (<= where
    not strict)."""
    n = org.shape[1]
    o, d = _pad_rays(org, dirs, rays_per_thread)
    lane = [x[:, None] for x in (*o, *d)]
    classes = ({"stable_miss": 0, "stable_hit": 0, "direct_miss": 0,
                "direct_hit": 0} if classes is None else classes)
    rows = table[:n_a + n_b]
    live = rows[:, 3] > 0.0
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ids = torch.nonzero(live[lo:hi])[:, 0] + lo
        parts.append(_range_sweep(lane, rows[ids], ids, n_a, classes, n))
    best = parts[0]
    for p in parts[1:]:
        take = p[0] < best[0] if strict else p[0] <= best[0]
        best = tuple(torch.where(take, a, b) for a, b in zip(p, best))
    return tuple(x[:n] for x in best)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _diff(got, want) -> list:
    """The rays on which t and slot differ in their bits."""
    return [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]


def _cuts(n_rows: int, n_a: int) -> dict:
    ragged = sorted({0, n_rows, *np.random.default_rng(n_rows).integers(
        1, max(n_rows, 2), 5).tolist()})
    return {
        "one_range": [0, n_rows],
        "one_row_a_range": list(range(n_rows + 1)),
        "ragged": ragged,
        "ab_boundary": sorted(set(ragged) | {min(n_a, n_rows)}),
        "chunks": list(range(0, n_rows, CHUNK)) + [n_rows],
    }


def _args(scene):
    table, _, nbc, nsc = ip.build_sphere_table(scene)
    return table, 64 * nbc, 64 * nsc


def _planes(o, d):
    return (torch.from_numpy(np.ascontiguousarray(np.asarray(o).T,
                                                  np.float32)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(d).T,
                                                  np.float32)))


def _unit(d):
    d = np.asarray(d, np.float32)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _check_every_cut(org, dirs, table, n_a, n_b, cuts=None):
    """The emulated sweep under every cut (or those named) equals
    closest_hit_plain bit for bit; returns the plain version's (t, slot)."""
    want = ip.closest_hit_plain(org, dirs, table, n_a, n_b)
    for name, bounds in _cuts(n_a + n_b, n_a).items():
        if cuts is None or name in cuts:
            got = split_sweep(org, dirs, table, n_a, n_b, bounds)
            assert _diff(got, want) == [0, 0], name
    return want


def _scene_rays(scene, w=32, h=24):
    """The scene's camera and first-bounce rays at w x h (one sample a
    pixel), as (3, N) planes."""
    cfg = RenderConfig(width=w, height=h, camera_model=CameraModel.LEGACY,
                       filter=Filter.TENT)
    cam, bounce = chip_smoke.camera_and_bounce_rays(
        scene, cfg, smallpt_camera(), rng.fold_in(rng.base_key(0), 1003),
        make_intersect_fn(scene, cfg), "cpu")
    return [(o.T.contiguous(), d.T.contiguous()) for o, d in (cam, bounce)]


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for name, scene in (("procedural300", procedural_sphere_scene(300)),
                        ("cornell", cornell_box_scene())):
        out[name] = (_args(scene), _scene_rays(scene))
    return out


@pytest.mark.parametrize("cut", ["one_range", "one_row_a_range", "ragged",
                                 "ab_boundary", "chunks"])
@pytest.mark.parametrize("rays", ["camera", "bounce"])
@pytest.mark.parametrize("scene", ["procedural300", "cornell"])
def test_scene_rays_every_cut(scenes, scene, rays, cut):
    """procedural_sphere_scene(300) (part A full of small spheres, swept
    twice) and the Cornell box (1e5 walls) on camera and first-bounce
    rays: every cut gives closest_hit_plain's bits."""
    (table, n_a, n_b), planes = scenes[scene]
    org, dirs = planes[rays == "bounce"]
    want = _check_every_cut(org, dirs, table, n_a, n_b, cuts=(cut,))
    assert 0.5 < float((want[0] < BIG).float().mean())


@pytest.mark.parametrize("rays_per_thread", [1, 2, 4])
def test_rays_per_thread_and_ragged_block(rays_per_thread):
    """77 rays fill no whole block: the dummy rays change no real ray's
    result, whatever the rays a thread."""
    table, n_a, n_b = _args(procedural_sphere_scene(300))
    r = np.random.default_rng(3)
    org, dirs = _planes(r.uniform((5, 5, 20), (95, 75, 150), (77, 3)),
                        _unit(r.normal(size=(77, 3))))
    got = split_sweep(org, dirs, table, n_a, n_b,
                      _cuts(n_a + n_b, n_a)["ragged"], rays_per_thread)
    assert _diff(got, ip.closest_hit_plain(org, dirs, table, n_a,
                                           n_b)) == [0, 0]


def _rays_at_balls(scene, balls, n, seed):
    """n rays from near the camera aimed at points around the given
    spheres' centres."""
    r = np.random.default_rng(seed)
    o = np.float32([50, 50, 160]) + r.uniform(-10, 10, (n, 3))
    tgt = scene.center.numpy()[balls][r.integers(0, len(balls), n)]
    return _planes(o, _unit(tgt + r.uniform(-12, 12, (n, 3)) - o))


def test_part_a_and_b_tie_across_a_range_boundary():
    """The Cornell box's two small balls are in part A (stable form) and
    part B (direct quadratic): where both forms give the same t, the part-A
    slot wins, in another range than its twin under the A/B cut."""
    scene = cornell_box_scene()
    table, n_a, n_b = _args(scene)
    org, dirs = _rays_at_balls(scene, [6, 7], 2000, 1)
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    lane = [x[:, None] for x in (*org, *dirs)]
    ties = 0
    for k in (6, 7):
        a = int(torch.nonzero((table[:n_a, :3] == scene.center[k]).all(1)))
        b = n_a + k
        cols = [table[[a, b], j][None, :] for j in range(5)]
        _, ta = stable_tt(lane, [c[:, :1] for c in cols])
        _, tb = direct_tt(lane, [c[:, 1:] for c in cols],
                          cols[3][:, 1:] * cols[3][:, 1:])
        tie = (ta[:, 0] == tb[:, 0]) & (ta[:, 0] == want[0])
        ties += int(tie.sum())
        assert bool((want[1][tie] == a).all())
        assert bool((want[1] == b).any())  # the direct form wins elsewhere
    assert ties > 50


def _twin_scene():
    """The Cornell box with its mirror ball twice (spheres 6 and 9): part A
    and part B each hold both copies."""
    s = cornell_box_scene()
    m = s.material
    pick = [*range(9), 6]
    return sphere_scene_from_arrays(
        s.center[pick], s.radius[pick], m.emission[pick], m.albedo[pick],
        m.refl[pick])


@pytest.mark.parametrize("cut", ["ragged", "ab_boundary", "one_row_a_range"])
def test_two_identical_spheres(cut):
    """Two identical spheres: every hit on one ties with its twin (and with
    both copies in part B); the strict merge keeps the first slot, the
    sequential fold's, under every cut."""
    scene = _twin_scene()
    table, n_a, n_b = _args(scene)
    org, dirs = _rays_at_balls(scene, [6], 500, 2)
    want = _check_every_cut(org, dirs, table, n_a, n_b, cuts=(cut,))
    twin_a = int(torch.nonzero((table[:n_a, 3] == 16.5)).max())
    hit_twin = ((want[1] == twin_a) | (want[1] == n_a + 9)) & (want[0] < BIG)
    assert int((want[0] < BIG).sum()) > 200 and not bool(hit_twin.any())


def test_nonstrict_merge_fails():
    """A merge that takes ties (<=) picks a later twin: the slot differs
    from the sequential fold's, t does not."""
    scene = _twin_scene()
    table, n_a, n_b = _args(scene)
    org, dirs = _rays_at_balls(scene, [6], 500, 2)
    got = split_sweep(org, dirs, table, n_a, n_b,
                      list(range(n_a + n_b + 1)), strict=False)
    diff = _diff(got, ip.closest_hit_plain(org, dirs, table, n_a, n_b))
    assert diff[1] > 0 and diff[0] == 0


def test_rays_that_miss_everything():
    """Rays from far outside the scene pointing away: (3e38, 0) each, under
    every cut, though some pairs go on past det (the line meets a sphere
    behind the origin)."""
    table, n_a, n_b = _args(procedural_sphere_scene(300))
    r = np.random.default_rng(6)
    d = r.normal(size=(130, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    org, dirs = _planes(np.tile(np.float32([50, 40, 1e6]), (130, 1)),
                        _unit(d))
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    assert bool((want[0] == BIG).all()) and int(want[1].abs().sum()) == 0
    classes = {"stable_miss": 0, "stable_hit": 0, "direct_miss": 0,
               "direct_hit": 0}
    split_sweep(org, dirs, table, n_a, n_b, [0, n_a + n_b], classes=classes)
    assert classes["stable_hit"] > 0


def _one_off_scene(center, radius):
    k = len(radius)
    return sphere_scene_from_arrays(center, radius, np.zeros((k, 3)),
                                    np.full((k, 3), 0.5), np.zeros(k))


def test_tangent_rays_det_exactly_zero():
    """Rays that graze a sphere: det is exactly 0 in both forms (a unit
    sphere, rays along x at distance 1), and in the stable form on a 1e5
    sphere; each is a hit at the tangent point, under every cut."""
    scene = _one_off_scene([(0, 0, 0), (0, -1e5 - 5, 0)], [1.0, 1e5])
    table, n_a, n_b = _args(scene)
    o = np.float32([(-5, 1, 0), (-5, -1, 0), (-7, 0, 1), (-3, 0, -1),
                    (-9, -5, 0)])
    d = np.tile(np.float32([1, 0, 0]), (5, 1))
    org, dirs = _planes(o, d)
    lane = [x[:, None] for x in (*org, *dirs)]
    small, big = table[[n_a], :5], table[[0, 1], :5]
    assert float(big[0, 3]) == 1e5
    go, _ = stable_tt(lane, [small[:, k][None, :] for k in range(5)])
    cols = [small[:, k][None, :] for k in range(5)]
    go_d, _ = direct_tt(lane, cols, cols[3] * cols[3])
    assert bool(go[:4].all()) and bool(go_d[:4].all())
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    assert bool((want[0] < BIG).all())
    np.testing.assert_array_equal(want[0][:4].numpy(), [5, 5, 7, 3])


def test_rays_from_inside_a_sphere():
    """Origins inside small and 1e5 spheres, and on a small sphere's
    surface: t_near <= eps, so each takes the far root, as the plain
    version does, under every cut."""
    scene = _one_off_scene([(0, 0, 0), (30, 0, 0), (0, 1e5 + 50, 0)],
                           [10.0, 4.0, 1e5])
    table, n_a, n_b = _args(scene)
    r = np.random.default_rng(7)
    o = np.concatenate([r.uniform(-3, 3, (60, 3)),
                        np.float32([30, 0, 0]) + r.uniform(-1, 1, (60, 3)),
                        np.tile(np.float32([10, 0, 0]), (20, 1))])
    d = _unit(r.normal(size=(140, 3)))
    d[120:] = _unit(np.abs(d[120:]) * [-1, 1, 1])  # into the ball
    org, dirs = _planes(o, d)
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    assert bool((want[0][:120] > 0.5).all()) and bool(
        (want[0] < BIG).all())


def test_1e5_walls():
    """Rays from inside the Cornell box in every direction: each meets a
    1e5 wall or a ball, under every cut."""
    scene = cornell_box_scene()
    table, n_a, n_b = _args(scene)
    r = np.random.default_rng(8)
    org, dirs = _planes(r.uniform((5, 5, 20), (95, 75, 150), (300, 3)),
                        _unit(r.normal(size=(300, 3))))
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    assert bool((want[0] < BIG).all())
    assert bool((table[want[1].long(), 3] == 1e5).any())


def test_nan_and_zero_radius_inside_a_range():
    """Live rows of both parts given a NaN or a zero radius: they are left
    out as the table is staged (a NaN radius is not > 0), never win, and
    the rest of the range folds as before."""
    table, n_a, n_b = _args(procedural_sphere_scene(300))
    table = table.clone()
    r = np.random.default_rng(9)
    live = torch.nonzero(table[:n_a + n_b, 3] > 0)[:, 0].numpy()
    dead = torch.from_numpy(r.choice(live, 60, replace=False))
    table[dead[:30], 3] = float("nan")
    table[dead[30:], 3] = 0.0
    org, dirs = _planes(r.uniform((5, 5, 20), (95, 75, 150), (400, 3)),
                        _unit(r.normal(size=(400, 3))))
    want = _check_every_cut(org, dirs, table, n_a, n_b)
    assert not bool(torch.isin(want[1], dead.to(torch.int32)).any())


def _edge_inputs():
    """(lane, cols) edge inputs broadcast pairwise: origins and directions
    with tangents, NaN and inf, spheres of radius 0, negative, NaN, and
    origins on and inside them, eps 1e-4 and NaN."""
    o = [(-5, 1, 0), (-5, 0, 0), (0, 0, 0), (1, 0, 0), (0.5, 0, 0),
         (np.nan, 0, 0), (np.inf, 0, 0), (-5, 1e-20, 0), (0, 0, -1e5)]
    d = [(1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, 0, 1), (np.nan, 0, 0),
         (0.6, 0.8, 0)]
    lane = [np.array(v, np.float32) for v in zip(*[
        (*a, *b) for a in o for b in d])]
    c = [(0, 0, 0, 1, 1e-4), (0, 0, 0, 0, 1e-4), (0, 0, 0, -1, 1e-4),
         (0, 0, 0, np.nan, 1e-4), (0, 0, 0, 1, np.nan),
         (0, 0, 0, 1e5, 0.05), (0, -1e5 - 1, 0, 1e5, 0.05),
         (3, 4, 0, 5, 1e-4), (0, 0, 0, np.inf, 1e-4)]
    cols = [np.array(v, np.float32) for v in zip(*c)]
    return ([torch.from_numpy(x)[:, None] for x in lane],
            [torch.from_numpy(x)[None, :] for x in cols])


@pytest.mark.parametrize("form", ["stable", "direct"])
def test_early_miss_tests_equal_the_whole_tests(form):
    """The early-miss copies return the whole tests' bits on edge inputs:
    tangents (det 0), NaN and inf rays, radii 0, negative, NaN and inf, a
    NaN eps, origins on and inside a sphere."""
    with np.errstate(all="ignore"):
        lane, cols = _edge_inputs()
    if form == "stable":
        _, got = stable_tt(lane, cols)
        want = _sphere_tt(*lane, *cols)
    else:
        _, got = direct_tt(lane, cols, cols[3] * cols[3])
        want = ip._sphere_tt_fast(*lane, *cols)
    assert torch.equal(_bits(got), _bits(want))
    assert 0 < int((want < BIG).sum()) < want.numel()


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_bound_counts_the_emulated_decisions(scenes, rays):
    """chip_smoke.py::k2_pairs, which prices K2's bound, counts the pairs
    the emulated sweep decides at det and past it, by form, uncut, and the
    rows the kernel leaves out as it stages them."""
    (table, n_a, n_b), planes = scenes["procedural300"]
    org, dirs = planes[rays == "bounce"]
    classes = {"stable_miss": 0, "stable_hit": 0, "direct_miss": 0,
               "direct_hit": 0}
    split_sweep(org, dirs, table, n_a, n_b, [0, n_a + n_b], classes=classes)
    pairs = chip_smoke.k2_pairs(org, dirs, table, n_a, n_b)
    assert {k: pairs[k] for k in classes} == classes
    assert classes["direct_hit"] and classes["stable_hit"]
    live = int((table[:n_a + n_b, 3] > 0).sum())
    assert pairs["left_out"] == n_a + n_b - live > 0
    assert pairs["live_a"] == n_a  # part A truncated to MAX_BIG rows
    assert 0 < pairs["warp_rows_tail"] < pairs["warp_rows"]


def test_edge_launch_every_cut():
    """chip_smoke.py::k2_edge_launch, the launch of edge cases K2 is held
    to on the card (tangent rays, origins inside spheres, NaN and inf
    rays, NaN and zero radii among the live rows, an infinite radius, a
    NaN eps), over procedural_sphere_scene(300)'s table: the emulated
    sweep equals the plain version under every cut; the ray tangent to
    both the unit sphere (part B) and the 1e5 sphere (part A) meets both
    at t = 5, and the first slot, the 1e5 sphere's, wins the tie; the edge
    spheres win rays."""
    table, n_a, n_b = _args(procedural_sphere_scene(300))
    with np.errstate(all="ignore"):
        org, dirs, tab = chip_smoke.k2_edge_launch(table, n_a, n_b)
    assert bool(torch.isnan(org).any()) and bool(torch.isinf(dirs).any())
    assert int(torch.isnan(tab[:n_a + n_b, 3]).sum()) == 30
    want = _check_every_cut(org, dirs, tab, n_a, n_b)
    assert float(want[0][55]) == 5.0 and int(want[1][55]) == 2
    won = torch.isin(want[1][want[0] < BIG],
                     torch.tensor([2, n_a + 1, n_a + 2], dtype=torch.int32))
    assert int(won.sum()) > 100


@pytest.mark.parametrize("rays", ["camera", "bounce"])
def test_bound_takes_the_lesser_algorithm(rays):
    """chip_smoke.py::k2_bound prices a launch at the lesser of K2's staged
    sweep and a grid walk over the scene's spheres where the sweep's ops
    outlast the bytes: the walk on procedural_sphere_scene(300), below
    the sweep; the sweep on the Cornell box, whose bytes bound it, with
    no walk counted."""
    for scene, algorithm in ((procedural_sphere_scene(300), "grid walk"),
                             (cornell_box_scene(), "staged sweep")):
        table, n_a, n_b = _args(scene)
        org, dirs = _scene_rays(scene)[rays == "bounce"]
        b = chip_smoke.k2_bound(org, dirs, table, n_a, n_b, scene=scene)
        assert b["bound_algorithm"] == algorithm
        assert b["bound_ms"] <= b["bound_ms_staged_sweep"]
        if algorithm == "grid walk":
            assert b["bound_ms"] == b["bound_ms_grid_walk"]
            assert b["walk"]["counts"]["walk_steps"] > 0
            assert b["walk"]["occ"] in chip_smoke.DDA_OCC
        else:
            assert b["bound_by"] == "bytes" and "walk" not in b
        no_scene = chip_smoke.k2_bound(org, dirs, table, n_a, n_b)
        assert no_scene["bound_algorithm"] == "staged sweep"
        assert no_scene["bound_ms"] == b["bound_ms_staged_sweep"]
