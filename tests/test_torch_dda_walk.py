"""K4's redesigned walk (csrc/dda.cu), emulated in plain PyTorch and held bit
for bit to the plain version it must equal, ops/dda.py::
closest_hit_dda_plain, on the CPU at toy ray counts on
tests/test_torch_dda.py's five grids.

The emulation follows the design, not the code.
- Part A: only its live rows (r > 0), in slot order with their slots, as
  the kernel stages them once a block; each through the early-miss
  stable test (tests/test_torch_hit_split.py's emulation of
  lane.cuh::early_stable_tt, which feeds NaN to the rest of the test where
  it has returned, so a result taken past a miss would show), folded with
  the strict <.
- The overflow rows: the early-miss direct quadratic (r * r taken once a
  pair), padding (r = 0) skipped, each folded on (t, id).
- The walk: the plain version's clip, entry cell, exit test and step; each
  walked cell swept as the kernel's warp sweeps it: thread w of a warp of
  ``width`` threads tests the slots w, w + width, ... below the cell's
  count (``slot_tables``: the count and the slots' [cx cy cz r]) through
  the early-miss direct test and folds them with the strict <, reading a
  slot's id where its best changes and keeping the lesser id on a tie
  below 3e38; then the warp's two REDUX minima, the least t as int32 bits
  over the threads and the least id's bits among the threads holding it.
- The lane queue: a ray's answer depends on its own ray and the grid
  alone, so the rays are taken in a shuffled order, 32 at a time as a
  warp asks for them, each batch walked on its own, and the answers
  scattered back; the queue's counts (rays, walk steps, slots tested) are
  summed as the kernel's scratch sums them and held to the plain
  version's.

Gates: t and code of every ray bit for bit (t compared as int32), for a
warp of 32 threads and of 4 (a cell's slots wrapping several times); on
each of the five grids; on the part-A rows with a zero and a NaN radius
among them; on a cell holding two identical spheres (the lesser id must
win), where a per-thread fold that takes ties (<=) fails; the grid
derives its slot tables once.
"""

import dataclasses

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.core.scene import (
    cornell_box_scene, procedural_sphere_scene, sphere_scene_from_arrays,
)
from smallpt_tpu_torch.core.math import fdiv
from smallpt_tpu_torch.ops import dda
from test_torch_hit_split import direct_tt, stable_tt

BIG = 3.0e38
BIGID = 3.0e38
TINY = float(np.float32(1e-20))
WARP = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    return x.contiguous().view(torch.int32)


# -- the emulation --------------------------------------------------------


def _part_a(lane, part_a):
    """Part A's live rows in slot order, the strict-< fold: (bta, bia)."""
    n = lane[0].shape[0]
    live = torch.nonzero(part_a[:, 3] > 0.0)[:, 0]
    bta = torch.full((n,), BIG)
    bia = torch.zeros((n,), dtype=torch.int64)
    for k in live.tolist():
        _, tt = stable_tt(lane, [part_a[k, j] for j in range(5)])
        take = tt < bta
        bta = torch.where(take, tt, bta)
        bia = torch.where(take, k, bia)
    return bta, bia


def _fold_lex(tt, ids, bt, bid):
    upd = (tt < BIG) & ((tt < bt) | ((tt == bt) & (ids < bid)))
    return torch.where(upd, tt, bt), torch.where(upd, ids, bid)


def warp_sweep(grid, lin, lane, width, ties="id"):
    """The kernel's sweep of each walking ray's cell lin: (m, idc, count)."""
    count, geom = grid.slots
    ids = grid.cells[..., 4]
    n = lin.shape[0]
    m = torch.full((width, n), BIG)
    idc = torch.full((width, n), BIGID)
    cnt = count[lin].long()
    eps = float(np.float32(grid.eps_local))
    for q in range(int(cnt.max()) if n else 0):
        w = q % width
        c = geom[lin, q].unbind(1)
        go, tt = direct_tt(lane, [*c, eps], c[3] * c[3])
        go = go & (q < cnt)
        idq = ids[lin, q]
        if ties == "le":
            take, tie = go & (tt <= m[w]), torch.zeros_like(go)
        else:
            take = go & (tt < m[w])
            tie = go & (tt == m[w]) & (tt < BIG) & (idq < idc[w])
        m[w] = torch.where(take, tt, m[w])
        idc[w] = torch.where(take | tie, idq, idc[w])
    mb = _bits(m).min(dim=0).values
    ib = torch.where(_bits(m) == mb, _bits(idc),
                     torch.iinfo(torch.int32).max).min(dim=0).values
    return mb.view(torch.float32), ib.view(torch.float32), cnt


def emulate_batch(org, dirs, grid, width, ties="id", counts=None):
    """K4's answer for one batch of rays ((3, n) planes): (t, code)."""
    o, d = tuple(org), tuple(dirs)
    lane = [v.clone() for v in (*o, *d)]
    n = o[0].shape[0]
    bta, bia = _part_a(lane, grid.part_a)
    btb = torch.full((n,), BIG)
    bidb = torch.full((n,), BIGID)
    for row in grid.overflow:
        if not float(row[3]) > 0.0:
            continue
        _, tt = direct_tt(lane, [row[j] for j in range(5)], row[3] * row[3])
        btb, bidb = _fold_lex(tt, row[5].expand(n), btb, bidb)

    # the plain version's clip and entry cell, in f32
    nb = grid.nb
    lo = [np.float32(v) for v in grid.lo]
    cl = [np.float32(v) for v in grid.cell]
    hi = [lo[a] + cl[a] * np.float32(nb[a]) for a in range(3)]
    invc = [np.float32(1.0) / cl[a] for a in range(3)]
    small = [torch.abs(d[a]) < TINY for a in range(3)]
    t0s, t1s, invs = [], [], []
    for a in range(3):
        dn = torch.where(small[a], torch.where(d[a] >= 0.0, TINY, -TINY),
                         d[a])
        inv = fdiv(1.0, dn)
        ta = (float(lo[a]) - o[a]) * inv
        tb = (float(hi[a]) - o[a]) * inv
        t0s.append(torch.minimum(ta, tb))
        t1s.append(torch.maximum(ta, tb))
        invs.append(inv)
    t_in = torch.maximum(torch.maximum(t0s[0], t0s[1]), t0s[2])
    t_far = torch.minimum(torch.minimum(t1s[0], t1s[1]), t1s[2])
    enter = torch.clamp(t_in, min=0.0)
    walking = (enter <= t_far) & (t_far > 0.0)
    ci, tm, dt = [], [], []
    for a in range(3):
        p = o[a] + d[a] * enter
        x = torch.clamp((p - float(lo[a])) * float(invc[a]), min=-1.0,
                        max=float(nb[a]))
        c_ = torch.clamp(x.to(torch.int64), 0, nb[a] - 1)
        fwd = d[a] >= 0.0
        nxt = float(lo[a]) + (c_ + fwd.long()).to(torch.float32) * float(
            cl[a])
        ci.append(c_)
        tm.append(torch.where(small[a], BIG, (nxt - o[a]) * invs[a]))
        dt.append(torch.where(small[a], BIG, float(cl[a]) * torch.abs(
            invs[a])))
    nx, ny, nz = nb
    it = torch.zeros((n,), dtype=torch.int64)
    max_steps = nx + ny + nz + 3
    while bool(walking.any()):
        idx = torch.nonzero(walking)[:, 0]
        lin = (ci[0][idx] * ny + ci[1][idx]) * nz + ci[2][idx]
        m, idc, cnt = warp_sweep(grid, lin, [v[idx] for v in lane], width,
                                 ties)
        if counts is not None:
            counts["walk_steps"] += idx.numel()
            counts["slot_tests"] += int(cnt.sum())
        b_t, b_i = _fold_lex(m, idc, btb[idx], bidb[idx])
        btb[idx], bidb[idx] = b_t, b_i
        tx, ty, tz = (t_[idx] for t_ in tm)
        t_exit = torch.minimum(torch.minimum(tx, ty), tz)
        done = torch.minimum(bta[idx], b_t) <= t_exit
        ax = (tx <= ty) & (tx <= tz)
        ay = ~ax & (ty <= tz)
        az = ~ax & ~ay
        go = ~done
        for a, sel in ((0, ax), (1, ay), (2, az)):
            step = torch.where(d[a][idx] >= 0.0, 1, -1)
            inew = torch.where(sel, ci[a][idx] + step, ci[a][idx])
            ci[a][idx] = inew
            tm[a][idx] = torch.where(sel, tm[a][idx] + dt[a][idx],
                                     tm[a][idx])
            go = go & (~sel | ((inew >= 0) & (inew < nb[a])))
        it[idx] += 1
        walking[idx] = go & (it[idx] < max_steps)
    a_wins = bta <= btb
    best = torch.where(a_wins, bta, btb)
    code = torch.where(best >= BIG, 0, torch.where(
        a_wins, -(bia + 1), bidb.to(torch.int64)))
    return best, code.to(torch.int32)


def emulate(org, dirs, grid, width=WARP, ties="id", seed=0, counts=None):
    """The emulated K4 launch: the rays taken in a shuffled order, a warp's
    32 at a time, each batch walked alone, the answers scattered back."""
    n = org.shape[1]
    order = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    t = torch.empty((n,), dtype=torch.float32)
    code = torch.empty((n,), dtype=torch.int32)
    for s in range(0, n, 32):
        take = order[s:s + 32]
        t[take], code[take] = emulate_batch(org[:, take], dirs[:, take], grid,
                                            width, ties, counts)
        if counts is not None:
            counts["rays"] += take.numel()
    return t, code


# -- the cases ------------------------------------------------------------


def _rays(n, seed, inside=True):
    rng = np.random.default_rng(seed)
    lo, hi = ([5, 5, 20], [95, 75, 150]) if inside else (
        [-40, -40, 170], [140, 120, 320])
    org = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return org.astype(np.float32), d.astype(np.float32)


def _axis_rays(lo, n=160):
    rng = np.random.default_rng(4)
    org = rng.uniform([5, 5, 20], [95, 75, 150], (n, 3))
    org[:16] = np.asarray(lo)
    org[16:32, 0] = lo[0]
    d = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))
    return org.astype(np.float32), d.astype(np.float32)


# tests/test_torch_dda.py's five grids, at toy ray counts
_CASES = {
    "procedural800_inside": (800, dict(occ_target=16.0),
                             lambda lo: _rays(160, 1, inside=True)),
    "procedural800_outside": (800, dict(occ_target=16.0),
                              lambda lo: _rays(160, 1, inside=False)),
    "cornell_occ4": (None, dict(occ_target=4.0), lambda lo: _rays(160, 2)),
    "overflow_nb222_k48": (600, dict(nb=(2, 2, 2), k_max=48),
                           lambda lo: _rays(96, 3)),
    "axis_aligned_boundary": (400, dict(occ_target=16.0), _axis_rays),
}
_CACHE = {}


def _case(name):
    if name not in _CACHE:
        n, kw, rays = _CASES[name]
        scene = cornell_box_scene() if n is None else \
            procedural_sphere_scene(n)
        grid = dda.build_dda_grid(scene, device="cpu", **kw)
        o, d = rays(grid.lo)
        _CACHE[name] = (scene, grid, torch.from_numpy(o.T.copy()),
                        torch.from_numpy(d.T.copy()))
    return _CACHE[name]


def _check(org, dirs, grid, width=WARP, seed=0):
    cnt = {"rays": 0, "walk_steps": 0, "slot_tests": 0}
    got = emulate(org, dirs, grid, width, seed=seed, counts=cnt)
    plain = {}
    want = dda.closest_hit_dda_plain(org, dirs, grid, counts=plain)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    assert cnt == {k: plain[k] for k in cnt}
    return want, plain


@pytest.mark.parametrize("width", [WARP, 4])
@pytest.mark.parametrize("name", list(_CASES))
def test_walk_equals_plain(name, width):
    """Every ray's (t, code) and the launch's counts as the plain
    version's, on each grid, with the rays taken in a shuffled order."""
    _, grid, org, dirs = _case(name)
    want, plain = _check(org, dirs, grid, width, seed=width)
    assert plain["walk_steps"] > 0
    if name == "overflow_nb222_k48":
        assert grid.n_overflow > 0 and plain["overflow_past_det"] > 0
    assert bool((want[0] < BIG).any())


def test_part_a_live_rows_only():
    """Part-A rows given a zero or a NaN radius are left out as the kernel
    stages the live rows; the fold over the rest keeps the plain version's
    bits, and the left-out rows never win."""
    _, grid, org, dirs = _case("procedural800_inside")
    pa = grid.part_a.clone()
    pa[[0, 3, 9, 40], 3] = 0.0
    pa[[5, 60, 61], 3] = float("nan")
    g = dataclasses.replace(grid, part_a=pa)
    assert int((g.part_a[:, 3] > 0).sum()) == 128 - 7
    want, _ = _check(org, dirs, g)
    assert not bool(torch.isin(want[1], torch.tensor(
        [-1, -4, -10, -41, -6, -61, -62], dtype=torch.int32)).any())


def _twin_grid():
    """procedural_sphere_scene(300) with its sphere 200 twice (the copy
    appended, id 300): both in every cell the sphere touches."""
    s = procedural_sphere_scene(300)
    m = s.material
    pick = [*range(300), 200]
    twin = sphere_scene_from_arrays(s.center[pick], s.radius[pick],
                                    m.emission[pick], m.albedo[pick],
                                    m.refl[pick])
    grid = dda.build_dda_grid(twin, occ_target=8.0, device="cpu")
    rng = np.random.default_rng(7)
    c = s.center[200].numpy()
    o = c[None] + rng.uniform(-12, 12, (96, 3))
    d = c[None] + rng.uniform(-0.5, 0.5, (96, 3)) * float(s.radius[200]) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return grid, (torch.from_numpy(o.T.astype(np.float32).copy()),
                  torch.from_numpy(d.T.astype(np.float32).copy()))


@pytest.mark.parametrize("width", [WARP, 4])
def test_twin_spheres_in_one_cell(width):
    """Two identical spheres listed in the same cells: every hit on one
    ties with the other, and the fold keeps the lesser id, in one thread
    of the warp (4 wide: the copy sits in a later round of the same
    thread or in another thread) and across the warp's REDUX."""
    grid, (org, dirs) = _twin_grid()
    ids = grid.cells[..., 4]
    both = ((ids == 200).any(1) & (ids == 300).any(1))
    assert bool(both.any())
    want, _ = _check(org, dirs, grid, width)
    assert int((want[1] == 200).sum()) > 20
    assert not bool((want[1] == 300).any())


def test_fold_that_takes_ties_fails():
    """A per-thread fold that takes the later slot on a tie (<=) answers
    with the copy's id where the two share a thread."""
    grid, (org, dirs) = _twin_grid()
    got = emulate(org, dirs, grid, width=1, ties="le")
    want = dda.closest_hit_dda_plain(org, dirs, grid)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert bool((got[1] == 300).any()) and not bool((want[1] == 300).any())


def test_slot_tables_are_cached_on_the_grid():
    """The grid derives its slot tables once: the count of filled slots
    and each slot's [cx cy cz r], as K3's tables are derived."""
    _, grid, *_ = _case("procedural800_inside")
    count, geom = grid.slots
    assert grid.slots[0] is count
    filled = grid.cells[..., 4] < BIGID
    assert torch.equal(count, filled.sum(1, dtype=torch.int32))
    assert torch.equal(geom, grid.cells[..., :4])
