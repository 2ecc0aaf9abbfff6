"""K7's cull (csrc/closest_tri_culled.cu::box_keep and sweep_cones), in
its plain form ops/mesh_pallas.py::box_test and cone_test, and K7's sweep
group by group (closest_tri_culled_plain), held on the CPU to the brute
sweep (closest_tri_plain, K6's plain version) on
procedural_mesh_scene(60, seed=3) (3,854 triangles, 241 local chunks).

Gates, on every kind of ray of ops/cull_rays.py (random, coherent,
surface, on-surface, grazing, axis-parallel, box-face, inside-box and NaN
and inf rays; the rays chip_smoke.py holds the kernel to on the card):
- the cull never drops a candidate at or below the lane's winner: every
  such row of a local chunk lies in a chunk whose box the ray enters
  (box_test with best = the winner's t) or in a normal cone the ray
  grazes (cone_test over graze_cones); the slivers are swept by every
  ray;
- every row whose plane a ray grazes, |cos(d, n)| sin(phi) < GRAZE
  (float64), lies in a cone the ray grazes;
- the sweep (the cones' rows, the box cull at each lane's running best,
  the overflow fallback) bit-equal to the brute sweep: t on every lane,
  triangle, u and v on hit lanes, K6's miss outputs elsewhere;
- the cull culls: a finite ray keeps a few chunks of the 241, and few
  rays graze a cone.
On rays that lie in a triangle's plane with their origin on it, the box
alone drops winners (rounding-dominated candidates away from their box):
the cones hold them, and the sweep finds them. Rays through a sliver's
line far from the sliver hit it there, away from its chunk's box: the
sweep finds those hits as the brute sweep does. The chunk box table
(chunk_boxes) holds its rows and lists the slivers, the cones
(graze_cones) hold every live local row but the slivers once, and the
wrapper checks its box and cone arguments. On a mesh whose triangles share
no normals (ops/cull_rays.py::rotated_ball_mesh, randomly rotated
instances), where the cones are many, the cull and the sweep pass the same
gates on every kind of ray.
"""

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.core.scene import procedural_mesh_scene
from smallpt_tpu_torch.ops import cull_rays as cr
from smallpt_tpu_torch.ops import mesh_accel as ma
from smallpt_tpu_torch.ops import mesh_pallas as mp

BIG = 3.0e38
N = 768
KINDS = cr.KINDS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    scene = procedural_mesh_scene(60, seed=3)
    return scene, ma.build_mesh_grid_accel(scene), mp.build_tri_table(scene)


def _rays(kind, acc, table, seed, n=N):
    return cr.edge_rays(kind, acc, table, n, seed)


def _candidates(o, d, table, best):
    """(N, rows) whether each row of the table is a candidate of the ray
    at t <= best."""
    lane = [torch.from_numpy(x.copy())[:, None] for x in (*o.T, *d.T)]
    out = torch.zeros((o.shape[0], table.shape[0]), dtype=torch.bool)
    for lo in range(0, table.shape[0], 512):
        cols = [table[lo:lo + 512, k][None, :] for k in range(13)]
        hit, t, _, _ = mp._tri_test(lane, cols, 0.0)
        out[:, lo:lo + 512] = hit & (t <= best[:, None])
    return out


def _cone_rows(acc, grazes):
    """(n, rows) whether each table row lies in a cone each ray grazes
    (grazes: (n, cones))."""
    n_cones = acc.cones.shape[0]
    off = acc.cone_rows[:n_cones + 1].long()
    rows = acc.cone_rows[n_cones + 1:].long()
    cone = torch.repeat_interleave(torch.arange(n_cones), off[1:] - off[:-1])
    out = torch.zeros((grazes.shape[0], acc.table.shape[0]), dtype=torch.bool)
    out[:, rows] = grazes[:, cone]
    return out


def _culled(o, d, acc, brute):
    """The cull's reading of (n, 3) rays at their winners' t: (dropped,
    box_dropped, keep, grazes). keep (n, chunks): the local chunks whose
    box each ray enters (box_test); grazes (n, cones): the cones it
    grazes (cone_test); box_dropped (n, chunks, 16): the candidates at or
    below the winner in a local chunk the box drops, the slivers, swept
    by every ray, aside; dropped: those no cone the ray grazes holds
    either."""
    n, g = o.shape[0], acc.n_glob_chunks
    ot, dt = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    win = mp.closest_tri_plain(ot, dt, brute)[0]
    keep = mp.box_test([x[:, None] for x in mp.box_lane(ot, dt)],
                       [c[None, :] for c in acc.boxes[g:].unbind(dim=1)],
                       win[:, None], 0.0)
    grazes = mp.cone_test([x[:, None] for x in dt],
                          [c[None, :] for c in acc.cones.unbind(dim=1)])
    cand = _candidates(o, d, acc.table, win)
    cand[:, acc.slivers.long()] = False  # swept by every ray
    box_dropped = cand.reshape(n, -1, 16)[:, g:] & ~keep[:, :, None]
    held = _cone_rows(acc, grazes).reshape(n, -1, 16)[:, g:]
    return box_dropped & ~held, box_dropped, keep, grazes


@pytest.mark.parametrize("kind", KINDS)
def test_cull_never_drops_a_winner(mesh, kind):
    scene, acc, brute = mesh
    o, d = _rays(kind, acc, brute, seed=KINDS.index(kind))
    dropped, _, keep, grazes = _culled(o, d, acc, brute)
    assert not bool(dropped.any()), (kind, dropped.nonzero()[:5])
    finite = torch.from_numpy(np.isfinite(o).all(axis=1)
                              & np.isfinite(d).all(axis=1))
    kept = keep[finite].sum(dim=1).float()
    assert float(kept.mean()) < 16, float(kept.mean())
    # few rays graze a cone, but for the grazing kind, built to
    rays = grazes[finite].any(dim=1).float()
    assert float(rays.mean()) < (0.9 if kind == "grazing" else 0.6)


@pytest.mark.parametrize("kind", ("random", "grazing", "axis_parallel",
                                  "box_faces"))
def test_a_grazed_row_lies_in_a_grazed_cone(mesh, kind):
    """Every live local row but the slivers whose plane a ray grazes,
    |d . n| / (|d| |e1| |e2|) < GRAZE in float64 (|cos(d, n)| sin(phi)),
    lies in a cone the ray grazes by the f32 cone test; the rays of the
    grazing kind graze a row by construction (|cos| <= 1e-3 on its
    first six eighths)."""
    scene, acc, brute = mesh
    o, d = _rays(kind, acc, brute, seed=KINDS.index(kind))
    rows = acc.table.double().numpy()
    d64 = d.astype(np.float64)
    norm = np.linalg.norm
    with np.errstate(invalid="ignore", divide="ignore"):
        graze = np.abs(d64 @ rows[:, 9:12].T) / norm(d64, axis=1)[:, None] / (
            norm(rows[:, 3:6], axis=1) * norm(rows[:, 6:9], axis=1))[None]
    live = np.zeros(rows.shape[0], bool)
    live[acc.cone_rows[acc.cones.shape[0] + 1:].numpy()] = True
    grazed = torch.from_numpy((graze < mp.GRAZE) & live[None])
    grazes = mp.cone_test([x[:, None] for x in torch.from_numpy(d.T.copy())],
                          [c[None, :] for c in acc.cones.unbind(dim=1)])
    assert not bool((grazed & ~_cone_rows(acc, grazes)).any())
    if kind == "grazing":
        assert float(grazed.any(dim=1).float().mean()) > 0.7


def test_cones_hold_the_winners_the_box_drops(mesh):
    """Rays in a triangle's plane with their origin on it (the grazing
    kind's |cos| <= 1e-6, four draws): there dn is rounding, and so are
    the candidates' t, u and v, and the box alone drops some of their
    winners. The cones each such ray grazes hold every one, and the group
    sweep finds them as the brute sweep does."""
    scene, acc, brute = mesh
    o, d = map(np.concatenate, zip(*[
        _rays("grazing", acc, brute, seed=s) for s in range(35, 39)]))
    dropped, box_dropped, _, _ = _culled(o, d, acc, brute)
    lost = box_dropped.any(dim=2).any(dim=1)
    assert int(lost.sum()) >= 4, int(lost.sum())
    assert not bool(dropped.any())
    idx = lost.nonzero()[:, 0].numpy()
    assert (idx % 8 < 3).all()  # |cos| 0 to 1e-6
    got, _, want, _ = _sweep(o[idx], d[idx], acc, brute)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _full_lists(acc, n_tiles: int):
    """Lists naming every local chunk with bound 0: a valid input for any
    rays (0 bounds every distance), and the one for NaN and inf rays,
    whose bin keys the list builder cannot take."""
    c = acc.n_chunks
    lists = torch.arange(c, dtype=torch.int32).expand(n_tiles, c)
    return (lists.contiguous(), torch.zeros((n_tiles, c)),
            torch.full((n_tiles,), c, dtype=torch.int32))


def _sweep(o, d, acc, brute, full=False):
    """The group sweep of (n, 3) rays padded to whole tiles (the last
    groups padding, their lanes invalid) beside the brute sweep's outputs:
    (got, work, want, stops)."""
    n = o.shape[0]
    n_pad = -(-n // 1024) * 1024
    ot, dt = mp._ray_planes(torch.from_numpy(o), torch.from_numpy(d), n_pad)
    if full:
        lists, dlo, stops = _full_lists(acc, n_pad // 1024)
    else:
        lists, dlo, stops = ma.mesh_tile_lists(ot, dt, torch.arange(n_pad)
                                               < n, acc)
    got, work = mp.closest_tri_culled_plain(
        ot, dt, n, acc.table, acc.boxes, acc.slivers, acc.cones,
        acc.cone_rows, lists, dlo, stops, acc.n_glob_chunks, acc.n_chunks,
        return_work=True)
    want = [x[:n] for x in mp.closest_tri_plain(ot, dt, brute)]
    return got, work, want, stops


@pytest.mark.parametrize("kind", KINDS)
def test_group_sweep_equals_the_brute_sweep(mesh, kind):
    scene, acc, brute = mesh
    o, d = _rays(kind, acc, brute, seed=KINDS.index(kind))
    got, (tests, chunks, _), want, _ = _sweep(o, d, acc, brute,
                                              full=kind == "nan_inf")
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    hit = want[0] < BIG
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[hit].numpy(), w[hit].numpy())
        assert (g[~hit] == 0).all()
    # the groups sweep a fraction of the chunks whose boxes they test
    # (where a NaN or inf ray in every group keeps them all, all of
    # them); the groups of padding lanes alone keep none
    if kind != "nan_inf":
        assert int(chunks.sum()) < int(tests.sum()) + len(chunks)
    assert (chunks[N // mp.GROUP:] == acc.n_glob_chunks).all()


def test_one_lane_missing_among_near_hits(mesh):
    """A tile whose lanes hit a near ball, but for one that starts outside
    the room and points away: every group tests every slot's box, and the
    missing lane, whose ray enters no box, makes its group sweep no chunk
    the others' groups do not; all equal the brute sweep."""
    scene, acc, brute = mesh
    o, d = _rays("one_lane_misses", acc, brute, seed=7)
    got, (tests, chunks, _), want, stops = _sweep(o, d, acc, brute)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert want[0][37] == BIG and bool((want[0] < BIG).sum() == N - 1)
    assert (tests[:N // mp.GROUP] == int(stops[0])).all()
    assert int(chunks[1]) < int(tests[1])
    lane = mp.box_lane(torch.from_numpy(o[37:38].T.copy()),
                       torch.from_numpy(d[37:38].T.copy()))
    box = acc.boxes[acc.n_glob_chunks:].unbind(dim=1)
    assert not bool(mp.box_test([x[:, None] for x in lane],
                                [c[None, :] for c in box], BIG, 0.0).any())


def test_sliver_hits_off_their_box_are_swept(mesh):
    """Rays through a point of a sliver's line 5 to 40 of its edges away,
    from just short of it: a sliver (e1 == e2) is a candidate where its
    computed u = -v is 0, at t where the ray meets that line, far outside
    its chunk's box, and the brute sweep takes it where it is the nearest.
    The group sweep, which sweeps the slivers for every ray, finds the
    same winners; the box cull would have dropped their chunks."""
    scene, acc, brute = mesh
    r = np.random.default_rng(11)
    table = acc.table.double().numpy()
    rows = acc.slivers.numpy()[r.integers(0, acc.slivers.shape[0], N)]
    assert (table[rows, 3:6] == table[rows, 6:9]).all()
    p = table[rows, 0:3] + r.uniform(5, 40, (N, 1)) * table[rows, 3:6]
    d = cr._unit(r.normal(size=(N, 3)))
    o = (p - r.uniform(0.2, 1.0, (N, 1)) * d).astype(np.float32)
    d = d.astype(np.float32)
    got, _, want, _ = _sweep(o, d, acc, brute)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    won = np.isin(want[1].numpy(), table[rows, 13].astype(np.int32))
    assert won.sum() >= 8, won.sum()
    win = (want[1][torch.from_numpy(won)].numpy()[:, None]
           == table[:, 13][None, :].astype(np.int32)) & np.isin(
        np.arange(table.shape[0]), acc.slivers.numpy())[None, :]
    chunk = win.argmax(axis=1) // 16
    ot, dt = torch.from_numpy(o[won].T.copy()), torch.from_numpy(d[won].T
                                                                 .copy())
    box = [c[:, None] for c in acc.boxes[torch.from_numpy(chunk)].unbind(
        dim=1)]
    box[7] = torch.full_like(box[7], 1.0)  # as if the sliver were boxed
    keep = mp.box_test([x[:, None] for x in mp.box_lane(ot, dt)], box,
                       want[0][torch.from_numpy(won)][:, None], 0.0)
    assert not bool(keep.all())


def test_chunk_boxes_hold_their_rows(mesh):
    """Every valid row's v0, v0 + e1, v0 + e2 lies in [c - h, c + h]
    (float64), w0 = BOX_REL * |h|_1 rounded up, the mask is the chunk's
    live rows but its slivers, which are listed apart (the 60 balls' pole
    triangles, e1 == e2); a chunk of padding is all zeros."""
    _, acc, _ = mesh
    table = torch.cat([acc.table, torch.zeros((16, 16))])
    boxes, slivers = mp.chunk_boxes(table)
    boxes = boxes.double().numpy()
    rows = table.double().numpy().reshape(-1, 16, 16)
    pts = np.stack([rows[..., 0:3], rows[..., 0:3] + rows[..., 3:6],
                    rows[..., 0:3] + rows[..., 6:9]], axis=2)
    valid = rows[..., 12] > 0.5
    c, h = boxes[:, None, None, 0:3], boxes[:, None, None, 4:7]
    inside = ((pts >= c - h) & (pts <= c + h)).all(axis=3).all(axis=2)
    assert inside[valid].all()
    assert (boxes[:, 3] >= mp.BOX_REL * boxes[:, 4:7].sum(axis=1)).all()
    live = valid & (rows[..., 9:12] != 0).any(axis=2)
    flat = rows.reshape(-1, 16)
    sliver = np.zeros(flat.shape[0], bool)
    sliver[slivers.numpy()] = True
    assert (flat[sliver, 3:6] == flat[sliver, 6:9]).all()
    assert live.reshape(-1)[sliver].all() and sliver.sum() == 474
    mask = mp.chunk_boxes(table)[0][:, 7].view(torch.int32).numpy()
    assert ((mask[:, None] >> np.arange(16)) & 1
            == live & ~sliver.reshape(live.shape)).all()
    assert (boxes[-1] == 0).all() and boxes[:-1, 4:7].max() > 0
    got = mp.chunk_boxes(acc.table)
    assert torch.equal(got[0], acc.boxes) and torch.equal(got[1],
                                                          acc.slivers)


def test_cones_hold_each_live_row_once(mesh):
    """graze_cones: every live row of the local chunks but the slivers in
    exactly one cone, ascending within it; each cone's a within rounding
    of unit length, every row's unit normal within rho of a and s at or
    above rho + GRAZE / min sin(phi) + 2^-20 (float64); the 60 copies of
    a ball share their cones."""
    _, acc, _ = mesh
    rows = acc.table.double().numpy()
    n_cones = acc.cones.shape[0]
    off = acc.cone_rows[:n_cones + 1].numpy()
    listed = acc.cone_rows[n_cones + 1:].numpy()
    assert off[0] == 0 and (np.diff(off) > 0).all()
    assert off[-1] == listed.shape[0]
    norm = np.linalg.norm
    live = (rows[:, 12] > 0.5) & (rows[:, 9:12] != 0).any(axis=1)
    live[acc.slivers.numpy()] = False
    live[:16 * acc.n_glob_chunks] = False
    assert sorted(listed.tolist()) == np.nonzero(live)[0].tolist()
    cones = acc.cones.double().numpy()
    assert (np.abs(norm(cones[:, 0:3], axis=1) - 1) < 1e-6).all()
    for c in range(n_cones):
        k = listed[off[c]:off[c + 1]]
        assert (np.diff(k) > 0).all()
        n = rows[k, 9:12]
        unit = n / norm(n, axis=1, keepdims=True)
        rho = norm(unit - cones[c, 0:3], axis=1).max()
        sin = norm(n, axis=1) / (norm(rows[k, 3:6], axis=1)
                                 * norm(rows[k, 6:9], axis=1))
        assert cones[c, 3] >= rho + mp.GRAZE / sin.min() + 2.0 ** -20
    assert n_cones < live.sum() // 30  # the balls' copies share cones
    got = mp.graze_cones(acc.table, acc.n_glob_chunks)
    assert torch.equal(got[0], acc.cones)
    assert torch.equal(got[1], acc.cone_rows)


@pytest.fixture(scope="module")
def rotated():
    scene = cr.rotated_ball_mesh()
    return scene, ma.build_mesh_grid_accel(scene), mp.build_tri_table(scene)


@pytest.mark.parametrize("kind", KINDS)
def test_rotated_instances_share_no_cones(rotated, kind):
    """A mesh whose triangles share no normals (12 balls placed by
    make_instanced_mesh_scene, each turned by its own random rotation):
    graze_cones finds a cone for every two rows or so, where the 60-ball
    mesh's copies share theirs; the cull still drops no candidate at or
    below a lane's winner, and the group sweep equals the brute sweep bit
    for bit, on every kind of ray."""
    scene, acc, brute = rotated
    assert acc.cones.shape[0] * 2 >= acc.table.shape[0] - acc.slivers.numel()
    o, d = _rays(kind, acc, brute, seed=40 + KINDS.index(kind), n=256)
    dropped, _, _, _ = _culled(o, d, acc, brute)
    assert not bool(dropped.any())
    got, _, want, _ = _sweep(o, d, acc, brute, full=kind == "nan_inf")
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    hit = want[0] < BIG
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[hit].numpy(), w[hit].numpy())
    if kind in ("random", "grazing"):
        assert bool(hit.any())


def test_culled_wrapper_checks_its_boxes(mesh):
    _, acc, _ = mesh
    o = torch.zeros((3, 1024))
    lists = torch.zeros((1, acc.l_max), dtype=torch.int32)
    dlo = torch.zeros((1, acc.l_max))
    stops = torch.zeros((1,), dtype=torch.int32)
    rest = (lists, dlo, stops, acc.n_glob_chunks, acc.n_chunks)
    s, c, r = acc.slivers, acc.cones, acc.cone_rows
    for boxes, slivers, cones, cone_rows, err, match in (
            (acc.boxes.double(), s, c, r, TypeError, "boxes"),
            (None, s, c, r, TypeError, "boxes"),
            (acc.boxes.t(), s, c, r, TypeError, "boxes"),
            (acc.boxes[1:], s, c, r, ValueError, "chunk_boxes"),
            (acc.boxes[:, :7].contiguous(), s, c, r, ValueError,
             "chunk_boxes"),
            (acc.boxes, s.long(), c, r, TypeError, "slivers"),
            (acc.boxes, None, c, r, TypeError, "slivers"),
            (acc.boxes, s[:, None].contiguous(), c, r, ValueError,
             "chunk_boxes"),
            (acc.boxes, s, c.double(), r, TypeError, "cones"),
            (acc.boxes, s, None, r, TypeError, "cones"),
            (acc.boxes, s, c, r.long(), TypeError, "cone_rows"),
            (acc.boxes, s, c[:, :3].contiguous(), r, ValueError,
             "graze_cones"),
            (acc.boxes, s, c, r[:c.shape[0]], ValueError, "graze_cones")):
        with pytest.raises(err, match=match):
            mp.closest_tri_culled(o, o, 10, acc.table, boxes, slivers,
                                  cones, cone_rows, *rest)
