"""K8's sweep of working rays cut into ranges (csrc/stream_binned.cu: the
compaction, the plan's cut and the in-order merge), emulated in plain
PyTorch and held bit for bit to the plain sweep it replaces,
ops/megakernel.py::_binned_sweep, on the CPU at toy sizes.

The emulation follows the kernel's design, not its code: each tile's
working items in lane order (an alive lane's primary ray, then one item a
pending NEE slot), the tile's chunk sequence cut into ranges, each
(item, range) folded from (3e38, no row) with the strict <, then per lane
the carried candidate and the ranges' partials folded in range order with
the strict <, and a slot's least t the fminf of its ranges'. Any cut must
give the sequential fold's winner: one range, one chunk a range, random
cuts and the cut the kernel's plan makes (ops/megakernel.py::_k8_cut).

Gates: bt and bi of every alive lane and each pending slot's least t,
bit for bit (float planes compared as int32); a lane without work keeps
its carried candidate. The random tables hold duplicate spheres in
different chunks (so across range boundaries), carried candidates tied
with a row, rays that miss everything, a tile with no working lane,
radius-0 rows, and lists whose order is not row order. A merge that takes
ties (<=) instead must fail on the same data.
"""

import numpy as np
import pytest
import torch

from smallpt_tpu_torch.ops import megakernel as mk

BIG = 3.0e38
N_GLOB, N_CHUNKS, L_MAX = 2, 14, 6
N_TILES = 3  # tile 1 has no working lane
LANES = 8 * mk._LANE_B
H100_FILL = 132 * 32  # the plan's fill on an H100 SXM: 32 units an SM


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed: int, n_slots: int):
    """A random table and lane state (see the module docstring)."""
    rng = np.random.default_rng(seed)
    n_rows = 8 * (N_GLOB + N_CHUNKS)
    tab = np.zeros((n_rows, 16), np.float32)
    tab[:, :3] = rng.uniform(0, 100, (n_rows, 3))
    tab[:, 3] = rng.uniform(0.5, 6.0, n_rows)
    tab[:, 4] = 1e-3
    tab[rng.random(n_rows) < 0.1, 3] = 0.0  # padding rows
    # duplicates: a few big spheres copied into later chunks
    for src in rng.choice(n_rows // 2, 6, replace=False):
        tab[src, 3] = 12.0
        dst = rng.integers(n_rows // 2, n_rows, 2)
        tab[dst] = tab[src]
    table = torch.from_numpy(tab)

    shape = (N_TILES, LANES)
    o = rng.uniform(0, 100, (3,) + shape).astype(np.float32)
    d = rng.normal(size=(3,) + shape)
    d /= np.linalg.norm(d, axis=0)
    # rays that miss everything: from far outside, pointing away
    away = rng.random(shape) < 0.1
    o[:, away] = np.float32(-500.0)
    d[:, away] = -np.abs(d[:, away])
    lanes = tuple(torch.from_numpy(x) for x in (*o, *d.astype(np.float32)))
    lds = []
    for _ in range(n_slots):
        ld = rng.normal(size=(3,) + shape)
        ld /= np.linalg.norm(ld, axis=0)
        lds.append(tuple(torch.from_numpy(x.astype(np.float32))
                         for x in ld))
    alive = rng.random(shape) < 0.3
    neep = np.zeros(shape, np.int64)
    for s in range(n_slots):
        neep |= (rng.random(shape) < 0.2).astype(np.int64) << s
    alive[1] = False
    neep[1] = 0

    bt = np.full(shape, BIG, np.float32)
    bi = np.full(shape, -1.0, np.float32)
    carried = rng.random(shape) < 0.3
    bt[carried] = rng.uniform(1, 200, int(carried.sum()))
    bi[carried] = rng.integers(0, n_rows, int(carried.sum()))
    bt, bi = torch.from_numpy(bt), torch.from_numpy(bi)
    # ties: a carried t equal to the lane's own t on a row it sweeps
    # (a global row, every tile sweeps those)
    row = torch.from_numpy(rng.integers(0, 8 * N_GLOB, shape))
    c = table[row]
    tt = mk._sphere_tt(*lanes, c[..., 0], c[..., 1], c[..., 2], c[..., 3],
                       c[..., 4])
    tie = torch.from_numpy(rng.random(shape) < 0.5) & (tt < BIG)
    bt = torch.where(tie, tt, bt)
    bi = torch.where(tie, (row + 8 * N_CHUNKS).float(), bi)

    lists = np.stack([rng.permutation(N_CHUNKS)[:L_MAX]
                      for _ in range(N_TILES)]).astype(np.int32)
    stops = np.array([-1, 3, L_MAX], np.int32)
    return dict(table=table, lanes=lanes, lds=lds, bt=bt, bi=bi,
                alive=torch.from_numpy(alive), neep=torch.from_numpy(neep),
                lists=torch.from_numpy(lists),
                stops=torch.from_numpy(stops), tie=tie)


def _sequence_rows(case, t: int) -> torch.Tensor:
    """Tile t's swept rows in sweep order: the global chunks, then its
    list (every local chunk where stops < 0), 8 rows a chunk."""
    stop = int(case["stops"][t])
    local = (list(range(N_CHUNKS)) if stop < 0
             else [int(case["lists"][t, min(k, L_MAX - 1)])
                   for k in range(stop)])
    cids = list(range(N_GLOB)) + [N_GLOB + c for c in local]
    return (8 * torch.tensor(cids)[:, None] + torch.arange(8)).reshape(-1)


# the lane at (row r, column c) of a tile: index r * _LANE_B + c of its
# tiled planes (megakernel._tiled), lane id 8 c + r
LANE_OF_ID = torch.tensor([(k % 8) * mk._LANE_B + k // 8
                           for k in range(LANES)])


def _compact(case, n_slots: int):
    """Each tile's items in lane order (the lane ids' order), a lane's
    primary ray first, then its pending slots: (tile, lane, kind) (N,)
    each, lane the index into the tiled planes, kind 0 the primary and
    1 + s slot s, sorted by (tile, lane id, kind)."""
    kinds = [case["alive"]] + [((case["neep"] >> s) & 1) == 1
                               for s in range(n_slots)]
    mask = torch.stack(kinds, dim=-1)[:, LANE_OF_ID]  # (T, ids, 1 + S)
    tile, lane_id, kind = torch.nonzero(mask, as_tuple=True)
    return tile, LANE_OF_ID[lane_id], kind


def split_sweep(case, n_slots: int, cut, strict: bool = True):
    """The emulated sweep: (bt, bi, sbts) as _binned_sweep returns them.
    cut(t, n_seq, n_items) gives tile t's range boundaries in chunks,
    0 = b0 < b1 < ... = n_seq."""
    tile, lane, kind = _compact(case, n_slots)
    bt, bi = case["bt"].clone(), case["bi"].clone()
    sbts = [torch.full_like(bt, BIG) for _ in range(n_slots)]
    table = case["table"]
    for t in range(N_TILES):
        sel = tile == t
        if not bool(sel.any()):
            continue
        ln, kd = lane[sel], kind[sel]
        rows = _sequence_rows(case, t)
        bounds = cut(t, rows.numel() // 8, int(sel.sum()))
        o = [x[t, ln][:, None] for x in case["lanes"][:3]]
        d = [x[t, ln] for x in case["lanes"][3:]]
        for s, ld in enumerate(case["lds"]):
            m = kd == 1 + s
            d = [torch.where(m, y[t, ln], x) for x, y in zip(d, ld)]
        c = table[rows]
        tt = mk._sphere_tt(*o, *(x[:, None] for x in d), c[:, 0], c[:, 1],
                           c[:, 2], c[:, 3], c[:, 4])  # (items, rows)
        partials = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            sub = tt[:, 8 * b0:8 * b1]
            m = sub.amin(dim=1)
            first = (sub == m[:, None]).to(torch.int8).argmax(dim=1)
            row = torch.where(m < BIG, rows[8 * b0 + first], -1)
            partials.append((m, row))
        prim = kd == 0
        lp = ln[prim]
        cb, ci = bt[t, lp], bi[t, lp]
        for pt, pr in partials:
            take = pt[prim] < cb if strict else pt[prim] <= cb
            cb = torch.where(take, pt[prim], cb)
            ci = torch.where(take, pr[prim].float(), ci)
        bt[t, lp], bi[t, lp] = cb, ci
        for s in range(n_slots):
            m = kd == 1 + s
            v = torch.full((int(m.sum()),), BIG)
            for pt, _ in partials:
                v = torch.fmin(v, pt[m])
            sbts[s][t, ln[m]] = v
    return bt, bi, sbts


def _reference(case, n_slots: int):
    work = case["alive"] | (case["neep"] != 0)
    return mk._binned_sweep(case["table"], case["lanes"], case["lds"],
                            case["bt"], case["bi"], work, N_GLOB, N_CHUNKS,
                            case["lists"], case["stops"])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _held(case, n_slots: int, got, want) -> dict:
    """Bit-equality on what the kernel reads: bt, bi of alive lanes, each
    pending slot's least t; the carried candidate of a lane without work.
    Returns the count of differing values per output."""
    (bt, bi, sb), (rbt, rbi, rsb) = got, want
    alive = case["alive"]
    idle = ~alive & (case["neep"] == 0)
    out = {"bt": int((_bits(bt) != _bits(rbt))[alive].sum()),
           "bi": int((_bits(bi) != _bits(rbi))[alive].sum()),
           "idle": int((_bits(bt) != _bits(case["bt"]))[idle].sum()
                       + (_bits(bi) != _bits(case["bi"]))[idle].sum())}
    for s in range(n_slots):
        m = ((case["neep"] >> s) & 1) == 1
        out[f"slot{s}"] = int((_bits(sb[s]) != _bits(rsb[s]))[m].sum())
    return out


def _kernel_cut(case, n_slots: int):
    """The ranges of the kernel's plan on this case's item counts."""
    tile = _compact(case, n_slots)[0]
    n_items = torch.bincount(tile, minlength=N_TILES).numpy()
    n_seq = np.array([_sequence_rows(case, t).numel() // 8
                      for t in range(N_TILES)])
    cut, nr = mk._k8_cut(n_items, n_seq, H100_FILL)
    assert cut is not None and nr.max() > 1  # the toy case is cut

    def bounds(t, n, _):
        return [min(n, k * cut) for k in range(int(nr[t]))] + [n]
    return bounds


CUTS = {
    "one_range": lambda seed: lambda t, n, _: [0, n],
    "one_chunk_a_range": lambda seed: lambda t, n, _: list(range(n + 1)),
    "random": lambda seed: lambda t, n, _: [0] + sorted(
        np.random.default_rng(seed + 7 * t).choice(
            np.arange(1, n), min(n - 1, 4), replace=False).tolist()) + [n],
}


@pytest.mark.parametrize("n_slots", [0, 2])
@pytest.mark.parametrize("cut", ["one_range", "one_chunk_a_range", "random",
                                 "kernel"])
def test_split_sweep_equals_binned_sweep(cut, n_slots):
    for seed in (0, 1):
        case = _case(seed, n_slots)
        bounds = (_kernel_cut(case, n_slots) if cut == "kernel"
                  else CUTS[cut](seed))
        got = split_sweep(case, n_slots, bounds)
        want = _reference(case, n_slots)
        diff = _held(case, n_slots, got, want)
        assert not any(diff.values()), (seed, diff)


def test_cases_exercise_the_edges():
    """The random case holds what the gates need: carried ties that win,
    duplicates that win across chunks, all-miss alive lanes, an idle tile
    and lists out of row order."""
    case = _case(0, 2)
    bt, bi, _ = _reference(case, 2)
    alive = case["alive"]
    assert bool((case["tie"] & alive & (bi == case["bi"])).any())
    tab = case["table"].numpy()
    won = bi[alive & (bi >= 0)].long().unique().numpy()
    dup_rows = [r for r in won if tab[r, 3] == 12.0
                and (tab[:, :4] == tab[r, :4]).all(axis=1).sum() > 1]
    assert dup_rows
    assert bool((alive & (bt == BIG)).any())
    assert not bool(case["alive"][1].any() or case["neep"][1].any())
    assert any((np.diff(case["lists"][t].numpy()) < 0).any()
               for t in range(N_TILES))


@pytest.mark.parametrize("n_slots", [0, 2])
def test_nonstrict_merge_fails(n_slots):
    """A merge that takes ties (<=) picks a later duplicate's row or a row
    over a tied carried candidate: bi differs from the sequential fold."""
    case = _case(0, n_slots)
    want = _reference(case, n_slots)
    got = split_sweep(case, n_slots, CUTS["one_chunk_a_range"](0),
                      strict=False)
    diff = _held(case, n_slots, got, want)
    assert diff["bi"] > 0 and diff["bt"] == 0


def test_compaction_order_and_counts():
    """Items in lane-id order, a lane's primary first, then its slots in
    slot order; a tile's count is its alive lanes plus its pending
    bits."""
    case = _case(3, 2)
    tile, lane, kind = _compact(case, 2)
    lane_id = 8 * (lane % mk._LANE_B) + lane // mk._LANE_B
    key = (tile * LANES + lane_id) * 8 + kind
    assert bool((key[1:] > key[:-1]).all())
    for t in range(N_TILES):
        n = int(case["alive"][t].sum()) + sum(
            int((((case["neep"][t] >> s) & 1) == 1).sum()) for s in range(2))
        assert int((tile == t).sum()) == n
    assert int((tile == 1).sum()) == 0


@pytest.mark.parametrize("seed", range(4))
def test_cut_fits_the_scratch(seed):
    """The plan's units never exceed the scratch the kernel sizes for them
    (csrc/stream_binned.cu max_units): the groups of the fullest tiles, or
    twice the fill; sequences are cut only below the fill, every range of a
    cut but the last is L chunks long, and a group without a sequence
    makes no unit. The fill is 32 units an SM, for an H100 SXM (132
    SMs), an H100 PCIe (114) and a small card (16)."""
    rng = np.random.default_rng(seed)
    n_tiles, n_slots = int(rng.integers(1, 200)), int(rng.integers(0, 3))
    cap = LANES * (1 + n_slots)
    dense = rng.random() < 0.5
    n_items = rng.integers(0, cap + 1 if dense else 300, n_tiles)
    n_seq = rng.integers(0, 1300, n_tiles)
    fill = 32 * int(rng.choice([132, 114, 16]))
    cut, nr = mk._k8_cut(n_items, n_seq, fill)
    groups = -(-n_items // mk._K8_GROUP)
    units = int((groups * nr).sum())
    assert units <= max(n_tiles * -(-cap // mk._K8_GROUP), 2 * fill)
    assert (cut is None) == (groups.sum() >= fill)
    assert not nr[(groups == 0) | (n_seq == 0)].any()
    if cut is not None:
        assert cut >= mk._K8_MIN_RANGE
        some = nr > 0
        assert ((nr[some] - 1) * cut < n_seq[some]).all()
        assert (nr[some] * cut >= n_seq[some]).all()
