"""K4 (per-instance statistics) on the CPU: a numpy replay of the CUDA
kernel's design (``csrc/instance_stats.cu``) held to the plain version bit
for bit and to the Pallas kernel in interpret mode, its geometry
(``InstanceStatsTiling``), and the design mutants ``chip_smoke.py`` holds
the kernel's check against.

The replay follows the kernel step by step: each tile's rows cut into
bands of 8 dealt in turn to a cluster of ``k`` ranks, each rank's spans of 8 pixels taken
32 to a warp, a lane's span cut into runs of one id, runs joined across
lanes by the segmented scan (heads where a lane's span does not continue
the lane before), each maximal run added once to its rank's table with its
sums in closed form from (x0, x1, y), then the tables reduced and
scattered over the ranks (rank r owns slots [r, r + 1) * ceil(S / k)) and
each slot turned into f32 once."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops.pallas.instance_stats import instance_stats_pallas
from path_gene_multimodal_tpu_torch.ops.instance_stats import (
    InstanceStatsTiling,
    _c_sum,
    instance_stats_plain,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.from_numpy
MUTANTS = ("lane_double", "head_extrema", "rank_unmerged")


def _run_sums(x0, x1, y, w, h):
    """The kernel's closed form of a run's count, sums and centred moments."""
    n = x1 - x0 + 1
    a, dy = 2 * x0 - w, 2 * y - h
    return (n, n * (x0 + x1) // 2, n * y,
            n * a * a + 2 * a * n * (n - 1) + 2 * ((n - 1) * n * (2 * n - 1) // 3),
            n * dy * dy, dy * n * (x0 + x1 - w))


class _Table:
    def __init__(self, s, nv):
        self.sums = np.zeros((s, 6), np.int64)  # count, sx, sy, mxx, myy, mxy
        self.votes = np.zeros((nv, s), np.int64)
        self.ext = np.array([[2**31 - 1] * s] * 2 + [[-(2**31)] * s] * 2, np.int64)

    def add(self, sid, sums, votes, x0, x1, y):
        self.sums[sid] += sums
        self.votes[:, sid] += votes
        self.ext[:, sid] = [min(self.ext[0, sid], x0), min(self.ext[1, sid], y),
                            max(self.ext[2, sid], x1), max(self.ext[3, sid], y)]

    def merge_into(self, other, sid):
        other.sums[sid] += self.sums[sid]
        other.votes[:, sid] += self.votes[:, sid]
        other.ext[:2, sid] = np.minimum(other.ext[:2, sid], self.ext[:2, sid])
        other.ext[2:, sid] = np.maximum(other.ext[2:, sid], self.ext[2:, sid])


def rows_of(geo, rank):
    """The rows block ``rank`` of a tile takes, in its order: bands of
    ``geo.band`` rows dealt in turn to the cluster's blocks."""
    return [y for y in range(geo.h) if (y // geo.band) % geo.cluster == rank]


def replay(li, ti, slots, num_types, geo, mutant=None):
    """The kernel's design on numpy maps: (sums, mins) as f32 arrays. A
    ``mutant`` (one of ``MUTANTS``) breaks it as ``chip_smoke._k4_mutant``
    says."""
    b, h, w = li.shape
    nv, span, k = num_types - 1, geo.span, geo.cluster
    chunk = geo.owner_chunk
    sums = np.zeros((b, slots, _c_sum(num_types)), np.float32)
    mins = np.full((b, 4, slots), np.float32(3e38), np.float32)
    for img in range(b):
        tables = [_Table(slots, nv) for _ in range(k)]
        for rank, tab in enumerate(tables):
            rows = rows_of(geo, rank)
            items = len(rows) * geo.spans_per_row

            def emit(run, y, xmax=None):
                sid, x0, x1, votes = run
                if sid >= 0:
                    tab.add(sid, _run_sums(x0, x1, y, w, h), votes, x0,
                            x1 if xmax is None else xmax, y)

            for base in range(0, items, 32):
                lanes = []
                for item in range(base, base + 32):
                    if item >= items:
                        lanes.append(None)
                        continue
                    y = rows[item // geo.spans_per_row]
                    s = item % geo.spans_per_row
                    xs = s * span
                    ids = [int(li[img, y, x]) if x < w else -1 for x in range(xs, xs + span)]
                    ids = [i if 0 <= i < slots else -1 for i in ids]
                    tys = [int(ti[img, y, x]) if x < w else 0 for x in range(xs, xs + span)]
                    runs, start = [], 0
                    for i in range(1, span + 1):
                        if i == span or ids[i] != ids[start]:
                            votes = np.array([sum(t == v for t in tys[start:i])
                                              for v in range(1, nv + 1)], np.int64)
                            runs.append((ids[start], xs + start, xs + i - 1, votes))
                            start = i
                    lanes.append({"y": y, "s": s, "runs": runs, "multi": len(runs) > 1})
                for lane, ln in enumerate(lanes):  # the first run continues the lane before
                    if ln is not None:
                        first = ln["runs"][0][0]
                        ln["cont"] = (lane > 0 and ln["s"] > 0 and first > 0
                                      and first == lanes[lane - 1]["runs"][-1][0])
                heads = [ln is None or ln["multi"] or not ln["cont"] for ln in lanes]
                seg = []  # (x0, votes, head's x1) of each lane's segment up to it
                for lane, ln in enumerate(lanes):
                    if ln is None:
                        seg.append(None)
                        continue
                    last = ln["runs"][-1]
                    if heads[lane]:
                        seg.append((last[1], last[3].copy(), last[2]))
                    else:
                        x0, votes, hx1 = seg[lane - 1]
                        seg.append((x0, votes + last[3], hx1))
                for lane, ln in enumerate(lanes):
                    if ln is None:
                        continue
                    y, runs = ln["y"], ln["runs"]
                    for run in runs[1:-1]:
                        emit(run, y)
                    first, last = runs[0], runs[-1]
                    if ln["cont"] and mutant == "lane_double":
                        emit(first, y)
                    if ln["multi"]:
                        if ln["cont"]:
                            x0, votes, hx1 = seg[lane - 1]
                            emit((first[0], x0, first[2], votes + first[3]), y,
                                 hx1 if mutant == "head_extrema" else None)
                        else:
                            emit(first, y)
                    tail = lane == 31 or heads[lane + 1]
                    nxt = lanes[lane + 1] if lane < 31 else None
                    handed = nxt is not None and nxt["multi"] and nxt["cont"]
                    if tail and not handed:
                        x0, votes, hx1 = seg[lane]
                        emit((last[0], x0, last[2], votes), y,
                             hx1 if mutant == "head_extrema" else None)
        for rank, tab in enumerate(tables):
            if mutant == "rank_unmerged" and rank == 1:
                continue
            for sid in range(slots):
                owner = sid // chunk
                if owner != rank and tab.sums[sid, 0] > 0:
                    tab.merge_into(tables[owner], sid)
        for sid in range(slots):
            tab = tables[sid // chunk]
            c = tab.sums[sid]
            sums[img, sid, :3] = c[:3].astype(np.float32)
            sums[img, sid, 3:6] = (c[3:6].astype(np.float64) * 0.25).astype(np.float32)
            sums[img, sid, 6 : 6 + nv] = tab.votes[:, sid].astype(np.float32)
            if c[0] > 0:
                e = tab.ext[:, sid]
                mins[img, :, sid] = np.array([e[0], e[1], -e[2], -e[3]], np.float32)
    return sums, mins


def _geo(shape, slots, num_types, cluster):
    """The tiling of ``shape`` whose cluster is ``cluster`` (by the number of
    multiprocessors it is asked to fill)."""
    return next(g for g in (InstanceStatsTiling(*shape, slots, num_types, sms)
                            for sms in range(1, 4096)) if g.cluster == cluster)


def _blobs(rng, b, h, w, n, max_id, num_types):
    li = np.zeros((b, h, w), np.int32)
    ti = rng.integers(0, num_types, (b, h, w)).astype(np.int32)
    for i in range(b):
        for _ in range(n):
            y0, y1 = np.sort(rng.integers(0, h, 2))
            x0, x1 = np.sort(rng.integers(0, w, 2))
            li[i, y0 : y1 + 1, x0 : x1 + 1] = rng.integers(1, max_id)
            ti[i, y0 : y1 + 1, x0 : x1 + 1][rng.random((y1 - y0 + 1, x1 - x0 + 1)) < 0.8] = \
                rng.integers(0, num_types)
    return li, ti


def _runs(rng, b, h, w, max_len, lo, hi):
    lens = rng.integers(1, max_len + 1, b * h * w)
    ids = rng.integers(lo, hi, b * h * w).astype(np.int32)
    return np.repeat(ids, lens)[: b * h * w].reshape(b, h, w)


def _cases():
    rng = np.random.default_rng(44)
    yy, xx = np.mgrid[0:12, 0:24]
    return {
        "blobs_3x40x70": (*_blobs(rng, 3, 40, 70, 12, 48, 6), 48, 6, 4),
        "runs_2x12x300": (_runs(rng, 2, 12, 300, 90, 0, 40),
                          rng.integers(0, 6, (2, 12, 300)).astype(np.int32), 40, 6, 2),
        "whole_tile_1x24x40": (np.ones((1, 24, 40), np.int32),
                               rng.integers(0, 6, (1, 24, 40)).astype(np.int32), 16, 6, 8),
        "background_1x16x16": (np.zeros((1, 16, 16), np.int32),
                               rng.integers(0, 6, (1, 16, 16)).astype(np.int32), 16, 6, 2),
        "alternating_1x12x24": ((1 + xx % 2 + 2 * (yy % 3)).astype(np.int32)[None],
                                rng.integers(0, 6, (1, 12, 24)).astype(np.int32), 16, 6, 4),
        "outside_ids_2x16x36": (_runs(rng, 2, 16, 36, 12, -9, 40),
                                rng.integers(-2, 9, (2, 16, 36)).astype(np.int32), 32, 6, 4),
        "over_slots_1x40x40": (*_blobs(rng, 1, 40, 40, 60, 90, 6), 32, 6, 4),
        "types_2_3x20x20": (*_blobs(rng, 3, 20, 20, 6, 20, 2), 20, 2, 1),
        "types_9_1x30x44": (*_blobs(rng, 1, 30, 44, 10, 20, 9), 20, 9, 4),
        "row_runs_2x1x1500": (np.array([7, 30], np.int32)[:, None, None].repeat(1500, 2),
                              rng.integers(0, 6, (2, 1, 1500)).astype(np.int32), 32, 6, 1),
        "row_runs_1x5x1025": (rng.integers(1, 40, (1, 5, 1)).astype(np.int32).repeat(1025, 2),
                              rng.integers(0, 6, (1, 5, 1025)).astype(np.int32), 40, 6, 4),
    }


@pytest.mark.parametrize("case", list(_cases()))
def test_replay_equals_plain(case):
    """The design, step by step, gives the plain version's outputs bit for
    bit, and each chip_smoke mutant gives what the same fault in the
    replay gives."""
    li, ti, slots, nt, cluster = _cases()[case]
    geo = _geo(li.shape, slots, nt, cluster)
    ps, pm = instance_stats_plain(T(li), T(ti), slots, nt)
    rs, rm = replay(li, ti, slots, nt, geo)
    assert rs.view(np.int32).tolist() == ps.numpy().view(np.int32).tolist()
    assert rm.view(np.int32).tolist() == pm.numpy().view(np.int32).tolist()
    if case == "blobs_3x40x70":
        for kind in MUTANTS:
            ms, mm = chip_smoke._k4_mutant(T(li), T(ti), slots, nt, kind, geo)
            es, em = replay(li, ti, slots, nt, geo, mutant=kind)
            np.testing.assert_array_equal(ms.numpy(), es, err_msg=kind)
            np.testing.assert_array_equal(mm.numpy(), em, err_msg=kind)


@pytest.mark.parametrize("kind", MUTANTS)
def test_mutants_differ(kind):
    """Each mutant of the design changes the outputs on nucleus-like maps
    split over a cluster of 4."""
    li, ti, slots, nt, cluster = _cases()["blobs_3x40x70"]
    geo = _geo(li.shape, slots, nt, cluster)
    want = instance_stats_plain(T(li), T(ti), slots, nt)
    got = chip_smoke._k4_mutant(T(li), T(ti), slots, nt, kind, geo)
    assert not chip_smoke._bit_equal(got, want)


def test_replay_against_pallas_interpret():
    """Counts, votes and extrema of the replay equal the TPU kernel's in
    interpret mode (its second moments are f32 sums, the port's exact)."""
    li, ti, slots, nt, cluster = _cases()["blobs_3x40x70"]
    li = li[:, :32]  # the Pallas kernel's strips: h a multiple of its rows
    ti = ti[:, :32]
    rs, rm = replay(li, ti, slots, nt, _geo(li.shape, slots, nt, cluster))
    js, jm = map(np.asarray, instance_stats_pallas(jnp.asarray(li), jnp.asarray(ti), slots, nt,
                                                   interpret=True))
    exact = [0, 1, 2] + list(range(6, js.shape[-1]))
    np.testing.assert_array_equal(rs[..., exact], js[..., exact])
    np.testing.assert_array_equal(rm, jm)
    np.testing.assert_allclose(rs[..., 3:6], js[..., 3:6], atol=1e-3, rtol=1e-5)


def test_run_sums_closed_form():
    """A run's closed-form sums equal the pixel-by-pixel sums."""
    for w, h in ((224, 224), (70, 100), (1004, 64), (1500, 1)):
        for x0 in (0, 1, 37, w - 9):
            for n in (1, 2, 7, 8, 255, 256, 1500):
                x1 = min(w - 1, x0 + n - 1)
                x = np.arange(x0, x1 + 1, dtype=np.int64)
                y = h - 3
                dx, dy = 2 * x - w, 2 * y - h
                want = (x.size, x.sum(), x.size * y, (dx * dx).sum(), x.size * dy * dy,
                        (dx * dy).sum())
                assert _run_sums(x0, x1, y, w, h) == want


@pytest.mark.parametrize("h,w", [(224, 224), (280, 280), (1, 1500), (1, 1860), (5, 1025),
                                 (64, 460), (1200, 2)])
def test_narrow_tiles_keep_32_bit_run_terms(h, w):
    """On a narrow tile (32-bit table sums) every term ``add_run`` forms in
    32 bits stays under 2^31 for any run of a row (up to the whole row,
    though the kernel cuts a run at its warp's 256 px), and the terms of
    the moment, which it forms in 64 bits, would not: a whole row of 1,500
    px makes (n - 1) n (2n - 1) = 6.7e9 before its division by 3."""
    assert InstanceStatsTiling(1, h, w).narrow
    n = w  # the longest run of a row
    x0, x1 = 0, w - 1
    for y in (0, h - 1):
        dy = 2 * y - h
        for term in (n * (x0 + x1), n * y, n * dy * dy, dy * n * (x0 + x1 - w)):
            assert abs(term) < 2**31
    moment = (n - 1) * n * (2 * n - 1)
    assert (moment >= 2**31) == (w >= 1025)


def test_tiling():
    """The path batch's geometry (128 tiles of 224^2, S 512, 6 types, 132
    SMs): clusters of 2 (the largest whose 256 blocks of 512 threads are
    one wave at 2 an SM), bands of 8 rows dealt in turn (112 rows a block),
    28 spans a row by 16-byte
    loads, a 30 KB table of 32-bit sums and 30 KB of lane records of the
    background, 256 slots a rank; the cluster
    never exceeds the rows; tiles whose sums could pass 2^31 get 64-bit
    sums and one block an SM (128 tiles of 300^2: clusters of 1, one
    wave); the types and tables it cannot take go to the table route;
    a tile whose moments could pass the 64-bit sums is refused."""
    geo = InstanceStatsTiling(128, 224, 224, 512, 6, 132)
    assert (geo.cluster, geo.spans_per_row, geo.vector_rows) == (2, 28, True)
    assert rows_of(geo, 1)[:10] == [8, 9, 10, 11, 12, 13, 14, 15, 24, 25]
    assert sorted(rows_of(geo, 0) + rows_of(geo, 1)) == list(range(224))
    assert len(rows_of(geo, 0)) == len(rows_of(geo, 1)) == 112
    assert (geo.narrow, geo.smem_bytes, geo.owner_chunk) == (True, 30720 + 30720, 256)
    assert geo.launch_args() == (2, 8, 1, 0, 30720 + 30720)
    assert InstanceStatsTiling(1, 224, 224).cluster == 8
    assert InstanceStatsTiling(256, 224, 224).cluster == 1
    assert InstanceStatsTiling(3, 100, 70).vector_rows is False
    assert InstanceStatsTiling(2, 3, 7).cluster == 2
    assert rows_of(InstanceStatsTiling(1, 1, 7), 0) == [0]
    wide = InstanceStatsTiling(1, 300, 300)
    assert (wide.narrow, wide.smem_bytes, wide.resident_blocks) == (False, 40960, 1)
    assert (geo.resident_blocks, InstanceStatsTiling(128, 300, 300).cluster) == (2, 1)
    assert InstanceStatsTiling(2, 1, 1500).narrow and not InstanceStatsTiling(1, 2, 1500).narrow
    for h, w in ((224, 224), (256, 256), (64, 1004), (300, 300)):
        xs = np.arange(w)
        worst = h * int(((2 * xs - w) ** 2).sum())  # a slot covering the whole tile
        assert InstanceStatsTiling(1, h, w).narrow == (worst < 2**31 and h * w * w < 2**31
                                                       and w * h * h < 2**31
                                                       and w * int(((2 * np.arange(h) - h) ** 2).sum()) < 2**31)
    assert geo.route == "cluster" and wide.route == "cluster"
    # types and tables the cluster kernel cannot take go to the table route
    for nt in (1, 10):
        assert InstanceStatsTiling(1, 8, 8, 16, nt).route == "table"
    assert InstanceStatsTiling(1, 8, 8, 4096, 9).route == "table"
    # refused: an empty input, a tile of 2^31 pixels, and a tile whose
    # moments reach 2^63 (a row of 2^27 px; its sums would wrap in 64 bits)
    with pytest.raises(ValueError, match="empty input"):
        InstanceStatsTiling(1, 8, 8, 16, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        InstanceStatsTiling(1, 2, 2**30)
    with pytest.raises(ValueError, match="2\\^63"):
        InstanceStatsTiling(1, 1, 2**27)
