"""K5 and K6 on the CPU: the banded cluster design of ``csrc/cc.cu``.

``CcTiling`` (the launch geometry: cluster size, band rows, column
segments, the bytes it counts in shared memory or in a global scratch) is
checked at the shapes the kernels run at. A numpy replay of the design,
band by band as the blocks of a cluster hold them, is held against the
plain versions (``relax_fixpoint`` through ``ops/cc.py``) and the Pallas
kernels in interpret mode, labels and counts: row runs per band, skipping
rows that nothing changed (dirty rows); column segments walked forward and
backward and joined across bands through each band's published records;
diagonal steps reading the neighbouring band's edge row as it was before
the step; a relaxation's change as "some step lowered some pixel"; K5's
rounds seeded by the border-min fused into the seeds. Two mutants of the
design (band records joined a pass late; the band border read as
background) must differ from the plain versions, and so must the mutants
``chip_smoke.py`` builds on the card."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops.pallas.cc import (
    pallas_label_components,
    pallas_label_components_tiled,
)
from path_gene_multimodal_tpu_torch.ops import cc as tcc
from path_gene_multimodal_tpu_torch.ops.cc import CcTiling
from path_gene_multimodal_tpu_torch.ops.cuda import SMEM_PER_BLOCK

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.from_numpy
INF = 2**30
DIAGONALS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


# ------------------------------------------------------------- geometry


@pytest.mark.parametrize("th, tw, tiles, n, bh, seg_len, segs, shared, smem, scratch", [
    (512, 512, 4, 16, 32, 16, 2, True, 101_424, 0),          # K5, the path's 1024^2 masks
    (512, 512, 16, 8, 64, 32, 2, True, 171_088, 0),         # K5 on a 2048^2 mask
    (256, 256, 128, 2, 128, 32, 4, True, 165_520, 0),       # K6 on the nuclei batch
    (1024, 1024, 4, 16, 64, 64, 1, False, 16, 321_600),  # a band too big: global
    (100, 70, 3, 2, 50, 4, 13, True, 35_472, 0),            # ragged
    (33, 517, 1, 1, 33, 33, 1, True, 94_976, 0),            # ragged, one segment a column
])
def test_cc_tiling(th, tw, tiles, n, bh, seg_len, segs, shared, smem, scratch):
    g = CcTiling(th, tw, tiles=tiles, sms=132)
    assert (g.n, g.bh, g.seg_len, g.segs, g.shared, g.smem_bytes, g.scratch_bytes) == (
        n, bh, seg_len, segs, shared, smem, scratch)
    assert g.smem_bytes <= SMEM_PER_BLOCK
    assert g.ls % 8 == 0 and g.ls >= tw and g.wpr * 32 >= tw
    # the smallest cluster whose band fits, doubled within one wave
    if shared and g.n > 1:
        assert not g.fits(g.n // 2) or tiles * g.n <= 132


@pytest.mark.parametrize("th, tw", [(0, 5), (5, 0)])
def test_cc_tiling_refuses_an_empty_tile(th, tw):
    with pytest.raises(ValueError, match="empty tile"):
        CcTiling(th, tw)


@pytest.mark.parametrize("th, tw, tiles, n, scratch", [
    (8, 12_000, 1, 8, 555_024),  # the records the cluster reads outgrow a block
    (1, 16_000, 2, 1, 740_016),  # a K6 strip one row high
])
def test_cc_tiling_refusals(th, tw, tiles, n, scratch):
    """No tile width is refused: where the band's records and edge rows
    outgrow a block, they go to the global scratch with the band, and only
    the changed flag stays in shared memory."""
    g = CcTiling(th, tw, tiles=tiles, sms=132)
    assert (g.n, g.bh, g.shared, g.smem_bytes, g.scratch_bytes) == (
        n, -(-th // n), False, 16, scratch)
    assert g.scratch_bytes == g.band_bytes + g.peer_bytes >= 20 * tw


# ------------------------------------------------------- banded replay


def _run_min_rows(lbl, mask):
    """Minimum over each horizontal run of ``mask`` in every row, INF off it."""
    out = np.full_like(lbl, INF)
    if not mask.any():
        return out
    m = mask.ravel()
    start = mask & ~np.pad(mask[:, :-1], ((0, 0), (1, 0)))
    rid = np.cumsum(start.ravel()) - 1
    mins = np.full(rid[-1] + 1, INF, np.int64)
    np.minimum.at(mins, rid[m], lbl.ravel()[m])
    out.ravel()[m] = mins[rid[m]]
    return out


class _Tile:
    """One tile as a cluster of ``n`` blocks holds it: band r owns rows
    [r bh, (r + 1) bh) of the labels; the other bands see only its
    published records (column head / tail run minima, all foreground) and
    its edge rows. ``mutant``: ``"late"`` uses the records of the pass
    before, ``"cut"`` reads the band border as background."""

    def __init__(self, mask, seeds, n, conn, mutant=None):
        self.m = mask
        self.lbl = np.where(mask, seeds, INF).astype(np.int64)
        self.th, self.tw = mask.shape
        self.n, self.bh = n, -(-self.th // n)
        self.seg_len = CcTiling(self.th, self.tw)._seg_len(self.bh)
        self.bands = [(min(r * self.bh, self.th), min((r + 1) * self.bh, self.th))
                      for r in range(n)]
        self.conn, self.mutant = conn, mutant
        self.dirty = np.ones(self.th, bool)
        self.cdirty = np.ones((n, self.tw), bool)  # columns lowered since the last column runs
        self.recs = {}  # (band, segment) -> its records, kept while its column is clean
        self.late = None  # the records of the pass before ("late")

    def _rows(self, first):
        lowered = False
        for q, (a, b) in enumerate(self.bands):
            rows = [r for r in range(a, b) if first or self.dirty[r]]
            self.dirty[rows] = False
            if rows:
                new = _run_min_rows(self.lbl[rows], self.m[rows])
                assert (new <= self.lbl[rows]).all()
                lowered |= bool((new < self.lbl[rows]).any())
                self.cdirty[q] |= (new < self.lbl[rows]).any(0)
                self.lbl[rows] = new
        return lowered

    def _columns(self, first):
        """Column runs, the segments of a band walked in lockstep; a band's
        columns that nothing lowered since its last column runs keep their
        segment records (stale: they only fall) and change nothing in their
        forward walks, as the kernel skips them."""
        L, M, tw, sl = self.lbl, self.m, self.tw, self.seg_len
        lowered, recs, band_recs = False, [], []
        for q, (a, b) in enumerate(self.bands):  # forward walks in every band, its records
            walk = np.ones(tw, bool) if first else self.cdirty[q].copy()
            self.cdirty[q] = False
            rows = b - a
            segs = max(1, -(-rows // sl))
            pad = ((0, segs * sl - rows), (0, 0))
            lb = np.pad(L[a:b], pad, constant_values=INF).reshape(segs, sl, tw)
            mb = np.pad(M[a:b], pad).reshape(segs, sl, tw)
            n_s = np.clip(rows - sl * np.arange(segs), 0, sl)[:, None]  # rows of each segment
            acc = np.full((segs, tw), INF, np.int64)
            head, tail, fbg = acc.copy(), acc.copy(), np.broadcast_to(n_s, (segs, tw)).copy()
            for j in range(sl):
                v, m = lb[:, j].copy(), mb[:, j]
                acc = np.where(m, np.minimum(acc, v), INF)
                assert ((acc == v) | ~m | walk).all()  # a clean column's runs are uniform
                fell = acc < v
                lowered |= bool(fell.any())
                self.dirty[a + sl * np.flatnonzero(fell.any(1)) + j] = True
                lb[:, j] = np.where(m, acc, v)
                real = j < n_s
                fbg = np.where(~m & real & (fbg == n_s), j, fbg)
                head = np.where((fbg == n_s) & real, acc, head)
                tail = np.where(j == n_s - 1, acc, tail)
            L[a:b] = lb.reshape(-1, tw)[:rows]
            new = (head, tail, fbg == n_s, fbg)
            old = self.recs.get(q, new)
            self.recs[q] = rec = tuple(np.where(walk, x, y) for x, y in zip(new, old))
            recs.append((lb, mb, n_s, rec))
            bh_, open_ = np.full(tw, INF, np.int64), np.ones(tw, bool)
            for k in range(segs):
                bh_ = np.where(open_, np.minimum(bh_, rec[0][k]), bh_)
                open_ &= rec[2][k]
            full = open_.copy()
            bt_, open_ = np.full(tw, INF, np.int64), np.ones(tw, bool)
            for k in range(segs - 1, -1, -1):
                bt_ = np.where(open_, np.minimum(bt_, rec[1][k]), bt_)
                open_ &= rec[2][k]
            band_recs.append((bh_, bt_, full))
        seen = band_recs
        if self.mutant == "late":
            seen = self.late or [(np.full(tw, INF), np.full(tw, INF), np.zeros(tw, bool))] * self.n
            self.late = band_recs
        for q, (a, b) in enumerate(self.bands):  # backward walks
            lb, mb, n_s, (head, tail, full, fbg) = recs[q]
            segs = len(n_s)
            top, bottom = np.full((segs, tw), INF, np.int64), np.full((segs, tw), INF, np.int64)
            t, open_ = np.full(tw, INF, np.int64), np.ones(tw, bool)  # from the bands above
            for p in range(q - 1, -1, -1):
                if self.mutant == "cut":
                    break
                t = np.where(open_, np.minimum(t, seen[p][1]), t)
                open_ &= seen[p][2]
            top[0] = t
            for k in range(1, segs):
                top[k] = np.minimum(tail[k - 1], np.where(full[k - 1], top[k - 1], INF))
            t, open_ = np.full(tw, INF, np.int64), np.ones(tw, bool)  # from the bands below
            for p in range(q + 1, self.n):
                if self.mutant == "cut":
                    break
                t = np.where(open_, np.minimum(t, seen[p][0]), t)
                open_ &= seen[p][2]
            bottom[segs - 1] = t
            for k in range(segs - 2, -1, -1):
                bottom[k] = np.minimum(head[k + 1], np.where(full[k + 1], bottom[k + 1], INF))
            rm, below = np.full((segs, tw), INF, np.int64), np.zeros((segs, tw), bool)
            for j in range(self.seg_len - 1, -1, -1):
                m, old = mb[:, j], lb[:, j]
                v = np.where(j == n_s - 1, np.minimum(old, bottom), old)
                v = np.where(j < fbg, np.minimum(v, top), v)
                rm = np.where(m & ~below, v, rm)
                new = np.where(m, rm, old)
                fell = new < old
                lowered |= bool(fell.any())
                self.dirty[a + self.seg_len * np.flatnonzero(fell.any(1)) + j] = True
                lb[:, j] = new
                below = m
            L[a:b] = lb.reshape(-1, tw)[: b - a]
        return lowered

    def _diagonal(self, dy, dx):
        M, before = self.m, self.lbl  # each band's own rows as before the step ...
        p = np.pad(before, 1, constant_values=INF)
        new = before.copy()
        lowered = False
        for q, (a, b) in enumerate(self.bands):
            if a >= b:
                continue
            sh = p[1 + a - dy : 1 + b - dy, 1 - dx : 1 - dx + self.tw].copy()
            if self.mutant == "cut":  # ... and the neighbour's edge row copy
                sh[0 if dy == 1 else -1] = INF
            v = np.where(M[a:b], np.minimum(before[a:b], sh), INF)
            fell = (v < before[a:b]).any(1)
            lowered |= bool(fell.any())
            self.dirty[a:b] |= fell
            self.cdirty[q] |= (v < before[a:b]).any(0)
            new[a:b] = v
        self.lbl = new
        return lowered

    def relax(self, first):
        start = self.lbl.copy()
        ch = self._rows(first)
        ch |= self._columns(first)
        if self.conn == 2:
            for dy, dx in DIAGONALS:
                ch |= self._diagonal(dy, dx)
        # change detection without a copy: labels only fall
        assert (self.lbl <= start).all()
        assert ch == bool((self.lbl != start).any())
        return ch

    def fixpoint(self, max_iters):
        relaxes = 0
        while True:
            ch = self.relax(relaxes == 0)
            if relaxes == 0:
                first = ch
            relaxes += 1
            if not ch or relaxes >= 1 + max_iters:
                return relaxes, first


def _k6_replay(mask, n, conn, max_iters=256, mutant=None):
    """(B, H, W) → labels and counts (relaxations, 1 round) of K6's design."""
    b, h, w = mask.shape
    out, relaxes = np.empty(mask.shape, np.int32), 0
    pix = np.arange(h * w).reshape(h, w)
    for i in range(b):
        t = _Tile(mask[i], pix, n, conn, mutant)
        relaxes += t.fixpoint(max_iters)[0]
        out[i] = t.lbl
    return out, [relaxes, 1]


def _k5_replay(mask, tile, n, conn, max_iters=128, max_outer=64, mutant=None):
    """(H, W) → labels and counts of K5's design: rounds of the banded
    fixpoint in every tile, each round after the first seeded by the
    border-min of the round before, fused into the seeds."""
    h, w = mask.shape
    ny, nx = -(-h // tile), -(-w // tile)
    maskp = np.zeros((ny * tile, nx * tile), bool)
    maskp[:h, :w] = mask
    rows, cols = np.indices(maskp.shape)
    dirs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (dy or dx) and (conn == 2 or not (dy and dx))]
    relaxes, prev, k = 0, None, 0
    while True:
        if prev is None:
            seeds = rows * w + cols
        else:
            p = np.pad(prev, 1, constant_values=INF)
            seeds = prev.copy()
            for dy, dx in dirs:
                seeds = np.minimum(seeds, p[1 + dy : 1 + dy + prev.shape[0],
                                            1 + dx : 1 + dx + prev.shape[1]])
            seeds = np.where(maskp, seeds, INF)
        changed = prev is not None and bool((seeds < prev).any())
        new = np.empty(maskp.shape, np.int64)
        for ty in range(ny):
            for tx in range(nx):
                sl = np.s_[ty * tile : (ty + 1) * tile, tx * tile : (tx + 1) * tile]
                t = _Tile(maskp[sl], seeds[sl], n, conn, mutant)
                r, first = t.fixpoint(max_iters)
                relaxes += r
                changed |= first
                new[sl] = t.lbl
        if prev is not None:
            assert changed == bool((new != prev).any())  # the round's flag
        prev, k = new, k + 1
        if k >= 2 and (not changed or k - 1 >= max_outer):
            return prev[:h, :w].astype(np.int32), [relaxes, k]


def _spiral(n):
    return chip_smoke._spiral(n)


def _snake():
    """``tests/test_pallas_kernels.py``'s 70x90 mask: random, plus a snake
    that crosses every 32-px tile border several times."""
    mask = np.random.default_rng(0).random((70, 90)) > 0.55
    mask[10, :] = True
    mask[:, 40] = True
    mask[50, 5:85] = True
    return mask


def _masks():
    rng = np.random.default_rng(11)
    return {"snake": _snake()[None], "spiral": _spiral(41)[None],
            "random": rng.random((2, 60, 50)) < 0.55}


def _k6_plain(mask, conn, max_iters=256):
    c = torch.zeros(2, dtype=torch.int64)
    lbl = tcc.label_components_batch(T(mask), conn, max_iters=max_iters, counts=c)
    return lbl.numpy(), c.tolist()


def _k5_plain(mask, conn, **kw):
    c = torch.zeros(2, dtype=torch.int64)
    lbl = tcc.label_components_tiled(T(mask), conn, counts=c, **kw)
    return lbl.numpy(), c.tolist()


NS = pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
CONN = pytest.mark.parametrize("conn", [1, 2])


@NS
@CONN
@pytest.mark.parametrize("name", ["snake", "spiral", "random"])
def test_k6_replay_matches_plain(name, conn, n):
    """Heights 70, 41 and 60 are no multiple of most n; at n = 16 the last
    bands of the 41- and 60-row tiles are empty."""
    mask = _masks()[name]
    want, wc = _k6_plain(mask, conn)
    got, gc = _k6_replay(mask, n, conn)
    np.testing.assert_array_equal(got, want)
    assert gc == wc


@pytest.mark.parametrize("n", [1, 4, 16])
def test_k6_replay_cap_binds(n):
    mask = _spiral(41)[None]
    want, wc = _k6_plain(mask, 1, max_iters=3)
    got, gc = _k6_replay(mask, n, 1, max_iters=3)
    np.testing.assert_array_equal(got, want)
    assert gc == wc == [4, 1]
    assert not np.array_equal(got, _k6_plain(mask, 1)[0])


@NS
@CONN
def test_k5_replay_matches_plain_snake(conn, n):
    """70 x 90 at tile 32: 3 x 3 tiles reaching past the mask; the border-min
    rounds fused into the seeds."""
    mask = _snake()
    want, wc = _k5_plain(mask, conn, tile=32)
    got, gc = _k5_replay(mask, 32, n, conn)
    np.testing.assert_array_equal(got, want)
    assert gc == wc


@pytest.mark.parametrize("n", [2, 8])
@CONN
def test_k5_replay_caps_bind(conn, n):
    """The spiral at tile 16 with max_iters 2, max_outer 2: both caps bind."""
    mask = _spiral(40)
    kw = dict(tile=16, max_iters=2, max_outer=2)
    want, wc = _k5_plain(mask, conn, **kw)
    got, gc = _k5_replay(mask, 16, n, conn, max_iters=2, max_outer=2)
    np.testing.assert_array_equal(got, want)
    assert gc == wc and wc[1] == 3
    assert not np.array_equal(got, _k5_plain(mask, conn, tile=16)[0])


@pytest.mark.parametrize("kernel, conn", [("k6", 2), ("k5", 1)])
def test_replay_matches_pallas_interpret(kernel, conn):
    """The replay against the Pallas kernels themselves (interpret mode):
    K6 on a 45 x 48 spiral over random pixels in bands of 4 (the last one
    shorter), K5 on a 40 x 40 spiral at tile 16 in bands of 8. (The plain
    versions, which the other replay tests hold it to, equal the Pallas
    kernels at both connectivities: ``tests/test_torch_cc.py``.)"""
    if kernel == "k6":
        mask = _spiral(48)[:45] | (np.random.default_rng(5).random((45, 48)) < 0.2)
        ref = np.asarray(pallas_label_components(jnp.asarray(mask[None]), conn, interpret=True))
        np.testing.assert_array_equal(_k6_replay(mask[None], 4, conn)[0], ref)
    else:
        mask = _spiral(40)
        ref = np.asarray(pallas_label_components_tiled(jnp.asarray(mask), conn, tile=16,
                                                       interpret=True))
        np.testing.assert_array_equal(_k5_replay(mask, 16, 8, conn)[0], ref)


@pytest.mark.parametrize("mutant", ["late", "cut"])
@pytest.mark.parametrize("name, n", [("snake", 4), ("random", 2)])
def test_band_mutants_differ_from_plain(name, n, mutant):
    """Joining the band records a pass late changes the relaxation count;
    reading the band border as background changes the labels."""
    mask = _masks()[name]
    want, wc = _k6_plain(mask, 1)
    got, gc = _k6_replay(mask, n, 1, mutant=mutant)
    assert gc != wc or not np.array_equal(got, want)


@pytest.mark.parametrize("mutant", ["late", "cut"])
def test_k5_band_mutants_differ_from_plain(mutant):
    mask = _snake()
    want, wc = _k5_plain(mask, 1, tile=32)
    got, gc = _k5_replay(mask, 32, 4, 1, mutant=mutant)
    assert gc != wc or not np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["late", "cut"])
def test_chip_smoke_band_mutants_fail_the_check(kind):
    """The mutants ``chip_smoke.py`` runs on the card differ from the plain
    version on a ragged case it checks K6 on (3 x 100 x 70, bands of 50)."""
    mask = np.random.default_rng(6).random((3, 100, 70)) < 0.55
    want, wc = _k6_plain(mask, 1)
    bh = CcTiling(100, 70, tiles=3, sms=132).bh
    ml, mc = chip_smoke._cc_band_mutant(T(mask), bh, kind)
    assert mc.tolist() != wc or not np.array_equal(ml.numpy(), want)
