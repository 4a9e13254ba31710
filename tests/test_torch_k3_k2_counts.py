"""K3 (the marker flood) and K2 (CC + sizes) on the CPU: their step and
pass counters, their launch geometry (``FloodTiling``, ``CcSizesTiling``),
numpy replays of the kernels' designs against the plain versions, and the
mutants ``chip_smoke.py`` holds the kernels' checks against.

The counts are what the Pallas kernels run: a K3 step is the first step of
a phase or one body of its ``while_loop`` (``ops/pallas/flood.py:95-120``
of the JAX package), a K2 pass one ``relax`` of ``_relax_fixpoint``
(``ops/pallas/cc.py:63-97``), each up to its cap and the last one (which
changes nothing) included."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import jax.numpy as jnp

from path_gene_multimodal_tpu.ops.components import INF as JINF
from path_gene_multimodal_tpu.ops.pallas.cc_sizes import pallas_cc_sizes
from path_gene_multimodal_tpu.ops.pallas.flood import pallas_marker_watershed
from path_gene_multimodal_tpu_torch.ops import cc_sizes as tcc
from path_gene_multimodal_tpu_torch.ops.components import INF, index_seeds, relax_fixpoint
from path_gene_multimodal_tpu_torch.ops.cuda import SMEM_PER_BLOCK
from path_gene_multimodal_tpu_torch.ops.flood import FloodTiling, marker_watershed, quantize

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

T = torch.from_numpy


def _strip(n, dist):
    """A 1 x n all-foreground strip at ``dist`` with one marker at column 0."""
    d = np.full((1, 1, n), dist, np.float32)
    mk = np.full((1, 1, n), int(JINF), np.int32)
    mk[0, 0, 0] = 1
    return d, mk, np.ones((1, 1, n), bool)


def _k3(dist, markers, mask):
    c = torch.zeros(3, dtype=torch.int64)
    lbl = marker_watershed(T(dist), T(markers), T(mask), counts=c)
    return lbl.numpy(), c.tolist()


def _flood_inputs(seed, b, h, w, n_markers=8, big_labels=False):
    rng = np.random.default_rng(seed)
    dist = np.stack([gaussian_filter(rng.random((h, w)), 3) for _ in range(b)])
    dist = ((dist - dist.min()) / np.ptp(dist)).astype(np.float32)
    mask = dist > 0.15
    markers = np.full((b, h, w), int(JINF), np.int32)
    for bi in range(b):
        ys, xs = rng.integers(0, h, n_markers), rng.integers(0, w, n_markers)
        ids = np.arange(1, n_markers + 1)
        markers[bi, ys, xs] = 70_000 + 1000 * ids if big_labels else ids
        markers[bi][~mask[bi]] = int(JINF)
    return dist, markers, mask


# ------------------------------------------------------------ K3 counts


@pytest.mark.parametrize("n", [10, 65, 66])
def test_k3_strip_steps(n):
    """Level 63 grows the strip one pixel a step in phase 1 (phase 0 leaves
    the fresh marker out), capped at 65 steps; each of the other 126
    phases takes one step: 127 + min(n, 65)."""
    lbl, c = _k3(*_strip(n, 1.0))
    assert c == [127 + min(n, 65), 127 + min(n, 65), n - 1]
    assert (lbl < INF).all()


def test_k3_strip_cap_then_next_level():
    """At n = 100 the cap binds at level 63 (65 steps, 65 pixels grown) and
    level 62's phase 0 grows the other 34 in 35 steps: 226 steps, every
    pixel labelled, as the Pallas kernel."""
    d, mk, m = _strip(100, 1.0)
    lbl, c = _k3(d, mk, m)
    assert c == [226, 226, 99]
    assert (lbl < INF).all()
    ref = np.asarray(pallas_marker_watershed(jnp.asarray(d), jnp.asarray(mk), jnp.asarray(m),
                                             interpret=True))
    np.testing.assert_array_equal(lbl, ref)


def test_k3_strip_cap_at_the_last_level():
    """dist = 0: the strip is eligible only at level 0, where the cap leaves
    34 pixels unlabelled (126 + 1 + 65 steps)."""
    d, mk, m = _strip(100, 0.0)
    lbl, c = _k3(d, mk, m)
    assert c == [192, 192, 65]
    assert int((lbl < INF).sum()) == 66


def test_k3_batch_counts_are_the_tiles_counts():
    """Tiles that step together count as each alone: the sum and the
    maximum of a mixed batch equal those of its tiles run one by one."""
    d, mk, m = _strip(100, 1.0)
    d = np.concatenate([d, np.zeros_like(d), d])
    mk = np.concatenate([mk, mk, mk])
    m = np.concatenate([m, m, m])
    m[2, 0, 10:] = False  # a strip of 10
    _, c = _k3(d, mk, m)
    alone = [_k3(d[i : i + 1], mk[i : i + 1], m[i : i + 1])[1] for i in range(3)]
    assert [a[0] for a in alone] == [226, 192, 137]
    assert c == [sum(a[0] for a in alone), max(a[1] for a in alone), sum(a[2] for a in alone)]


# ------------------------------------------------------------ K2 counts


def _k2(mask, s_slots=64):
    c = torch.zeros(2, dtype=torch.int64)
    out = tcc.cc_sizes(T(mask), s_slots=s_slots, counts=c)
    return out, c.tolist()


def _serpentine(h=32, w=32):
    """``test_k2_spiral_relaxation_cap``'s serpentine."""
    mask = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        mask[r, :] = True
        mask[r + 1 if r + 1 < h else r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return mask


def _staircases(h=160, w=400):
    """A staircase down from (0, 0), then one back up: the minimum label
    moves one row a pass, so 2h rows of stairs need more passes than the
    cap of 257."""
    m = np.zeros((h, w), bool)
    for i in range(h):
        m[i, i : i + 2] = True
        m[h - 1 - i, h + 1 + i : h + 3 + i] = True
    return m


@pytest.mark.parametrize("name, mask, passes", [
    ("full", np.ones((1, 16, 16), bool), 2),
    ("empty", np.zeros((1, 16, 16), bool), 1),
    ("serpentine", _serpentine()[None], 17),
])
def test_k2_passes(name, mask, passes):
    _, c = _k2(mask)
    assert c == [passes, passes], name


def test_k2_passes_reach_the_cap():
    """The staircases need more than 257 passes: the count stops at the cap
    and the labels at the Pallas kernel's capped ones (the component is
    still split)."""
    mask = _staircases()[None]
    (lbl, _, _, n_roots), c = _k2(mask)
    assert c == [257, 257]
    assert int(n_roots[0]) > 1
    ref = np.asarray(pallas_cc_sizes(jnp.asarray(mask), 1, s_slots=64, interpret=True)[0])
    np.testing.assert_array_equal(lbl.numpy(), ref)


def test_k2_batch_counts_are_the_tiles_counts():
    h, w = 160, 400
    tiles = np.zeros((4, h, w), bool)
    tiles[0] = True
    tiles[2, :32, :32] = _serpentine()
    tiles[3] = _staircases(h, w)
    _, c = _k2(tiles)
    alone = [_k2(tiles[i : i + 1])[1] for i in range(4)]
    assert [a[0] for a in alone] == [2, 1, 17, 257]
    assert c == [sum(a[0] for a in alone), max(a[1] for a in alone)]


def test_k2_adaptive_counts_its_rerun():
    """The adaptive call counts each relaxation it runs: one at ``small``
    slots, and the re-run at ``big`` when a tile overflows ``small``."""
    mask = np.zeros((2, 16, 16), bool)
    mask[0, ::2, ::2] = True  # 64 roots, 1 pass
    mask[1, 2:6, 2:6] = True  # 2 passes
    for small, runs in ((128, 1), (16, 2)):
        c = torch.zeros(2, dtype=torch.int64)
        tcc.cc_sizes_adaptive(T(mask), min_size=1, small=small, big=256, counts=c)
        assert c.tolist() == [3 * runs, 2]


def test_counts_are_checked():
    with pytest.raises(ValueError, match="int64 \\(3,\\)"):
        marker_watershed(*map(T, _strip(4, 1.0)), counts=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64 \\(2,\\)"):
        tcc.cc_sizes(T(np.ones((1, 4, 4), bool)), counts=torch.zeros(3, dtype=torch.int32))


# ------------------------------------------------------------ geometry


def test_flood_tiling_main_shape():
    geo = FloodTiling(256, 256)
    assert (geo.wpr, geo.words) == (8, 2048)
    assert geo.shared and geo.smem_bytes == 12 * 8 * 1024 == 98_304 <= SMEM_PER_BLOCK
    assert geo.scratch_words == 0


@pytest.mark.parametrize("h, w, wpr, pad", [(100, 70, 3, 26), (40, 56, 2, 8), (1, 100, 4, 28),
                                            (8, 32, 1, 0), (3, 1, 1, 31)])
def test_flood_tiling_padding(h, w, wpr, pad):
    """A row takes ceil(w / 32) words, ``pad`` bits of the last one past w
    (``test_k3_replay_matches_plain`` checks that they stay 0 in every
    plane after every step)."""
    geo = FloodTiling(h, w)
    assert (geo.wpr, 32 * geo.wpr - w) == (wpr, pad)
    assert geo.words == h * wpr and geo.shared


def test_flood_tiling_large_tiles_keep_their_planes_in_global_memory():
    geo = FloodTiling(512, 512)
    assert not geo.shared and geo.smem_bytes == 0
    assert geo.scratch_words == 12 * 512 * 16
    # the largest 256-wide tile whose planes fit
    assert FloodTiling(605, 256).shared and not FloodTiling(606, 256).shared


def test_flood_tiling_refuses_an_empty_tile():
    with pytest.raises(ValueError, match="empty tile 0x5"):
        FloodTiling(0, 5)


@pytest.mark.parametrize("h, w, s_slots, ls, per, seg_len, segs, smem", [
    (256, 256, 4096, 256, 8, 64, 4, 186_368),
    (256, 256, 512, 256, 8, 64, 4, 164_864),
    (100, 70, 512, 72, 8, 8, 13, 32_912),
    (40, 56, 64, 56, 8, 3, 14, 18_144),
    (64, 1024, 512, 1024, 32, 64, 1, 165_248),
    (128, 300, 512, 304, 16, 43, 3, 104_800),
    (1024, 1, 64, 8, 8, 1, 1024, 43_408),
])
def test_cc_sizes_tiling(h, w, s_slots, ls, per, seg_len, segs, smem):
    geo = tcc.CcSizesTiling(h, w, s_slots)
    assert (geo.ls, geo.per, geo.seg_len, geo.segs, geo.smem_bytes) == (
        ls, per, seg_len, segs, smem)
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert geo.ls % 8 == 0 and 32 * geo.per >= geo.ls  # 16-byte rows; a warp covers a row
    assert geo.segs * geo.w <= geo.threads and geo.segs * geo.seg_len >= h


@pytest.mark.parametrize("h, w, s_slots, msg", [
    (257, 256, 512, "<= 65536 pixels and sides <= 1024, got 257x256"),
    (1, 1025, 512, "<= 65536 pixels and sides <= 1024, got 1x1025"),
    (256, 256, 0, "1..65534 slots, got 0"),
    (256, 256, 65535, "1..65534 slots, got 65535"),
    (256, 256, 20_000, "needs 281792 B of shared memory, more than 232448"),
    (0, 8, 64, "empty tile 0x8"),
])
def test_cc_sizes_tiling_refusals(h, w, s_slots, msg):
    with pytest.raises(ValueError, match=msg):
        tcc.CcSizesTiling(h, w, s_slots)


# ------------------------------------------------------------ K3 replay


def _pack(bits, wpr):
    """(H, W) bool → (H, wpr) uint32 row words, bit b of word j = column
    32 j + b, the bits past W zero."""
    h, w = bits.shape
    padded = np.zeros((h, 32 * wpr), bool)
    padded[:, :w] = bits
    return (padded.reshape(h, wpr, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def _unpack(words, w):
    h, wpr = words.shape
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(h, 32 * wpr)[:, :w].astype(bool)


def _hdil(l, m, r):
    one, top = np.uint32(1), np.uint32(31)
    return m | (m << one) | (l >> top) | (m >> one) | (r << top)


def _flood_replay(dist, markers, mask, levels=64, max_rounds=64):
    """csrc/flood.cu's design on one tile in numpy: the bit planes, the
    word-level dilation with bits carried across words, the phase starts,
    the A double buffer and U, the step and cap counting; labels resolved
    only where cand is set. Asserts that the bits past W stay 0."""
    h, w = dist.shape
    geo = FloodTiling(h, w)
    wpr = geo.wpr
    q = quantize(T(dist[None]), levels)[0].numpy()
    valid = _pack(np.ones((h, w), bool), wpr)
    qb = [_pack((q >> b) & 1 == 1, wpr) for b in range(6)]
    msk, mk = _pack(mask, wpr), _pack(markers < INF, wpr)
    lbl = np.where(markers < INF, markers, INF).astype(np.int64)
    lab = mk.copy()
    act = [np.zeros_like(lab), np.zeros_like(lab)]
    cur, steps, grown = 0, 0, 0
    for level in range(levels - 1, -1, -1):
        ge = np.full_like(lab, 0xFFFFFFFF)
        eq = np.full_like(lab, 0xFFFFFFFF)
        for b in range(6):
            one = (level >> b) & 1
            ge = (qb[b] & ge) if one else (qb[b] | ge)
            eq &= qb[b] if one else ~qb[b]
        for phase in (0, 1):
            lab = lab | act[cur]
            keep = ge & ~(mk & eq) if phase == 0 else ge
            act[0] = lab & keep
            unl = msk & ge & ~lab
            cur = 0
            s = 0
            while True:
                a = np.pad(act[cur], 1)
                dil = np.zeros_like(lab)
                for dy in range(3):
                    dil |= _hdil(a[dy : dy + h, 0:wpr], a[dy : dy + h, 1 : wpr + 1],
                                 a[dy : dy + h, 2 : wpr + 2])
                cand = unl & dil
                on = _unpack(cand, w)
                if on.any():
                    active = np.pad(np.where(_unpack(act[cur], w), lbl, INF), 1,
                                    constant_values=INF)
                    best = np.full((h, w), INF, np.int64)
                    for dy in range(3):
                        for dx in range(3):
                            if dy != 1 or dx != 1:
                                best = np.minimum(best, active[dy : dy + h, dx : dx + w])
                    assert (best[on] < INF).all()
                    lbl[on] = best[on]
                    grown += int(on.sum())
                unl &= ~cand
                act[1 - cur] = act[cur] | cand
                cur ^= 1
                s += 1
                for p in (unl, act[cur], lab, cand, msk, mk, *qb):
                    assert not (p & ~valid).any(), "a bit past W was set"
                if not on.any() or s >= 1 + max_rounds:
                    break
            steps += s
    return lbl.astype(np.int32), steps, grown


@pytest.mark.parametrize("case", ["blobs_2x40x56", "min_index_3x100x70", "strip_cap",
                                  "strip_last_level"])
def test_k3_replay_matches_plain(case):
    if case == "blobs_2x40x56":
        d, mk, m = _flood_inputs(1, 2, 40, 56)
    elif case == "min_index_3x100x70":
        d, mk, m = _flood_inputs(2, 3, 100, 70, big_labels=True)
    else:
        d, mk, m = _strip(100, 1.0 if case == "strip_cap" else 0.0)
    lbl, c = _k3(d, mk, m)
    got = [_flood_replay(d[i], mk[i], m[i]) for i in range(len(d))]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), lbl)
    assert c == [sum(g[1] for g in got), max(g[1] for g in got), sum(g[2] for g in got)]


# ------------------------------------------------------------ K2 replay


def _cc_replay(mask, late=False, max_iters=256):
    """csrc/cc_sizes.cu's relaxation on one tile in numpy: row runs by lane
    chunks of ``per`` pixels with the forward and backward segmented scans
    across the 32 lanes; column runs by segments of ``seg_len`` rows, a
    forward walk (running minima in place) and a backward one (each run's
    minimum), the segments' head and tail minima combined across segments
    within the pass (``late``: one pass late, the mutant); after the first
    pass only the rows and columns changed since their last runs. Returns
    (labels, passes)."""
    h, w = mask.shape
    geo = tcc.CcSizesTiling(h, w, 64)
    per, span = geo.per, 32 * geo.per
    lbl = np.arange(h * w, dtype=np.int64).reshape(h, w)
    late_carry = np.full((geo.segs, w, 2), INF, np.int64)

    def row_runs(r):
        v = np.full(span, INF, np.int64)
        fg = np.zeros(span, bool)
        v[:w], fg[:w] = lbl[r], mask[r]
        v, fg = v.reshape(32, per), fg.reshape(32, per)
        m = np.full((32, per), INF, np.int64)
        for ln in range(32):
            acc = INF
            for i in range(per):
                acc = min(acc, v[ln, i]) if fg[ln, i] else INF
                m[ln, i] = acc
            for i in range(per - 2, -1, -1):
                if fg[ln, i] and fg[ln, i + 1]:
                    m[ln, i] = m[ln, i + 1]
        full = fg.all(1)
        tv = [m[ln, -1] if fg[ln, -1] else INF for ln in range(32)]
        hv = [m[ln, 0] if fg[ln, 0] else INF for ln in range(32)]
        tp, hp = list(full), list(full)
        d = 1
        while d < 32:  # Hillis-Steele, as the shuffles
            tv2, tp2, hv2, hp2 = list(tv), list(tp), list(hv), list(hp)
            for ln in range(32):
                if ln >= d:
                    tv2[ln] = min(tv[ln - d], tv[ln]) if tp[ln] else tv[ln]
                    tp2[ln] = tp[ln] and tp[ln - d]
                if ln + d < 32:
                    hv2[ln] = min(hv[ln + d], hv[ln]) if hp[ln] else hv[ln]
                    hp2[ln] = hp[ln] and hp[ln + d]
            tv, tp, hv, hp = tv2, tp2, hv2, hp2
            d *= 2
        out = v.copy()
        for ln in range(32):
            left = tv[ln - 1] if ln > 0 else INF
            right = hv[ln + 1] if ln < 31 else INF
            first_bg = per if full[ln] else int(np.argmin(fg[ln]))
            last_bg = -1 if full[ln] else per - 1 - int(np.argmin(fg[ln][::-1]))
            for i in range(per):
                if fg[ln, i]:
                    nv = m[ln, i]
                    if i < first_bg:
                        nv = min(nv, left)
                    if i > last_bg:
                        nv = min(nv, right)
                    out[ln, i] = nv
        lbl[r] = out.reshape(-1)[:w]

    def column_runs(c):
        """Returns the rows it changed."""
        nonlocal late_carry
        segs = [(s * geo.seg_len, min((s + 1) * geo.seg_len, h)) for s in range(geo.segs)]
        rec, changed = [], set()
        for a, b in segs:  # forward: running minima in place, head and tail
            acc = head = INF
            first_bg = b
            for r in range(a, b):
                acc = min(acc, lbl[r, c]) if mask[r, c] else INF
                if mask[r, c] and acc != lbl[r, c]:
                    lbl[r, c] = acc
                    changed.add(r)
                if not mask[r, c] and first_bg == b:
                    first_bg = r
                if first_bg == b:
                    head = acc
            rec.append((head, acc, first_bg == b, first_bg))
        carries = []
        for s in range(geo.segs):
            top = bottom = INF
            for k in range(s - 1, -1, -1):
                top = min(top, rec[k][1])
                if not rec[k][2]:
                    break
            for k in range(s + 1, geo.segs):
                bottom = min(bottom, rec[k][0])
                if not rec[k][2]:
                    break
            carries.append((top, bottom))
        use = late_carry[:, c].copy() if late else np.array(carries)
        if late:
            late_carry[:, c] = carries
        for s, (a, b) in enumerate(segs):  # backward: each run's minimum
            rm, below = INF, False
            for r in range(b - 1, a - 1, -1):
                if mask[r, c]:
                    if not below:
                        rm = lbl[r, c]
                        if r == b - 1:
                            rm = min(rm, use[s][1])
                        if r < rec[s][3]:
                            rm = min(rm, use[s][0])
                    if rm != lbl[r, c]:
                        lbl[r, c] = rm
                        changed.add(r)
                below = mask[r, c]
        return changed

    passes = 0
    rows, cols = set(range(h)), set(range(w))  # the first pass takes all
    while True:
        old = lbl.copy()
        for r in sorted(rows):
            before = lbl[r].copy()
            row_runs(r)
            cols |= set(np.flatnonzero(lbl[r] != before).tolist())
        rows = set()
        for c in sorted(cols):
            rows |= column_runs(c)
        cols = set()
        if late:  # a late carry may be pending in any column
            rows, cols = set(range(h)), set(range(w))
        passes += 1
        if (lbl == old).all() or passes >= 1 + max_iters:
            break
    return np.where(mask, lbl, INF).astype(np.int32), passes


def _cc_masks():
    rng = np.random.default_rng(4)
    f = np.stack([gaussian_filter(rng.random((100, 70)), 2) for _ in range(2)])
    blobs = f > np.median(f)
    wide = gaussian_filter(rng.random((40, 300)), 2)
    return {"blobs_100x70": blobs[0], "blobs_100x70_b": blobs[1],
            "serpentine": _serpentine(), "wide_40x300": wide > np.median(wide),
            "thin_60x7": rng.random((60, 7)) < 0.6}


@pytest.mark.parametrize("name", sorted(_cc_masks()))
def test_k2_replay_matches_plain(name):
    mask = _cc_masks()[name]
    want, n = relax_fixpoint(T(mask[None]), index_seeds(T(mask[None])), 1, tcc.MAX_ITERS)
    lbl, passes = _cc_replay(mask)
    np.testing.assert_array_equal(lbl, want[0].numpy())
    assert passes == int(n[0])


def test_k2_late_segments_change_the_passes():
    """Combining the column segments one pass late takes more passes on a
    tile whose components cross the 8-row segments (100 x 70); the replay
    and ``chip_smoke.py``'s mutant agree on the counts."""
    mask = _cc_masks()["blobs_100x70"]
    _, passes = _cc_replay(mask)
    _, late = _cc_replay(mask, late=True)
    assert late > passes
    _, c = chip_smoke._cc_late_mutant(T(mask[None]), tcc.CcSizesTiling(100, 70, 64).seg_len)
    assert c.tolist() == [late, late]


# ------------------------------------------------------------ mutants


@pytest.mark.parametrize("kind", ["gauss_seidel", "no_fresh", "cap64"])
def test_k3_mutants_fail_the_check(kind):
    """Each mutant ``chip_smoke.py`` runs differs from the plain version in
    labels or counts on the ragged cases it checks K3 on."""
    cases = [_flood_inputs(2, 3, 100, 70, big_labels=True), _strip(100, 0.0)]
    caught = False
    for d, mk, m in cases:
        lbl, c = _k3(d, mk, m)
        ml, mc = chip_smoke._flood_mutant(T(d), T(mk), T(m), kind)
        caught |= bool((ml.numpy() != lbl).any()) or mc.tolist() != c
    assert caught
